"""The fastddc channelizer bank over a (chan, time) mesh, BASELINE config
5 (counterpart of csdr_tpu.parallel.sharded_ddc; the reference's
64-channel ddcd fastddc mode, ddcd_old.h:59-61).

- "time": each rank holds a slice of the wideband chunk.  The forward
  frames' overlap (overlap_length = taps-1, fastddc.c:52) crosses the
  shard boundary as a halo from the left neighbour: the collective form
  of the reference CLI's keep-overlap-then-fread (csdr.c:2291-2293).
- "chan": each rank keeps its rows of the channels.  Every chan shard
  transforms its own time samples forward instead of receiving spectra
  (compute traded for link bytes, as csdr_tpu does).

A shard's work is the port's single-card channelizer, started from the
state the mesh gives the shard: its overlap tail is the left halo, and
its per-channel frame NCO phase csdr_tpu's float32 ``frac(tidx*c1)``, c1
the phase a shard's frames advance.  Divisible post decimation (D=16)
runs ``FastddcChannelizerBlock`` (the split DFT and K4); otherwise (D=50)
``FastddcFwdBlock`` in kernel bin order (K3) and the classed inverse,
whose shards must hold whole q-frame groups.  So a 1x1 mesh is the
single-card bank bit for bit.  csdr_tpu's D=16 bank runs the fused dense
inverse instead (its TPU MXU choice), ~116 dB from K4's factored form.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.ops import fastddc as fd
from csdr_tpu_torch.parallel import halo as hx, segments
from csdr_tpu_torch.parallel.mesh import chan_rows


def _frames(nl: int, ddc: fd.FastDDC) -> int:
    """Frames in a shard of ``nl`` samples, with csdr_tpu's divisibility
    checks (its trace-time asserts)."""
    ins, pis, post = ddc.input_size, ddc.post_input_size, ddc.post_decimation
    if nl % ins:
        raise ValueError(f"shard samples {nl} % input_size {ins} != 0")
    b = nl // ins
    if (b * pis) % post:
        raise ValueError(f"a shard's {b} frames give {b * pis} samples, not "
                         f"a multiple of post_decimation {post}")
    return b


class FwdOnlyStep:
    """The chan-replicated part of the bank alone (framing, halo, forward
    FFT in kernel order): a shard (N_l,) -> spectra (B_l, fft_size)."""

    def __init__(self, mesh, ddc: fd.FastDDC):
        self.mesh, self.ddc = mesh, ddc
        self.fwd = fd.FastddcFwdBlock(ddc, "kernel").to(mesh.device)

    def body(self, state, xs):
        """(halo, x) -> spectra: the forward block from the halo."""
        tail, x = xs
        return state, self.fwd(tail, x)[1]

    def run(self, state, x: torch.Tensor, seg):
        """The halo, then the body (parallel/segments)."""
        _frames(x.shape[-1], self.ddc)
        tail = hx.halo_from_left(x, self.ddc.overlap_length, self.mesh)
        return seg("body", self.body, state, (tail, x))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.run((), x, segments.eager)[1]


def build_fwd_only_step(mesh, ddc: fd.FastDDC):
    """The rank's :class:`FwdOnlyStep`, captured on a card
    (``parallel.segments.on_card``)."""
    return segments.on_card(FwdOnlyStep(mesh, ddc))


class DdcBankStep:
    """One rank's step: its time slice (N_l,) complex64 on the mesh's
    device -> (C_l, M_l) complex64 baseband of its channel rows."""

    def __init__(self, mesh, ddc: fd.FastDDC, shift_rates):
        self.mesh, self.ddc = mesh, ddc
        rates = [float(r) for r in shift_rates]
        local = rates[chan_rows(len(rates), mesh)]
        pis, post = ddc.post_input_size, ddc.post_decimation
        self.fused = pis % post == 0
        if self.fused:
            self.chan = fd.FastddcChannelizerBlock(ddc, local).to(mesh.device)
            self.q, self.ga = 1, pis // post
        else:
            self.fwd = fd.FastddcFwdBlock(ddc, "kernel").to(mesh.device)
            self.inv = fd.FastddcInvClassedBlock(ddc, local, "kernel").to(
                mesh.device)
            self.q, self.ga = self.inv.q, self.inv.ga
        self.meta = dict(input_size=ddc.input_size,
                         overlap=ddc.overlap_length, post_input=pis,
                         post=post, channels=len(rates), q=self.q,
                         group_out=self.ga)
        self._phase_cache: dict = {}

    def phases(self, b_local: int) -> torch.Tensor:
        """The local channels' NCO phases (cycles, float32) at this shard's
        first frame: frac(tidx*c1), c1 = frac(the cycles b_local frames
        advance), as csdr_tpu's mesh bank."""
        if b_local not in self._phase_cache:
            if self.fused:
                c1 = np.mod(b_local * self.chan.frame_cyc, 1.0)
            else:
                if b_local % self.q:
                    raise ValueError(f"shard frames {b_local} % q {self.q} "
                                     "!= 0")
                c1 = np.mod((b_local // self.q) * self.ga * self.inv.dsa, 1.0)
            tidx = np.float32(self.mesh.coords["time"])
            ph = np.mod(tidx * c1.astype(np.float32), np.float32(1.0))
            self._phase_cache[b_local] = torch.from_numpy(
                ph.astype(np.float32)).to(self.mesh.device)
        return self._phase_cache[b_local]

    def body(self, state, xs):
        """The segment after the halo, (halo, x) -> (C_l, M_l): the fused
        channelizer, or the forward block and the classed inverse, from
        the phases of this shard length (a card tensor that ``run`` caches
        on the first call, so a capture reads a fixed address)."""
        tail, x = xs
        phases = self.phases(_frames(x.shape[-1], self.ddc))
        if self.fused:
            _, out = self.chan((tail, phases), x)
        else:
            _, spectra = self.fwd(tail, x)
            _, out = self.inv(phases, spectra)
        return state, out.data[:, :out.count]

    def run(self, state, x: torch.Tensor, seg):
        """The halo, then the body (parallel/segments)."""
        self.phases(_frames(x.shape[-1], self.ddc))
        tail = hx.halo_from_left(x, self.ddc.overlap_length, self.mesh)
        return seg("body", self.body, state, (tail, x))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.run((), x, segments.eager)[1]


def build_ddc_bank_step(mesh, ddc: fd.FastDDC, shift_rates):
    """Returns (step, meta): ``step`` the rank's :class:`DdcBankStep`,
    captured on a card (``parallel.segments.on_card``: the body one graph),
    ``meta`` csdr_tpu's plan sizes (input_size, overlap, post_input, post,
    channels, q, group_out)."""
    step = DdcBankStep(mesh, ddc, shift_rates)
    return segments.on_card(step), step.meta


def example_ddc_bank(mesh, frames_per_shard: int = 4, c_total: int = 8,
                     decimation: int = 16, transition_bw: float = 0.05):
    """A bank and its example input (csdr_tpu's seed and draws): returns
    (step, x global (time*frames*input_size,) complex64 on the CPU, ddc,
    rates)."""
    ddc = fd.fastddc_init(transition_bw, decimation)
    rng = np.random.default_rng(1)
    rates = rng.uniform(-0.4, 0.4, c_total)
    step, _ = build_ddc_bank_step(mesh, ddc, rates)
    n = mesh.shape["time"] * frames_per_shard * ddc.input_size
    re = rng.standard_normal(n).astype(np.float32)
    im = rng.standard_normal(n).astype(np.float32)
    return step, torch.from_numpy((re + 1j * im).astype(np.complex64)), \
        ddc, rates
