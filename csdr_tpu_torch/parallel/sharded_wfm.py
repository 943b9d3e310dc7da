"""The WFM receiver bank over a (chan, time) mesh (counterpart of
csdr_tpu.parallel.sharded_wfm).

A bank of C FM channels, each its own NCO shift of the shared wideband
stream (the ddcd per-client model of ddcd_old.h:51-57 as a batch axis),
over a mesh of ranks:

- "time": each rank holds a slice of the wideband chunk.  The FIR history
  crosses shard boundaries as a halo from the left neighbour
  (parallel/halo.py), and the de-emphasis carry is fixed up from one
  all-gather of every shard's affine reduction.
- "chan": each rank runs its rows of the channels.

The chain per channel, on [halo | x_local] with
``tail_ext = round_up(T-1, D1) + D1`` halo samples (one extra decimated
output for the discriminator): NCO mix and decimating FIR through K1
(``kernels/fir_cuda.shift_fir_decimate``, one launch a channel), the
quadri-correlator discriminator over the extra leading output, ``[::D2]``
(the reference fractional decimator at an integer rate), and the 1-pole
de-emphasis as a local affine scan plus the cross-shard fixup.  The NCO
phase at the shard's first sample is csdr_tpu's float32
``frac(tidx*c1 + c2)``, c1 = frac(N_l*rate), c2 = frac(-tail_ext*rate),
and K1 steps it in float64 from there, so no float32 phase grows with the
stream position.  csdr_tpu runs the FIR as a Toeplitz MXU product, a TPU
layout of the same sums.  Each call of the step is a block of its own:
zero history on time shard 0 and a zero de-emphasis carry.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core.scan import affine_prefix
from csdr_tpu_torch.kernels import fir_cuda
from csdr_tpu_torch.ops.demod import fmdemod_quadri_cf
from csdr_tpu_torch.parallel import halo as hx, segments
from csdr_tpu_torch.parallel.mesh import chan_rows


class WfmBankStep:
    """One rank's step: its time slice of the wideband chunk, complex64
    (N_l,) on the mesh's device -> audio (C_l, N_l/(D1*D2)) float32 of its
    channel rows."""

    def __init__(self, mesh, chan_rates, taps, d1: int = 10, d2: int = 5,
                 tau: float = 50e-6, audio_rate: int = 48_000):
        self.mesh = mesh
        rates = np.asarray(chan_rates, np.float64)
        self.rates = rates[chan_rows(len(rates), mesh)]
        self.taps = torch.from_numpy(np.asarray(taps, np.float32)
                                     ).to(mesh.device)
        self.d1, self.d2 = d1, d2
        t_len = len(taps)
        self.tail_ext = -(-(t_len - 1) // d1) * d1 + d1
        self.alpha = (1.0 / audio_rate) / (tau + 1.0 / audio_rate)

    def phases(self, nl: int) -> np.ndarray:
        """Each local channel's NCO phase (cycles) at this shard's first
        [halo | x] sample: csdr_tpu's float32 frac(tidx*c1 + c2)."""
        r = self.rates
        c1 = np.mod(nl * r, 1.0).astype(np.float32)
        c2 = np.mod(-self.tail_ext * r, 1.0).astype(np.float32)
        tidx = np.float32(self.mesh.coords["time"])
        return np.mod(tidx * c1 + c2, np.float32(1.0))

    def body(self, state, xs):
        """The segment between the halo and the fixup: K1 once a local
        channel, the discriminator, ``[::D2]`` and the local affine scan,
        (halo, x) -> (cb, ca).  K1 takes theta by value: ``phases(nl)``
        depends only on the shard length and the rank's time coordinate,
        so a captured graph, keyed by the input shapes, replays the theta
        it was captured with rightly."""
        halo, x = xs
        d1, d2, nl = self.d1, self.d2, x.shape[-1]
        kout = nl // d1 + 1
        theta = self.phases(nl)
        y = torch.stack([
            fir_cuda.shift_fir_decimate(halo, x, self.taps, d1, kout,
                                        float(r), float(th))
            for r, th in zip(self.rates, theta)])          # (C_l, kout)
        # the discriminator over the extra leading output, then [::D2]
        dem = fmdemod_quadri_cf(y[:, 1:], y[:, 0])[0][:, ::d2]
        return state, affine_prefix(torch.full_like(dem, 1.0 - self.alpha),
                                    self.alpha * dem)

    @staticmethod
    def finish(state, xs):
        """The segment after the fixup: (cb, ca, carry) -> audio."""
        cb, ca, carry = xs
        return state, cb * carry[:, None] + ca

    def run(self, state, x: torch.Tensor, seg):
        """The step with ``seg`` running its segments (parallel/segments):
        the halo, the body, the fixup's all-gather, the finish."""
        d1, d2, nl = self.d1, self.d2, x.shape[-1]
        if nl % (d1 * d2):
            raise ValueError(f"a shard of {nl} samples is not a multiple of "
                             f"D1*D2 = {d1 * d2}")
        halo = hx.halo_from_left(x, self.tail_ext, self.mesh)
        _, (cb, ca) = seg("body", self.body, state, (halo, x))
        carry = hx.affine_scan_fixup(cb[:, -1], ca[:, -1], 0.0, self.mesh)
        return seg("finish", self.finish, state, (cb, ca, carry))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.run((), x, segments.eager)[1]


def build_wfm_bank_step(mesh, chan_rates, taps, d1: int = 10, d2: int = 5,
                        tau: float = 50e-6, audio_rate: int = 48_000):
    """The rank's step (see :class:`WfmBankStep`), captured on a card
    (``parallel.segments.SegmentedStep``: the body and the finish a graph
    each, one graph where time is 1; ``.eager`` the step).  The channel
    count must split over "chan" and every shard hold a multiple of D1*D2
    samples."""
    return segments.on_card(WfmBankStep(mesh, chan_rates, taps, d1, d2, tau,
                                        audio_rate))


def example_bank(mesh, n_block: int, c_total: int = 8):
    """A step and its example input (csdr_tpu's seed and draws): rates in
    [-0.4, 0.4), ``firdes_lowpass_f(81, 0.05)``, and the global wideband
    block (n_block,) complex64 on the CPU (shard it with
    ``mesh.shard_input``)."""
    from csdr_tpu_torch import firdes

    rng = np.random.default_rng(0)
    rates = rng.uniform(-0.4, 0.4, c_total).astype(np.float32)
    taps = firdes.firdes_lowpass_f(81, 0.05)
    step = build_wfm_bank_step(mesh, rates, taps)
    re = rng.standard_normal(n_block).astype(np.float32)
    im = rng.standard_normal(n_block).astype(np.float32)
    return step, torch.from_numpy((re + 1j * im).astype(np.complex64))
