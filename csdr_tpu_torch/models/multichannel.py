"""The flagship multichannel pipeline, BASELINE config 5 on one card
(counterpart of csdr_tpu.models.multichannel): a 64-channel fastddc FFT
channelizer feeding a BPSK31 Gardner symbol recovery and DBPSK decode per
channel (the reference RX chain of grc_tests/bpsk31_ber.py:16-26).

The channelizer is the port's own: ``fastddc_channelizer_block`` (K4) for
a divisible plan such as D=16, and ``fastddc_fwd_block`` in kernel bin
order (K3) with the classed inverse for D=50.  As csdr_tpu's bank does,
every chunk is channelized from zero history (no overlap tail, NCO ramps
from the chunk's first frame); the carried state is the modem's alone.
The modem is ``ops/sync`` and ``ops/digital`` over the channel axis.

With a ``mesh`` (``parallel/mesh.init_mesh``) the bank is csdr_tpu's mesh
form: each rank channelizes its time slice of the chunk for its channel
rows (``parallel/sharded_ddc``), the decimated channel streams are
gathered along "time" (the corner turn, csdr_tpu's resharding to
P('chan', None) and the reference ddcd's per-client pipes,
ddcd_old.h:59-61), and the modem runs on the rank's rows with its state
sharded by chan.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from csdr_tpu_torch.core.block import Pipeline, resolve_device
from csdr_tpu_torch.core.graph import CapturedStep
from csdr_tpu_torch.ops import digital, fastddc as fd, sync
from csdr_tpu_torch.parallel import mesh as pmesh, segments, sharded_ddc


class DdcBpsk31Bank:
    """Channelizer plus per-channel modem.  State: (TED tail (C, 4*sps)
    complex64, occ (C,) int32, corr (C,) int32, DBPSK last symbol (C,)
    complex64) and, with the Costas loop, its (nco_phase, freq, dphase)
    (C,) float32: csdr_tpu's 6 (or 9) arrays once each complex tensor is
    split into its (re, im) planes."""

    def __init__(self, shift_rates, decimation: int, sps: int,
                 use_costas: bool, costas_bw: float, tr_segments: int,
                 tr_subchunks: int, device):
        self.device = resolve_device(device)
        ddc = fd.fastddc_init(0.05, decimation)
        rates = [float(r) for r in shift_rates]
        pis, post = ddc.post_input_size, ddc.post_decimation
        if pis % post == 0:
            chan = fd.fastddc_channelizer_block(ddc, rates)
            q, ga = 1, pis // post
        else:
            chan = Pipeline([
                fd.fastddc_fwd_block(ddc, spectra_order="kernel"),
                fd.fastddc_inv_block(ddc, rates, spectra_order="kernel")],
                name=f"fastddc{decimation} fwd|inv")
            q = fd._class_plan(ddc)[0]
            ga = q * pis // post
        self.channelizer = chan.to(self.device)
        self.ddc, self.channels, self.q, self.group_out = ddc, len(rates), q, ga
        self._modem_setup(sps, use_costas, costas_bw, tr_segments,
                          tr_subchunks)
        self.meta = dict(input_size=ddc.input_size, overlap=ddc.overlap_length,
                         post_input=pis, post=post, channels=len(rates), q=q,
                         group_out=ga, bank=self)

    def _modem_setup(self, sps, use_costas, costas_bw, tr_segments,
                     tr_subchunks) -> None:
        self.tr = sync.timing_recovery_block(
            "GARDNER", sps, loop_gain=0.5, max_error=2.0, use_q=True,
            segments=tr_segments)
        self.tr_subchunks = tr_subchunks
        self.costas = sync.costas_loop_params(costas_bw) if use_costas \
            else None

    def _zero_state(self) -> tuple:
        c = self.channels
        state = self.tr.init(self.device, channels=c) + (
            torch.zeros(c, dtype=torch.complex64, device=self.device),)
        if self.costas is not None:
            state += tuple(torch.zeros(c, dtype=torch.float32,
                                       device=self.device) for _ in range(3))
        return state

    def samples_per_chunk(self, n_wideband: int) -> int:
        """Per-channel samples a chunk of ``n_wideband`` gives: the classed
        plan emits group_out samples per q frames."""
        frames, rem = divmod(n_wideband, self.ddc.input_size)
        if rem or frames % self.q:
            raise ValueError(f"a chunk of {n_wideband} samples is not a "
                             f"whole number of {self.q}-frame groups of "
                             f"{self.ddc.input_size}")
        return frames // self.q * self.group_out

    def init(self, n_wideband: int) -> tuple:
        """The zero state for chunks of ``n_wideband`` samples, which must
        hold a whole number of q-frame groups (the TED carry itself is a
        fixed 4*sps tail)."""
        self.samples_per_chunk(n_wideband)
        return self._zero_state()

    def state_from_jax(self, leaves) -> tuple:
        """csdr_tpu's bank state (6 or 9 arrays, channel axis first)."""
        return leaves.like(self._zero_state())

    def channelize(self, x: torch.Tensor) -> torch.Tensor:
        """Wideband chunk -> (C, m) complex64 channel streams."""
        self.samples_per_chunk(x.shape[-1])
        chan = self.channelizer
        _, y = chan(chan.init(x.device), x)
        return y.data

    def _ted_dbpsk(self, ted, last, y):
        """TED and DBPSK over a (C, m) chunk, as ``tr_subchunks``
        sequential TED calls where that divides m; bits packed back to
        back.  Returns (ted', last', bits (C, cap), counts (C,))."""
        m = y.shape[-1]
        k = self.tr_subchunks if m % self.tr_subchunks == 0 else 1
        if k != self.tr_subchunks:
            warnings.warn(
                f"tr_subchunks={self.tr_subchunks} does not divide the "
                f"per-channel chunk ({m}); falling back to the serial k=1 "
                "TED", stacklevel=3)
        sub = m // k
        parts, counts = [], []
        for i in range(k):
            ted, syms = self.tr(ted, y[:, i * sub:(i + 1) * sub])
            b_i, last = digital.dbpsk_decoder_c_u8(syms.data, last,
                                                   count=syms.count)
            parts.append(b_i)
            counts.append(syms.count)
        if k == 1:
            return ted, last, parts[0], counts[0]
        cap = parts[0].shape[-1]
        bits = torch.zeros((y.shape[0], k * cap), dtype=torch.uint8,
                           device=y.device)
        slot = torch.arange(cap, device=y.device)
        off = torch.zeros_like(counts[0])
        for b_i, c_i in zip(parts, counts):
            bits.scatter_(1, off[:, None].to(torch.int64) + slot, b_i)
            off = off + c_i
        return ted, last, bits, off

    def modem(self, state: tuple, y: torch.Tensor):
        """(Costas ->) Gardner -> DBPSK on (C, m) channel streams.  Returns
        (state', (bits (C, cap) uint8, counts (C,) int32))."""
        ted, last = state[:3], state[3]
        if self.costas is not None:
            y, _e, _d, costas = sync.bpsk_costas_loop_cc(
                y, *self.costas, state=state[4:7])
        ted, last, bits, count = self._ted_dbpsk(ted, last, y)
        new_state = ted + (last,)
        if self.costas is not None:
            new_state += costas
        return new_state, (bits, count)

    def step(self, state: tuple, x: torch.Tensor):
        """Wideband chunk on the bank's device -> (state', (bits, counts))."""
        with torch.no_grad():
            return self.modem(state, self.channelize(x))


class MeshDdcBpsk31Bank(DdcBpsk31Bank):
    """The bank on one rank of a (chan, time) mesh: the sharded
    channelizer on the rank's time slice for its channel rows, the corner
    turn (an all-gather of the (C_l, m_l) channel streams along "time",
    counted under "corner_turn"), and the modem on its C_l rows.  The
    state is :class:`DdcBpsk31Bank`'s for those rows; ``step`` takes the
    rank's slice of the chunk (``mesh.shard_input``) and returns its rows'
    bits and counts (``mesh.gather_output(..., time_sharded=False)``
    collects them)."""

    def __init__(self, mesh, shift_rates, decimation: int, sps: int,
                 use_costas: bool, costas_bw: float, tr_segments: int,
                 tr_subchunks: int):
        self.mesh, self.device = mesh, mesh.device
        ddc = fd.fastddc_init(0.05, decimation)
        self.bank_step = sharded_ddc.DdcBankStep(mesh, ddc, shift_rates)
        meta = self.bank_step.meta
        self.rows = pmesh.chan_rows(len(shift_rates), mesh)
        self.ddc, self.q, self.group_out = ddc, meta["q"], meta["group_out"]
        self.channels = self.rows.stop - self.rows.start
        self._modem_setup(sps, use_costas, costas_bw, tr_segments,
                          tr_subchunks)
        self.meta = dict(meta, bank=self)

    def samples_per_chunk(self, n_wideband: int) -> int:
        """Per-channel samples of a whole chunk of ``n_wideband`` samples,
        whose every time shard must hold whole q-frame groups."""
        p = self.mesh.shape["time"]
        if n_wideband % p:
            raise ValueError(f"a chunk of {n_wideband} samples does not "
                             f"split over {p} time shards")
        return p * super().samples_per_chunk(n_wideband // p)

    def state_from_jax(self, leaves) -> tuple:
        """csdr_tpu's mesh bank state (6 or 9 global (C, ...) arrays): this
        rank's chan rows of each."""
        from csdr_tpu_torch.core.checkpoint import JaxLeaves

        rest = leaves.leaves[leaves.pos:]
        mine = JaxLeaves([a[self.rows] for a in rest], leaves.device)
        state = mine.like(self._zero_state())
        leaves.pos += mine.pos
        return state

    def _corner_turn(self, y: torch.Tensor) -> tuple:
        """Every time shard's (C_l, m_l) streams of this chan row, in
        order: an all-gather along "time", none where time is 1."""
        if self.mesh.shape["time"] == 1:
            return (y,)
        return tuple(pmesh.all_gather(y, self.mesh, "time", "corner_turn"))

    def channelize(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's slice of the chunk -> (C_l, m) complex64: its rows of
        the channel streams over the whole chunk."""
        DdcBpsk31Bank.samples_per_chunk(self, x.shape[-1])
        return _joined(self._corner_turn(self.bank_step(x)))

    def _modem_on(self, state: tuple, parts: tuple):
        return self.modem(state, _joined(parts))

    def run(self, state: tuple, x: torch.Tensor, seg):
        """The step with ``seg`` running its segments (parallel/segments):
        the DDC bank's (the halo, its body), the corner turn, the modem on
        the rank's rows (its state donated where captured)."""
        DdcBpsk31Bank.samples_per_chunk(self, x.shape[-1])
        _, y = self.bank_step.run((), x, seg)
        return seg("modem", self._modem_on, state, self._corner_turn(y))

    def step(self, state: tuple, x: torch.Tensor):
        with torch.no_grad():
            return self.run(state, x, segments.eager)


def _joined(parts: tuple) -> torch.Tensor:
    return torch.cat(parts, -1) if len(parts) > 1 else parts[0]


def build_ddc_bpsk31_bank(shift_rates, decimation: int, sps: int = 256,
                          use_costas: bool = False,
                          costas_bw: float = 2 * np.pi / 100,
                          tr_segments: int = 1, tr_subchunks: int = 1,
                          device="cuda", mesh=None):
    """Returns (init, step, meta): ``init(n_wideband)`` the zero state for
    chunks of that many wideband samples, ``step(state, x)`` ->
    (state', (bits (C, cap) uint8, counts (C,) int32)) for a complex64
    wideband chunk on ``device``, ``meta`` the plan sizes (input_size, q,
    group_out, ...) and ``meta["bank"]`` the :class:`DdcBpsk31Bank`.

    shift_rates: per-channel ``shift=`` rates (mix by +rate: a channel
    centred at -rate comes to baseband).  sps: modem samples per symbol at
    the channel rate (divisible by 4).  use_costas: a BPSK Costas loop per
    channel before the TED (carrier recovery for mistuned channels); it
    steps once per channel sample, so keep it to low channel rates.
    tr_segments > 1: the TED's segmented mode.  tr_subchunks > 1: each
    channel chunk fed to the TED as that many sequential calls (same
    bits); a count that does not divide the chunk warns and runs one.

    mesh: a ``parallel.mesh.Mesh`` for csdr_tpu's mesh form
    (:class:`MeshDdcBpsk31Bank`, on the mesh's device; ``device`` is not
    read): ``init`` takes the whole chunk's length, ``step`` the rank's
    time slice and returns its channel rows.

    On the card ``step`` is :meth:`DdcBpsk31Bank.step` captured and
    replayed (core/graph.CapturedStep, csdr_tpu's jitted bank step): one
    CUDA graph without a mesh or where the mesh's time axis is 1, else
    the channelizer body and the modem a graph each with the halo and the
    corner turn run between them (parallel/segments.SegmentedStep).  It
    donates its state, as csdr_tpu's does.  ``meta["bank"].step``,
    ``.channelize`` and ``.modem`` stay eager."""
    if mesh is not None:
        bank = MeshDdcBpsk31Bank(mesh, shift_rates, decimation, sps,
                                 use_costas, costas_bw, tr_segments,
                                 tr_subchunks)
        step = segments.SegmentedStep(bank) \
            if bank.device.type == "cuda" else bank.step
        return bank.init, step, bank.meta
    bank = DdcBpsk31Bank(shift_rates, decimation, sps, use_costas,
                         costas_bw, tr_segments, tr_subchunks, device)
    step = CapturedStep(bank.step) if bank.device.type == "cuda" \
        else bank.step
    return bank.init, step, bank.meta


def example_flagship(mesh, frames_per_shard: int = 4, c_total: int = 8,
                     decimation: int = 16, sps: int = 256,
                     tr_segments: int = 1):
    """The mesh bank and an example input (csdr_tpu's seed and draws):
    returns (state, step, x global complex64 on the CPU, rates); give
    ``step`` the rank's slice, ``mesh.shard_input(x, mesh)``."""
    rng = np.random.default_rng(3)
    rates = rng.uniform(-0.35, 0.35, c_total)
    init, step, meta = build_ddc_bpsk31_bank(rates, decimation, sps,
                                             tr_segments=tr_segments,
                                             mesh=mesh)
    n = mesh.shape["time"] * frames_per_shard * meta["input_size"]
    re = rng.standard_normal(n).astype(np.float32)
    im = rng.standard_normal(n).astype(np.float32)
    x = torch.from_numpy((re + 1j * im).astype(np.complex64))
    return init(n), step, x, rates
