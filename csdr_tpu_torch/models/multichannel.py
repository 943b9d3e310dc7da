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
csdr_tpu shards channels and time over a device mesh; that form waits for
the port's sharded banks.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from csdr_tpu_torch.core.block import Pipeline, resolve_device
from csdr_tpu_torch.ops import digital, fastddc as fd, sync


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
        self.tr = sync.timing_recovery_block(
            "GARDNER", sps, loop_gain=0.5, max_error=2.0, use_q=True,
            segments=tr_segments)
        self.tr_subchunks = tr_subchunks
        self.costas = sync.costas_loop_params(costas_bw) if use_costas \
            else None
        self.meta = dict(input_size=ddc.input_size, overlap=ddc.overlap_length,
                         post_input=pis, post=post, channels=len(rates), q=q,
                         group_out=ga, bank=self)

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


def build_ddc_bpsk31_bank(shift_rates, decimation: int, sps: int = 256,
                          use_costas: bool = False,
                          costas_bw: float = 2 * np.pi / 100,
                          tr_segments: int = 1, tr_subchunks: int = 1,
                          device="cuda"):
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
    bits); a count that does not divide the chunk warns and runs one."""
    bank = DdcBpsk31Bank(shift_rates, decimation, sps, use_costas, costas_bw,
                         tr_segments, tr_subchunks, device)
    return bank.init, bank.step, bank.meta
