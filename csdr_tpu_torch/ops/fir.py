"""Decimating FIR filtering, the main-path part of csdr_tpu.ops.fir.

Reference semantics: ``fir_decimate_cc`` is libcsdr.c:528-549, a real-tap
FIR at stride D over complex input in valid mode,
y[k] = sum_t x[k*D+t] * taps[t].

Stream framing is csdr_tpu's exactly: a streaming block keeps a zero-init
input tail of round_up(T-1, D) samples, so each chunk of N (N % D == 0)
gives exactly N/D outputs, and the first tail_len/D outputs are the
zero-history warmup.  On the card each chunk is ONE kernel launch over the
carried tail and the chunk (kernels/fir_cuda.py): the TPU package's
head/body/tail split exists only because its Pallas blocks are row-aligned,
and is not carried over.

``precision``: "HIGHEST" and "HIGH" are both accepted; both compute in f32
FMA, at least as accurate as csdr_tpu's bf16x3 "HIGH".
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core.block import Block, resolve_device
from csdr_tpu_torch.kernels import fir_cuda

DEFAULT_PRECISION = "HIGHEST"


def _round_up(a: int, m: int) -> int:
    return ((a + m - 1) // m) * m


def _taps_list(taps) -> list[float]:
    return [float(v) for v in np.asarray(taps, np.float32)]


def fir_decimate_cc(x: torch.Tensor, taps, decimation: int,
                    precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Stateless valid-mode decimating FIR (reference libcsdr.c:528-549).
    x: complex64 (N,); taps a float32 tensor or a sequence; returns
    floor((N-T)/D)+1 outputs.  On the card this is one launch of the
    fir_decimate kernel."""
    if not isinstance(taps, torch.Tensor):
        taps = np.asarray(taps, np.float32)
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    kout = max(0, (x.shape[0] - taps.shape[0]) // decimation + 1)
    empty = x.new_empty(0)
    return fir_cuda.fir_decimate(empty, x.contiguous(), taps, decimation,
                                 kout, precision)


def fir_decimate_ff(x: torch.Tensor, taps, decimation: int) -> torch.Tensor:
    """Real-input valid-mode decimating FIR."""
    kout = max(0, (x.shape[0] - len(taps)) // decimation + 1)
    return fir_cuda.strided_corr(x.float(), _taps_list(taps), decimation,
                                 kout)


def apply_real_fir_ff(x: torch.Tensor, taps) -> torch.Tensor:
    """Valid-mode real FIR: y[i] = sum_t taps[t] * x[i+t]
    (reference libcsdr.c:2276-2291, real form)."""
    return fir_decimate_ff(x, taps, 1)


class FirDecimateBlock(Block):
    """Streaming decimating FIR (complex64 in and out).

    State: zero-init tail of round_up(T-1, D) samples.  Output per chunk of
    N (N % D == 0): exactly N/D samples.  warmup_out = tail_len // D."""

    def __init__(self, taps, decimation: int, name: str = "fir_decimate_cc",
                 precision: str = DEFAULT_PRECISION):
        super().__init__(name)
        taps_np = np.asarray(taps, np.float32)
        self.decimation = int(decimation)
        self.tail_len = _round_up(len(taps_np) - 1, self.decimation)
        self.warmup_out = self.tail_len // self.decimation
        self.rate_ratio = 1.0 / self.decimation
        self.precision = precision
        self.register_buffer("taps", torch.from_numpy(taps_np.copy()))

    def init(self, device="cuda"):
        return torch.zeros(self.tail_len, dtype=torch.complex64,
                           device=resolve_device(device))

    def _new_tail(self, tail, x):
        n = x.shape[0]
        if n >= self.tail_len:
            return x[n - self.tail_len:].clone()
        return torch.cat([tail, x])[n:]

    def forward(self, tail, x):
        n = x.shape[0]
        if n % self.decimation:
            raise ValueError(f"chunk size {n} must be a multiple of "
                             f"decimation {self.decimation}")
        y = fir_cuda.fir_decimate(tail, x.contiguous(), self.taps,
                                  self.decimation, n // self.decimation,
                                  self.precision)
        return self._new_tail(tail, x), y


def fir_decimate_block(taps, decimation: int, name: str = "fir_decimate_cc",
                       precision: str = DEFAULT_PRECISION) -> Block:
    return FirDecimateBlock(taps, decimation, name, precision)


class ShiftedFirDecimateBlock(FirDecimateBlock):
    """NCO shift + decimating FIR as ONE stream block: the same function as
    shift_block(rate) | fir_decimate_block(taps, D), run on the card as one
    launch of the NCO-fused kernel over [tail | chunk].

    State: (theta, tail).  theta is the phase in cycles of tail[0], a
    float32 0-dim CPU tensor advanced with csdr_tpu's own float32 step
    (``_th``), so the carried phase tracks csdr_tpu's chunk for chunk;
    stream sample 0 starts at phase 0, as in the serial chain."""

    def __init__(self, rate: float, taps, decimation: int,
                 name: str = "shift_fir_decimate_cc",
                 precision: str = DEFAULT_PRECISION):
        super().__init__(taps, decimation, name, precision)
        self.rate = float(rate)
        # phase of xcat[0] so that stream sample 0 (at xcat[tail_len]) is 0
        self.theta0 = float(np.mod(-np.float64(rate) * self.tail_len, 1.0))

    def init(self, device="cuda"):
        return (torch.tensor(self.theta0, dtype=torch.float32),
                super().init(device))

    def _th(self, theta, off: int) -> torch.Tensor:
        """theta + frac(rate*off) mod 1 in float32 — phase at xcat[off]."""
        step = np.float32(np.mod(np.float64(self.rate) * off, 1.0))
        return torch.tensor(np.mod(np.float32(theta) + step, np.float32(1.0)),
                            dtype=torch.float32)

    def forward(self, state, x):
        theta, tail = state
        n = x.shape[0]
        if n % self.decimation:
            raise ValueError(f"chunk size {n} must be a multiple of "
                             f"decimation {self.decimation}")
        y = fir_cuda.shift_fir_decimate(
            tail, x.contiguous(), self.taps, self.decimation,
            n // self.decimation, self.rate, float(theta), self.precision)
        return (self._th(theta, n), self._new_tail(tail, x)), y


def shifted_fir_decimate_block(rate: float, taps, decimation: int,
                               name: str = "shift_fir_decimate_cc",
                               precision: str = DEFAULT_PRECISION) -> Block:
    return ShiftedFirDecimateBlock(rate, taps, decimation, name, precision)
