"""NCO frequency shift (counterpart of csdr_tpu.ops.shift):
output[n] = input[n] * e^{j(phi0 + 2*pi*rate*n)}.

One direct-form NCO: the per-sample phase is frac(n*rate), computed on the
host in float64 (exact to 1 ULP, no accumulated rounding), so output does
not depend on where chunk boundaries fall.  The phase step per sample is
2*pi*rate (rate in cycles/sample); mixing is in * (cos(phi) + j*sin(phi)),
as the reference's shift_math_cc (libcsdr.c:186-207).

The carried phase is a float32 0-dim CPU tensor advanced on the host with
csdr_tpu's float32 arithmetic: it depends on the chunk length only, never
on the samples, so a chunk costs no device sync.

A rate given as a tensor (a live-retuned channel, the DDC server's rows)
takes csdr_tpu's traced-rate path instead, on the rate's device in
float32: frac(idx*rate) from 12-bit digits of idx (:func:`_frac_mul`),
with the fused multiply-adds that compiled csdr_tpu gives (XLA contracts
``a*b + c`` inside ``jit``), so the carried phases are its bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core.block import Block, resolve_device
from csdr_tpu_torch.core.cplx import expj
from csdr_tpu_torch.core.graph import carried_value
from csdr_tpu_torch.core.precision import fma_f32

TWO_PI = 2.0 * np.pi
TWO_PI_F32 = float(np.float32(TWO_PI))   # the constant as float32 holds it


def _frac_cycles_static(n: int, rate: float) -> np.ndarray:
    """frac(arange(n)*rate) computed host-side in float64 — exact to 1 ULP."""
    return np.mod(np.arange(n, dtype=np.float64) * np.float64(rate),
                  1.0).astype(np.float32)


def _frac_mul(idx, rate, max_val: int) -> torch.Tensor:
    """frac(idx * rate) for a float32 tensor ``rate`` and non-negative
    int32 ``idx`` (an int or a tensor; the two broadcast), with an error
    of ~1 ULP of a cycle whatever idx (csdr_tpu/ops/shift.py:39-64).

    idx splits into 12-bit digits d_k, and frac(idx*rate) = frac(sum
    d_k*s_k) with s_k = frac(4096^k * rate), exact in float32; each s_k
    splits into a 12-bit head, whose product with d_k is exact, and a tail
    of less than 2^-12.  The tail's product is added in one rounding, as
    the fma XLA contracts it into (:func:`fma_f32`).  A number becomes a
    0-dim CPU tensor, which a CUDA op takes as a scalar: no copy, no
    sync."""
    rate = torch.as_tensor(rate, dtype=torch.float32)
    idx = torch.as_tensor(idx, dtype=torch.int32)
    dev = rate.device if rate.is_cuda else idx.device
    rate = torch.remainder(rate, 1.0)
    acc = torch.zeros(torch.broadcast_shapes(idx.shape, rate.shape),
                      dtype=torch.float32, device=dev)
    step = rate
    for shift in range(0, 31, 12):
        digit = ((idx >> shift) & 0xFFF).float()
        s_hi = torch.floor(step * 4096.0) * (1.0 / 4096.0)
        s_lo = step - s_hi
        acc = torch.remainder(acc + torch.remainder(digit * s_hi, 1.0), 1.0)
        acc = torch.remainder(fma_f32(digit, s_lo, acc), 1.0)
        step = torch.remainder(step * 4096.0, 1.0)
        if (1 << (shift + 12)) >= max_val:
            break
    return acc


def _frac_cycles_dynamic(n: int, rate, device=None) -> torch.Tensor:
    """frac(arange(n)*rate) for a tensor rate, on ``device`` (the rate's
    by default); a rate of shape (C, 1) gives (C, n)."""
    rate = torch.as_tensor(rate, dtype=torch.float32)
    return _frac_mul(torch.arange(n, dtype=torch.int32,
                                  device=device or rate.device), rate, n)


def _wrap_phase(p: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi] like the reference's while-loops, in float32."""
    return torch.remainder(torch.as_tensor(p, dtype=torch.float32) + np.pi,
                           TWO_PI) - np.pi


def _advance_phase(phase, frac: torch.Tensor) -> torch.Tensor:
    """phase + 2*pi*frac (radians, ``frac`` in cycles) in one float32
    rounding, as compiled csdr_tpu computes it, wrapped to (-pi, pi]."""
    phase = torch.as_tensor(phase, dtype=torch.float32)
    return _wrap_phase(fma_f32(TWO_PI_F32, frac, phase))


def _next_phase(phase, n: int, rate: float) -> torch.Tensor:
    """Phase after n samples, wrapped to (-pi, pi], as csdr_tpu computes
    it: in float32 when the phase is a float32 tensor (the carried state),
    in float64 when it is a Python number, then rounded to float32."""
    step = TWO_PI * float((n * np.float64(rate)) % 1.0)
    if isinstance(phase, torch.Tensor):
        p = np.float32(np.float32(phase) + np.float32(step))
        pi, two_pi = np.float32(np.pi), np.float32(TWO_PI)
    else:
        p, pi, two_pi = float(phase) + step, np.pi, TWO_PI
    return torch.tensor(np.float32(np.mod(p + pi, two_pi) - pi))


def static_cycles(n: int, rate: float, device) -> torch.Tensor:
    """frac(arange(n)*rate) from the host's float64 ramp, on ``device``."""
    return torch.from_numpy(_frac_cycles_static(n, rate)).to(device)


def traced_mix(x: torch.Tensor, rate: torch.Tensor, phase) -> torch.Tensor:
    """``x`` mixed by a float32 tensor ``rate`` from ``phase``: the
    traced-rate path's samples (:func:`shift_cc`)."""
    return x * expj(phase + TWO_PI * _frac_cycles_dynamic(
        x.shape[-1], rate, x.device))


def traced_next_phase(phase: torch.Tensor, n: int,
                      rate: torch.Tensor) -> torch.Tensor:
    """The traced-rate path's phase after n samples, on the phase's and
    the rate's device (the host for 0-dim CPU tensors)."""
    return _advance_phase(phase, _frac_mul(n, rate, n + 1))


def shift_cc(x: torch.Tensor, rate, phase=0.0):
    """Mix complex64 ``x`` by ``rate`` cycles/sample starting at ``phase``
    (radians); returns (y, next_phase).

    A Python-number rate takes exact float64 host ramps, and next_phase
    is a float32 0-dim CPU tensor.  A tensor rate (or a numpy float32)
    takes the traced-rate path on ``x``'s device (csdr_tpu/ops/shift.py:
    87-92): x may be (C, n) with rate and phase shaped (C, 1), and
    next_phase is a float32 tensor there."""
    n = x.shape[-1]
    if not isinstance(rate, (int, float)):
        rate = torch.as_tensor(rate, dtype=torch.float32)
        phase = torch.as_tensor(phase, dtype=torch.float32)
        return (traced_mix(x, rate, phase),
                traced_next_phase(phase, n, rate))
    cycles = static_cycles(n, rate, x.device)
    # a 0-dim CPU phase enters a CUDA op as a scalar: no copy, no sync
    y = x * expj(torch.as_tensor(phase, dtype=torch.float32)
                 + TWO_PI * cycles)
    return y, _next_phase(phase, n, rate)


def shift_fc(x: torch.Tensor, rate: float, phase=0.0):
    """Real -> complex + shift (reference libcsdr_gpl.c:54-79):
    out = x[n] * e^{j phi_n}."""
    return shift_cc(torch.complex(x.float(), torch.zeros_like(x.float())),
                    rate, phase)


class ShiftBlock(Block):
    """Streaming shift carrying the oscillator phase across chunks (the
    reference's ``starting_phase`` return value).  The phase is a value
    leaf (core/graph.carried_value): a captured step reads it as a 0-dim
    tensor on the card."""

    def __init__(self, rate: float, name: str = "shift_cc"):
        super().__init__(name)
        self.rate = float(rate)
        self._cycles: dict = {}          # (n, device) -> frac-cycle ramp

    def init(self, device="cuda"):
        resolve_device(device)
        return torch.tensor(0.0, dtype=torch.float32)

    def forward(self, phase, x):
        n = x.shape[0]
        key = (n, x.device)
        if key not in self._cycles:
            self._cycles[key] = torch.from_numpy(
                _frac_cycles_static(n, self.rate)).to(x.device)
        ph, ph_next = carried_value(
            phase, lambda p: _next_phase(p, n, self.rate))
        y = x * expj(ph + TWO_PI * self._cycles[key])
        return ph_next, y


def shift_block(rate: float, name: str = "shift_cc") -> Block:
    return ShiftBlock(rate, name)


def decimating_shift_cc(x: torch.Tensor, rate, decimation: int, phase=0.0,
                        start_offset=0, cycles=None):
    """Fused shift and decimate (reference libcsdr_gpl.c:126-160
    decimating_shift_addition_cc; csdr_tpu/ops/shift.py:119-157): every
    ``decimation``-th sample from ``start_offset`` on, rotated by an NCO
    stepping ``rate`` cycles per taken sample (callers pass
    rate*decimation, fastddc.c:69).

    Returns (y, count, next_phase, next_offset): y has capacity
    ceil(n/decimation) with zeros past ``count``; count is an int32
    0-dim tensor on x's device, next_offset ``start_offset +
    decimation*count - n`` likewise, and next_phase a float32 tensor
    there.  ``start_offset`` may be an int or such a tensor, so a stream
    of calls never waits on the device.  ``cycles``: a Python rate's ramp
    of ceil(n/decimation) on x's device (:func:`static_cycles`), uploaded
    once by a streaming caller whose step is captured."""
    n_in, d = x.shape[0], int(decimation)
    cap = (n_in + d - 1) // d
    dev = x.device
    off = torch.as_tensor(start_offset, dtype=torch.int32)
    idx = off + d * torch.arange(cap, dtype=torch.int32, device=dev)
    valid = idx < n_in
    taken = torch.where(valid, x[idx.clamp(max=max(n_in - 1, 0)).long()],
                        0) if n_in else x.new_zeros(cap)
    if isinstance(rate, (int, float)):
        if cycles is None:
            cycles = static_cycles(cap, rate, dev)
    else:
        cycles = _frac_mul(torch.arange(cap, dtype=torch.int32, device=dev),
                           rate, cap)
    ph = torch.as_tensor(phase, dtype=torch.float32)
    y = torch.where(valid, taken * expj(ph + TWO_PI * cycles), 0)
    count = valid.sum(dtype=torch.int32)
    # count is a tensor, so even a Python rate goes through the digit split
    rate32 = np.float32(rate) if isinstance(rate, (int, float)) else rate
    next_phase = _advance_phase(ph, _frac_mul(count, rate32, cap + 1))
    return y, count, next_phase, off + d * count - n_in
