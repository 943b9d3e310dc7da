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
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core.block import Block, resolve_device
from csdr_tpu_torch.core.cplx import expj

TWO_PI = 2.0 * np.pi


def _frac_cycles_static(n: int, rate: float) -> np.ndarray:
    """frac(arange(n)*rate) computed host-side in float64 — exact to 1 ULP."""
    return np.mod(np.arange(n, dtype=np.float64) * np.float64(rate),
                  1.0).astype(np.float32)


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


def shift_cc(x: torch.Tensor, rate: float, phase=0.0):
    """Mix complex64 ``x`` by ``rate`` cycles/sample starting at ``phase``
    (radians, float or 0-dim tensor); returns (y, next_phase) with
    next_phase a float32 0-dim CPU tensor."""
    n = x.shape[0]
    cycles = torch.from_numpy(_frac_cycles_static(n, rate)).to(x.device)
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
    reference's ``starting_phase`` return value)."""

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
        y = x * expj(phase + TWO_PI * self._cycles[key])
        return _next_phase(phase, n, self.rate), y


def shift_block(rate: float, name: str = "shift_cc") -> Block:
    return ShiftBlock(rate, name)
