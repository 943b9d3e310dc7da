"""Gain, limiting, DC blocking, power metering, in-stream monitors and the
squelch (counterpart of csdr_tpu.ops.util_ops).

``clipdetect_ff`` and ``detect_nan_ff`` return counts; the CLI reads them
on the host and prints the monitor's line to stderr, as csdr_tpu's does.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core.block import Block, resolve_device
from csdr_tpu_torch.core.scan import affine_scan


def gain_ff(x: torch.Tensor, gain) -> torch.Tensor:
    """reference libcsdr.c:1139-1142"""
    return (x * gain).to(x.dtype)


def limit_ff(x: torch.Tensor, max_amplitude: float = 1.0) -> torch.Tensor:
    """Clamp to [-max, max] (reference libcsdr.c:1130-1137)."""
    return torch.clamp(x, -max_amplitude, max_amplitude)


def clipdetect_ff(x: torch.Tensor) -> torch.Tensor:
    """Count of samples outside [-1, 1] (the reference warns on stderr,
    csdr.c:220-228), an int64 0-dim tensor on x's device."""
    return torch.sum((x < -1.0) | (x > 1.0))


def detect_nan_ff(x: torch.Tensor) -> torch.Tensor:
    """Count of NaNs (reference csdr.c:1034-1054)."""
    return torch.sum(torch.isnan(x))


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def dcblock_ff(x: torch.Tensor, a: float = 0.999, last_input=0.0,
               last_output=0.0):
    """DC-blocking IIR y[i] = x[i] - x[i-1] + a*y[i-1]
    (reference libcsdr.c:903-918), as an affine scan.
    Returns (y, (next_last_input, next_last_output))."""
    x = x.float()
    prev = torch.cat([_scalar(last_input, x).reshape(1), x[:-1]])
    y = affine_scan(torch.full_like(x, a), x - prev,
                     _scalar(last_output, x))
    return y, (x[-1].clone(), y[-1].clone())


class DcblockBlock(Block):
    """Streaming dcblock_ff; state (last input, last output)."""

    def __init__(self, a: float = 0.999):
        super().__init__("dcblock_ff")
        self.a = a

    def init(self, device="cuda"):
        z = torch.zeros((), dtype=torch.float32,
                        device=resolve_device(device))
        return (z, z.clone())

    def forward(self, state, x):
        y, state = dcblock_ff(x, self.a, *state)
        return state, y


def dcblock_block(a: float = 0.999) -> Block:
    return DcblockBlock(a)


def fastdcblock_ff(x: torch.Tensor, last_dc_level=0.0):
    """Block-average DC removal with a linear level ramp
    (reference libcsdr.c:920-941).  Returns (y, next_dc_level)."""
    x = x.float()
    n = x.shape[0]
    avg = x.mean()
    ramp = torch.arange(n, dtype=torch.float32, device=x.device) / n
    last = _scalar(last_dc_level, x)
    return x - (last + (avg - last) * ramp), avg


class FastdcblockBlock(Block):
    """Streaming fastdcblock_ff; state the last block's DC level."""

    def __init__(self):
        super().__init__("fastdcblock_ff")

    def init(self, device="cuda"):
        return torch.zeros((), dtype=torch.float32,
                           device=resolve_device(device))

    def forward(self, level, x):
        y, level = fastdcblock_ff(x, level)
        return level, y


def fastdcblock_block() -> Block:
    return FastdcblockBlock()


def get_power_f(x: torch.Tensor, decimation: int = 1) -> torch.Tensor:
    """Mean power with an optional stride; the reference divides by the
    full input size even when striding (libcsdr.c:1144-1152), and so does
    this."""
    xs = x[::decimation]
    return torch.sum(xs * xs) / x.shape[0]


def _abs2(x: torch.Tensor) -> torch.Tensor:
    return x.real * x.real + x.imag * x.imag


def get_power_c(x: torch.Tensor, decimation: int = 1) -> torch.Tensor:
    return torch.sum(_abs2(x[::decimation])) / x.shape[0]


def add_dcoffset_cc(x: torch.Tensor) -> torch.Tensor:
    """reference libcsdr.c:1174-1178: i -> 0.5 + i/2, q -> q/2."""
    return torch.complex(0.5 + x.real / 2, x.imag / 2)


def fixed_amplitude_cc(x: torch.Tensor, new_amplitude) -> torch.Tensor:
    """Every sample scaled to magnitude ``new_amplitude``, zeros kept
    (reference libcsdr.c:1198-1212).  The square root and the division
    are taken in float64 and rounded once to float32, which is the
    correctly rounded float32 result that XLA gives: torch's float32 CPU
    kernels for both can be an ulp or more off."""
    amp = torch.sqrt(_abs2(x).double()).float()
    nz = amp > 0
    num = float(np.float32(new_amplitude))
    gain = torch.where(nz, (num / torch.where(nz, amp, torch.ones_like(amp))
                            .double()).float(), torch.zeros_like(amp))
    return torch.complex(x.real * gain, x.imag * gain)


def add_ff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def squelch_and_smeter_cc(x: torch.Tensor, squelch_level,
                          use_every_nth: int = 1):
    """Power gate and S-meter (reference csdr.c:2192-2243): the chunk's
    (strided) power, and the chunk zeroed where that power is under the
    level (a level of 0 never closes).  Returns (y, power), both on x's
    device: the CLI reads the power for its S-meter FIFO."""
    power = get_power_c(x, use_every_nth)
    level = torch.as_tensor(squelch_level, dtype=torch.float32,
                            device=x.device)
    open_ = (level == 0.0) | (power >= level)
    return torch.where(open_, x, torch.zeros_like(x)), power


class SquelchBlock(Block):
    """Squelch with its level in the state (a float32 0-dim tensor on the
    stream's device, 0 = open), so a FIFO retune replaces the state
    between chunks (reference csdr.c:2210-2222).  As csdr_tpu's block it
    measures every sample whatever ``use_every_nth`` says."""

    def __init__(self, use_every_nth: int = 1):
        super().__init__("squelch_and_smeter_cc")
        self.use_every_nth = use_every_nth

    def init(self, device="cuda"):
        return torch.zeros((), dtype=torch.float32,
                           device=resolve_device(device))

    def forward(self, level, x):
        y, _power = squelch_and_smeter_cc(x, level)
        return level, y


def squelch_block(use_every_nth: int = 1) -> Block:
    return SquelchBlock(use_every_nth)
