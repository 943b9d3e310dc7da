"""Gain, limiting and DC blocking (counterpart of csdr_tpu.ops.util_ops);
so far the ops the SSB, NFM and AM receivers need."""

from __future__ import annotations

import torch

from csdr_tpu_torch.core.block import Block, resolve_device
from csdr_tpu_torch.ops.demod import _affine_scan


def gain_ff(x: torch.Tensor, gain) -> torch.Tensor:
    """reference libcsdr.c:1139-1142"""
    return (x * gain).to(x.dtype)


def limit_ff(x: torch.Tensor, max_amplitude: float = 1.0) -> torch.Tensor:
    """Clamp to [-max, max] (reference libcsdr.c:1130-1137)."""
    return torch.clamp(x, -max_amplitude, max_amplitude)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def dcblock_ff(x: torch.Tensor, a: float = 0.999, last_input=0.0,
               last_output=0.0):
    """DC-blocking IIR y[i] = x[i] - x[i-1] + a*y[i-1]
    (reference libcsdr.c:903-918), as an affine scan.
    Returns (y, (next_last_input, next_last_output))."""
    x = x.float()
    prev = torch.cat([_scalar(last_input, x).reshape(1), x[:-1]])
    y = _affine_scan(torch.full_like(x, a), x - prev,
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
