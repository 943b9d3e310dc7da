"""Utility ops (counterpart of csdr_tpu.ops.util_ops); so far the one the
SSB receiver needs."""

from __future__ import annotations

import torch


def limit_ff(x: torch.Tensor, max_amplitude: float = 1.0) -> torch.Tensor:
    """Clamp to [-max, max] (reference libcsdr.c:1130-1137)."""
    return torch.clamp(x, -max_amplitude, max_amplitude)
