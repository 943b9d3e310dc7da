"""complex64 helpers.  Streams are ``torch.complex64`` tensors; the planar
float pair of the JAX package (csdr_tpu.core.cplx.CF) exists there only
because its TPU backend had no complex type, and is not carried over.
Kernels see a complex stream as interleaved float pairs through
``torch.view_as_real``."""

from __future__ import annotations

import numpy as np
import torch


def expj(theta: torch.Tensor) -> torch.Tensor:
    """e^{j theta} as complex64 (the reference's e_powj, libcsdr.h:56).

    ``torch.polar``, not ``torch.cos`` and ``torch.sin``: on the CPU those
    two run float32 through MKL's vector math, which in a fresh process
    can give one worker thread's share of a large tensor (>= 32768
    elements, split over threads) with errors near 2^-13 on its first
    call: in a few to a third of fresh processes after a complex matmul,
    on Intel CPUs with AVX-512 (tools/cpu_trig_probe.py).  ``polar``
    computes each element on its own and gives the same values on every
    call."""
    return torch.polar(torch.ones_like(theta), theta)


def from_numpy(x: np.ndarray, device="cuda") -> torch.Tensor:
    """Host array -> tensor on ``device``: complex input becomes complex64,
    floating input float32; integer input (u8 I/Q bytes, s16 audio) keeps
    its type, as csdr_tpu's stream runner passes it."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        dtype = np.complex64
    elif np.issubdtype(x.dtype, np.integer):
        dtype = x.dtype
    else:
        dtype = np.float32
    return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()
