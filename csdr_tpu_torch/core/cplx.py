"""complex64 helpers.  Streams are ``torch.complex64`` tensors; the planar
float pair of the JAX package (csdr_tpu.core.cplx.CF) exists there only
because its TPU backend had no complex type, and is not carried over.
Kernels see a complex stream as interleaved float pairs through
``torch.view_as_real``."""

from __future__ import annotations

import numpy as np
import torch


def expj(theta: torch.Tensor) -> torch.Tensor:
    """e^{j theta} as complex64 (the reference's e_powj, libcsdr.h:56)."""
    return torch.complex(torch.cos(theta), torch.sin(theta))


def from_numpy(x: np.ndarray, device="cuda") -> torch.Tensor:
    """Host array -> tensor on ``device``: complex input becomes complex64,
    real input float32."""
    x = np.asarray(x)
    dtype = np.complex64 if np.iscomplexobj(x) else np.float32
    return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()
