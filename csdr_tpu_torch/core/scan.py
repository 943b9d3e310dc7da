"""The affine prefix scan the port's IIRs and the AGC share: y <- b*y + a
along the last axis as a log-depth (Hillis-Steele) scan of vector ops.
Its tree of roundings is part of the contract: csdr_tpu's scans and the
AGC kernel (csrc/agc.cu) take the same one, element by element.
"""

from __future__ import annotations

import torch


def affine_prefix(b: torch.Tensor, a: torch.Tensor):
    """Inclusive prefix of the affine maps y <- b*y + a along the last
    axis: a log-depth (Hillis-Steele) scan over the (mul, add) pairs, each
    step one pass of vector ops.  Returns (B, A), the composed maps, so
    the output for an entry carry y0 is B*y0 + A."""
    b, a = b.clone(), a.clone()
    off, n = 1, a.shape[-1]
    while off < n:
        a[..., off:] = a[..., off:] + b[..., off:] * a[..., :-off]
        b[..., off:] = b[..., off:] * b[..., :-off]
        off *= 2
    return b, a


def affine_scan(b: torch.Tensor, a: torch.Tensor, y0) -> torch.Tensor:
    """Prefix of y <- b*y + a from y0 along the last axis (y0 folded into
    the first pair, then :func:`affine_prefix`).  Leading axes are
    independent scans, with ``y0`` their entry values (a scalar, or one
    per scan)."""
    a = a.clone()
    a[..., 0] = a[..., 0] + b[..., 0] * y0
    return affine_prefix(b, a)[1]
