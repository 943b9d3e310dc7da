"""Float32 arithmetic as csdr_tpu does it: full float32 for matrix
products outside the port's kernels, and XLA's fused multiply-add.

PyTorch may run float32 (and complex64) ``torch.matmul`` on the tensor
cores in TF32, which keeps about three decimal digits, when
``torch.backends.cuda.matmul.allow_tf32`` is True (or, what sets the same
flag, the float32 matmul precision is below "highest").  The port's card
output is held to its CPU output at 100 dB per channel, which TF32 cannot
meet, so its products run inside :func:`full_f32_matmul` whatever the
caller set.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def full_f32_matmul():
    """Run the enclosed ``torch.matmul``s in full float32, with cuBLAS's
    TF32 flag off (PyTorch's default), and restore the caller's flag on
    exit.  Only that flag is read and set: PyTorch raises on reading the
    backend-less float32 matmul precision once legacy and newer precision
    settings have been mixed."""
    cuda = torch.backends.cuda.matmul
    prev = cuda.allow_tf32
    if not prev:
        yield
        return
    cuda.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32 = prev


def fma_f32(x, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x*y + z rounded once to float32, as the fused multiply-add that
    XLA's CPU backend contracts ``a*b + c`` into inside a compiled
    function (eager JAX rounds the product first).  ``x`` may be a float32
    tensor or a Python number that float32 holds exactly.  The product is
    exact in float64; the sum is rounded to odd there (an inexact sum with
    an even last bit moves one ulp towards the exact value, whose error
    TwoSum gives), and rounding that to float32 is the correctly rounded
    fma (Boldo and Melquiond, "Emulation of FMA and correctly rounded
    sums: proved algorithms using rounding to odd", 2008).  Separate
    torch ops in float64: the same bits on the CPU and on the card."""
    x = x.double() if isinstance(x, torch.Tensor) else float(x)
    p = y.double() * x
    z = z.double()
    s = p + z
    bb = s - p
    e = (p - (s - bb)) + (z - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((e != 0) & even, torch.nextafter(s, e * np.inf), s)
    return s.float()
