"""Full float32 for matrix products outside the port's kernels.

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
