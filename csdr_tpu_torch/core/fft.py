"""Complex FFT helpers (counterpart of csdr_tpu.core.fft).

csdr_tpu writes its FFT as a Stockham radix-2 network in plain XLA ops,
because its TPU backend has neither a complex type nor an FFT op; it is no
Pallas kernel, so its counterpart here is plain ``torch.fft``.  The
hand-written transform of this port is the kernel-order matmul-FFT's
counterpart, ``kernels/fft_cuda.py``.  Sizes are powers of two, as every
size the reference plans is (csdr.c:1833-1837, fastddc.c:52).
"""

from __future__ import annotations

import torch


def fft(x: torch.Tensor) -> torch.Tensor:
    """Forward DFT over the last axis (unnormalized, FFTW sign convention)."""
    return torch.fft.fft(x)


def ifft(x: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """Inverse DFT, unnormalized by default like FFTW backward (the
    reference divides by the size itself, libcsdr.c:833-837)."""
    # norm="forward" puts the 1/n on the forward transform: ifft unscaled
    return torch.fft.ifft(x, norm="backward" if normalize else "forward")


def rfft(x: torch.Tensor) -> torch.Tensor:
    """Real-input forward DFT with the full-size output, as csdr_tpu's
    (the reference's r2c keeps n/2+1 bins; callers slice)."""
    return torch.fft.fft(x.to(torch.float32))


def fft_swap_sides(x: torch.Tensor) -> torch.Tensor:
    """fftshift over the last axis (reference fastddc.c:91-104)."""
    return torch.roll(x, x.shape[-1] // 2, dims=-1)


def next_pow2(x: int) -> int:
    """Smallest power of two strictly greater than x (reference
    libcsdr.c:1240-1249 returns 1<<i for the first 1<<i > x)."""
    p = 1
    while p <= x:
        p *= 2
    return p


def log2n(x: int) -> int:
    """Exact log2, or -1 for a non-power of two or x <= 0 (reference
    libcsdr.c:1220-1228)."""
    if x <= 0:
        return -1
    n = x.bit_length() - 1
    return n if (1 << n) == x else -1
