"""Batched power-of-two FFT in kernel bin order (counterpart of
csdr_tpu.kernels.fft_pallas).

Replaces the TPU kernels ``_fft_fwd_kernel`` and ``_fft_inv_kernel`` (K3,
csdr_tpu/kernels/fft_pallas.py), one ``pallas_call`` there; here both are
instantiations of one CUDA template, ``csrc/fft_ko.cu``, and so is
``fft_natural`` (that ``pallas_call`` and ``ko_to_natural``'s relayout
there): the forward storing natural bin order through shared memory, one
launch.

The contract is the TPU kernels' own, so that their consumers port
unchanged: the forward DFT of (..., N) complex64 frames (unnormalized,
FFTW sign) comes out in *kernel bin order*, where position ``128*j + u``
holds bin ``(N/128)*u + bitrev(j)``; ``natural[..., k] ==
ko[..., kernel_perm(N)[k]]``.  The inverse takes kernel order and returns
natural order, unnormalized.  fastddc folds the order into its class
matrices and fftfilt into its taps spectrum, so nothing reorders at run
time.  N is a power of two in 128..16384, any batch.

What bounds it on an H100: 16 B of device memory per point against
~5*log2(N) FP32 operations, so device-memory bytes at N=256..1024.  The
kernel reads and writes each point once and runs a mixed-radix plan
(:func:`radix_plan`) in registers, one shared-memory exchange between
passes, with the twiddles of :func:`twiddles` from a table this module
keeps on the card per (N, device) (see the source note).

The wrappers launch the kernel for CUDA tensors, or raise; they take the
plain version (``*_plain``: ``torch.fft`` plus the order permutation;
``torch.fft.fft`` for ``fft_natural``) only for CPU tensors.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from csdr_tpu_torch.kernels import _build

LANE = 128
MAX_N = 16384

LAUNCHES = {"fft_ko": 0, "ifft_ko": 0, "fft_natural": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bitrev(i: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


def supported(n: int, b: int) -> bool:
    """Shapes the kernel takes: N a power of two in 128..16384, B > 0."""
    return LANE <= n <= MAX_N and not n & (n - 1) and b > 0


def kernel_perm(n: int) -> np.ndarray:
    """perm with natural[k] = kernelorder[perm[k]] (numpy int32); the same
    array as csdr_tpu's ``fft_pallas.kernel_perm``."""
    t = n // LANE
    bits = int(np.log2(t))
    perm = np.empty(n, np.int32)
    for j in range(t):
        r = _bitrev(j, bits)
        for u in range(LANE):
            perm[t * u + r] = LANE * j + u
    return perm


def gather_idx(n: int) -> np.ndarray:
    """Index array g with x_ko = x_nat[g]: the inverse of kernel_perm."""
    perm = kernel_perm(n)
    inv = np.empty(n, np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)
    return inv


@functools.lru_cache(maxsize=None)
def _index(n: int, which: str, device: str) -> torch.Tensor:
    idx = kernel_perm(n) if which == "perm" else gather_idx(n)
    return torch.from_numpy(idx.astype(np.int64)).to(device)


def radix_plan(n: int) -> list[int]:
    """The kernel's passes for an N-point frame, first pass first: every
    radix at most 16 and the last 16, the remaining bits shared out with
    the odd ones first (1024 -> [8, 8, 16], 256 -> [16, 16]).  The launch
    checks that the CUDA source plans the same."""
    if not supported(n, 1):
        raise ValueError(f"fft_ko: N={n} is not a power of two in "
                         f"{LANE}..{MAX_N}")
    logn = n.bit_length() - 1
    passes = (logn + 3) // 4
    rest, k = logn - 4, passes - 1
    return [1 << (rest // k + (i < rest % k)) for i in range(k)] + [16]


def twiddles(n: int) -> np.ndarray:
    """The kernel's twiddle table (complex64, computed in float64): pass by
    pass, for every pass of :func:`radix_plan` but the last, the R-1 rows
    j = 1..R-1 of S entries W_N^(j * low * W), low < S, where S is the
    product of the radices after the pass and W of those before it.  The
    inverse conjugates it."""
    plan = radix_plan(n)
    parts = []
    for i, r in enumerate(plan[:-1]):
        w = int(np.prod(plan[:i], dtype=np.int64))
        s = n // (w * r)
        e = np.arange(1, r)[:, None] * np.arange(s)[None, :] * w % n
        parts.append(np.exp(-2j * np.pi * e.ravel() / n))
    return np.concatenate(parts).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _twiddle_table(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(twiddles(n)).to(device)


@functools.lru_cache(maxsize=None)
def _check_plan(n: int) -> None:
    lib = _build.lib()
    plan = radix_plan(n)
    built = [1 << lib.csdr_fft_ko_pass_bits(n, i)
             for i in range(len(plan))]
    if built != plan or lib.csdr_fft_ko_pass_bits(n, len(plan)) != 0:
        raise RuntimeError(f"fft_ko: the kernel's plan for N={n} differs "
                           f"from radix_plan: {built} against {plan}")


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.complex64 or x.dim() < 1:
        raise TypeError(f"want a complex64 tensor of frames, got "
                        f"{x.dim()}-D {x.dtype}")
    n = x.shape[-1]
    if not supported(n, max(1, x.numel() // max(n, 1))):
        raise ValueError(f"fft_ko: N={n} is not a power of two in "
                         f"{LANE}..{MAX_N}")


def _launch(name: str, x: torch.Tensor) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError(f"{name}: frames must be contiguous")
    n = x.shape[-1]
    _check_plan(n)
    tw = _twiddle_table(n, str(x.device))
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = getattr(_build.lib(), "csdr_" + name)(
        x.data_ptr(), y.data_ptr(), tw.data_ptr(), n, x.numel() // n,
        stream)
    _build.check(code, name)
    LAUNCHES[name] += 1
    return y


def fft_ko(x: torch.Tensor) -> torch.Tensor:
    """Forward DFT over the last axis, output in kernel bin order.  CUDA
    tensors launch the kernel; CPU tensors take :func:`fft_ko_plain`."""
    _check(x)
    if not x.is_cuda:
        return fft_ko_plain(x)
    return _launch("fft_ko", x)


def ko_to_natural(x: torch.Tensor) -> torch.Tensor:
    """Kernel-bin-order spectra -> natural order (counterpart of
    ``fft_pallas.ko_to_natural``): one gather by :func:`kernel_perm` over
    the last axis, on either device.  csdr_tpu writes it as a tile shuffle
    and a transpose because a bulk gather is slow on its TPU; the values
    are the same."""
    return x[..., _index(x.shape[-1], "perm", str(x.device))]


def fft_natural(x: torch.Tensor) -> torch.Tensor:
    """Forward DFT over the last axis in natural bin order (counterpart of
    ``fft_pallas.fft_natural``, K3 then ``ko_to_natural``).  CUDA tensors
    launch the natural-order form of the kernel once, bit for bit
    ``ko_to_natural(fft_ko(x))``, and raise where it does not take N;
    CPU tensors take ``torch.fft.fft``."""
    _check(x)
    if not x.is_cuda:
        return torch.fft.fft(x)
    return _launch("fft_natural", x)


def ifft_ko(x: torch.Tensor) -> torch.Tensor:
    """Inverse DFT (unnormalized) from kernel bin order to natural order.
    CUDA tensors launch the kernel; CPU tensors take :func:`ifft_ko_plain`."""
    _check(x)
    if not x.is_cuda:
        return ifft_ko_plain(x)
    return _launch("ifft_ko", x)


# ---------------------------------------------------------------------------
# plain versions: the same functions in torch ops
# ---------------------------------------------------------------------------

def fft_ko_plain(x: torch.Tensor) -> torch.Tensor:
    g = _index(x.shape[-1], "gather", str(x.device))
    return torch.fft.fft(x)[..., g]


def ifft_ko_plain(x: torch.Tensor) -> torch.Tensor:
    perm = _index(x.shape[-1], "perm", str(x.device))
    return torch.fft.ifft(x[..., perm], norm="forward")   # unnormalized
