"""Decimating FIR kernels, plain and NCO-fused (counterpart of
csdr_tpu.kernels.fir_pallas).

Replaces the TPU kernels ``_fir_vmem_shift_kernel`` (K1, the NCO shift
fused into the FIR, csdr_tpu/kernels/fir_pallas.py) and ``_fir_vmem_kernel``
(K2, the same FIR without the mix), which share ``_vmem_core`` there.  Here
both are instantiations of one CUDA template, ``csrc/fir_decimate.cu``.

Both compute, over the virtual stream ``v = [tail | x]``:

    y[k] = sum_{t<T} m(s) * v[s] * taps[t],   s = k*D + t,   k < kout

with ``m(s) = exp(j*2*pi*(theta + rate*s))`` for the shifted form, else 1.
The kernel reads ``tail`` and ``x`` through two pointers, so a streaming
block hands it its carried tail and the new chunk as they are: no
concatenation pass over the chunk, and one launch per chunk.

What bounds it on an H100: at the WFM front end (D=10, T=79) it moves
~8 B per input sample and does ~2T/D FMA per sample, so it is bound by
device-memory bytes; the design reads each input sample about once and
mixes it once in shared memory.  At long taps (D=10, T=1023) it is bound by
FP32 FMA and the shared-memory reads that feed them (see the source note).

The wrappers launch the kernel for CUDA tensors, or raise; they take the
plain version (``*_plain``, the same function in torch ops) only for CPU
tensors.  ``LAUNCHES`` counts kernel launches per instantiation.
"""

from __future__ import annotations

import torch

from csdr_tpu_torch.kernels import _build

TILE = 256                 # outputs per block: kTile in csrc/fir_decimate.cu
MAX_SMEM = 232448          # bytes of shared memory a block may opt into

LAUNCHES = {"shift_fir_decimate": 0, "fir_decimate": 0}

PRECISIONS = ("HIGHEST", "HIGH")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def smem_bytes(taps_len: int, decimation: int) -> int:
    """Shared memory one block stages: the taps plus its input window."""
    return (4 * ((taps_len + 1) & ~1)
            + 8 * ((TILE - 1) * decimation + taps_len))


def _check(tail, x, taps, decimation, kout, precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    for name, t, dt in (("tail", tail, torch.complex64),
                        ("x", x, torch.complex64),
                        ("taps", taps, torch.float32)):
        if t.dtype != dt or t.dim() != 1:
            raise TypeError(f"{name}: want a 1-D {dt} tensor, got "
                            f"{t.dim()}-D {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    t_len, d = taps.shape[0], int(decimation)
    if t_len < 1 or d < 1 or kout < 0:
        raise ValueError(f"bad shape: T={t_len} D={d} kout={kout}")
    if kout and (kout - 1) * d + t_len > tail.shape[0] + x.shape[0]:
        raise ValueError(
            f"kout={kout} outputs need {(kout - 1) * d + t_len} samples; "
            f"[tail|x] has {tail.shape[0] + x.shape[0]}")
    if x.is_cuda and smem_bytes(t_len, d) > MAX_SMEM:
        raise ValueError(
            f"fir_decimate kernel: D={d} T={t_len} needs "
            f"{smem_bytes(t_len, d)} B of shared memory > {MAX_SMEM}")


def _launch(name: str, tail, x, taps, decimation, kout, *phase):
    if not (tail.is_contiguous() and x.is_contiguous()
            and taps.is_contiguous()):
        raise ValueError(f"{name}: tail, x and taps must be contiguous")
    lib = _build.lib()
    y = torch.empty(kout, dtype=torch.complex64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = getattr(lib, "csdr_" + name)
    code = fn(tail.data_ptr(), tail.shape[0], x.data_ptr(), x.shape[0],
              taps.data_ptr(), taps.shape[0], int(decimation), kout,
              y.data_ptr(), *phase, stream)
    _build.check(code, name)
    LAUNCHES[name] += 1
    return y


def fir_decimate(tail: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                 decimation: int, kout: int,
                 precision: str = "HIGHEST") -> torch.Tensor:
    """K2: ``kout`` decimated outputs of ``[tail | x]`` (complex64) through
    real ``taps`` (float32).  CUDA tensors launch the kernel; CPU tensors
    take :func:`fir_decimate_plain`."""
    _check(tail, x, taps, decimation, kout, precision)
    if not x.is_cuda:
        return fir_decimate_plain(tail, x, taps, decimation, kout)
    return _launch("fir_decimate", tail, x, taps, decimation, kout)


def shift_fir_decimate(tail: torch.Tensor, x: torch.Tensor,
                       taps: torch.Tensor, decimation: int, kout: int,
                       rate: float, theta: float,
                       precision: str = "HIGHEST") -> torch.Tensor:
    """K1: as :func:`fir_decimate`, with sample s of ``[tail | x]`` first
    mixed by ``exp(j*2*pi*(theta + rate*s))`` (rate and theta in cycles)."""
    _check(tail, x, taps, decimation, kout, precision)
    if not x.is_cuda:
        return shift_fir_decimate_plain(tail, x, taps, decimation, kout,
                                        rate, theta)
    return _launch("shift_fir_decimate", tail, x, taps, decimation, kout,
                   float(rate), float(theta))


# ---------------------------------------------------------------------------
# plain versions: the same functions in torch ops
# ---------------------------------------------------------------------------

def strided_corr(v: torch.Tensor, taps, decimation: int,
                 kout: int) -> torch.Tensor:
    """y[k] = sum_t v[k*D + t] * taps[t] for k < kout: one strided
    multiply-add per tap, exact f32 like the kernel.  ``taps`` is a
    sequence of Python floats."""
    d = int(decimation)
    y = torch.zeros(kout, dtype=v.dtype, device=v.device)
    span = (kout - 1) * d + 1
    for t, h in enumerate(taps):
        y.add_(v[t: t + span: d], alpha=h)
    return y


def nco_phasor(n: int, rate: float, theta: float, device) -> torch.Tensor:
    """exp(j*2*pi*(theta + frac(rate*s))) for s < n, the phase computed in
    float64 (no accumulation along the stream), rounded to complex64."""
    s = torch.arange(n, dtype=torch.float64, device=device)
    c = torch.remainder(torch.remainder(s * float(rate), 1.0)
                        + float(theta), 1.0)
    return torch.polar(torch.ones_like(c), 2.0 * torch.pi * c
                       ).to(torch.complex64)


def fir_decimate_plain(tail, x, taps, decimation, kout) -> torch.Tensor:
    v = torch.cat([tail, x])
    return strided_corr(v, taps.tolist(), decimation, kout)


def shift_fir_decimate_plain(tail, x, taps, decimation, kout, rate,
                             theta) -> torch.Tensor:
    v = torch.cat([tail, x])
    v = v * nco_phasor(v.shape[0], rate, theta, v.device)
    return strided_corr(v, taps.tolist(), decimation, kout)
