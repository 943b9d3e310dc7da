"""Roofline accounting: the card's measured ceilings, its published peaks,
and a kernel's share of them (csdr_tpu's ``utils/roofline.py``).

The ceilings are MEASURED on the attached card with the same
:func:`~csdr_tpu_torch.utils.timing.time_kernel` discipline as every
other number, as csdr_tpu measures its chip's:

- device memory: a sum-reduction over ``n_mb`` MB of float32, far past
  the 50 MB L2 (a pure read stream: the bytes must cross the memory);
- matrix products: a square (m, m) product at each precision;
- FP32 outside the tensor cores: the fused fma chain of
  ``kernels/probe_cuda`` (``csrc/roofline_probe.cu``).

Precision names on Hopper (csdr_tpu's ``jax.lax.Precision`` names):

- ``HIGHEST``: float32 operands, TF32 off (cuBLAS SGEMM on the CUDA cores);
- ``DEFAULT``: one TF32 pass on the tensor cores;
- ``HIGH``: the port's 3-pass contract, 3xTF32 as K4 runs it.  No single
  call computes it, so its ceiling is DEFAULT's divided by 3, marked as
  derived (``matmul_high_derived``);
- ``BF16``: bf16 operands, float32 sums (reduced-precision reductions off).

TF32 is switched on only inside a context that restores the caller's flag.

The key map from csdr_tpu (every other key, and all of the arithmetic of
:func:`account`, are csdr_tpu's):

=========================  =========================
csdr_tpu                   csdr_tpu_torch
=========================  =========================
``mxu_<p>_Tflops``         ``matmul_<p>_Tflops``
``vpu_Tflops``             ``fp32_Tflops``
``measure_mxu_flops``      ``measure_matmul_flops``
``measure_vpu_flops``      ``measure_fp32_flops``
``account(vpu_flops=)``    ``account(fp32_flops=)``
``bound_by`` "mxu"/"vpu"   "matmul"/"fp32" ("hbm" stays)
``mxu_busy_pct``           ``matmul_busy_pct``
``vpu_busy_pct``           ``fp32_busy_pct``
=========================  =========================

``PUBLISHED`` holds data-sheet peaks by ``torch.cuda.get_device_name``;
a share is stated against them with the card's power limit beside it,
and the measured ceilings beside that.  Every ``measure_*`` raises on a
machine without CUDA.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from csdr_tpu_torch.utils.timing import time_kernel

PRECISIONS = ("HIGHEST", "DEFAULT", "HIGH", "BF16")

# NVIDIA's H100 SXM data sheet, dense rates without sparsity, at 700 W
PUBLISHED = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bw_GBps": 3350.0,
        "fp32_Tflops": 67.0,
        "tf32_Tflops": 495.0,
        "bf16_Tflops": 989.0,
        "power_W": 700.0,
    },
}


def published_peaks(name: str) -> dict:
    """The data-sheet peaks of card ``name`` in :func:`device_peaks`'s
    keys: HIGHEST at the FP32 rate, DEFAULT at TF32's, HIGH at TF32's
    over 3 (derived), BF16 at bf16's.  Raises for a card not in
    ``PUBLISHED``."""
    if name not in PUBLISHED:
        raise KeyError(f"no published peaks for {name!r} (known: "
                       f"{sorted(PUBLISHED)})")
    p = PUBLISHED[name]
    return {"device": name, "hbm_bw_GBps": p["hbm_bw_GBps"],
            "matmul_highest_Tflops": p["fp32_Tflops"],
            "matmul_default_Tflops": p["tf32_Tflops"],
            "matmul_high_Tflops": p["tf32_Tflops"] / 3,
            "matmul_high_derived": True,
            "matmul_bf16_Tflops": p["bf16_Tflops"],
            "fp32_Tflops": p["fp32_Tflops"], "power_W": p["power_W"]}


def _require_cuda(what: str) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures the card and needs CUDA")
    return torch.device("cuda")


def _dev_noise(shape, dtype=torch.float32, seed=0) -> torch.Tensor:
    """Pseudo-random data made on the card."""
    dev = _require_cuda("roofline")
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, dtype=torch.float32, device=dev,
                       generator=gen).to(dtype)


@contextlib.contextmanager
def matmul_precision(precision_name: str):
    """cuBLAS's flags for ``precision_name`` inside the context, the
    caller's restored on exit: TF32 on for DEFAULT and HIGH (whose
    ceiling is DEFAULT's), off for HIGHEST; for BF16, reduced-precision
    reductions off, so the sums stay float32."""
    if precision_name not in PRECISIONS:
        raise ValueError(f"precision {precision_name!r}: one of "
                         f"{PRECISIONS}")
    cuda = torch.backends.cuda.matmul
    prev = cuda.allow_tf32, cuda.allow_bf16_reduced_precision_reduction
    cuda.allow_tf32 = precision_name in ("DEFAULT", "HIGH")
    cuda.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        cuda.allow_tf32, cuda.allow_bf16_reduced_precision_reduction = prev


@functools.lru_cache(maxsize=None)
def measure_hbm_bw(n_mb: int = 256) -> float:
    """Streaming READ bandwidth in bytes/s: a sum-reduction over n_mb MB of
    float32 (traffic = n_mb MB).  A triad is not used, as in csdr_tpu:
    the timing loop reduces the output, which a fused triad would skip."""
    _require_cuda("measure_hbm_bw")
    n = n_mb * (1 << 20) // 4
    x = _dev_noise((n,))
    per = time_kernel(lambda x: x.sum(), x, k_pair=(32, 512))
    return 1.0 * n * 4 / per


@functools.lru_cache(maxsize=None)
def measure_matmul_flops(precision_name: str = "HIGHEST",
                         m: int = 4096) -> float:
    """Matmul flops/s (2*m^3 a call) at ``precision_name`` (module
    docstring); HIGH is DEFAULT's rate over 3 (derived, not timed)."""
    _require_cuda("measure_matmul_flops")
    if precision_name == "HIGH":
        return measure_matmul_flops("DEFAULT", m) / 3
    dtype = torch.bfloat16 if precision_name == "BF16" else torch.float32
    a = _dev_noise((m, m), dtype, 1)
    b = _dev_noise((m, m), dtype, 2)
    with matmul_precision(precision_name):
        per = time_kernel(lambda a: torch.matmul(a, b), a, k_pair=(16, 128))
    return 2.0 * m * m * m / per


@functools.lru_cache(maxsize=None)
def measure_fp32_flops(n: int = 1 << 22, chain: int = 2048) -> float:
    """FP32 flops/s outside the tensor cores: the probe kernel's fma chain
    (2*chain flops an element, x read and y written once).  csdr_tpu's
    default chain of 64 would be memory-bound on this card (16 flops a
    byte against its ~20), hence 2048."""
    from csdr_tpu_torch.kernels import probe_cuda

    _require_cuda("measure_fp32_flops")
    x = _dev_noise((n,))
    per = time_kernel(lambda x: probe_cuda.fma_chain(x, chain), x,
                      k_pair=(16, 128))
    return 2.0 * chain * n / per


def device_peaks(precisions=("HIGHEST", "HIGH", "BF16")) -> dict:
    """Measured ceilings of the attached card (cached per process), in
    :func:`published_peaks`'s keys."""
    dev = _require_cuda("device_peaks")
    peaks = {"device": torch.cuda.get_device_name(dev),
             "hbm_bw_GBps": measure_hbm_bw() / 1e9}
    for p in precisions:
        peaks[f"matmul_{p.lower()}_Tflops"] = measure_matmul_flops(p) / 1e12
        if p == "HIGH":
            peaks["matmul_high_derived"] = True
    peaks["fp32_Tflops"] = measure_fp32_flops() / 1e12
    return peaks


def account(name: str, seconds: float, bytes_moved: float, flops: float,
            peaks: dict, precision_name: str = "HIGHEST",
            ideal_flops: float | None = None,
            fp32_flops: float | None = None) -> dict:
    """Roofline account for one kernel invocation (csdr_tpu's arithmetic).

    bytes_moved: the device-memory traffic the kernel MUST move (inputs
    read once, outputs written once).  flops: the matrix-product flops
    the implementation executes, against the ``matmul_<precision>``
    ceiling; ideal_flops: the algorithmic minimum, when the formulation
    does extra MACs.  fp32_flops: work outside the tensor cores (FIRs,
    FFT butterflies, K4's fold), against ``fp32_Tflops``.  A kernel with
    no matrix product passes flops=0.  pct_of_roofline is the least time
    (the largest of bytes, matmul and FP32 times) over ``seconds``;
    ``bound_by`` names the resource that sets it."""
    if ideal_flops is None:
        ideal_flops = flops
    bw = peaks["hbm_bw_GBps"] * 1e9
    mm = peaks[f"matmul_{precision_name.lower()}_Tflops"] * 1e12
    t_mem = bytes_moved / bw
    t_mm = ideal_flops / mm
    bound = "matmul" if t_mm > t_mem else "hbm"
    t_light = max(t_mem, t_mm)
    t_fp32 = None
    if fp32_flops:
        fp32 = peaks.get("fp32_Tflops", 0.0) * 1e12
        if fp32 > 0:
            t_fp32 = fp32_flops / fp32
            if t_fp32 > t_light:
                bound, t_light = "fp32", t_fp32
    rec = {
        "kernel": name,
        "achieved_GBps": round(bytes_moved / seconds / 1e9, 1),
        "achieved_Tflops": round(flops / seconds / 1e12, 2),
        "ideal_Tflops": round(ideal_flops / seconds / 1e12, 2),
        "mac_overhead_x": round(flops / max(ideal_flops, 1.0), 2),
        "bound_by": bound,
        "pct_of_roofline": round(100.0 * t_light / seconds, 1),
        "matmul_busy_pct": round(100.0 * (flops / mm) / seconds, 1),
        "hbm_busy_pct": round(100.0 * t_mem / seconds, 1),
        "precision": precision_name,
    }
    if t_fp32 is not None:
        rec["fp32_busy_pct"] = round(100.0 * t_fp32 / seconds, 1)
    return rec


def least_seconds(bytes_moved: float, peaks: dict, flops: float = 0.0,
                  precision_name: str = "HIGHEST",
                  fp32_flops: float = 0.0) -> tuple[float, str]:
    """The least time :func:`account` charges (unrounded), and its
    ``bound_by``."""
    bw = peaks["hbm_bw_GBps"] * 1e9
    times = {"hbm": bytes_moved / bw}
    if flops:
        times["matmul"] = flops / (
            peaks[f"matmul_{precision_name.lower()}_Tflops"] * 1e12)
    if fp32_flops:
        times["fp32"] = fp32_flops / (peaks["fp32_Tflops"] * 1e12)
    bound = max(times, key=times.get)
    return times[bound], bound
