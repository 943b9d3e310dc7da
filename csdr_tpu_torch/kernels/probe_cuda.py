"""The FP32 ceiling's probe kernel (``csrc/roofline_probe.cu``): each
float32 element runs ``chain`` links of ``y <- fma(y, a, b)``.

It replaces no Pallas kernel: it is the fused program that XLA makes of
the elementwise chain in csdr_tpu's ``measure_vpu_flops``
(csdr_tpu/utils/roofline.py:89-93), which eager torch would run as
2*chain memory-bound launches.  ``utils/roofline.measure_fp32_flops``
times it; the source note says what bounds it and why its default chain
is 2048, not csdr_tpu's 64.

:func:`fma_chain` launches the kernel for a CUDA tensor, or raises; it
takes :func:`fma_chain_plain` (the same chain through
``core/precision.fma_f32``, one rounding a link, so the two agree bit for
bit) only for a CPU tensor.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core.precision import fma_f32
from csdr_tpu_torch.kernels import _build

LAUNCHES = {"fma_chain": 0}
# csdr_tpu's link constants (roofline.py:92): y * 1.0000001 + 1e-7
A, B = np.float32(1.0000001), np.float32(1e-7)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x: torch.Tensor, chain: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"fma_chain: want a 1-D float32 tensor, got "
                        f"{x.dim()}-D {x.dtype}")
    if chain < 0:
        raise ValueError(f"fma_chain: chain={chain} < 0")


def fma_chain(x: torch.Tensor, chain: int, a=A, b=B) -> torch.Tensor:
    """``chain`` links of fma(y, a, b) from y = x, each rounded once to
    float32.  A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`fma_chain_plain`."""
    _check(x, chain)
    if not x.is_cuda:
        return fma_chain_plain(x, chain, a, b)
    x = x.contiguous()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(_build.lib().csdr_fma_chain(
        x.data_ptr(), y.data_ptr(), x.numel(), chain, float(np.float32(a)),
        float(np.float32(b)), stream), "fma_chain")
    LAUNCHES["fma_chain"] += 1
    return y


def fma_chain_plain(x: torch.Tensor, chain: int, a=A, b=B) -> torch.Tensor:
    """The plain version: the same links through ``fma_f32`` (float64 with
    the sum rounded to odd, then to float32: a correctly rounded fma), on
    ``x``'s device."""
    _check(x, chain)
    a = float(np.float32(a))
    bt = torch.full_like(x, float(np.float32(b)))
    y = x
    for _ in range(chain):
        y = fma_f32(a, y, bt)
    return y
