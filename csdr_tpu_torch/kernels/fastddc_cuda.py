"""fastddc factored-v2 inverse kernel (counterpart of
csdr_tpu.kernels.fastddc_pallas).

Replaces the TPU kernel ``_inv_kernel`` (K4,
csdr_tpu/kernels/fastddc_pallas.py) with ``csrc/fastddc_inv.cu``.  For raw
spectra S (B, pre*inv), per-channel folded taps TQ (C, pre, inv), the
shared iDFT-and-select matrix W (inv, M), the output diagonal d (C, M) and
the per-frame NCO rot (C, B), all complex64, it computes

    Z[c,b,m]   = sum_{j<pre} S[b, j*inv + m] * TQ[c,j,m]       (fold)
    out[c,b,o] = ((Z[c,b,:] @ W)[o] * d[c,o]) * rot[c,b]        o < m_out

which is the whole per-channel inverse of fastddc.c:106-166 after the
forward FFT (ops/fastddc.channel_factored2_arrays has the algebra).
csdr_tpu's W packing (128-lane padding, the bf16 [hi; lo] stack of
``pack_w``) is a TPU layout and has no counterpart: W is (inv, M) complex.

What bounds it on an H100: FP32 operations outside the tensor cores
(~4.3 GFLOP against ~38 MB at the 64-channel D=16 plan); Z stays in shared
memory, one chunk of inverse bins at a time.  Shared memory is fixed
(33 KB) whatever the plan, so every plan shape and chunk length runs
through the kernel: there is no plan dispatch.

The wrapper launches the kernel for CUDA tensors, or raises; it takes the
plain version (:func:`fastddc_inv_plain`) only for CPU tensors.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from csdr_tpu_torch.core.precision import full_f32_matmul
from csdr_tpu_torch.kernels import _build

# tiles of csrc/fastddc_inv.cu: channels, frames, bins per chunk, columns;
# its static shared memory (33 KB) does not depend on the plan, so no plan
# can exceed the 48 KB a block gets without opting in
CB, BT, KC, OT = 8, 8, 32, 64
SMEM_BYTES = 8 * (CB * BT * (KC + 1) + KC * OT)

LAUNCHES = {"fastddc_inv": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(spectra, tq, w, d, rot, m_out):
    for name, t in (("spectra", spectra), ("tq", tq), ("w", w), ("d", d),
                    ("rot", rot)):
        if t.dtype != torch.complex64:
            raise TypeError(f"{name}: want complex64, got {t.dtype}")
        if t.device != spectra.device:
            raise ValueError(f"{name} on {t.device}, spectra on "
                             f"{spectra.device}")
    if tq.dim() != 3 or spectra.dim() != 2 or w.dim() != 2 or \
            d.dim() != 2 or rot.dim() != 2:
        raise ValueError("want spectra (B, pre*inv), tq (C, pre, inv), "
                         "w (inv, M), d (C, M), rot (C, B)")
    c, pre, inv = tq.shape
    b = spectra.shape[0]
    if spectra.shape[1] != pre * inv or w.shape[0] != inv or \
            d.shape[0] != c or tuple(rot.shape) != (c, b):
        raise ValueError(
            f"shapes: spectra {tuple(spectra.shape)}, tq {tuple(tq.shape)}, "
            f"w {tuple(w.shape)}, d {tuple(d.shape)}, rot {tuple(rot.shape)}")
    if not 1 <= m_out <= min(w.shape[1], d.shape[1]):
        raise ValueError(f"m_out={m_out} outside 1..{min(w.shape[1], d.shape[1])}")


def fastddc_inv(spectra: torch.Tensor, tq: torch.Tensor, w: torch.Tensor,
                d: torch.Tensor, rot: torch.Tensor,
                m_out: int) -> torch.Tensor:
    """K4: the factored-v2 inverse with the per-frame NCO, (C, B, m_out)
    complex64.  CUDA tensors launch the kernel; CPU tensors take
    :func:`fastddc_inv_plain`."""
    _check(spectra, tq, w, d, rot, m_out)
    if not spectra.is_cuda:
        return fastddc_inv_plain(spectra, tq, w, d, rot, m_out)
    for name, t in (("spectra", spectra), ("tq", tq), ("w", w), ("d", d),
                    ("rot", rot)):
        if not t.is_contiguous():
            raise ValueError(f"fastddc_inv: {name} must be contiguous")
    c, pre, inv = tq.shape
    b = spectra.shape[0]
    out = torch.empty((c, b, m_out), dtype=torch.complex64,
                      device=spectra.device)
    stream = torch.cuda.current_stream(spectra.device).cuda_stream
    code = _build.lib().csdr_fastddc_inv(
        spectra.data_ptr(), tq.data_ptr(), w.data_ptr(), d.data_ptr(),
        rot.data_ptr(), out.data_ptr(), b, c, pre, inv, w.shape[1],
        d.shape[1], m_out, stream)
    _build.check(code, "fastddc_inv")
    LAUNCHES["fastddc_inv"] += 1
    return out


# ---------------------------------------------------------------------------
# plain versions: the same functions in torch ops
# ---------------------------------------------------------------------------

def factored2_batch(spectra: torch.Tensor, tq: torch.Tensor,
                    w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The factored-v2 inverse before the per-frame NCO: fold, ONE shared
    iDFT product for all channels, output diagonal.  spectra (B, fft);
    tq (C, pre, inv); w (inv, M); d (C, M).  Returns (C, B, M)."""
    b = spectra.shape[0]
    c, pre, inv = tq.shape
    with full_f32_matmul():
        z = torch.einsum("bjm,cjm->cbm", spectra.reshape(b, pre, inv), tq)
        y = torch.matmul(z.reshape(c * b, inv), w).reshape(c, b, -1)
    return y * d[:, None, :]


def fastddc_inv_plain(spectra, tq, w, d, rot, m_out: int) -> torch.Tensor:
    y = factored2_batch(spectra, tq, w[:, :m_out], d[:, :m_out])
    return y * rot[:, :, None]
