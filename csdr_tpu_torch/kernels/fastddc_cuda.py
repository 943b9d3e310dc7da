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

What bounds it on an H100: at the 64-channel D=16 plan ~4.3 GFLOP against
~38 MB, 3.76 GFLOP of it the iDFT, a dense (C*B x inv) x (inv x M) complex
product.  The kernel runs that product on the tensor cores in 3xTF32
(``mma.sync`` m16n8k8; each f32 operand split as hi = rna_tf32(x),
lo = rna_tf32(x - hi), and hi*hi + hi*lo + lo*hi summed in f32), so its
bound is the FP32 fold plus 3x the iDFT at the TF32 rate (~31 us at D=16,
against 64 us all in FP32).  The fold stays exact FP32 FMA; at large
``pre`` (D=256: pre=128, inv=16) the warp lanes a short bin chunk leaves
free split the j sum, added by a shuffle.  Z stays in shared memory, one
chunk of inverse bins at a time; S rows, TQ rows and W chunks are staged
with cp.async, double-buffered.  The rounding is the kernel's own, so the
result does not depend on ``torch.backends.cuda.matmul.allow_tf32``.

:func:`plan_tiles` picks the tiles from the plan on the host: 128 rows of
Z a block (8 channels x 16 frames), the column tile M rounded up to a
multiple of 8 (up to 56 columns a block; wider plans take several column
blocks), the bin chunk ``min(inv, 32)`` and the fold stage length that
fits the opt-in shared memory twice, else once (up to 16 folds a stage).
A plan
whose tiles do not fit raises; there is no fallback.

The wrapper launches the kernel for CUDA tensors, or raises; it takes the
plain version (:func:`fastddc_inv_plain`) only for CPU tensors.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import functools

import torch

from csdr_tpu_torch.core.precision import full_f32_matmul
from csdr_tpu_torch.kernels import _build

# fixed tiles of csrc/fastddc_inv.cu: channels and frames a block (128
# rows of Z, one 16-row MMA tile for each of its 8 warps)
CB, BT = 8, 16
ROWS = CB * BT
NI_MENU = (1, 2, 4, 7)          # n-tiles of 8 columns the source instantiates
KC_MENU = (16, 32)               # bin chunks the source instantiates
MAX_SMEM = 232_448               # opt-in shared memory of one block, bytes
# two blocks an SM: the SM's 228 KB less the 1 KB the runtime keeps a block
HALF_SMEM = 233_472 // 2 - 1024


def smem_bytes(kc: int, mt: int, jc: int) -> int:
    """Dynamic shared memory of one block: two staging buffers (S rows,
    TQ rows, the raw W chunk) and the 3xTF32-split Z tile and W chunk
    (float4 per complex value, rows padded against bank conflicts)."""
    stage = 8 * (BT * jc * kc + CB * jc * kc + kc * mt)
    return 2 * stage + 16 * (ROWS * (kc + 4) + kc * (mt + 2))


@functools.lru_cache(maxsize=None)
def plan_tiles(pre: int, inv: int, m: int) -> dict:
    """The kernel's tiles for a plan (TQ's pre and inv, W's M columns):
    ``kc`` bins a chunk, ``mt`` columns a block, ``col_blocks`` column
    blocks covering M, ``jc`` folds a stage and ``smem`` bytes.  Raises
    ValueError for a plan the kernel cannot take."""
    kc = min(inv, 32)
    if kc not in KC_MENU or inv % kc:
        raise ValueError(f"fastddc_inv: inv={inv} has no bin chunk in "
                         f"{KC_MENU}")
    ni = next((n for n in NI_MENU if 8 * n >= m), NI_MENU[-1])
    mt = 8 * ni
    # the longest fold stage (up to 16) at which two blocks share an SM,
    # else the longest that fits one: at D=256, 8 folds at two blocks an
    # SM beat 16 at one; only plans of up to 16 columns (at most 128
    # registers a thread) get there
    stages = [jc for jc in (16, 8, 4, 2, 1) if jc <= pre and pre % jc == 0]
    for budget in (HALF_SMEM, MAX_SMEM):
        for jc in stages:
            if smem_bytes(kc, mt, jc) <= budget:
                return {"kc": kc, "mt": mt, "col_blocks": -(-m // mt),
                        "jc": jc, "smem": smem_bytes(kc, mt, jc)}
    raise ValueError(f"fastddc_inv: plan pre={pre} inv={inv} M={m} needs "
                     f"{smem_bytes(kc, mt, 1)} B of shared memory > "
                     f"{MAX_SMEM}")


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
    if (spectra.data_ptr() | tq.data_ptr()) % 16:
        raise ValueError("fastddc_inv: spectra and tq must be 16-byte "
                         "aligned (the kernel stages them 16 bytes a copy)")
    c, pre, inv = tq.shape
    b = spectra.shape[0]
    tiles = plan_tiles(pre, inv, w.shape[1])
    out = torch.empty((c, b, m_out), dtype=torch.complex64,
                      device=spectra.device)
    stream = torch.cuda.current_stream(spectra.device).cuda_stream
    code = _build.lib().csdr_fastddc_inv(
        spectra.data_ptr(), tq.data_ptr(), w.data_ptr(), d.data_ptr(),
        rot.data_ptr(), out.data_ptr(), b, c, pre, inv, w.shape[1],
        d.shape[1], m_out, tiles["kc"], tiles["mt"], tiles["jc"], stream)
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
