"""fastddc — the FFT channelizer (counterpart of csdr_tpu.ops.fastddc).

Reference: fastddc.c (init math :38-72, inverse :106-166), CLI wiring
csdr.c:2255-2378.  One forward FFT of the wideband stream serves C
channels; each channel multiplies the spectrum by its bandpass taps while
folding fft_size bins into fft_inv_size bins (decimation by
pre_decimation in frequency), inverse-transforms, scraps the overlap and
fixes the residual shift with a decimating NCO.

The host math (plan, fold permutations, channel matrices) is csdr_tpu's,
copied, and gives bit-identical numpy arrays.  The blocks are
``nn.Module``s whose constant matrices are registered buffers; their state
is only the stream history: the overlap tail (complex64) and the
per-channel NCO phase in cycles (float32 ``(C,)``), both on the stream's
device.  Device work:

- forward: overlap frames -> one batched FFT, natural order
  (``torch.fft``) or kernel bin order (K3, ``kernels/fft_cuda.fft_ko``);
- divisible post decimation: the factored-v2 inverse, K4
  (``kernels/fastddc_cuda.fastddc_inv``), for every plan shape and chunk;
  ``fastddc_channelizer_block`` puts the subsequence-split DFT (a plain
  ``torch.matmul``) in front of it and needs no forward FFT;
- otherwise (D=20, D=50): the phase-classed inverse, plain batched
  ``torch.matmul``s, taking natural or kernel-order spectra;
- the retunable blocks of the DDC server (``fastddc_*_dynamic_*``): the
  same inverses with each channel's rows and NCO rate as call arguments;
- csdr_tpu's r2 batch functions (``fastddc_inv_batch`` and its ``_mxu``
  form, ``fastddc_inv_factored_batch``): the inverse's readable
  specification and two matrix forms of it, plain torch, which no block
  runs.

Matrix products outside a kernel run inside
:func:`~csdr_tpu_torch.core.precision.full_f32_matmul`, so they stay in
full float32 whatever the global TF32 setting.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csdr_tpu_torch import firdes
from csdr_tpu_torch.core import fft as cfft
from csdr_tpu_torch.core.block import Block, VarOut, resolve_device
from csdr_tpu_torch.core.checkpoint import state_from_jax_leaves  # noqa: F401
from csdr_tpu_torch.core.cplx import expj
from csdr_tpu_torch.core.precision import full_f32_matmul
from csdr_tpu_torch.kernels import fastddc_cuda, fft_cuda


@dataclasses.dataclass(frozen=True)
class FastDDC:
    pre_decimation: int
    post_decimation: int
    taps_length: int
    taps_min_length: int
    overlap_length: int
    fft_size: int
    fft_inv_size: int
    input_size: int
    post_input_size: int
    pre_shift: float
    startbin: int
    v: int
    offsetbin: int
    post_shift: float
    scrap: int
    shift_rate: float
    transition_bw: float
    window: str


def fastddc_init(transition_bw: float, decimation: int, shift_rate: float = 0.0,
                 window: str = firdes.WINDOW_DEFAULT) -> FastDDC:
    """Size/shift planning (reference fastddc.c:38-72), exact C semantics:
    float32 arithmetic, int truncation for startbin, C round() for the bin
    quantization."""
    pre, post = 1, decimation
    while post % 2 == 0 and post // 2 != 1:
        post //= 2
        pre *= 2
    taps_min_length = firdes.firdes_filter_len(transition_bw)
    taps_length = cfft.next_pow2(-(-taps_min_length // pre) * pre) + 1
    fft_size = cfft.next_pow2(taps_length * 4)
    while fft_size < pre:
        fft_size *= 2
    overlap_length = taps_length - 1
    input_size = fft_size - overlap_length
    fft_inv_size = fft_size // pre

    v = fft_size // overlap_length
    middlebin = fft_size // 2
    sr = np.float32(shift_rate)
    startbin = int(np.float32(middlebin) + np.float32(middlebin) * (-sr) * np.float32(2))
    startbin = v * int(np.round(np.float32(startbin) / np.float32(v)))
    offsetbin = startbin - middlebin
    post_shift = float(np.float32(pre) * (sr + np.float32(offsetbin) / np.float32(fft_size)))
    pre_shift = float(np.float32(offsetbin) / np.float32(fft_size))
    scrap = overlap_length // pre
    post_input_size = fft_inv_size - scrap
    assert fft_size > 2, "error in fastddc_init()"
    return FastDDC(pre, post, taps_length, taps_min_length, overlap_length,
                   fft_size, fft_inv_size, input_size, post_input_size,
                   pre_shift, startbin, v, offsetbin, post_shift, scrap,
                   float(shift_rate), float(transition_bw), window)


def channel_taps_fft(ddc: FastDDC, shift_rate: float) -> np.ndarray:
    """Side-swapped FFT of the channel bandpass taps (csdr.c:2345-2356):
    complex bandpass around -shift_rate, zero-padded to fft_size, forward
    FFT, fftshift.  Returns a complex128 host array (cast at use)."""
    half_bw = 0.5 / (ddc.pre_decimation * ddc.post_decimation)
    taps = firdes.firdes_bandpass_c(ddc.taps_length, (-shift_rate) - half_bw,
                                    (-shift_rate) + half_bw, ddc.window)
    padded = np.zeros(ddc.fft_size, np.complex128)
    padded[: ddc.taps_length] = taps
    tf = np.fft.fft(padded)
    return np.fft.fftshift(tf)


def overlap_frames(x: torch.Tensor, tail: torch.Tensor, ins: int,
                   ov: int) -> torch.Tensor:
    """Overlapping frame matrix (B, ins+ov) from a flat stream and the
    carried tail: frame b = [last ov of block b-1 (the tail for b=0) |
    block b].  Requires ov <= ins."""
    assert ov <= ins, (ov, ins)
    b = x.shape[0] // ins
    blk = x.reshape(b, ins)
    prev = torch.cat([tail[None, :], blk[:-1, ins - ov:]], 0)
    return torch.cat([prev, blk], 1)


def _frames_in(x: torch.Tensor, ins: int) -> int:
    """Frames in a chunk, which must be a whole number of input_size."""
    if x.shape[0] % ins:
        raise ValueError(f"chunk of {x.shape[0]} samples is not a multiple "
                         f"of input_size {ins}")
    return x.shape[0] // ins


_ko_gather_idx = fft_cuda.gather_idx     # x_ko = x_nat[g]


def fwd_fft_frames(frames: torch.Tensor, spectra_order: str) -> torch.Tensor:
    """Batched forward FFT of overlap frames in the requested bin order.
    'kernel' order runs K3 (``fft_cuda.fft_ko``); a frame size K3 does not
    take gets the natural FFT and an order gather, as in csdr_tpu."""
    if spectra_order == "natural":
        return cfft.fft(frames)
    n = frames.shape[-1]
    if fft_cuda.supported(n, int(frames.shape[0])):
        return fft_cuda.fft_ko(frames)
    g = torch.from_numpy(_ko_gather_idx(n).astype(np.int64)).to(frames.device)
    return cfft.fft(frames)[:, g]


class FastddcFwdBlock(Block):
    """Wideband chunk (B*input_size,) -> spectra (B, fft_size).  Overlap as
    the reference (csdr.c:2291-2295): frame b = [last overlap_length
    samples | input_size new], no window, zero history at stream start.
    State: the overlap tail."""

    rate_ratio = None

    def __init__(self, ddc: FastDDC, spectra_order: str = "natural"):
        super().__init__("fastddc_fwd_cc")
        self.ddc = ddc
        self.spectra_order = spectra_order

    def init(self, device="cuda"):
        return torch.zeros(self.ddc.overlap_length, dtype=torch.complex64,
                           device=resolve_device(device))

    def forward(self, tail, x):
        ov, ins = self.ddc.overlap_length, self.ddc.input_size
        n = _frames_in(x, ins) * ins
        frames = overlap_frames(x, tail, ins, ov)
        return x[n - ov:].clone(), fwd_fft_frames(frames, self.spectra_order)

    def state_from_jax(self, leaves):
        return leaves.complex((self.ddc.overlap_length,), "fastddc_fwd tail")


def fastddc_fwd_block(ddc: FastDDC, frames_per_chunk: int = 32,
                      spectra_order: str = "natural") -> Block:
    """Forward half: pair 'kernel' order with fastddc_inv_block(...,
    spectra_order='kernel'), which folds the order into its matrices.
    ``frames_per_chunk`` keeps csdr_tpu's signature and is ignored: a block
    takes whatever whole number of frames each chunk holds."""
    return FastddcFwdBlock(ddc, spectra_order)


# ---------------------------------------------------------------------------
# host math: fold permutations and channel matrices (csdr_tpu's, copied)
# ---------------------------------------------------------------------------

def make_fold_perm(ddc: FastDDC) -> np.ndarray:
    """Swapped-domain permutation: perm[k*inv + j] = the k-th swapped-spectrum
    bin i whose reference fold target (fft_size + i - offsetbin + inv/2) mod
    inv equals j (fastddc.c:126-141)."""
    fft_size, inv = ddc.fft_size, ddc.fft_inv_size
    i = np.arange(fft_size)
    out_idx = (fft_size + i - ddc.offsetbin + inv // 2) % inv
    order = np.argsort(out_idx * np.int64(fft_size) + i, kind="stable")
    grouped = order.reshape(inv, ddc.pre_decimation)  # rows j, cols k
    perm = np.empty(fft_size, np.int64)
    for j in range(inv):
        for k in range(ddc.pre_decimation):
            perm[k * inv + j] = grouped[j, k]
    return perm.astype(np.int32)


def raw_gather_perm(ddc: FastDDC) -> np.ndarray:
    """The slot permutation composed with the input side swap, so the RAW
    spectrum can be gathered directly: swapped[i] = raw[(i + fft/2) % fft]."""
    p = make_fold_perm(ddc)
    return ((p + ddc.fft_size // 2) % ddc.fft_size).astype(np.int32)


def channel_arrays(ddc: FastDDC, shift_rate: float):
    """One channel's (taps_eff_row complex64 (fft,), fold_perm_row int32
    (fft,), dsa_rate float32)."""
    ch = fastddc_init(ddc.transition_bw,
                      ddc.pre_decimation * ddc.post_decimation,
                      float(shift_rate), ddc.window)
    assert ch.fft_size == ddc.fft_size and ch.fft_inv_size == ddc.fft_inv_size
    taps_row = channel_taps_fft(ch, float(shift_rate)).astype(np.complex64)
    taps_row = taps_row[make_fold_perm(ch)]
    return taps_row, raw_gather_perm(ch), np.float32(ch.post_shift) * ddc.post_decimation


def channel_matrix(ddc: FastDDC, shift_rate: float) -> np.ndarray:
    """One channel's dense fold matrix F_c (fft_size, fft_inv_size)
    complex64: folded = raw_spectrum @ F_c is the reference's swap-sides ->
    taps-multiply -> bin-fold (fastddc.c:118-146), /pre-normalized."""
    t, p, _ = channel_arrays(ddc, shift_rate)
    inv = ddc.fft_inv_size
    f = np.zeros((ddc.fft_size, inv), np.complex64)
    slots = np.arange(ddc.fft_size)
    np.add.at(f, (p[slots], slots % inv), t[slots])
    return f / np.float32(ddc.pre_decimation)


def channel_fused_matrix(ddc: FastDDC, shift_rate: float):
    """The whole per-channel inverse as one (fft_size, M) complex matrix G,
    M = post_input_size / post_decimation (requires pis % post == 0):
    out[b, m] = A(b) * (spectra[b] @ G)[m] with A(b) the per-frame NCO.
    Returns (G complex64, frame_cycles float64)."""
    pis, post = ddc.post_input_size, ddc.post_decimation
    inv, scrap = ddc.fft_inv_size, ddc.scrap
    assert pis % post == 0, (pis, post)
    m = pis // post
    f = channel_matrix(ddc, shift_rate)                      # (fft, inv)
    ch = fastddc_init(ddc.transition_bw,
                      ddc.pre_decimation * ddc.post_decimation,
                      float(shift_rate), ddc.window)
    dsa = np.float64(np.float32(ch.post_shift)) * post       # cycles/taken
    k = np.arange(inv)[:, None]
    t = scrap + post * np.arange(m)[None, :]
    w = np.exp(2j * np.pi * (k + inv // 2) * t / inv) / inv  # swap+ifft+sel
    b = np.exp(2j * np.pi * np.mod(np.arange(m) * dsa, 1.0))  # in-frame NCO
    g = (f @ (w * b[None, :])).astype(np.complex64)
    return g, np.mod(m * dsa, 1.0)


def channel_factored_arrays(ddc: FastDDC, rates):
    """Host arrays of the r2 factored inverse
    (:func:`fastddc_inv_factored_batch`): TQ (C, pre, inv) complex64, the
    raw-order taps spectrum / pre, so TQ[c, j, m] multiplies raw bin
    j*inv + m; E (C, inv, M) complex64, the shared swap + iFFT +
    post-select + in-frame NCO matrix with its rows rolled by each
    channel's fold shift cc = (-offsetbin + inv/2) mod inv; frame_cyc
    (C,) float64.  Factored-v2 (:func:`channel_factored2_arrays`) turns
    the roll into a column scaling of one shared W."""
    inv, fft, pre = ddc.fft_inv_size, ddc.fft_size, ddc.pre_decimation
    pis, post = ddc.post_input_size, ddc.post_decimation
    assert pis % post == 0
    m = pis // post
    tq_list, e_list, cyc_list = [], [], []
    half_bw = 0.5 / (ddc.pre_decimation * ddc.post_decimation)
    k = np.arange(inv)[:, None]
    t_sel = ddc.scrap + post * np.arange(m)[None, :]
    w = np.exp(2j * np.pi * (k + inv // 2) * t_sel / inv) / inv
    for rate in map(float, rates):
        ch = fastddc_init(ddc.transition_bw,
                          ddc.pre_decimation * ddc.post_decimation, rate,
                          ddc.window)
        taps = firdes.firdes_bandpass_c(ch.taps_length, -rate - half_bw,
                                        -rate + half_bw, ddc.window)
        padded = np.zeros(fft, np.complex128)
        padded[: ch.taps_length] = taps
        tq = (np.fft.fft(padded) / pre).astype(np.complex64)
        cc = (-ch.offsetbin + inv // 2) % inv
        dsa = np.float64(np.float32(ch.post_shift)) * post
        b_nco = np.exp(2j * np.pi * np.mod(np.arange(m) * dsa, 1.0))
        wb = w * b_nco[None, :]
        e = wb[(np.arange(inv) + cc) % inv, :].astype(np.complex64)
        tq_list.append(tq.reshape(pre, inv))
        e_list.append(e)
        cyc_list.append(np.mod(m * dsa, 1.0))
    return (np.stack(tq_list), np.stack(e_list),
            np.asarray(cyc_list, np.float64))


def channel_factored2_arrays(ddc: FastDDC, rates):
    """Host arrays of the shared-iDFT factored inverse (factored-v2):

        out[b, c, o] = (Z[b, c, :] @ W)[o] * d_c[o],
        Z[b, c, m]   = sum_j spectra[b, j*inv + m] * TQ[c, j, m],
        d_c[o]       = exp(2*pi*i*cc_c*t_o/inv) * b_nco_c[o]

    (rolling W's rows by the channel's fold shift cc_c is a column scaling,
    because the taken times t_o = scrap + post*o are integers).

    Returns (TQ (C, pre, inv) c64, W (inv, M) c64, D (C, M) c64,
    frame_cyc (C,) f64)."""
    inv, fft, pre = ddc.fft_inv_size, ddc.fft_size, ddc.pre_decimation
    pis, post = ddc.post_input_size, ddc.post_decimation
    assert pis % post == 0
    m = pis // post
    half_bw = 0.5 / (ddc.pre_decimation * ddc.post_decimation)
    k = np.arange(inv)[:, None]
    t_sel = ddc.scrap + post * np.arange(m)[None, :]
    w = (np.exp(2j * np.pi * (k + inv // 2) * t_sel / inv) / inv)
    tq_list, d_list, cyc_list = [], [], []
    for rate in map(float, rates):
        ch = fastddc_init(ddc.transition_bw,
                          ddc.pre_decimation * ddc.post_decimation, rate,
                          ddc.window)
        taps = firdes.firdes_bandpass_c(ch.taps_length, -rate - half_bw,
                                        -rate + half_bw, ddc.window)
        padded = np.zeros(fft, np.complex128)
        padded[: ch.taps_length] = taps
        tq = (np.fft.fft(padded) / pre).astype(np.complex64)
        cc = (-ch.offsetbin + inv // 2) % inv
        dsa = np.float64(np.float32(ch.post_shift)) * post
        b_nco = np.exp(2j * np.pi * np.mod(np.arange(m) * dsa, 1.0))
        roll_fac = np.exp(2j * np.pi * cc * t_sel[0] / inv)
        tq_list.append(tq.reshape(pre, inv))
        d_list.append((roll_fac * b_nco).astype(np.complex64))
        cyc_list.append(np.mod(m * dsa, 1.0))
    return (np.stack(tq_list), w.astype(np.complex64), np.stack(d_list),
            np.asarray(cyc_list, np.float64))


def mpad_for(ddc: FastDDC) -> int:
    """csdr_tpu's lane-padded per-frame output width (M rounded up to a
    128 multiple): the width of its padded d/W state leaves."""
    m = ddc.post_input_size // ddc.post_decimation
    return max(128, -(-m // 128) * 128)


def channelizer_arrays(ddc: FastDDC, rates):
    """Host arrays of the fused channelizer (forward DFT + factored-v2
    inverse with no standalone FFT).  The fft-point DFT splits over the
    pre stride-decimated subsequences, and the fold absorbs the twiddles:

        Z[b,c,m] = sum_{n2} TQ2[c,n2,m] * Y[b,n2,m],
        Y[b,n2,:] = frame[b, n2::pre] @ Wdft
        TQ2[c,n2,m] = sum_j TQ[c,j,m] e_fft^{-n2(m+inv*j)}

    Returns (TQ2 (C, pre, inv), Wdft (inv, inv), W (inv, M), D (C, M),
    frame_cyc (C,)), c64 / f64."""
    inv, fft, pre = ddc.fft_inv_size, ddc.fft_size, ddc.pre_decimation
    tq, w, d, cyc = channel_factored2_arrays(ddc, rates)
    n2 = np.arange(pre)
    j = np.arange(pre)
    m = np.arange(inv)
    # (n2, j, m) twiddle, f64 host math
    tw = np.exp(-2j * np.pi * n2[:, None, None]
                * (m[None, None, :] + inv * j[None, :, None]) / fft)
    tq2 = np.einsum("cjm,njm->cnm", tq.astype(np.complex128), tw)
    n1 = np.arange(inv)
    wdft = np.exp(-2j * np.pi * np.outer(n1, m) / inv)
    return (tq2.astype(np.complex64), wdft.astype(np.complex64), w, d, cyc)


def _class_plan(ddc: FastDDC):
    """Frame phase classes for post_input_size % post != 0: frame b's first
    taken in-frame offset t0 = (post - (b*pis) % post) % post cycles with
    period q = post / gcd(pis, post).  Returns (q, t0s, ms, m_max, S), S
    the 0/1 compaction matrix (q*m_max, q*pis//post)."""
    pis, post = ddc.post_input_size, ddc.post_decimation
    q = post // int(np.gcd(pis, post))
    t0s = [(post - (b * pis) % post) % post for b in range(q)]
    ms = [int(np.ceil((pis - t0) / post)) for t0 in t0s]
    m_max = max(ms)
    total = q * pis // post
    assert sum(ms) == total
    s = np.zeros((q * m_max, total), np.float32)
    pos = 0
    for o in range(q):
        for i in range(ms[o]):
            s[o * m_max + i, pos] = 1.0
            pos += 1
    return q, t0s, ms, m_max, s


def channel_class_matrices(ddc: FastDDC, shift_rate: float):
    """Per-class fused matrices for one channel: (q, fft, m_max) complex64
    (zero-padded columns), plus dsa_rate (f64 cycles per taken sample)."""
    pis, post = ddc.post_input_size, ddc.post_decimation
    inv, scrap = ddc.fft_inv_size, ddc.scrap
    q, t0s, ms, m_max, _ = _class_plan(ddc)
    f = channel_matrix(ddc, shift_rate)                      # (fft, inv)
    ch = fastddc_init(ddc.transition_bw,
                      ddc.pre_decimation * ddc.post_decimation,
                      float(shift_rate), ddc.window)
    dsa = np.float64(np.float32(ch.post_shift)) * post
    k = np.arange(inv)[:, None]
    bvec = np.exp(2j * np.pi * np.mod(np.arange(m_max) * dsa, 1.0))
    g = np.zeros((q, ddc.fft_size, m_max), np.complex64)
    for o in range(q):
        t = scrap + t0s[o] + post * np.arange(ms[o])
        w = np.exp(2j * np.pi * (k + inv // 2) * t[None, :] / inv) / inv
        g[o, :, : ms[o]] = f @ (w * bvec[None, : ms[o]])
    return g, dsa


# ---------------------------------------------------------------------------
# the inverse as batch functions: the readable specification and its
# matrix forms (csdr_tpu's r2 functions; the blocks below run the fused,
# factored-v2 and classed forms)
# ---------------------------------------------------------------------------

def _check_precision(precision: str) -> None:
    if precision not in ("HIGH", "HIGHEST"):
        raise ValueError(f"precision {precision!r}")


def _swap_ifft_scrap(folded: torch.Tensor, ddc: FastDDC) -> torch.Tensor:
    """Folded bins (..., inv) -> the inverse's time samples (..., pis):
    side swap, normalized iFFT, overlap scrap (fastddc.c:146-157)."""
    td = cfft.ifft(cfft.fft_swap_sides(folded), normalize=True)
    return td[..., ddc.scrap:]


def fastddc_inv_batch(spectra: torch.Tensor, ddc: FastDDC,
                      taps_eff: torch.Tensor, fold_perm) -> torch.Tensor:
    """B spectra for C channels -> time samples (B, C, post_input_size),
    step by step as the reference inverse (fastddc.c:106-166): the
    readable specification, which the production forms
    (:func:`channel_fused_matrix`, :func:`channel_class_matrices`) compute
    as matrix products.

    spectra (B, fft) complex64 RAW (not side-swapped); taps_eff (C, fft)
    complex64, the side-swapped taps already permuted into fold-slot order
    (:func:`channel_arrays`); fold_perm (C, fft) integer, the raw-spectrum
    gather in the same slot order.  Slot (k, j) = k*inv + j adds
    S_swapped[i]*T_swapped[i] into folded bin j."""
    b, c = spectra.shape[0], taps_eff.shape[0]
    pre, inv = ddc.pre_decimation, ddc.fft_inv_size
    idx = torch.as_tensor(np.asarray(fold_perm), dtype=torch.int64,
                          device=spectra.device)
    z = spectra[:, idx] * taps_eff[None]                       # (B, C, fft)
    folded = z.reshape(b, c, pre, inv).sum(2) / pre
    return _swap_ifft_scrap(folded, ddc)


def fastddc_inv_batch_mxu(spectra: torch.Tensor, ddc: FastDDC,
                          fold_mat: torch.Tensor,
                          precision: str = "HIGH") -> torch.Tensor:
    """:func:`fastddc_inv_batch` with the fold and taps as one product by
    the dense fold matrix: spectra (B, fft) @ fold_mat (fft, C*inv) (the
    :func:`channel_matrix` blocks side by side), in full float32.
    ``precision`` keeps csdr_tpu's signature ("HIGH" and "HIGHEST" both run
    in float32).  Returns (B, C, post_input_size)."""
    _check_precision(precision)
    with full_f32_matmul():
        z = torch.matmul(spectra, fold_mat)
    return _swap_ifft_scrap(z.reshape(spectra.shape[0], -1,
                                      ddc.fft_inv_size), ddc)


def fastddc_inv_factored_batch(spectra: torch.Tensor, tq: torch.Tensor,
                               e: torch.Tensor,
                               precision: str = "HIGH") -> torch.Tensor:
    """The r2 factored inverse before the per-frame NCO: the class sum
    Z[b,c,m] = sum_j spectra[b, j*inv + m] * TQ[c,j,m] (pre products a
    bin), then Z[b,c,:] @ E_c (inv a sample), the fused G_c of
    :func:`channel_fused_matrix` taken apart.  spectra (B, fft); tq (C,
    pre, inv); e (C, inv, M), from :func:`channel_factored_arrays`.
    Returns (C, B, M); ``precision`` as :func:`fastddc_inv_batch_mxu`."""
    _check_precision(precision)
    b = spectra.shape[0]
    c, pre, inv = tq.shape
    with full_f32_matmul():
        z = torch.einsum("bjm,cjm->bcm", spectra.reshape(b, pre, inv), tq)
        return torch.einsum("bcm,cmo->cbo", z, e)


# ---------------------------------------------------------------------------
# inverse blocks
# ---------------------------------------------------------------------------

fastddc_inv_factored2_batch = fastddc_cuda.factored2_batch


def _c64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.complex64))


def _rotate(phases: torch.Tensor, cycles: torch.Tensor) -> torch.Tensor:
    """exp(j*2*pi*((phase + cycles) mod 1)), float32 as csdr_tpu."""
    tail = (slice(None),) + (None,) * (cycles.dim() - 1)
    return expj(2.0 * np.pi * torch.remainder(phases[tail] + cycles, 1.0))


def _fused_product(spectra: torch.Tensor, g: torch.Tensor, c: int,
                   m: int) -> torch.Tensor:
    """spectra (B, fft) @ G (fft, C*M) as (C, B, M), in full float32."""
    with full_f32_matmul():
        z = torch.matmul(spectra, g)
    return z.reshape(spectra.shape[0], c, m).permute(1, 0, 2)


def _classed_product(spectra: torch.Tensor, g: torch.Tensor, q: int, c: int,
                     m_max: int) -> torch.Tensor:
    """q-aligned spectra (B, fft) by the class matrices G (q, fft,
    C*m_max): frame b takes class b % q.  Returns (C, B/q, q, m_max)."""
    groups = spectra.shape[0] // q
    s = spectra.reshape(groups, q, -1).transpose(0, 1)     # (q, groups, fft)
    with full_f32_matmul():
        z = torch.matmul(s, g)                            # (q, groups, C*m)
    return z.reshape(q, groups, c, m_max).permute(2, 1, 0, 3)


def _compact(y: torch.Tensor, sel: torch.Tensor, ga: int) -> torch.Tensor:
    """(C, groups, q, m_max) -> the taken samples (C, groups*ga): csdr_tpu's
    0/1 selection product, as the gather it equals."""
    c, groups = y.shape[:2]
    return y.reshape(c, groups, -1)[..., sel].reshape(c, groups * ga)


class _PhasedInverse(Block):
    """Base of the inverse blocks: C channels, each with an NCO phase in
    cycles (float32) carried on the stream's device; the per-frame ramps
    are exact float64 host math cast to float32, cached per chunk shape."""

    def __init__(self, name: str, n_channels: int):
        super().__init__(name)
        self.n_channels = n_channels
        self._ramp_cache: dict = {}

    def _host_ramps(self, b: int):
        """(ramp float32, per-chunk advance float32 (C,)) for b frames."""
        raise NotImplementedError

    def _ramps(self, b: int, device):
        key = (b, str(device))
        if key not in self._ramp_cache:
            r, adv = self._host_ramps(b)
            self._ramp_cache[key] = (torch.from_numpy(r).to(device),
                                     torch.from_numpy(adv).to(device))
        return self._ramp_cache[key]

    def init(self, device="cuda"):
        return torch.zeros(self.n_channels, dtype=torch.float32,
                           device=resolve_device(device))

    def _phases_from_jax(self, leaves):
        return leaves.real((self.n_channels,), f"{self.name} phases")


class _FrameRampInverse(_PhasedInverse):
    """Divisible post decimation: one NCO step per frame."""

    def __init__(self, name: str, frame_cyc: np.ndarray, m: int):
        super().__init__(name, len(frame_cyc))
        self.frame_cyc = np.asarray(frame_cyc, np.float64)
        self.m = m

    def _host_ramps(self, b: int):
        r = np.mod(np.arange(b)[None, :] * self.frame_cyc[:, None], 1.0)
        return (r.astype(np.float32),
                np.mod(b * self.frame_cyc, 1.0).astype(np.float32))

    def _factored2(self, phases, spectra, tq):
        """K4 on (B, fft) spectra: (new phases, VarOut (C, B*M))."""
        b = spectra.shape[0]
        ramp, adv = self._ramps(b, spectra.device)
        y = fastddc_cuda.fastddc_inv(spectra.contiguous(), tq, self.w,
                                     self.d, _rotate(phases, ramp), self.m)
        out = VarOut(y.reshape(self.n_channels, b * self.m), b * self.m)
        return torch.remainder(phases + adv, 1.0), out


class FastddcInvFusedBlock(_FrameRampInverse):
    """Fused single-matrix inverse: spectra @ G (fft, C*M), then the
    per-frame NCO.  csdr_tpu's non-TPU route for divisible post
    decimation; here the tests' CPU reference for the K4 block, which
    computes the same map factored.  State: phases (C,)."""

    def __init__(self, ddc: FastDDC, rates):
        cols = [channel_fused_matrix(ddc, r) for r in rates]
        super().__init__("fastddc_inv_cc", [fc for _, fc in cols],
                         ddc.post_input_size // ddc.post_decimation)
        self.register_buffer("g", _c64(np.concatenate([g for g, _ in cols],
                                                       axis=1)))

    def forward(self, phases, spectra):
        b, m = spectra.shape[0], self.m
        ramp, adv = self._ramps(b, spectra.device)
        y = _fused_product(spectra, self.g, self.n_channels, m) \
            * _rotate(phases, ramp)[:, :, None]
        return (torch.remainder(phases + adv, 1.0),
                VarOut(y.reshape(self.n_channels, b * m), b * m))

    def state_from_jax(self, leaves):
        phases = self._phases_from_jax(leaves)
        leaves.matches(self.g, "fastddc_inv G")
        return phases


def _fastddc_inv_fused_block(ddc: FastDDC, rates) -> Block:
    return FastddcInvFusedBlock(ddc, list(map(float, rates)))


class FastddcInvFactored2Block(_FrameRampInverse):
    """The factored-v2 inverse through K4 (csdr_tpu's
    ``_fastddc_inv_vmem_block``, its TPU choice): fold, per-frame NCO,
    shared iDFT product and output diagonal in one launch per chunk, for
    every plan shape and chunk length.  State: phases (C,)."""

    def __init__(self, ddc: FastDDC, rates):
        tq, w, d, frame_cyc = channel_factored2_arrays(ddc, rates)
        super().__init__("fastddc_inv_cc", frame_cyc, w.shape[1])
        self.register_buffer("tq", _c64(tq))
        self.register_buffer("w", _c64(w))
        self.register_buffer("d", _c64(d))

    def forward(self, phases, spectra):
        return self._factored2(phases, spectra, self.tq)

    def state_from_jax(self, leaves):
        phases = self._phases_from_jax(leaves)
        leaves.matches(self.tq, "fastddc_inv TQ")
        leaves.matches_padded(self.d, "fastddc_inv d")
        leaves.matches_packed_w(self.w, "fastddc_inv W")
        return phases


class FastddcChannelizerBlock(_FrameRampInverse):
    """Wideband chunk -> per-channel baseband VarOut (C, B*M), forward and
    inverse in one block with no standalone FFT: overlap framing, the
    subsequence-split DFT as one ``torch.matmul``, then K4.  Requires
    post_input_size % post_decimation == 0.  State: (tail, phases)."""

    def __init__(self, ddc: FastDDC, rates):
        pis, post = ddc.post_input_size, ddc.post_decimation
        if pis % post:
            raise ValueError(f"the channelizer needs post_input_size {pis} "
                             f"divisible by post_decimation {post}")
        tq2, wdft, w, d, frame_cyc = channelizer_arrays(ddc, rates)
        super().__init__("fastddc_channelizer_cc", frame_cyc, pis // post)
        self.ddc = ddc
        for name, a in (("tq2", tq2), ("wdft", wdft), ("w", w), ("d", d)):
            self.register_buffer(name, _c64(a))

    def init(self, device="cuda"):
        dev = resolve_device(device)
        return (torch.zeros(self.ddc.overlap_length, dtype=torch.complex64,
                            device=dev), super().init(dev))

    def forward(self, state, x):
        tail, phases = state
        ddc = self.ddc
        ov, ins = ddc.overlap_length, ddc.input_size
        pre, inv = ddc.pre_decimation, ddc.fft_inv_size
        b = _frames_in(x, ins)
        n = b * ins
        frames = overlap_frames(x, tail, ins, ov)
        # subsequence split: x6[b, n2, n1] = frame[b, n2 + pre*n1]
        x6 = frames.reshape(b, inv, pre).transpose(1, 2)
        with full_f32_matmul():
            s = torch.matmul(x6, self.wdft).reshape(b, ddc.fft_size)
        phases, out = self._factored2(phases, s, self.tq2)
        return (x[n - ov:].clone(), phases), out

    def state_from_jax(self, leaves):
        tail = leaves.complex((self.ddc.overlap_length,), "channelizer tail")
        phases = self._phases_from_jax(leaves)
        leaves.matches(self.tq2, "channelizer TQ2")
        leaves.matches(self.wdft, "channelizer Wdft")
        leaves.matches_padded(self.d, "channelizer d")
        leaves.matches_packed_w(self.w, "channelizer W")
        return tail, phases


def fastddc_channelizer_block(ddc: FastDDC, shift_rates,
                              precision: str = "HIGH") -> Block:
    """The fused channelizer (see channelizer_arrays).  ``precision`` keeps
    csdr_tpu's signature and changes nothing: "HIGH" and "HIGHEST" both run
    in float32 here."""
    _check_precision(precision)
    return FastddcChannelizerBlock(ddc, list(map(float, shift_rates)))


class FastddcInvClassedBlock(_PhasedInverse):
    """Inverse for non-divisible post decimation (D=20, D=50): frames
    grouped by phase class, one batched complex product per chunk, a
    per-frame NCO scalar, then compaction of the taken samples.  Chunks
    must hold a multiple of q frames for streaming continuity; a lone
    unaligned chunk is zero-padded.  State: phases (C,)."""

    def __init__(self, ddc: FastDDC, rates, spectra_order: str = "natural"):
        q, t0s, ms, m_max, s_np = _class_plan(ddc)
        super().__init__("fastddc_inv_cc", len(rates))
        self.ddc = ddc
        self.q, self.m_max = q, m_max
        pis, post = ddc.post_input_size, ddc.post_decimation
        self.ga = q * pis // post                # taken samples per group
        cols = [channel_class_matrices(ddc, r) for r in rates]
        g_np = np.concatenate([g for g, _ in cols], axis=2)
        if spectra_order == "kernel":
            # G_ko[perm[k]] = G_nat[k]: the kernel's bin order folded into
            # the spectral rows
            g_ko = np.empty_like(g_np)
            g_ko[:, fft_cuda.kernel_perm(ddc.fft_size), :] = g_np
            g_np = g_ko
        self.dsa = np.asarray([d for _, d in cols], np.float64)     # (C,)
        self.g0_local = np.asarray(
            [(b * pis + t0s[b]) // post for b in range(q)], np.float64)
        self.register_buffer("g", _c64(g_np))                # (q, fft, C*m_max)
        # compaction: S is 0/1 with one 1 per column, i.e. a gather
        self.register_buffer("sel", torch.from_numpy(s_np.argmax(0)))

    def _host_ramps(self, bp: int):
        j = np.arange(bp // self.q, dtype=np.float64)[None, :, None]
        r = self.g0_local[None, None, :]
        cyc = np.mod((j * self.ga + r) * self.dsa[:, None, None], 1.0)
        return (cyc.astype(np.float32),                          # (C, B/q, q)
                np.mod((bp // self.q) * self.ga * self.dsa, 1.0)
                .astype(np.float32))

    def forward(self, phases, spectra):
        ddc, q, c = self.ddc, self.q, self.n_channels
        b = spectra.shape[0]
        bp = -(-b // q) * q
        if bp != b:
            spectra = torch.cat([spectra, spectra.new_zeros(
                bp - b, ddc.fft_size)])
        z = _classed_product(spectra, self.g, q, c, self.m_max)
        ramp, adv = self._ramps(bp, spectra.device)
        y = _compact(z * _rotate(phases, ramp)[..., None], self.sel, self.ga)
        count = -(-(b * ddc.post_input_size) // ddc.post_decimation)
        return torch.remainder(phases + adv, 1.0), VarOut(y, count)

    def state_from_jax(self, leaves):
        phases = self._phases_from_jax(leaves)
        leaves.matches(self.g, "fastddc_inv classed G")
        return phases


def _fastddc_inv_classed_block(ddc: FastDDC, rates,
                               spectra_order: str = "natural") -> Block:
    return FastddcInvClassedBlock(ddc, list(map(float, rates)), spectra_order)


def fastddc_inv_block(ddc: FastDDC, shift_rates, frames_per_chunk: int = 32,
                      spectra_order: str = "natural") -> Block:
    """Spectra (B, fft_size) -> per-channel baseband VarOut (C, cap).

    All channels share the sizing of ``ddc``; each has its own
    offsetbin/post_shift (fastddc_init per rate), exactly C reference
    fastddc_inv_cc processes.  Divisible post decimation runs the
    factored-v2 inverse through K4 (csdr_tpu's TPU choice); otherwise the
    phase-classed inverse, which also takes kernel-order spectra
    (fastddc_fwd_block(..., spectra_order='kernel')).  ``frames_per_chunk``
    keeps csdr_tpu's signature and is ignored."""
    rates = list(map(float, shift_rates))
    chans = [fastddc_init(ddc.transition_bw,
                          ddc.pre_decimation * ddc.post_decimation, r,
                          ddc.window) for r in rates]
    for ch in chans:
        assert ch.fft_size == ddc.fft_size and ch.fft_inv_size == ddc.fft_inv_size
    if ddc.post_input_size % ddc.post_decimation == 0:
        if spectra_order != "natural":
            raise ValueError("divisible-post configs take natural-order "
                             "spectra (or run the fused channelizer)")
        return FastddcInvFactored2Block(ddc, rates)
    return _fastddc_inv_classed_block(ddc, rates, spectra_order)


# ---------------------------------------------------------------------------
# dynamic (retunable) blocks: per-channel rows are call arguments
# ---------------------------------------------------------------------------
#
# The DDC server claims, releases and retunes channels at run time, so the
# per-channel matrices and NCO rates are arguments of each call, not
# buffers (csdr_tpu/ops/fastddc.py:323-578).  As in csdr_tpu, their NCO
# ramps are float32 on the device from the argument ``cyc``, frac(k*cyc)
# and the carried phase (phases + frac(B*cyc)) mod 1, not the static
# blocks' float64 host ramps: the same float32 operations, so the carried
# phases are csdr_tpu's bit for bit.

def dynamic_channel_cols(ddc: FastDDC, shift_rate: float,
                         spectra_order: str = "natural"):
    """One channel's payload for :class:`FastddcInvDynamicBlock`: (G_block,
    cyc float32).  Divisible post decimation: the fused (fft, M) matrix and
    per-frame cycles; otherwise the classed (q, fft, m_max) matrices and
    per-taken-sample cycles.  'kernel' order permutes the spectral rows for
    K3's bin order."""
    if ddc.post_input_size % ddc.post_decimation == 0:
        g, fc = channel_fused_matrix(ddc, shift_rate)
        ax, cyc = 0, np.float32(fc)
    else:
        g, dsa = channel_class_matrices(ddc, shift_rate)
        ax, cyc = 1, np.float32(np.mod(dsa, 1.0))
    if spectra_order == "kernel":
        gk = np.empty_like(g)
        idx = [slice(None)] * g.ndim
        idx[ax] = fft_cuda.kernel_perm(ddc.fft_size)
        gk[tuple(idx)] = g
        g = gk
    return g, cyc


def _padded_row(d: np.ndarray, mpad: int) -> np.ndarray:
    row = np.zeros((mpad,), np.complex64)
    row[: d.shape[0]] = d
    return row


def dynamic_channel_rows(ddc: FastDDC, shift_rate: float,
                         mpad: int | None = None):
    """One channel's payload for :class:`FastddcInvDynamicFactoredBlock`
    (divisible post only): (tq_row (pre, inv), d_row (mpad,), cyc
    float32), d padded to csdr_tpu's ``mpad_for`` width."""
    tq, _w, d, cyc = channel_factored2_arrays(ddc, [float(shift_rate)])
    return (tq[0], _padded_row(d[0], mpad or mpad_for(ddc)),
            np.float32(cyc[0]))


def dynamic_channelizer_rows(ddc: FastDDC, shift_rate: float,
                             mpad: int | None = None):
    """One channel's payload for :class:`FastddcDynamicChannelizerBlock`:
    (tq2_row (pre, inv), d_row (mpad,), cyc float32), from
    :func:`channelizer_arrays` for this one rate, so a retune back to a
    starting rate rewrites the rows bit for bit."""
    tq2, _wdft, _w, d, cyc = channelizer_arrays(ddc, [float(shift_rate)])
    return (tq2[0], _padded_row(d[0], mpad or mpad_for(ddc)),
            np.float32(cyc[0]))


def _frame_ramp(b: int, cyc: torch.Tensor) -> torch.Tensor:
    """frac(k*cyc) for k < b, (C, b) float32, as csdr_tpu's dynamic
    blocks compute it."""
    k = torch.arange(b, dtype=torch.float32, device=cyc.device)
    return torch.remainder(k[None, :] * cyc[:, None], 1.0)


def _advance(phases: torch.Tensor, steps: int,
             cyc: torch.Tensor) -> torch.Tensor:
    """(phases + frac(steps*cyc)) mod 1, float32."""
    return torch.remainder(phases + torch.remainder(steps * cyc, 1.0), 1.0)


def _check_rows(what: str, c: int, **rows) -> None:
    for name, t in rows.items():
        if t.shape[0] != c:
            raise ValueError(f"{what}: {name} has {t.shape[0]} rows for "
                             f"{c} channels")


class FastddcInvDynamicBlock(_PhasedInverse):
    """The dynamic inverse of spectra (B, fft), csdr_tpu's
    ``fastddc_inv_dynamic_block``.  Called as ``block(phases, spectra, g,
    cyc)`` with ``g`` shaped ``g_shape`` (columns per channel from
    :func:`dynamic_channel_cols`) and ``cyc`` (C,) float32:

    - divisible post decimation: g (fft, C*M), one dense product, then the
      per-frame NCO;
    - otherwise: g (q, fft, C*m_max), the phase-classed product (B a
      multiple of q), the per-taken-sample NCO and the compaction.

    State: the NCO phases (C,) in cycles."""

    def __init__(self, ddc: FastDDC, n_channels: int):
        super().__init__("fastddc_inv_dynamic_cc", n_channels)
        self.ddc = ddc
        pis, post = ddc.post_input_size, ddc.post_decimation
        self.divisible = pis % post == 0
        if self.divisible:
            self.m = pis // post
            self.g_shape = (ddc.fft_size, n_channels * self.m)
            return
        q, t0s, _ms, m_max, s_np = _class_plan(ddc)
        self.q, self.m_max, self.ga = q, m_max, q * pis // post
        self.g_shape = (q, ddc.fft_size, n_channels * m_max)
        self.register_buffer("g0_local", torch.tensor(
            [(b * pis + t0s[b]) // post for b in range(q)],
            dtype=torch.float32))
        self.register_buffer("sel", torch.from_numpy(s_np.argmax(0)))

    def forward(self, phases, spectra, g, cyc):
        c, b = self.n_channels, spectra.shape[0]
        _check_rows("fastddc_inv_dynamic", c, cyc=cyc)
        if tuple(g.shape) != self.g_shape:
            raise ValueError(f"g {tuple(g.shape)}, want {self.g_shape}")
        if self.divisible:
            m = self.m
            y = _fused_product(spectra, g, c, m) \
                * _rotate(phases, _frame_ramp(b, cyc))[:, :, None]
            return (_advance(phases, b, cyc),
                    VarOut(y.reshape(c, b * m), b * m))
        q = self.q
        if b % q:
            raise ValueError(f"chunk frames {b} % q {q} != 0")
        groups = b // q
        z = _classed_product(spectra, g, q, c, self.m_max)
        jj = torch.arange(groups, dtype=torch.float32, device=cyc.device)
        per_group = torch.remainder(self.ga * cyc, 1.0)
        base = torch.remainder(jj[None, :, None] * per_group[:, None, None]
                               + self.g0_local[None, None, :]
                               * cyc[:, None, None], 1.0)
        y = _compact(z * _rotate(phases, base)[..., None], self.sel, self.ga)
        return (_advance(phases, groups, per_group),
                VarOut(y, groups * self.ga))

    def state_from_jax(self, leaves):
        return self._phases_from_jax(leaves)


def fastddc_inv_dynamic_block(ddc: FastDDC, n_channels: int):
    """The DDC server's inverse for spectra in (see
    :class:`FastddcInvDynamicBlock`; its ``g_shape`` is the third value
    csdr_tpu returns)."""
    return FastddcInvDynamicBlock(ddc, n_channels)


class FastddcInvDynamicFactoredBlock(_PhasedInverse):
    """The factored-v2 dynamic inverse through K4 (divisible post only),
    csdr_tpu's ``fastddc_inv_dynamic_factored_block``: called as
    ``block(phases, spectra, tq, d, cyc)`` with tq (C, pre, inv), d (C,
    mpad) (rows of :func:`dynamic_channel_rows`) and cyc (C,).  The shared
    iDFT matrix W is a buffer."""

    def __init__(self, ddc: FastDDC, n_channels: int):
        pis, post = ddc.post_input_size, ddc.post_decimation
        if pis % post:
            raise ValueError(f"the factored inverse needs post_input_size "
                             f"{pis} divisible by post_decimation {post}")
        super().__init__("fastddc_inv_dynamic_cc", n_channels)
        self.m = pis // post
        self.register_buffer("w", _c64(channel_factored2_arrays(ddc,
                                                                [0.0])[1]))

    def _k4(self, phases, spectra, tq, d, cyc):
        """K4 with this call's rows and the float32 frame ramp."""
        _check_rows(self.name, self.n_channels, tq=tq, d=d, cyc=cyc)
        b = spectra.shape[0]
        y = fastddc_cuda.fastddc_inv(
            spectra.contiguous(), tq.contiguous(), self.w, d.contiguous(),
            _rotate(phases, _frame_ramp(b, cyc)), self.m)
        return (_advance(phases, b, cyc),
                VarOut(y.reshape(self.n_channels, b * self.m), b * self.m))

    def forward(self, phases, spectra, tq, d, cyc):
        return self._k4(phases, spectra, tq, d, cyc)

    def state_from_jax(self, leaves):
        phases = self._phases_from_jax(leaves)
        leaves.matches_packed_w(self.w, f"{self.name} W")
        return phases


def fastddc_inv_dynamic_factored_block(ddc: FastDDC, n_channels: int,
                                       precision: str = "HIGH"):
    """See :class:`FastddcInvDynamicFactoredBlock`.  ``precision`` keeps
    csdr_tpu's signature and changes nothing (K4 is 3xTF32 on the card,
    float32 on the CPU)."""
    _check_precision(precision)
    return FastddcInvDynamicFactoredBlock(ddc, n_channels)


class FastddcDynamicChannelizerBlock(FastddcInvDynamicFactoredBlock):
    """The dynamic fused channelizer (divisible post only), csdr_tpu's
    ``fastddc_dynamic_channelizer_block``: wideband chunk in, per-channel
    baseband out, called as ``block((tail, phases), x, tq2, d, cyc)`` with
    the rows of :func:`dynamic_channelizer_rows`.  Overlap framing, the
    subsequence-split DFT as one ``torch.matmul`` (TF32 off), then K4.  The
    split-DFT matrix and W are buffers.  State: (tail, phases)."""

    def __init__(self, ddc: FastDDC, n_channels: int):
        super().__init__(ddc, n_channels)
        self.name = "fastddc_dynamic_channelizer_cc"
        self.ddc = ddc
        self.register_buffer("wdft", _c64(channelizer_arrays(ddc,
                                                             [0.0])[1]))

    def init(self, device="cuda"):
        dev = resolve_device(device)
        return (torch.zeros(self.ddc.overlap_length, dtype=torch.complex64,
                            device=dev), super().init(dev))

    def forward(self, state, x, tq2, d, cyc):
        tail, phases = state
        ddc = self.ddc
        ov, ins = ddc.overlap_length, ddc.input_size
        b = _frames_in(x, ins)
        n = b * ins
        frames = overlap_frames(x, tail, ins, ov)
        x6 = frames.reshape(b, ddc.fft_inv_size, ddc.pre_decimation
                            ).transpose(1, 2)
        with full_f32_matmul():
            s = torch.matmul(x6, self.wdft).reshape(b, ddc.fft_size)
        phases, out = self._k4(phases, s, tq2, d, cyc)
        return (x[n - ov:].clone(), phases), out

    def state_from_jax(self, leaves):
        tail = leaves.complex((self.ddc.overlap_length,), f"{self.name} tail")
        phases = self._phases_from_jax(leaves)
        leaves.matches(self.wdft, f"{self.name} Wdft")
        leaves.matches_packed_w(self.w, f"{self.name} W")
        return tail, phases


def fastddc_dynamic_channelizer_block(ddc: FastDDC, n_channels: int,
                                      precision: str = "HIGH"):
    """See :class:`FastddcDynamicChannelizerBlock`; ``precision`` as for
    :func:`fastddc_inv_dynamic_factored_block`."""
    _check_precision(precision)
    return FastddcDynamicChannelizerBlock(ddc, n_channels)
