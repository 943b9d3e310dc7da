"""Fractional (floating-rate) decimation via Lagrange polynomial
interpolation (counterpart of csdr_tpu.ops.resamp; reference
fractional_decimator_ff, libcsdr.c:715-793).

Variable-rate output under csdr_tpu's framing: each chunk is appended to a
fixed-size carried tail, the block emits a VarOut of fixed capacity whose
count is what the reference would have produced, and the carry keeps the
reference's ``input_processed``/``where`` bookkeeping.

The count and the carried occupancy and position depend only on the state
and the chunk length, never on the samples.  They are computed on the host
with csdr_tpu's float32 arithmetic (numpy float32), kept as 0-dim CPU
tensors, and every start index is a host int: a chunk needs no device sync.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core.block import Block, VarOut, resolve_device
from csdr_tpu_torch.ops.fir import apply_real_fir_ff


def _lagrange_denominators(num_poly_points: int) -> np.ndarray:
    """poly_precalc_denomiator (reference libcsdr.c:726-739)."""
    p = num_poly_points & ~1
    xifirst = -(p // 2) + 1
    xilast = p // 2
    xs = np.arange(xifirst, xilast + 1, dtype=np.float64)
    den = np.ones(p, dtype=np.float64)
    for i, xi in enumerate(xs):
        for xj in xs:
            if xi != xj:
                den[i] *= (xi - xj)
    return den.astype(np.float32)


def _rational_den(rate: float, max_den: int = 64) -> int | None:
    """Smallest q <= max_den with rate*q integral (f64), else None."""
    for q in range(1, max_den + 1):
        if abs(rate * q - round(rate * q)) < 1e-9 * max(1.0, abs(rate * q)):
            return q
    return None


class _FracDecimatorBase(Block):
    """Shared state layout: (tail (margin,) float32 on the stream's device,
    occ int32 0-dim CPU, where float32 0-dim CPU)."""

    rate_ratio = None

    def __init__(self, rate, p, taps, margin):
        super().__init__("fractional_decimator_ff")
        self.rate = float(rate)
        self.p = p
        self.xifirst = -(p // 2) + 1
        self.taps = None if taps is None else np.asarray(taps, np.float32)
        self.t_len = 0 if taps is None else len(self.taps)
        self.margin = margin

    def init(self, device="cuda"):
        return (torch.zeros(self.margin, dtype=torch.float32,
                            device=resolve_device(device)),
                torch.tensor(0, dtype=torch.int32),
                torch.tensor(-self.xifirst, dtype=torch.float32))

    def _xcat(self, tail, x, pad_extra):
        """[tail | x | zeros] and its prefiltered stream."""
        xcat = torch.cat([tail, x.float(),
                          x.new_zeros(pad_extra, dtype=torch.float32)])
        pre = xcat if self.taps is None else apply_real_fir_ff(xcat,
                                                               self.taps)
        return xcat, pre

    def _carry(self, xcat, n, size, input_processed, new_where):
        return (xcat[n: n + self.margin].clone(),
                torch.tensor(size - input_processed, dtype=torch.int32),
                torch.tensor(new_where, dtype=torch.float32))


class FractionalDecimatorBlock(_FracDecimatorBase):
    """Generic and integer-rate paths (csdr_tpu ops/resamp.py:43-167)."""

    def __init__(self, rate, p, taps):
        t_len = 0 if taps is None else len(taps)
        super().__init__(rate, p, taps, p + t_len + int(np.ceil(rate)) + 4)
        xs = np.arange(self.xifirst, p // 2 + 1, dtype=np.float32)
        self.register_buffer("xs", torch.from_numpy(xs))
        self.register_buffer("den",
                             torch.from_numpy(_lagrange_denominators(p)))

    def forward(self, state, x):
        n = x.shape[0]
        rate32 = np.float32(self.rate)
        p, t_len, xifirst = self.p, self.t_len, self.xifirst
        cap = int(n / self.rate) + 2
        tail, occ, where = state
        occ, where = int(occ), np.float32(where)
        base = self.margin - occ
        size = occ + n
        # the same static pad as csdr_tpu, so every read below is in range
        r_ceil = int(np.ceil(self.rate))
        cap_read = -(-cap // 128) * 128
        pad_extra = max(16, cap_read * r_ceil - n + p + t_len + r_ceil + 16)
        xcat, pre = self._xcat(tail, x, pad_extra)
        # output count, host-side float32 as csdr_tpu computes it
        wh = where + np.arange(cap, dtype=np.float32) * rate32
        count = int(np.sum(np.ceil(wh).astype(np.int32) + p + t_len < size))
        dev = x.device
        if self.rate.is_integer():
            # integer rate: wh stays integral, the Lagrange weights are
            # exactly one-hot and y[k] = pre[s0 + k*rate]
            r = int(self.rate)
            s0 = int(np.ceil(where)) - xifirst + base
            y = pre[s0: s0 + cap * r: r].clone()
            if y.shape[0] != cap:
                raise AssertionError(f"subsample read {y.shape[0]} of {cap}")
        else:
            whd = (torch.arange(cap, dtype=torch.float32, device=dev)
                   * float(rate32) + float(where))
            fd_low = torch.ceil(whd).to(torch.int64) - 1
            xwhere = whd - fd_low.float()
            diff = xwhere[:, None] - self.xs[None, :]      # (cap, p)
            cols = []
            for i in range(p):
                keep = [j for j in range(p) if j != i]
                cols.append(torch.prod(diff[:, keep], dim=1))
            coeffs = torch.stack(cols, dim=1) / self.den[None, :]
            gidx = (base + fd_low)[:, None] + torch.arange(p, device=dev)
            gidx = gidx.clamp(0, pre.shape[0] - 1)
            y = torch.sum(coeffs * pre[gidx], dim=1)
        y[count:] = 0.0
        # loop-exit carry (reference libcsdr.c:789-792), clamped >= 0
        adv = np.float32(np.float32(count) * rate32)
        ih_exit = int(np.ceil(np.float32(where + adv)))
        input_processed = max((ih_exit - 1) + xifirst, 0)
        new_where = np.float32(np.float32(where + adv)
                               - np.float32(input_processed))
        return (self._carry(xcat, n, size, input_processed, new_where),
                VarOut(y, count))


class RationalFractionalDecimatorBlock(_FracDecimatorBase):
    """Rate num/den (den <= 64): each of the den output phase classes has
    fixed Lagrange coefficients (host float64 constants), so output
    k = j*den + qc is y = sum_i c_qc[i] * pre[W-1 + j*num + off_qc + i].
    Emission is quantized to multiples of den per chunk so the carried
    ``where`` stays integral (csdr_tpu ops/resamp.py:170-284)."""

    def __init__(self, rate, q_den, p, taps):
        t_len = 0 if taps is None else len(taps)
        margin = p + t_len + int(np.ceil(rate)) + 4
        # up to (q_den-1)*rate extra input samples stay buffered
        margin += int(np.ceil((q_den - 1) * rate)) + 2
        super().__init__(rate, p, taps, margin)
        self.q_den = q_den
        self.num = num = int(round(rate * q_den))
        den_np = _lagrange_denominators(p).astype(np.float64)
        xs64 = np.arange(self.xifirst, p // 2 + 1, dtype=np.float64)
        offs, coefs = [], []
        for qc in range(q_den):
            whf = qc * num / q_den
            off = int(np.ceil(whf))
            xw = whf - off + 1.0
            c = np.array([np.prod(xw - np.delete(xs64, i)) for i in range(p)])
            offs.append(off)
            coefs.append((c / den_np).astype(np.float32))
        self.offs = offs
        self.register_buffer("coefs",
                             torch.from_numpy(np.stack(coefs)))  # (q_den, p)
        # csdr_tpu's slab geometry, kept for its input pad rule
        self.g_grp = max(1, -(-128 // q_den))
        self.slab_len = (self.g_grp - 1) * num + max(offs) + p

    def forward(self, state, x):
        n = x.shape[0]
        rate32 = np.float32(self.rate)
        p, t_len, q, num = self.p, self.t_len, self.q_den, self.num
        # +q headroom: emission floors to whole den-classes, leaving up to
        # q-1 outputs buffered, which the next chunk must be able to drain
        cap = int(n / self.rate) + q + 2
        rows = -(-cap // (self.g_grp * q))
        tail, occ, where = state
        occ, where = int(occ), np.float32(where)
        base = self.margin - occ
        size = occ + n
        rd = self.g_grp * num
        n_slices = -(-self.slab_len // rd)
        ps_len = (n_slices - 1 + rows) * rd
        pad_extra = max(16, ps_len - n + p + t_len + 16)
        xcat, pre = self._xcat(tail, x, pad_extra)
        w_int = int(np.round(where))
        b0 = base + max(w_int - 1, 0)
        jn = -(-cap // q)                       # output groups of q classes
        coefs = self.coefs
        ys = []
        for qc in range(q):
            s = b0 + self.offs[qc]
            frames = pre[s: s + (jn - 1) * num + p].unfold(0, p, num)
            ys.append(torch.sum(frames * coefs[qc], dim=1))
        y = torch.stack(ys, dim=1).reshape(-1)[:cap].clone()
        # validity: index_high + p + t_len < size, in whole den-classes
        wh = where + np.arange(cap, dtype=np.float32) * rate32
        count_all = int(np.sum(np.ceil(wh).astype(np.int32) + p + t_len
                               < size))
        count = (count_all // q) * q
        y[count:] = 0.0
        # carry: count*rate = (count/den)*num is an exact integer
        cnum = (count // q) * num
        input_processed = max((w_int + cnum - 1) + self.xifirst, 0)
        new_where = np.float32(np.float32(where + np.float32(cnum))
                               - np.float32(input_processed))
        return (self._carry(xcat, n, size, input_processed, new_where),
                VarOut(y, count))


def fractional_decimator_block(rate: float, num_poly_points: int = 12,
                               taps=None,
                               rational: bool | None = None) -> Block:
    """Streaming fractional decimator; emits VarOut (capacity ~ N/rate + 2).

    taps: optional prefilter FIR (the reference applies fir_one_pass_ff at
    each interpolation point, libcsdr.c:769-772: equivalently a valid-mode
    FIR of the buffer, then the interpolator on the filtered stream).

    rational: for rate = num/den (den <= 64 detected from the f64 rate) the
    per-class fixed-coefficient path; None = auto-detect, False forces the
    generic path.  Integer rates take the exact one-hot subsample."""
    if not rate > 1.0:
        raise ValueError("can't fractionally decimate rate <= 1.0")
    p = num_poly_points & ~1
    q_den = None
    if rational is not False and not float(rate).is_integer() and p >= 4:
        q_den = _rational_den(rate)
    if q_den is not None:
        return RationalFractionalDecimatorBlock(rate, q_den, p, taps)
    return FractionalDecimatorBlock(rate, p, taps)
