"""Carrier and timing recovery loops: PLL, BPSK Costas loop, Gardner and
early-late timing recovery (counterpart of csdr_tpu.ops.sync).

These are serial per-sample (or per-symbol) nonlinear feedback loops.
csdr_tpu runs each as a ``lax.scan`` and ``vmap``s it over channels; here
each is a Python loop of torch ops over a leading batch axis (one row per
channel), plain torch with no kernel of its own.  No step reads a value
back to the host: masks run every step of a fixed count, and data-
dependent counts stay on the device.

The timing recovery loop has no transcendental and gives csdr_tpu's
symbols, errors, indexes and carried state bit for bit.  The PLL and the
Costas loop evaluate sin/cos/atan2 every sample inside their feedback, and
torch's and XLA's transcendentals differ in the last bits, so they follow
csdr_tpu to a stated SNR, not bit for bit.  csdr_tpu's ``rowslice`` pick
(``CSDR_TED_ROWSLICE``) is a TPU gather-domain layout with outputs equal
to the gather's; the port has the gather only.
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch.core.block import Block, VarOut, resolve_device

TWO_PI = 2.0 * np.pi
_INT32_MAX = int(np.iinfo(np.int32).max)


def _wrap_pi(p: torch.Tensor) -> torch.Tensor:
    """while(p>pi) p-=2pi; while(p<-pi) p+=2pi;"""
    return torch.remainder(p + np.pi, TWO_PI) - np.pi


def _fma_f32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """x*y + z rounded once to float32, as the fused multiply-add that
    XLA's CPU backend contracts ``a*b + c*d`` into (``fma(a, b, c*d)``).
    The product is exact in float64; the sum is rounded to odd there (an
    inexact sum with an even last bit moves one ulp towards the exact
    value, whose error TwoSum gives), and rounding that to float32 is the
    correctly rounded fma (Boldo and Melquiond, "Emulation of FMA and
    correctly rounded sums: proved algorithms using rounding to odd",
    2008).  Separate torch ops in float64: the same bits on the CPU and
    on the card."""
    p = x.double() * y.double()
    z = z.double()
    s = p + z
    bb = s - p
    e = (p - (s - bb)) + (z - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((e != 0) & even, torch.nextafter(s, e * np.inf), s)
    return s.float()


def _loop_state(state, shape, device) -> tuple:
    """Three float32 loop scalars per row, from numbers or tensors."""
    return tuple(torch.as_tensor(v, dtype=torch.float32, device=device
                                 ).expand(shape).clone() for v in state)


# --------------------------------------------------------------------------
# PLL (reference libcsdr.c:1844-1915)
# --------------------------------------------------------------------------

def pll_loop_params(bandwidth: float, ko: float = 10.0, kd: float = 0.1,
                    damping_factor: float = 0.707):
    """PI controller gains (reference pll_cc_init_pi_controller,
    libcsdr.c:1849-1858; reference CLI defaults ko=10, kd=0.1, csdr.c:2546)."""
    bw = TWO_PI * bandwidth
    alpha = (damping_factor * 2 * bw) / (ko * kd)
    beta = (bw * bw) / (ko * kd)
    return alpha, beta


def pll_cc(x: torch.Tensor, alpha: float, beta: float | None = None,
           state=(0.0, 0.0, 0.0)):
    """PLL: atan2 phase detector, P or PI loop filter (reference pll_cc,
    libcsdr.c:1870-1915), over complex64 ``x`` (..., n).  beta=None is the
    P controller.  Returns (dphase_out, nco complex64, state'), state =
    (output_phase, dphase, iir) per row.  The reference NCO is sin + j*cos
    and its detector atan2(i, q), mirrored exactly."""
    output_phase, dphase, iir = _loop_state(state, x.shape[:-1], x.device)
    re, im = x.real, x.imag
    dph, nr, ni = [], [], []
    for i in range(x.shape[-1]):
        output_phase = _wrap_pi(output_phase + dphase)
        nr.append(torch.sin(output_phase))
        ni.append(torch.cos(output_phase))
        input_phase = torch.atan2(re[..., i], im[..., i])
        new_dphase = _wrap_pi(input_phase - output_phase)
        if beta is None:
            dphase = new_dphase * alpha
        else:
            dphase = _wrap_pi(new_dphase * alpha + iir)
            iir = iir + new_dphase * beta
        dph.append(-dphase)
    nco = torch.complex(torch.stack(nr, -1), torch.stack(ni, -1))
    return torch.stack(dph, -1), nco, (output_phase, dphase, iir)


class PllBlock(Block):
    """pll_cc as a block: output 'dphase' (float32) or 'nco' (complex64).
    State: (output_phase, dphase, iir), float32 per row."""

    def __init__(self, alpha: float, beta: float | None, output: str):
        super().__init__("pll_cc")
        self.alpha, self.beta, self.output = alpha, beta, output

    def init(self, device="cuda", shape=()):
        dev = resolve_device(device)
        return _loop_state((0.0, 0.0, 0.0), shape, dev)

    def forward(self, state, x):
        dph, nco, state = pll_cc(x, self.alpha, self.beta, state)
        return state, dph if self.output == "dphase" else nco


def pll_block(bandwidth: float = 0.01, pi_controller: bool = True,
              output: str = "dphase") -> Block:
    alpha, beta = pll_loop_params(bandwidth)
    if not pi_controller:
        alpha, beta = bandwidth, None   # P controller: alpha given directly
    return PllBlock(alpha, beta, output)


# --------------------------------------------------------------------------
# BPSK Costas loop (reference libcsdr.c:2094-2142)
# --------------------------------------------------------------------------

def costas_loop_params(bandwidth: float = 0.01, damping_factor: float = 0.707):
    """alpha/beta from bandwidth and damping (reference
    init_bpsk_costas_loop_cc, libcsdr.c:2094-2106).  ``bandwidth`` is the
    reference's parameter before the 2*pi (0.01 means omega = 2*pi*0.01)."""
    bw = TWO_PI * bandwidth
    denom = 1 + 2 * damping_factor * bw + bw * bw
    alpha = (4 * damping_factor * bw) / denom
    beta = (4 * bw * bw) / denom
    return alpha, beta, bw


def bpsk_costas_loop_cc(x: torch.Tensor, alpha, beta, dphase_max,
                        decision_directed: bool = False,
                        dphase_max_reset_to_zero: bool = False,
                        state=(0.0, 0.0, 0.0)):
    """Costas loop (reference bpsk_costas_loop_cc, libcsdr.c:2108-2142) over
    complex64 ``x`` (..., n); state = (nco_phase, current_freq, dphase) per
    row.  Returns (y complex64, error, dphase_out, state')."""
    nco_phase, freq, dphase = _loop_state(state, x.shape[:-1], x.device)
    re, im = x.real, x.imag
    yr, yi, errs, dphs = [], [], [], []
    for i in range(x.shape[-1]):
        nco_re = torch.cos(nco_phase)
        nco_im = torch.sin(nco_phase)
        xr, xi = re[..., i], im[..., i]
        y_re = xr * nco_re - xi * nco_im
        y_im = xr * nco_im + xi * nco_re
        if decision_directed:
            op = torch.atan2(y_im, y_re)
            error = torch.where(torch.abs(op) < np.pi / 2, -op,
                                _wrap_pi(np.pi - op))
        else:
            error = np.pi * y_re * y_im
        freq = freq + error * beta
        dphase = error * alpha + freq
        if dphase_max_reset_to_zero:
            dphase = torch.where(torch.abs(dphase) > dphase_max, 0.0, dphase)
        else:
            dphase = torch.clamp(dphase, -dphase_max, dphase_max)
        # while(nco_phase > 2pi) -= 2pi; while(nco_phase <= 0) += 2pi
        nco_phase = torch.remainder(nco_phase + dphase, TWO_PI)
        nco_phase = torch.where(nco_phase <= 0, nco_phase + TWO_PI, nco_phase)
        yr.append(y_re)
        yi.append(y_im)
        errs.append(error)
        dphs.append(dphase)
    y = torch.complex(torch.stack(yr, -1), torch.stack(yi, -1))
    return (y, torch.stack(errs, -1), torch.stack(dphs, -1),
            (nco_phase, freq, dphase))


class CostasBlock(Block):
    """The Costas loop as a block.  State: (nco_phase, freq, dphase),
    float32 per row."""

    def __init__(self, alpha, beta, dphase_max, decision_directed: bool):
        super().__init__("bpsk_costas_loop_cc")
        self.params = (alpha, beta, dphase_max)
        self.decision_directed = decision_directed

    def init(self, device="cuda", shape=()):
        dev = resolve_device(device)
        return _loop_state((0.0, 0.0, 0.0), shape, dev)

    def forward(self, state, x):
        y, _e, _d, state = bpsk_costas_loop_cc(
            x, *self.params, self.decision_directed, state=state)
        return state, y


def costas_block(bandwidth: float = 0.01, damping: float = 0.707,
                 decision_directed: bool = False) -> Block:
    return CostasBlock(*costas_loop_params(bandwidth, damping),
                       decision_directed)


# --------------------------------------------------------------------------
# Gardner / early-late timing recovery (reference libcsdr.c:1960-2072)
# --------------------------------------------------------------------------

GARDNER = "GARDNER"
EARLYLATE = "EARLYLATE"


def _shift_left(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each row of ``a`` shifted left by its ``k``, zero-filled (the last
    axis keeps its size)."""
    n = a.shape[-1]
    idx = torch.arange(n, device=a.device) + k[..., None].to(torch.int64)
    got = torch.gather(a, -1, torch.clamp(idx, max=n - 1))
    return torch.where(idx < n, got, torch.zeros((), dtype=a.dtype,
                                                 device=a.device))


class TimingRecoveryBlock(Block):
    """Non-data-aided symbol synchronizer (reference timing_recovery_cc,
    libcsdr.c:1977-2072); ``decimation`` = samples/symbol, divisible by 4.

    The stride is data-dependent (bitstart += decimation + correction), so
    each chunk runs ``cap = (n + margin)//decimation + 2`` symbol slots
    over ``[tail | x]`` with an ``alive`` mask, and the outputs are VarOut
    with a device count per row.  output: 'symbols' (complex64), 'error'
    (float32) or 'indexes' (int32, relative to the first unconsumed
    sample, the reference's buffer origin).

    Input: complex64 (n,) or (C, n); the state follows: (tail (margin,)
    or (C, margin) complex64, occ int32, corr int32), margin = 4*decimation,
    the valid tail right-aligned at tail[margin-occ:].  Each chunk's new
    tail is the buffer's last margin samples: anything earlier is consumed,
    or, for a loop railed hard enough to fall behind, dropped oldest.

    segments > 1 is csdr_tpu's overlap-discard segmented mode: the chunk's
    sample range split into ``segments`` spans run as parallel rows, each
    after the first starting ``warmup_symbols`` symbols early and
    discarding them, each overrunning its span by one symbol, seams
    deduplicated, the emissions packed back to back.  A chunk that cannot
    give every segment ``warmup_symbols`` symbols runs serially.
    """

    rate_ratio = None

    def __init__(self, algorithm: str, decimation: int, loop_gain: float,
                 max_error: float, use_q: bool, output: str, segments: int,
                 warmup_symbols: int):
        super().__init__("timing_recovery_cc")
        if decimation % 4:
            raise ValueError("decimation must be divisible by 4")
        if segments < 1:
            raise ValueError(f"segments {segments} < 1")
        if output not in ("symbols", "error", "indexes"):
            raise ValueError(f"output {output!r}")
        self.nsb = nsb = decimation
        self.nshb = nshb = decimation // 2
        self.nsqb = decimation // 4
        wing = int(nsb * 0.25)          # earlylate_ratio = 0.25 (:1971)
        self.gardner = algorithm.upper() == GARDNER
        self.err_sign = -1.0 if self.gardner else 1.0
        self.margin = 4 * nsb
        self.loop_gain, self.max_error, self.use_q = loop_gain, max_error, use_q
        self.output, self.segments, self.warm = output, segments, warmup_symbols
        # picks relative to bitstart, (right, left, mid); the symbol is
        # left for Gardner, mid for early-late (reference :2006-2031)
        if self.gardner:
            self.offs, self.out_slot = (nshb * 3, nshb, nshb * 2), 1
        else:
            self.offs, self.out_slot = (wing * 3, wing, nshb), 2

    def init(self, device="cuda", channels: int | None = None):
        """Zero history for one stream, or for ``channels`` rows."""
        dev = resolve_device(device)
        lead = () if channels is None else (channels,)
        return (torch.zeros(lead + (self.margin,), dtype=torch.complex64,
                            device=dev),
                torch.zeros(lead, dtype=torch.int32, device=dev),
                torch.zeros(lead, dtype=torch.int32, device=dev))

    def state_from_jax(self, leaves):
        """csdr_tpu's (tail re, tail im, occ, corr) leaves, one stream or
        vmapped over channels (a leading axis on every leaf)."""
        lead = leaves.next_shape()[:-1]
        return leaves.like(self.init(leaves.device,
                                     lead[0] if lead else None))

    # -- the symbol loop ---------------------------------------------------

    def _scan(self, planes, size, bitstart, corr, cap, span_hi=None,
              emit_lo=None):
        """``cap`` symbol slots for every row of ``bitstart`` (R, ...) over
        the buffer ``planes`` (R, 2*size), interleaved re/im.  Returns the
        final (bitstart, corr) and the per-slot (v (..., cap, 3, 2),
        raw error, bitstart at the slot, emit)."""
        nsb, nshb, nsqb = self.nsb, self.nshb, self.nsqb
        dev = planes.device
        lead = bitstart.shape
        rows = lead[0]
        offs = torch.tensor(self.offs, dtype=torch.int32, device=dev)
        sel = torch.tensor((0, 1, 0), dtype=torch.int32, device=dev)
        reim = torch.arange(2, dtype=torch.int64, device=dev)
        gain = nshb * self.err_sign
        alive = torch.ones(lead, dtype=torch.bool, device=dev)
        vs, errs, starts, emits = [], [], [], []
        for _ in range(cap):
            alive = alive & (bitstart + nshb * 3 < size)
            if span_hi is not None:
                alive = alive & (bitstart < span_hi)
            # correction reset (reference :2000-2004)
            corr = torch.where((corr <= -nsqb * 0.9) | (corr >= 0.9 * nsqb),
                               0, corr)
            gi = bitstart[..., None] + offs
            if not self.gardner:
                gi = gi - corr[..., None] * sel
            gi = torch.clamp(gi, 0, size - 1)
            at = (gi.to(torch.int64)[..., None] * 2 + reim).reshape(rows, -1)
            v = torch.gather(planes, 1, at).reshape(lead + (3, 2))
            diff = v[..., 0, :] - v[..., 1, :]
            if self.use_q:      # (d_re + d_im) / 2, d_re's product fused
                error = _fma_f32(diff[..., 0], v[..., 2, 0],
                                 diff[..., 1] * v[..., 2, 1]) / 2
            else:
                error = diff[..., 0] * v[..., 2, 0]
            raw_error = error
            error = torch.clamp(error, -self.max_error, self.max_error)
            # err_sign * error * loop_gain, left to right, truncated
            new_corr = (gain * error * self.loop_gain).to(torch.int32)
            vs.append(v)
            errs.append(raw_error)
            starts.append(bitstart)
            emits.append(alive if emit_lo is None
                         else alive & (bitstart >= emit_lo))
            bitstart = torch.where(alive, bitstart + nsb + new_corr, bitstart)
            corr = torch.where(alive, new_corr, corr)
        return (bitstart, corr, torch.stack(vs, -3), torch.stack(errs, -1),
                torch.stack(starts, -1), torch.stack(emits, -1))

    def _pick_output(self, v, errs, starts, emits, s0):
        """The requested output of every slot, zero where not emitted."""
        if self.output == "symbols":
            sym = v[..., self.out_slot, :]
            sym = torch.where(emits[..., None], sym, torch.zeros((), device=
                                                                 sym.device))
            return [sym[..., 0], sym[..., 1]]
        if self.output == "error":
            return [torch.where(emits, errs, 0.0)]
        # indexes relative to the first unconsumed sample: the reference's
        # buffer origin after its memmove (csdr.c:2641-2642)
        return [torch.where(emits, starts + self.nshb - s0, 0)]

    def _data(self, parts):
        if self.output == "symbols":
            return torch.complex(*parts)
        return parts[0].to(torch.int32) if self.output == "indexes" \
            else parts[0]

    def _segmented(self, planes, size, n, s0, corr0):
        """The segmented mode over rows (R,): S spans a row, run as (R, S)."""
        s_count, warm, nsb, nshb = self.segments, self.warm, self.nsb, \
            self.nshb
        dev = planes.device
        span = torch.div(size - s0, s_count, rounding_mode="floor")
        cap_seg = (n + self.margin) // (s_count * nsb) + warm + 4
        s_idx = torch.arange(s_count, dtype=torch.int32, device=dev)
        emit_lo = s0[:, None] + s_idx * span[:, None]             # (R, S)
        # each non-last segment overruns its span by one symbol so the seam
        # gap is covered by its predecessor; the dedup below removes the
        # successor's overlapping leading emissions
        span_hi = torch.where(s_idx == s_count - 1, _INT32_MAX,
                              emit_lo + span[:, None] + nsb).to(torch.int32)
        bs0 = torch.maximum(emit_lo - warm * nsb, s0[:, None])
        corr_init = torch.where(s_idx == 0, corr0[:, None], 0
                                ).to(torch.int32)
        bse, cre, v, errs, starts, emits = self._scan(
            planes, size, bs0, corr_init, cap_seg, span_hi, emit_lo)
        # a segment's emissions are one contiguous run (bitstart is
        # monotone): shift each run to its segment's front, then pack the
        # runs back to back
        counts = emits.to(torch.int32).sum(-1, dtype=torch.int32)
        first = torch.argmax(emits.to(torch.int32), -1).to(torch.int32)
        data_seg = self._pick_output(v, errs, starts, emits, s0[:, None, None])
        # seam dedup: drop a segment's leading symbols within nsb/2 of its
        # predecessor's last emission
        pos = torch.where(emits, starts + nshb, _INT32_MAX).to(torch.int32)
        p_first = _shift_left(pos, first)
        last_slot = torch.clamp(counts - 1, min=0).to(torch.int64)
        p_last = torch.gather(p_first, -1, last_slot[..., None])[..., 0]
        p_last = torch.where(counts > 0, p_last, -nshb - 1)
        thr = torch.cat([torch.full_like(p_last[:, :1], -1),
                         p_last[:, :-1] + nshb], 1)
        slot = torch.arange(cap_seg, device=dev)
        k_dup = ((p_first <= thr[..., None]) & (slot < counts[..., None])
                 ).to(torch.int32).sum(-1, dtype=torch.int32)
        first = first + k_dup
        counts = counts - torch.minimum(k_dup, counts)
        off = torch.cumsum(counts, 1, dtype=torch.int32) - counts   # (R, S)
        rows = s0.shape[0]

        def pack(a):
            rolled = _shift_left(a, first)                 # (R, S, cap_seg)
            out = torch.zeros((rows, s_count * cap_seg), dtype=a.dtype,
                              device=dev)
            for s in range(s_count):    # later segments overwrite in order
                at = off[:, s:s + 1].to(torch.int64) + slot
                out.scatter_(1, at, rolled[:, s])
            return out

        data = self._data([pack(p) for p in data_seg])
        count = counts.sum(1, dtype=torch.int32)
        return bse[:, -1], cre[:, -1], data, count

    def forward(self, state, x):
        tail, occ, corr0 = state
        one = x.dim() == 1
        if one:
            x, tail, occ, corr0 = x[None], tail[None], occ[None], corr0[None]
        n = x.shape[-1]
        margin, nsb = self.margin, self.nsb
        # buffer = [tail (margin,) | x]; the valid region is
        # [margin - occ, margin + n), s0 its start
        xcat = torch.cat([tail, x], -1)
        size = margin + n
        s0 = margin - occ
        planes = torch.view_as_real(xcat).reshape(xcat.shape[0], 2 * size)
        # a chunk too short to give every segment warmup_symbols symbols
        # (a bound on n alone: occ may be 0) runs serially
        if self.segments > 1 and n // (self.segments * nsb) >= self.warm:
            bitstart, corr, data, count = self._segmented(planes, size, n, s0,
                                                          corr0)
        else:
            cap = (n + margin) // nsb + 2
            bitstart, corr, v, errs, starts, emits = self._scan(
                planes, size, s0, corr0, cap)
            count = emits.to(torch.int32).sum(-1, dtype=torch.int32)
            data = self._data(self._pick_output(v, errs, starts, emits,
                                                s0[:, None]))
        # consume bitstart samples (reference input_processed, :2068-2070)
        new_occ = torch.clamp(size - bitstart, 0, margin).to(torch.int32)
        new_state = (xcat[:, n:], new_occ, corr.to(torch.int32))
        if one:
            new_state = tuple(t[0] for t in new_state)
            data, count = data[0], count[0]
        return new_state, VarOut(data, count)


def timing_recovery_block(algorithm: str, decimation: int,
                          loop_gain: float = 0.5, max_error: float = 2.0,
                          use_q: bool = False, output: str = "symbols",
                          segments: int = 1,
                          warmup_symbols: int = 32) -> Block:
    """Gardner or early-late timing recovery (see TimingRecoveryBlock)."""
    return TimingRecoveryBlock(algorithm, decimation, loop_gain, max_error,
                               use_q, output, segments, warmup_symbols)
