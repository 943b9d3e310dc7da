"""FIR filtering and integer-ratio resampling (counterpart of
csdr_tpu.ops.fir).

Reference semantics:

- ``fir_decimate_cc`` libcsdr.c:528-549, a real-tap FIR at stride D over
  complex input in valid mode, y[k] = sum_t x[k*D+t] * taps[t];
- ``fir_interpolate_cc`` libcsdr.c:579-604, the polyphase zero-stuffed
  FIR with the reference's tistart=(I-ip) tap-phase convention;
- ``rational_resampler_ff`` libcsdr.c:607-662, I/D polyphase with the
  carried ``last_taps_delay`` and its (T-delay)/I tap truncation;
- ``apply_fir_cc`` / ``apply_real_fir_cc`` libcsdr.c:2261-2291.

Stream framing is csdr_tpu's exactly: a streaming block keeps a zero-init
input tail of round_up(T-1, D) samples, so each chunk of N (N % D == 0)
gives exactly N/D outputs, and the first tail_len/D outputs are the
zero-history warmup.  On the card each chunk is ONE kernel launch over the
carried tail and the chunk (kernels/fir_cuda.py): the TPU package's
head/body/tail split exists only because its Pallas blocks are row-aligned,
and is not carried over.

The interpolator, the resampler and the stride-1 FIRs are plain XLA
products in csdr_tpu (``jnp.dot`` over a frames view, a grouped conv), no
Pallas kernel, so here they are ``torch.matmul`` over ``unfold`` views, in
full float32 (:func:`~csdr_tpu_torch.core.precision.full_f32_matmul`).
csdr_tpu's Toeplitz-tile forms of the stride-1 FIRs are a TPU MXU layout of
the same sums and have no counterpart.

``precision``: "HIGHEST" and "HIGH" are both accepted; both compute in f32
FMA, at least as accurate as csdr_tpu's bf16x3 "HIGH".
"""

from __future__ import annotations

import numpy as np
import torch

from csdr_tpu_torch import firdes
from csdr_tpu_torch.core.block import Block, resolve_device
from csdr_tpu_torch.core.graph import carried_value
from csdr_tpu_torch.core.precision import full_f32_matmul
from csdr_tpu_torch.kernels import fir_cuda

DEFAULT_PRECISION = "HIGHEST"


def _round_up(a: int, m: int) -> int:
    return ((a + m - 1) // m) * m


def _taps_list(taps) -> list[float]:
    return [float(v) for v in np.asarray(taps, np.float32)]


def fir_decimate_cc(x: torch.Tensor, taps, decimation: int,
                    precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Stateless valid-mode decimating FIR (reference libcsdr.c:528-549).
    x: complex64 (N,); taps a float32 tensor or a sequence; returns
    floor((N-T)/D)+1 outputs.  On the card this is one launch of the
    fir_decimate kernel."""
    if not isinstance(taps, torch.Tensor):
        taps = np.asarray(taps, np.float32)
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    kout = max(0, (x.shape[0] - taps.shape[0]) // decimation + 1)
    empty = x.new_empty(0)
    return fir_cuda.fir_decimate(empty, x.contiguous(), taps, decimation,
                                 kout, precision)


def fir_decimate_ff(x: torch.Tensor, taps, decimation: int) -> torch.Tensor:
    """Real-input valid-mode decimating FIR."""
    kout = max(0, (x.shape[0] - len(taps)) // decimation + 1)
    return fir_cuda.strided_corr(x.float(), _taps_list(taps), decimation,
                                 kout)


def apply_real_fir_ff(x: torch.Tensor, taps) -> torch.Tensor:
    """Valid-mode real FIR: y[i] = sum_t taps[t] * x[i+t]
    (reference libcsdr.c:2276-2291, real form)."""
    return fir_decimate_ff(x, taps, 1)


class FirDecimateBlock(Block):
    """Streaming decimating FIR (complex64 in and out).

    State: zero-init tail of round_up(T-1, D) samples.  Output per chunk of
    N (N % D == 0): exactly N/D samples.  warmup_out = tail_len // D."""

    def __init__(self, taps, decimation: int, name: str = "fir_decimate_cc",
                 precision: str = DEFAULT_PRECISION):
        super().__init__(name)
        taps_np = np.asarray(taps, np.float32)
        self.decimation = int(decimation)
        self.tail_len = _round_up(len(taps_np) - 1, self.decimation)
        self.warmup_out = self.tail_len // self.decimation
        self.rate_ratio = 1.0 / self.decimation
        self.precision = precision
        self.register_buffer("taps", torch.from_numpy(taps_np.copy()))

    def init(self, device="cuda"):
        return torch.zeros(self.tail_len, dtype=torch.complex64,
                           device=resolve_device(device))

    def _new_tail(self, tail, x):
        n = x.shape[0]
        if n >= self.tail_len:
            return x[n - self.tail_len:].clone()
        return torch.cat([tail, x])[n:]

    def forward(self, tail, x):
        n = x.shape[0]
        if n % self.decimation:
            raise ValueError(f"chunk size {n} must be a multiple of "
                             f"decimation {self.decimation}")
        y = fir_cuda.fir_decimate(tail, x.contiguous(), self.taps,
                                  self.decimation, n // self.decimation,
                                  self.precision)
        return self._new_tail(tail, x), y


def fir_decimate_block(taps, decimation: int, name: str = "fir_decimate_cc",
                       precision: str = DEFAULT_PRECISION) -> Block:
    return FirDecimateBlock(taps, decimation, name, precision)


class ShiftedFirDecimateBlock(FirDecimateBlock):
    """NCO shift + decimating FIR as ONE stream block: the same function as
    shift_block(rate) | fir_decimate_block(taps, D), run on the card as one
    launch of the NCO-fused kernel over [tail | chunk].

    State: (theta, tail).  theta is the phase in cycles of tail[0], a
    float32 0-dim CPU tensor advanced with csdr_tpu's own float32 step
    (``_th``), so the carried phase tracks csdr_tpu's chunk for chunk;
    stream sample 0 starts at phase 0, as in the serial chain.  theta is a
    value leaf (core/graph.carried_value): a captured step's K1 reads it on
    the card."""

    def __init__(self, rate: float, taps, decimation: int,
                 name: str = "shift_fir_decimate_cc",
                 precision: str = DEFAULT_PRECISION):
        super().__init__(taps, decimation, name, precision)
        self.rate = float(rate)
        # phase of xcat[0] so that stream sample 0 (at xcat[tail_len]) is 0
        self.theta0 = float(np.mod(-np.float64(rate) * self.tail_len, 1.0))

    def init(self, device="cuda"):
        return (torch.tensor(self.theta0, dtype=torch.float32),
                super().init(device))

    def _th(self, theta, off: int) -> torch.Tensor:
        """theta + frac(rate*off) mod 1 in float32 — phase at xcat[off]."""
        step = np.float32(np.mod(np.float64(self.rate) * off, 1.0))
        return torch.tensor(np.mod(np.float32(theta) + step, np.float32(1.0)),
                            dtype=torch.float32)

    def forward(self, state, x):
        theta, tail = state
        n = x.shape[0]
        if n % self.decimation:
            raise ValueError(f"chunk size {n} must be a multiple of "
                             f"decimation {self.decimation}")
        th, th_next = carried_value(theta, lambda t: self._th(t, n))
        y = fir_cuda.shift_fir_decimate(
            tail, x.contiguous(), self.taps, self.decimation,
            n // self.decimation, self.rate, th, self.precision)
        return (th_next, self._new_tail(tail, x)), y


def shifted_fir_decimate_block(rate: float, taps, decimation: int,
                               name: str = "shift_fir_decimate_cc",
                               precision: str = DEFAULT_PRECISION) -> Block:
    return ShiftedFirDecimateBlock(rate, taps, decimation, name, precision)


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

def _interp_tap_matrix(taps: np.ndarray, interpolation: int) -> np.ndarray:
    """Hmat[s, ip] = taps[(I-ip) + s*I] (0 where out of range), so that
    y[i*I+ip] = sum_s x[i+s] * Hmat[s, ip]: the reference's tap-phase rule
    (libcsdr.c:579-604) with its tistart=(I-ip) convention."""
    t = len(taps)
    i_ = interpolation
    h = np.zeros(((t - 1) // i_ + 1, i_), np.float32)
    for ip in range(i_):
        ti, s = i_ - ip, 0
        while ti < t:
            h[s, ip] = taps[ti]
            ti += i_
            s += 1
    return h


def _frames(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Overlapping frames F[i, j] = x[i + j], shape (k, s): a view."""
    return x.unfold(0, s, 1)[:k]


def _planes_matmul(x: torch.Tensor, k: int, h: torch.Tensor) -> torch.Tensor:
    """frames(re) @ h and frames(im) @ h of a complex stream, each a
    float32 product, joined as complex64: (k, h.shape[1])."""
    s = h.shape[0]
    with full_f32_matmul():
        yr = torch.matmul(_frames(x.real, k, s), h)
        yi = torch.matmul(_frames(x.imag, k, s), h)
    return torch.complex(yr, yi)


def fir_interpolate_cc(x: torch.Tensor, taps, interpolation: int,
                       precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Stateless polyphase interpolator (reference libcsdr.c:579-604):
    (N - S + 1) * I outputs, S the frame length, as frames(N-S+1, S) @
    Hmat(S, I) a plane."""
    h = torch.from_numpy(_interp_tap_matrix(np.asarray(taps, np.float32),
                                            interpolation)).to(x.device)
    return _planes_matmul(x, x.shape[0] - h.shape[0] + 1, h).reshape(-1)


class FirInterpolateBlock(Block):
    """Streaming interpolator: the tail holds S-1 input samples; N in,
    N*I out; warmup_out = (S-1)*I."""

    def __init__(self, taps, interpolation: int,
                 name: str = "fir_interpolate_cc",
                 precision: str = DEFAULT_PRECISION):
        super().__init__(name)
        h = _interp_tap_matrix(np.asarray(taps, np.float32), interpolation)
        self.s = h.shape[0]
        self.warmup_out = (self.s - 1) * interpolation
        self.rate_ratio = float(interpolation)
        self.register_buffer("h", torch.from_numpy(h))

    def init(self, device="cuda"):
        return torch.zeros(self.s - 1, dtype=torch.complex64,
                           device=resolve_device(device))

    def forward(self, tail, x):
        n = x.shape[0]
        xcat = torch.cat([tail, x])
        return xcat[n:].clone(), _planes_matmul(xcat, n, self.h).reshape(-1)


def fir_interpolate_block(taps, interpolation: int,
                          name: str = "fir_interpolate_cc",
                          precision: str = DEFAULT_PRECISION) -> Block:
    return FirInterpolateBlock(taps, interpolation, name, precision)


def plain_interpolate_cc(x: torch.Tensor, interpolation: int) -> torch.Tensor:
    """Zero-stuffing only (reference libcsdr.c:2499-2506)."""
    y = x.new_zeros((x.shape[0], interpolation))
    y[:, 0] = x
    return y.reshape(-1)


# ---------------------------------------------------------------------------
# stride-1 FIRs
# ---------------------------------------------------------------------------

def _taps_on(taps, dtype, device) -> torch.Tensor:
    """Taps (a tensor, an array or a sequence) as a ``dtype`` tensor on
    ``device``."""
    if not isinstance(taps, torch.Tensor):
        taps = torch.from_numpy(np.asarray(
            taps, np.complex64 if dtype.is_complex else np.float32))
    return taps.to(device=device, dtype=dtype)


def apply_fir_cc(x: torch.Tensor, taps,
                 precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Valid-mode FIR with complex taps on complex input (reference
    libcsdr.c:2261-2273): y[i] = sum_t x[i+t]*taps[t], no conjugate.  As
    csdr_tpu's frames form: four real products, frames(re) and frames(im)
    by the taps' two planes."""
    taps = _taps_on(taps, torch.complex64, x.device)
    t = taps.shape[0]
    k = x.shape[0] - t + 1
    if k <= 0:
        return x.new_zeros(0)
    tr, ti = taps.real.contiguous(), taps.imag.contiguous()
    with full_f32_matmul():
        fr, fi = _frames(x.real, k, t), _frames(x.imag, k, t)
        return torch.complex(torch.matmul(fr, tr) - torch.matmul(fi, ti),
                             torch.matmul(fr, ti) + torch.matmul(fi, tr))


def apply_real_fir_cc(x: torch.Tensor, taps,
                      precision: str = DEFAULT_PRECISION) -> torch.Tensor:
    """Valid-mode real-tap FIR on complex input (reference
    libcsdr.c:2276-2291): frames @ taps a plane."""
    taps = _taps_on(taps, torch.float32, x.device)
    k = x.shape[0] - taps.shape[0] + 1
    if k <= 0:
        return x.new_zeros(0)
    return _planes_matmul(x, k, taps[:, None])[:, 0]


class _TailFirBlock(Block):
    """A stride-1 valid-mode FIR over [tail | chunk]: the tail holds T-1
    input samples, N in, N out, warmup_out = T-1."""

    def __init__(self, name: str, taps: torch.Tensor, fn, precision: str):
        super().__init__(name)
        self.fn, self.precision = fn, precision
        self.warmup_out = taps.shape[0] - 1
        self.register_buffer("taps", taps)

    def init(self, device="cuda"):
        return torch.zeros(self.warmup_out, dtype=torch.complex64,
                           device=resolve_device(device))

    def forward(self, tail, x):
        n = x.shape[0]
        xcat = torch.cat([tail, x])
        return xcat[n:].clone(), self.fn(xcat, self.taps,
                                         self.precision)[:n]


def apply_fir_cc_block(taps, name: str = "apply_fir_cc",
                       precision: str = DEFAULT_PRECISION) -> Block:
    """Streaming complex-tap FIR, tail carried (peaks_fir_cc, reference
    csdr.c:2975-3016, and bfsk front ends)."""
    t = torch.from_numpy(np.asarray(taps, np.complex64).copy())
    return _TailFirBlock(name, t, apply_fir_cc, precision)


def peaks_fir_cc_block(peak_rates, length: int,
                       precision: str = DEFAULT_PRECISION) -> Block:
    """Multi-peak filter for FSK tones (reference peaks_fir_cc CLI,
    csdr.c:2975-3016, with firdes_add_peak_c, libcsdr.c:2232-2272)."""
    return apply_fir_cc_block(firdes.firdes_add_peak_c(length, peak_rates),
                              name="peaks_fir_cc", precision=precision)


def pulse_shaping_filter_cc_block(matched_filter: str,
                                  samples_per_symbol: int,
                                  num_taps: int | None = None,
                                  beta: float = 0.25,
                                  precision: str = DEFAULT_PRECISION
                                  ) -> Block:
    """RRC or COSINE matched filter on complex symbols (reference
    csdr.c:3206-3218 with firdes_rrc_f / firdes_cosine_f)."""
    if matched_filter.upper() == "RRC":
        taps = firdes.firdes_rrc_f(num_taps, samples_per_symbol, beta)
    else:
        taps = firdes.firdes_cosine_f(2 * samples_per_symbol + 1,
                                      samples_per_symbol)
    t = torch.from_numpy(np.asarray(taps, np.float32).copy())
    return _TailFirBlock("pulse_shaping_filter_cc", t, apply_real_fir_cc,
                         precision)


# ---------------------------------------------------------------------------
# rational resampler (I/D polyphase with carried tap phase), real streams
# ---------------------------------------------------------------------------

def _resampler_phase_matrix(taps_np: np.ndarray, i_: int) -> np.ndarray:
    """P[p, j] = taps[p + j*I], masked by the reference's truncation: its
    inner loop runs exactly (T - delayi)/I terms (libcsdr.c:626-630), so
    taps with j >= (T-p)//I are dropped even when p + j*I < T."""
    t = len(taps_np)
    s = (t - 1) // i_ + 1
    pmat = np.zeros((i_, s), np.float32)
    j = np.arange(s)
    for p in range(i_):
        ok = j < (t - p) // i_
        pmat[p, ok] = taps_np[(p + j * i_)[ok]]
    return pmat


def rational_resampler_ff(x: torch.Tensor, taps, interpolation: int,
                          decimation: int, last_taps_delay=0,
                          precision: str = DEFAULT_PRECISION):
    """Reference libcsdr.c:607-662; returns (y, count, input_processed,
    next_taps_delay), y of capacity N*I//D with zeros past count.  For each
    output oi:

      startingi = (oi*D + I - 1 - ltd) // I
      delayi    = (ltd + startingi*I - oi*D) % I
      y[oi]     = I * sum_j x[startingi+j] * taps[delayi + j*I]

    stopping when startingi + T//I + 1 > N.  The indices depend only on
    N, I, D and ltd, so they and the three counts are host integers."""
    taps_np = np.asarray(taps.cpu() if isinstance(taps, torch.Tensor)
                         else taps, np.float32)
    t = len(taps_np)
    i_, d_ = interpolation, decimation
    n = x.shape[0]
    cap = n * i_ // d_
    ltd = int(last_taps_delay)
    oi = np.arange(cap, dtype=np.int64)
    startingi = (oi * d_ + i_ - 1 - ltd) // i_
    delayi = (ltd + startingi * i_ - oi * d_) % i_
    valid = startingi + t // i_ + 1 <= n
    pmat = _resampler_phase_matrix(taps_np, i_)
    s = pmat.shape[1]
    gidx = startingi[:, None] + np.arange(s)[None, :]
    inside = gidx < n
    dev = x.device
    frames = torch.where(torch.from_numpy(inside).to(dev),
                         x.float()[torch.from_numpy(
                             np.clip(gidx, 0, n - 1)).to(dev)], 0.0)
    ph = torch.from_numpy(pmat[delayi]).to(dev)
    y = torch.sum(frames * ph, 1) * i_
    y = torch.where(torch.from_numpy(valid).to(dev), y, 0.0)
    count = int(valid.sum())
    input_processed = (count * d_ + i_ - 1 - ltd) // i_
    next_delay = (ltd + input_processed * i_ - count * d_) % i_
    return y, count, input_processed, next_delay


class RationalResamplerBlock(Block):
    """Streaming rational resampler with exact-rate output, csdr_tpu's
    closed form: in global stream coordinates the carried delay collapses
    to S(m) = floor((m*D + I - 1)/I), delay(m) = (S(m)*I - m*D) mod I, both
    periodic in the output with period I (S(m+I) = S(m)+D).  So the
    resampler is I stride-D correlations, one a tap phase, over [tail |
    chunk], with outputs anchored shift_out = ceil(S_frames*I/D) samples
    late so every frame fits; exactly N*I/D outputs a chunk of N.  The
    state is the input tail (its length does not depend on N); the
    correlations are one batched product over unfold views.
    warmup_out = shift_out."""

    def __init__(self, taps, interpolation: int, decimation: int,
                 name: str = "rational_resampler_ff",
                 precision: str = DEFAULT_PRECISION):
        super().__init__(name)
        taps_np = np.asarray(taps, np.float32)
        i_, d_ = interpolation, decimation
        self.i_, self.d_ = i_, d_
        self.s = (len(taps_np) - 1) // i_ + 1
        self.shift_out = -(-self.s * i_ // d_)
        self.warmup_out = self.shift_out
        self.rate_ratio = i_ / d_
        self.pmat = _resampler_phase_matrix(taps_np, i_)
        self.tail_len = int(max(self.s + 1, -self._start(
            np.arange(1) - self.shift_out).min() + 1))
        self._plans: dict[tuple, tuple] = {}   # (n, device) -> plan

    def _start(self, m):
        return (m * self.d_ + self.i_ - 1) // self.i_

    def _plan(self, n: int):
        """The chunk's host plan: each output phase's first window start,
        its taps, the outputs a phase, the window length and the zero pad
        past the chunk."""
        i_, d_, s = self.i_, self.d_, self.s
        nout = n * i_ // d_
        if nout * d_ != n * i_:
            raise ValueError(f"chunk {n} * I {i_} is not a multiple of D "
                             f"{d_}")
        m = np.arange(nout) - self.shift_out
        xidx = self._start(m) + self.tail_len
        kmax = -(-nout // i_)
        starts = [int(v) for v in xidx[:i_]]
        delay = (self._start(m[:i_]) * i_ - m[:i_] * d_) % i_
        taps_sel = torch.from_numpy(self.pmat[delay.astype(np.int64)])
        lw = (kmax - 1) * d_ + s
        pad = max(0, max(starts) + lw - (self.tail_len + n))
        return starts, taps_sel, kmax, lw, pad, nout

    def init(self, device="cuda"):
        return torch.zeros(self.tail_len, dtype=torch.float32,
                           device=resolve_device(device))

    def forward(self, tail, x):
        n = x.shape[0]
        if (n, x.device) not in self._plans:
            starts, taps_sel, *rest = self._plan(n)
            self._plans[n, x.device] = (starts, taps_sel.to(x.device), *rest)
        starts, taps_sel, kmax, lw, pad, nout = self._plans[n, x.device]
        xcat = torch.cat([tail, x.float(), tail.new_zeros(pad)])
        segs = torch.stack([xcat[st: st + lw] for st in starts])   # (I, lw)
        frames = segs.unfold(1, self.s, self.d_)              # (I, kmax, S)
        with full_f32_matmul():
            out = torch.matmul(frames, taps_sel[:, :, None])
        y = out[:, :, 0].T.reshape(-1)[:nout] * self.i_
        return xcat[n: n + self.tail_len].clone(), y


def rational_resampler_block(taps, interpolation: int, decimation: int,
                             name: str = "rational_resampler_ff",
                             precision: str = DEFAULT_PRECISION) -> Block:
    return RationalResamplerBlock(taps, interpolation, decimation, name,
                                  precision)
