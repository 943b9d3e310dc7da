"""Gardner / early-late timing recovery's symbol loop (the counterpart of
csdr_tpu's ``lax.scan`` in csdr_tpu/ops/sync.py:374, 397; no Pallas kernel
there).

csdr_tpu compiles the loop over symbol slots into one device loop.  In
eager torch the same loop is a Python loop of ~43 small ops a slot (9 929
launches a chunk of BASELINE config 5), so it is hand-written CUDA,
``csrc/ted.cu``: one block a (row, segment) lane, one thread on its
chain with every slot in registers, one launch a call, bit for bit
:func:`scan_plain`.  The lane's row streams through a ring of tiles in
shared memory ahead of the chain (:func:`ring_plan` lays it out), so the
chain reads its picks from shared memory, not L2.  A parameter set whose
walk may step backwards (a correction of more than a symbol), whose
correction is unbounded, or whose window does not fit the ring, goes to
the first design, the picks read from L2 (``csdr_ted_scan_l2``), chosen
from the parameters alone before launch and counted under its own key.
:func:`chain_cycles` measures on the card the chain that bounds the
function: a slot's picks from shared memory and its arithmetic.

:func:`scan` takes the buffer ``planes`` (R, 2*size) float32 (interleaved
re/im), ``bitstart`` and ``corr`` int32 (R,) (the serial mode) or (R, S)
(the segmented mode, lane (r, s) reading row r, with ``span_hi`` and
``emit_lo`` (R, S) int32), ``cap`` slots and the block's constants
(:class:`TedParams`).  It returns the final (bitstart, corr) and, per
slot, v (..., cap, 3, 2) float32 (the right, left and mid picks), the raw
error (..., cap) float32, bitstart at the slot (..., cap) int32 and emit
(..., cap) bool.

The wrapper launches a kernel for CUDA tensors, or raises; it takes the
plain version only for CPU tensors.  ``LAUNCHES`` counts kernel launches:
``ted_scan`` the ring, ``ted_scan_l2`` the L2 route.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from csdr_tpu_torch.core.precision import fma_f32
from csdr_tpu_torch.kernels import _build

LAUNCHES = {"ted_scan": 0, "ted_scan_l2": 0}
PROBE_WINDOW = 4096     # complex samples the probe stages (csrc/ted.cu)
RING_TILES = 4          # ring slots: the window's two tiles and two ahead
RING_MIN_TILE = 2048    # complex samples a tile, at least
RING_MAX_BYTES = 128 * 1024   # the ring's shared memory, at most


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class TedParams(NamedTuple):
    """A timing recovery block's constants: ``nsb`` samples a symbol, the
    picks ``offs`` (right, left, mid) relative to bitstart, the algorithm
    (Gardner, or early-late whose left pick moves by -corr), the error's
    form (``use_q``: the I and Q products averaged), its clamp and the loop
    gain."""
    nsb: int
    offs: tuple
    gardner: bool
    use_q: bool
    max_error: float
    loop_gain: float

    @property
    def nshb(self) -> int:
        return self.nsb // 2

    @property
    def nsqb(self) -> int:
        return self.nsb // 4

    @property
    def err_sign(self) -> float:
        return -1.0 if self.gardner else 1.0


def max_correction(params: TedParams) -> int | None:
    """The largest |new_corr| a slot can give, computed as the kernel
    computes a correction: trunc((gain*e)*loop_gain) in float32 for the
    largest |e| the clamp lets through, |max_error| (a NaN error gives 0).
    None when it is unbounded: a constant that is not finite (a NaN or
    infinite max_error does not clamp) or a product past int32."""
    f32 = np.float32
    gain = f32(params.nshb * params.err_sign)
    m, lg = f32(params.max_error), f32(params.loop_gain)
    if not (np.isfinite(gain) and np.isfinite(m) and np.isfinite(lg)):
        return None
    with np.errstate(over="ignore"):
        v = abs(f32(f32(gain * m) * lg))
    if not np.isfinite(v) or v >= 2.0 ** 31:
        return None
    return int(v)


class RingPlan(NamedTuple):
    """How the TED kernel streams a row (:func:`ring_plan`): the route
    ("ring", or "l2" for the L2 design), ``tile`` complex samples a tile (a
    power of two), ``tiles`` ring slots, ``lo_off`` and ``hi_off`` the
    lowest and highest pick relative to bitstart in any slot, ``lead`` the
    samples the copies may run past the end of the window's last tile (at
    least), ``trail`` the samples kept behind the window's first tile (0:
    the walk never steps back), and why."""
    route: str
    tile: int
    tiles: int
    lo_off: int
    hi_off: int
    lead: int
    trail: int
    why: str


def ring_plan(size: int, params: TedParams) -> RingPlan:
    """The ring's layout for a block's constants, from the parameters
    alone.  A slot moves bitstart by nsb + new_corr, |new_corr| <= c =
    :func:`max_correction`; its picks lie in [bitstart + lo_off, bitstart +
    hi_off] (early-late's left pick moves by -corr, |corr| < 0.9*nsqb after
    the reset, whatever corr a lane starts with), clamped to [0, size-1].
    With c <= nsb bitstart never decreases, so that envelope never returns
    to a tile it left (a pick may: early-late's left pick after a large
    correction lands up to 0.9*nsqb below the slot before's), and the
    kernel publishes the envelope's lowest tile as the one the copies must
    keep: the ring keeps the window's tiles and the copies run ahead.  A
    tile is at least as wide as the window and as a slot's longest step
    (nsb + c), so the window spans at most two tiles and the copies run
    at least RING_TILES - 2 tiles ahead of it; a row shorter than that
    tile takes a tile its own length.  Otherwise the
    route is "l2": c > nsb (bitstart may step back by c - nsb a slot, with
    no bound over many slots), c unbounded, or a ring past
    RING_MAX_BYTES."""
    p = params
    c = max_correction(p)
    cb = 0 if p.gardner else p.nsqb
    lo = min(p.offs[0], p.offs[1] - cb, p.offs[2])
    hi = max(p.offs[0], p.offs[1] + cb, p.offs[2])
    if c is None:
        return RingPlan("l2", 0, 0, lo, hi, 0, 0, "the correction is "
                        "unbounded (a constant not finite, or past int32)")
    if c > p.nsb:
        return RingPlan("l2", 0, 0, lo, hi, 0, 0, f"bitstart may step back: "
                        f"|corr| up to {c} > nsb {p.nsb}")
    tile = RING_MIN_TILE
    while tile < max(hi - lo + 1, p.nsb + c):
        tile *= 2
    # a row shorter than a tile is one tile: every window lies in it
    tile = min(tile, max(16, 1 << max(size - 1, 1).bit_length()))
    if RING_TILES * tile * 8 > RING_MAX_BYTES:
        return RingPlan("l2", 0, 0, lo, hi, 0, 0, f"a ring of {RING_TILES} "
                        f"tiles of {tile} samples passes {RING_MAX_BYTES} B")
    return RingPlan("ring", tile, RING_TILES, lo, hi,
                    (RING_TILES - 2) * tile, 0, "bitstart never decreases")


def _check(planes, size, bitstart, corr, span_hi, emit_lo):
    if planes.dtype != torch.float32 or planes.dim() != 2 \
            or planes.shape[1] != 2 * size:
        raise TypeError(f"ted scan: want planes (R, {2 * size}) float32, got "
                        f"{tuple(planes.shape)} {planes.dtype}")
    lead = tuple(bitstart.shape)
    if len(lead) not in (1, 2) or lead[0] != planes.shape[0]:
        raise TypeError(f"ted scan: bitstart {lead} does not lead with the "
                        f"planes' {planes.shape[0]} rows")
    if (span_hi is None) != (emit_lo is None) or (
            span_hi is not None and len(lead) != 2):
        raise TypeError("ted scan: span_hi and emit_lo go together, with "
                        "(R, S) lanes")
    for name, t in (("bitstart", bitstart), ("corr", corr),
                    ("span_hi", span_hi), ("emit_lo", emit_lo)):
        if t is None:
            continue
        if t.dtype != torch.int32 or tuple(t.shape) != lead:
            raise TypeError(f"ted scan: want {name} int32 {lead}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != planes.device:
            raise ValueError(f"ted scan: {name} on {t.device}, planes on "
                             f"{planes.device}")


def scan(planes: torch.Tensor, size: int, bitstart: torch.Tensor,
         corr: torch.Tensor, cap: int, span_hi=None, emit_lo=None, *,
         params: TedParams):
    """``cap`` symbol slots for every lane of ``bitstart`` over ``planes``
    (module docstring).  CUDA tensors launch the kernel, through the ring
    or, where :func:`ring_plan` routes the parameters there, the L2
    design; CPU tensors take :func:`scan_plain`."""
    _check(planes, size, bitstart, corr, span_hi, emit_lo)
    if not planes.is_cuda:
        return scan_plain(planes, size, bitstart, corr, cap, span_hi,
                          emit_lo, params=params)
    lead = tuple(bitstart.shape)
    dev = planes.device
    planes = planes.contiguous()
    if planes.data_ptr() % 8:
        planes = planes.clone()         # the kernel reads float2 samples
    ins = [t.contiguous() if t is not None else None
           for t in (bitstart, corr, span_hi, emit_lo)]
    bs_out = torch.empty(lead, dtype=torch.int32, device=dev)
    corr_out = torch.empty(lead, dtype=torch.int32, device=dev)
    v = torch.empty(lead + (cap, 3, 2), dtype=torch.float32, device=dev)
    errs = torch.empty(lead + (cap,), dtype=torch.float32, device=dev)
    starts = torch.empty(lead + (cap,), dtype=torch.int32, device=dev)
    emits = torch.empty(lead + (cap,), dtype=torch.bool, device=dev)
    p = params
    segs = lead[1] if len(lead) == 2 else 1
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = [t.data_ptr() if t is not None else None for t in ins]
    args = (planes.data_ptr(), size, ptr[0], ptr[1], ptr[2], ptr[3],
            lead[0], segs, cap, p.nsb, p.nshb, p.nsqb, *p.offs,
            int(p.gardner), int(p.use_q), p.max_error, p.err_sign,
            p.loop_gain)
    outs = (bs_out.data_ptr(), corr_out.data_ptr(), v.data_ptr(),
            errs.data_ptr(), starts.data_ptr(), emits.data_ptr(), stream)
    plan = ring_plan(size, p)
    if plan.route == "ring":
        key = "ted_scan"
        code = _build.lib().csdr_ted_scan(
            *args, plan.tile.bit_length() - 1, plan.tiles, plan.lo_off,
            *outs)
    else:
        key = "ted_scan_l2"
        code = _build.lib().csdr_ted_scan_l2(*args, *outs)
    _build.check(code, key)
    LAUNCHES[key] += 1
    return bs_out, corr_out, v, errs, starts, emits


def chain_cycles(iters: int, device="cuda") -> float:
    """SM cycles a TED slot takes on the chain that bounds the function
    (``csrc/ted.cu``): config 5's Gardner loop on one thread, three picks
    from a window staged in shared memory and the step's arithmetic to the
    next bitstart, ``iters`` slots after a first pass.  It recovers no
    symbol and is not counted in ``LAUNCHES``."""
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    if not cycles.is_cuda:
        raise ValueError("ted chain probe: runs on a CUDA device only")
    gen = torch.Generator(device=device).manual_seed(7)
    buf = torch.randn(PROBE_WINDOW, 2, device=device, generator=gen)
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(cycles.device).cuda_stream
    _build.check(_build.lib().csdr_ted_chain_probe(
        cycles.data_ptr(), buf.data_ptr(), sink.data_ptr(), iters, stream),
        "ted chain probe")
    return int(cycles.item()) / iters


# ---------------------------------------------------------------------------
# the plain version: csdr_tpu's step (ops/sync.py:265-312) as torch ops
# ---------------------------------------------------------------------------

def scan_plain(planes: torch.Tensor, size: int, bitstart: torch.Tensor,
               corr: torch.Tensor, cap: int, span_hi=None, emit_lo=None, *,
               params: TedParams):
    """:func:`scan` as a Python loop over the slots of torch ops on every
    lane."""
    p = params
    nsb, nshb, nsqb = p.nsb, p.nshb, p.nsqb
    dev = planes.device
    lead = bitstart.shape
    rows = lead[0]
    offs = torch.tensor(p.offs, dtype=torch.int32, device=dev)
    sel = torch.tensor((0, 1, 0), dtype=torch.int32, device=dev)
    reim = torch.arange(2, dtype=torch.int64, device=dev)
    gain = nshb * p.err_sign
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
        if not p.gardner:
            gi = gi - corr[..., None] * sel
        gi = torch.clamp(gi, 0, size - 1)
        at = (gi.to(torch.int64)[..., None] * 2 + reim).reshape(rows, -1)
        v = torch.gather(planes, 1, at).reshape(lead + (3, 2))
        diff = v[..., 0, :] - v[..., 1, :]
        if p.use_q:         # (d_re + d_im) / 2, d_re's product fused
            error = fma_f32(diff[..., 0], v[..., 2, 0],
                            diff[..., 1] * v[..., 2, 1]) / 2
        else:
            error = diff[..., 0] * v[..., 2, 0]
        raw_error = error
        error = torch.clamp(error, -p.max_error, p.max_error)
        # err_sign * error * loop_gain, left to right, truncated
        new_corr = (gain * error * p.loop_gain).to(torch.int32)
        vs.append(v)
        errs.append(raw_error)
        starts.append(bitstart)
        emits.append(alive if emit_lo is None
                     else alive & (bitstart >= emit_lo))
        bitstart = torch.where(alive, bitstart + nsb + new_corr, bitstart)
        corr = torch.where(alive, new_corr, corr)
    return (bitstart, corr, torch.stack(vs, -3), torch.stack(errs, -1),
            torch.stack(starts, -1), torch.stack(emits, -1))

