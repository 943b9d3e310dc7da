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

What bounds it on an H100: at the receivers' shapes it moves ~8 B an
input sample and does 2T/D FMA a sample, so device-memory bytes bound it;
behind them come the shared-memory reads that feed the FMA.  The kernel
stages each block's window phase-major in shared memory (each sample read
from device memory about once, mixed once), and each thread sums S runs
of R consecutive outputs, so one window read serves R outputs and one tap
read S runs, each output still one f32 chain over t in order: the
outputs are bit for bit those of a one-output-a-thread sum.
:func:`plan_tile` sizes R, S and the block to the shape on the host (the
source note of ``csrc/fir_decimate.cu`` has the design, PERF.md the
measurements it rests on).

K5 (``_fir_poly_kernel``, the direct polyphase FIR that csdr_tpu keeps as
its exact-f32 reference form) is ``csrc/fir_poly.cu``:
:func:`fir_decimate_poly` over an already tail-extended stream, each
output one f32 chain per phase over exactly M = ceil(T/D) tap rows, then
the D chains added in phase order, and its dispatcher
:func:`fir_decimate_poly_or_plain`.  It bounds like K2 (bytes at short
taps, FP32 FMA at T=1023) and takes K2's phase-major window and
``cp.async`` staging; a thread walks the columns of its R consecutive
outputs phase by phase (G phases side by side), one window load and one
tap broadcast serving 2R FMA, and keeps the phase sums in registers.
:func:`poly_plan` sizes R, G and the block to the shape on the host.

The wrappers launch the kernel for CUDA tensors, or raise; they take the
plain version (``*_plain``, the same function in torch ops) only for CPU
tensors.  ``LAUNCHES`` counts kernel launches per kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from csdr_tpu_torch.kernels import _build

MAX_SMEM = 232448          # bytes of shared memory a block may opt into
SM_SMEM = 233472           # shared memory of one SM (228 KB)
SMS = 132                  # SMs of an H100 SXM
PER_THREAD = (4, 2, 1)     # consecutive outputs a thread: R in the source
GROUPS = (1, 2)            # runs of R outputs a thread: S there
THREADS = tuple(range(32, 513, 32))   # threads a block: kMaxThreads there
MIX_STAGERS = 2            # K1's staging threads a summing one: kMixStagers

POLY_PER_THREAD = (8, 4, 1)      # K5's outputs a thread: R in fir_poly.cu
POLY_GROUPS = {1: (1, 4), 4: (2,), 8: (2,)}  # its phases at once, by R
POLY_THREADS = (8, 16) + THREADS  # K5's threads a block

LAUNCHES = {"shift_fir_decimate": 0, "fir_decimate": 0, "fir_poly": 0}

PRECISIONS = ("HIGHEST", "HIGH")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def smem_bytes(taps_len: int, decimation: int, tile: int,
               per_thread: int) -> int:
    """Shared memory of one K1/K2 block of ``tile`` outputs, ``per_thread``
    (R) a thread: the taps as (M + R - 1, D, R) R-vectors, rounded up to 16
    bytes, and the phase-major window of D rows of ``tile + M - 1``
    columns, in R sub-rows with an odd row stride (M = ceil(T/D))."""
    d, r = int(decimation), int(per_thread)
    m = -(-int(taps_len) // d)
    sub = -(-(int(tile) + m - 1) // r)
    return 4 * ((((m + r - 1) * d * r) + 3) & ~3) + 8 * d * ((r * sub) | 1)


def _plan(taps_len, d, r, g, nt, kout, mix):
    tile = nt * r * g
    smem = smem_bytes(taps_len, d, tile, r)
    launched = nt * (MIX_STAGERS if mix else 1)
    return {"tile": tile, "per_thread": r, "groups": g, "threads": nt,
            "smem": smem, "blocks": -(-max(int(kout), 1) // tile),
            "blocks_per_sm": min(SM_SMEM // (smem + 1024), 2048 // launched,
                                 32)}


def plans(taps_len: int, decimation: int, kout: int,
          mix: bool = False) -> list:
    """Every launch K1 (``mix``) or K2 takes at (T, D): each (R, S,
    threads) of PER_THREAD x GROUPS x THREADS whose block fits in shared
    memory; ``threads`` sum, and K1 launches MIX_STAGERS times as many
    to stage its window."""
    t_len, d = int(taps_len), int(decimation)
    most = THREADS[-1] // (MIX_STAGERS if mix else 1)
    return [_plan(t_len, d, r, g, nt, kout, mix) for r in PER_THREAD
            for g in GROUPS for nt in THREADS
            if nt <= most and smem_bytes(t_len, d, nt * r * g, r) <= MAX_SMEM]


def waves(plan: dict, sms: int = SMS) -> int:
    """How many times over the grid of ``plan`` fills ``sms`` SMs."""
    return -(-plan["blocks"] // (sms * plan["blocks_per_sm"]))


def plan_tile(taps_len: int, decimation: int, kout: int, mix: bool = False,
              sms: int = SMS) -> dict:
    """The K1 (``mix``) or K2 launch for (T, D, kout): ``tile`` outputs a
    block, ``groups`` (S) runs of ``per_thread`` (R) consecutive outputs
    a thread, ``threads`` summing a block (K1 launches MIX_STAGERS times as
    many), ``smem`` bytes, ``blocks`` in the grid and the ``blocks_per_sm``
    that shared memory and threads let one of ``sms`` SMs hold.

    R outputs a thread divide the window reads of a tap by R and S runs
    divide the tap reads by S, but a thread runs M + R - 1 steps (M =
    ceil(T/D) tap rows) and each output holds D samples of window: from
    D = 32 on, R = S = 1 (at D=50 more outputs a thread leave too few
    warps an SM); else R = 4 where the taps span 32 rows or more, R = S =
    2 from 8 rows, else R = S = 1.  Then the grid: where kout fills the
    SMs, the fewest waves and the fullest last wave, else the most blocks;
    then the smallest block of at least 128 threads.  At chip_smoke.py's
    shapes that came within 4 % of the best launch the kernel takes
    (tools/k2_tiles.py, PERF.md).  Raises ValueError for a shape no launch
    fits."""
    t_len, d = int(taps_len), int(decimation)
    fits = plans(t_len, d, kout, mix)
    if not fits:
        raise ValueError(
            f"fir_decimate kernel: D={d} T={t_len} needs "
            f"{smem_bytes(t_len, d, 32, 1)} B of shared memory > "
            f"{MAX_SMEM}")
    m = -(-t_len // d)
    r, g = ((1, 1) if d >= 32 else (4, 1) if m >= 32
            else (2, 2) if m >= 8 else (1, 1))
    mine = [p for p in fits if (p["per_thread"], p["groups"]) == (r, g)] or \
        [p for p in fits if (p["per_thread"], p["groups"]) == (1, 1)]

    def rank(p):
        small = p["threads"] < 128, p["threads"]
        if p["blocks"] < sms:             # kout too small to fill the SMs
            return (1, -p["blocks"]) + small
        fill = p["blocks"] / (waves(p, sms) * sms * p["blocks_per_sm"])
        return (0, waves(p, sms), -round(fill, 2)) + small
    return min(mine, key=rank)


_planned = functools.lru_cache(maxsize=256)(plan_tile)   # per launch shape


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(
        torch.cuda.current_device() if index is None else index
    ).multi_processor_count


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


def _launch(name: str, tail, x, taps, decimation, kout, plan, *phase,
            entry: str | None = None):
    if not (tail.is_contiguous() and x.is_contiguous()
            and taps.is_contiguous()):
        raise ValueError(f"{name}: tail, x and taps must be contiguous")
    if plan is None:
        plan = _planned(taps.shape[0], int(decimation), int(kout),
                        name == "shift_fir_decimate",
                        _sm_count(x.device.index))
    lib = _build.lib()
    y = torch.empty(kout, dtype=torch.complex64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = getattr(lib, "csdr_" + (entry or name))
    code = fn(tail.data_ptr(), tail.shape[0], x.data_ptr(), x.shape[0],
              taps.data_ptr(), taps.shape[0], int(decimation), kout,
              y.data_ptr(), *phase, plan["tile"], plan["per_thread"],
              plan["groups"], stream)
    _build.check(code, name)
    LAUNCHES[name] += 1
    return y


def fir_decimate(tail: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                 decimation: int, kout: int, precision: str = "HIGHEST",
                 plan: dict | None = None) -> torch.Tensor:
    """K2: ``kout`` decimated outputs of ``[tail | x]`` (complex64) through
    real ``taps`` (float32).  CUDA tensors launch the kernel with
    :func:`plan_tile`'s launch, or ``plan`` (one of its dicts) where given
    (a shape no block fits raises); CPU tensors take
    :func:`fir_decimate_plain`."""
    _check(tail, x, taps, decimation, kout, precision)
    if not x.is_cuda:
        return fir_decimate_plain(tail, x, taps, decimation, kout)
    return _launch("fir_decimate", tail, x, taps, decimation, kout, plan)


def shift_fir_decimate(tail: torch.Tensor, x: torch.Tensor,
                       taps: torch.Tensor, decimation: int, kout: int,
                       rate: float, theta,
                       precision: str = "HIGHEST",
                       plan: dict | None = None) -> torch.Tensor:
    """K1: as :func:`fir_decimate`, with sample s of ``[tail | x]`` first
    mixed by ``exp(j*2*pi*(theta + rate*s))`` (rate and theta in cycles).

    ``theta`` is a number or a 0-dim CPU tensor, passed by value, or a
    one-element float32 tensor on ``x``'s card, which the kernel reads
    there (``csdr_shift_fir_decimate_dev``: the form a captured step
    launches, core/graph.carried_value); both give the same bits."""
    _check(tail, x, taps, decimation, kout, precision)
    if not x.is_cuda:
        return shift_fir_decimate_plain(tail, x, taps, decimation, kout,
                                        rate, theta)
    if isinstance(theta, torch.Tensor) and theta.device.type != "cpu":
        if (theta.device != x.device or theta.dtype != torch.float32
                or theta.numel() != 1):
            raise ValueError(f"theta: want one float32 on {x.device}, got "
                             f"{theta.numel()} {theta.dtype} on "
                             f"{theta.device}")
        return _launch("shift_fir_decimate", tail, x, taps, decimation,
                       kout, plan, float(rate), theta.data_ptr(),
                       entry="shift_fir_decimate_dev")
    return _launch("shift_fir_decimate", tail, x, taps, decimation, kout,
                   plan, float(rate), float(theta))


# ---------------------------------------------------------------------------
# K5: the direct polyphase form
# ---------------------------------------------------------------------------

def poly_smem_bytes(taps_len: int, decimation: int, tile: int,
                    per_thread: int, groups: int = 1) -> int:
    """Shared memory of one K5 block of ``tile`` outputs, ``per_thread`` (R)
    a thread, ``groups`` (G) phases at once: the taps as an (M, D) matrix
    (D rounded up to 4 where G = 4), rounded up to 4 floats so that the
    window behind it is 16-byte aligned, and the phase-major window of D
    rows of ``tile + M - 1`` columns, in R sub-rows with an odd row stride
    (M = ceil(T/D))."""
    d, r, g = int(decimation), int(per_thread), int(groups)
    m = -(-int(taps_len) // d)
    sub = -(-(int(tile) + m - 1) // r)
    table = (m * ((d + 3) & ~3 if g == 4 else d) + 3) & ~3
    return 4 * table + 8 * d * ((r * sub) | 1)


def _poly_plan(taps_len, d, r, g, nt, kout):
    tile = nt * r
    smem = poly_smem_bytes(taps_len, d, tile, r, g)
    return {"tile": tile, "per_thread": r, "groups": g, "threads": nt,
            "smem": smem, "blocks": -(-max(int(kout), 1) // tile),
            "blocks_per_sm": min(SM_SMEM // (smem + 1024), 2048 // nt, 32)}


def poly_plans(taps_len: int, decimation: int, kout: int) -> list:
    """Every launch K5 takes at (T, D): each (R, G, threads) of
    POLY_PER_THREAD x POLY_GROUPS x POLY_THREADS whose block fits in
    shared memory."""
    t_len, d = int(taps_len), int(decimation)
    return [_poly_plan(t_len, d, r, g, nt, kout) for r in POLY_PER_THREAD
            for g in POLY_GROUPS[r] for nt in POLY_THREADS
            if poly_smem_bytes(t_len, d, nt * r, r, g) <= MAX_SMEM]


def poly_rg(taps_len: int, decimation: int) -> tuple:
    """K5's (R, G) for (T, D): R outputs a thread, G phases summed at once.
    One window read and one tap broadcast serve R complex FMA pairs, but a
    thread's outputs hold R*D samples of window between them: from D = 32
    on, or below 8 tap rows, R = 1; else R = 8 from 32 rows, R = 4 below.
    G phases side by side put G times the loads in flight where R is small
    (tools/k5_phases.py, PERF.md)."""
    d = int(decimation)
    m = -(-int(taps_len) // d)
    r = 1 if d >= 32 or m < 8 else 8 if m >= 32 else 4
    return r, POLY_GROUPS[r][-1]


def poly_plan(taps_len: int, decimation: int, kout: int,
              sms: int = SMS) -> dict:
    """The K5 launch for (T, D, kout): ``tile`` outputs a block,
    ``per_thread`` (R) consecutive outputs a thread, ``groups`` (G) phases
    summed at once, ``threads`` a block, ``smem`` bytes, ``blocks`` in the
    grid and the ``blocks_per_sm`` that shared memory and threads let one
    of ``sms`` SMs hold.  R and G from :func:`poly_rg` (or the first of
    (1, 4), (1, 1) that fits); then, where kout fills the SMs, the
    fewest warps on the busiest warp scheduler, at least two blocks an SM
    and the least halo (the M - 1 window columns the next block stages
    again) a tile, else the most blocks; then the smallest block
    (tools/k5_phases.py's sweep, PERF.md).  Raises ValueError for a shape
    no launch fits."""
    t_len, d = int(taps_len), int(decimation)
    fits = poly_plans(t_len, d, kout)
    if not fits:
        raise ValueError(
            f"fir_poly kernel: D={d} T={t_len} needs "
            f"{poly_smem_bytes(t_len, d, POLY_THREADS[0], 1)} B of shared "
            f"memory > {MAX_SMEM}")
    r, g = poly_rg(t_len, d)
    m = -(-t_len // d)
    # the (R, G) of poly_rg, else the first of these that fits
    for rg in ((r, g), (1, 4), (1, 1)):
        mine = [p for p in fits if (p["per_thread"], p["groups"]) == rg]
        if mine:
            break

    def rank(p):
        if p["blocks"] < sms:             # kout too small to fill the SMs
            return (1, -p["blocks"], p["threads"] < 128, p["threads"])
        per_sm = -(-p["blocks"] // sms)   # blocks of the busiest SM
        # warps of its busiest scheduler, over all waves: the sum is
        # issue-bound per scheduler, so 2.25 warps a scheduler take as
        # long as 3
        warps = -(-per_sm * -(-p["threads"] // 32) // 4)
        halo = round((m - 1) / p["tile"], 3)  # columns staged twice
        return (0, warps, p["blocks_per_sm"] < 2, halo, p["threads"])
    return min(mine, key=rank)


_poly_planned = functools.lru_cache(maxsize=256)(poly_plan)


def fir_decimate_poly(xcat: torch.Tensor, taps: torch.Tensor,
                      decimation: int, kout: int) -> torch.Tensor:
    """K5: ``kout`` outputs ``y[k] = sum_t xcat[k*D + t] * taps[t]`` of the
    tail-extended stream ``xcat`` (complex64) through real ``taps``
    (float32), summed per phase over the tap rows and then across the
    phases.  CUDA tensors launch the kernel with :func:`poly_plan`'s
    launch (a shape no block fits raises); CPU tensors take
    :func:`fir_decimate_poly_plain`."""
    for name, t, dt in (("xcat", xcat, torch.complex64),
                        ("taps", taps, torch.float32)):
        if t.dtype != dt or t.dim() != 1:
            raise TypeError(f"{name}: want a 1-D {dt} tensor, got "
                            f"{t.dim()}-D {t.dtype}")
    if taps.device != xcat.device:
        raise ValueError(f"taps on {taps.device}, xcat on {xcat.device}")
    t_len, d, kout = taps.shape[0], int(decimation), int(kout)
    if t_len < 1 or d < 1 or kout < 0:
        raise ValueError(f"bad shape: T={t_len} D={d} kout={kout}")
    if kout and (kout - 1) * d + t_len > xcat.shape[0]:
        raise ValueError(f"kout={kout} outputs need {(kout - 1) * d + t_len} "
                         f"samples; xcat has {xcat.shape[0]}")
    if not xcat.is_cuda:
        return fir_decimate_poly_plain(xcat, taps, d, kout)
    plan = _poly_planned(t_len, d, kout, _sm_count(xcat.device.index))
    if not (xcat.is_contiguous() and taps.is_contiguous()):
        raise ValueError("fir_poly: xcat and taps must be contiguous")
    y = torch.empty(kout, dtype=torch.complex64, device=xcat.device)
    stream = torch.cuda.current_stream(xcat.device).cuda_stream
    code = _build.lib().csdr_fir_poly(xcat.data_ptr(), xcat.shape[0],
                                      taps.data_ptr(), t_len, d, kout,
                                      plan["tile"], plan["per_thread"],
                                      plan["groups"], y.data_ptr(), stream)
    _build.check(code, "fir_poly")
    LAUNCHES["fir_poly"] += 1
    return y


def fir_decimate_poly_or_plain(xcat: torch.Tensor, taps, decimation: int,
                               kout: int) -> torch.Tensor:
    """The dispatcher of csdr_tpu's ``fir_pallas.
    fir_decimate_pallas_or_fallback``: K5 on the card, its plain version on
    the CPU.  ``taps`` is a float32 tensor on ``xcat``'s device, used as it
    is, or a float sequence, copied there on every call; ``xcat`` is the
    stream with its tail in front and must hold ``(kout-1)*D + T`` samples.
    The TPU wrapper's conv fallback (T <= D, ``len % D``) and its pad to
    2048 outputs have no counterpart: K5 serves every shape whose block
    fits in shared memory and raises on the others.  It runs in f32 FMA,
    csdr_tpu's ``precision`` HIGHEST."""
    if not isinstance(taps, torch.Tensor):
        taps = torch.as_tensor(np.asarray(taps, np.float32),
                               device=xcat.device)
    return fir_decimate_poly(xcat.contiguous(), taps, decimation, kout)


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
    """``theta`` a number or a one-element tensor, read as a float64."""
    v = torch.cat([tail, x])
    v = v * nco_phasor(v.shape[0], rate, float(theta), v.device)
    return strided_corr(v, taps.tolist(), decimation, kout)


def fir_decimate_poly_plain(xcat, taps, decimation, kout) -> torch.Tensor:
    """K5's function in its summation order: per phase p the sum over the
    tap rows m of X[p, k+m] * H[m, p] (X[p, q] = xcat[q*D + p], H the taps
    zero-padded to (M, D)), then the sum over the phases."""
    d, t_len = int(decimation), taps.shape[0]
    m = -(-t_len // d)
    h = torch.zeros(m * d, dtype=torch.float32, device=xcat.device)
    h[:t_len] = taps
    h = h.reshape(m, d)
    cols = kout + m - 1
    v = xcat[: cols * d]
    if v.shape[0] < cols * d:             # the zero taps' columns past len
        v = torch.cat([v, v.new_zeros(cols * d - v.shape[0])])
    x = v.reshape(cols, d).T                                   # X[p, q]
    acc = torch.zeros(d, kout, dtype=torch.complex64, device=xcat.device)
    for mi in range(m):
        acc += x[:, mi: mi + kout] * h[mi][:, None]
    return acc.sum(0)
