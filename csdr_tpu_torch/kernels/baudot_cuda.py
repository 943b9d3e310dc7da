"""The RTTY Baudot decoder on the card (the counterpart of csdr_tpu's
``lax.scan`` in csdr_tpu/ops/digital.py:182); no Pallas kernel there.

The decoder is the reference's start/stop-pulse state machine
(libcsdr.c:1622-1654): an integer recurrence a symbol.  In eager torch it
was a Python loop of ~60 small ops a symbol, so it is hand-written CUDA,
``csrc/baudot.cu``, one launch a call, bit for bit :func:`decode_plain`.
A row is split into segments of SEGMENT symbols, one a thread, one CTA a
row (:func:`plan` gives its threads), a tile of SEGMENT x threads symbols
at a time.  A segment's state map over the machine's seven behavioural
states (waiting for the stop pulse, for the start pulse, receiving bit 0
to 4) and its effects on the rest of the state compose in block-wide
scans, so each segment learns its exact entry state and re-runs its
symbols exactly; the characters are packed by a scan of the counts.

The route, chosen on the card for each tile inside the one launch: thread
0 runs the tile's first segment exactly from the tile's entry state; if
that ends outside the seven states (machine state 2 with a bit counter
outside 0-4, which only a carried state a stream never makes reaches),
thread 0 runs the rest of the tile too (the serial route), else the tile
takes the segmented route.  :func:`decode_serial` asks for the serial
route on every tile (to hold the two routes against each other).

:func:`decode` takes bit symbols (..., n) (a symbol is 1 where nonzero),
the output capacity ``cap``, the state (machine state, figures mode,
shift register, bit counter, char received: five int32 tensors shaped
like the symbols without their last axis) and the letters and figures
tables (32,) int32 on the symbols' device, and returns the emitted
characters packed to the front of (..., cap) uint8 (zeros after, the ones
past cap dropped), their count (...) int32 (at most cap) and the state'.
On the card every output stays there: no host read, no upload.
:func:`chain_cycles` measures on the card the serial machine's chain, the
floor of a design that runs a row on one thread; :func:`empty_launch`
launches an empty kernel through the same call path (the floor of one
launch).

The wrapper launches the kernel for CUDA tensors, or raises; it takes the
plain version only for CPU tensors.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from csdr_tpu_torch.kernels import _build

LAUNCHES = {"baudot_scan": 0}
PROBE_MAX = 4096        # symbols the chain probe stages (csrc/baudot.cu)
SEGMENT = 32            # symbols a thread's segment (csrc/baudot.cu kSeg)
MAX_THREADS = 1024      # a CTA's threads at most
FIGURE_SELECT = 0b11011     # RTTY_FIGURE_MODE_SELECT_CODE
LETTER_SELECT = 0b11111     # RTTY_LETTER_MODE_SELECT_CODE
# machine states (reference libcsdr.h:243-248)
WAIT_STOP, WAIT_START, RECV = 0, 1, 2


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def compact(hit: torch.Tensor, values: torch.Tensor, cap: int):
    """Stream compaction along the last axis: the ``values`` where ``hit``,
    packed to the front of a (..., cap) int32 buffer (zeros after), and
    their count clipped to cap.  Hits past cap are dropped."""
    pos = torch.cumsum(hit.to(torch.int32), -1) - 1
    tgt = torch.where(hit & (pos < cap), pos, cap).to(torch.int64)
    data = torch.zeros(hit.shape[:-1] + (cap + 1,), dtype=torch.int32,
                       device=hit.device)
    data.scatter_(-1, tgt, values.to(torch.int32))
    count = torch.clamp(hit.to(torch.int32).sum(-1, dtype=torch.int32),
                        max=cap)
    return data[..., :cap], count


def plan(n: int) -> int:
    """The threads of a row's CTA for rows of n symbols: a segment each,
    a multiple of 32, 32 to MAX_THREADS (a tile is SEGMENT x threads)."""
    segs = -(-n // SEGMENT)
    return min(MAX_THREADS, max(32, -(-segs // 32) * 32))


def zero_state(shape, device) -> tuple:
    """The machine at the stream's start: waiting for a stop pulse."""
    z = torch.zeros(shape, dtype=torch.int32, device=device)
    return (z + WAIT_STOP, z, z.clone(), z.clone(), z.clone())


def decode(symbols: torch.Tensor, cap: int, state, letters: torch.Tensor,
           figures: torch.Tensor):
    """The Baudot machine over ``symbols`` (..., n), n >= 1, from
    ``state``.  Returns (data (..., cap) uint8, count (...) int32,
    state').  A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`decode_plain`."""
    return _decode(symbols, cap, state, letters, figures, False)


def decode_serial(symbols: torch.Tensor, cap: int, state,
                  letters: torch.Tensor, figures: torch.Tensor):
    """:func:`decode` with the kernel told to take the serial route on
    every tile (thread 0 runs the machine): the same outputs, bit for
    bit."""
    return _decode(symbols, cap, state, letters, figures, True)


def _decode(symbols, cap, state, letters, figures, serial):
    if not symbols.is_cuda:
        if symbols.device.type != "cpu":
            raise ValueError(f"baudot: runs on CPU or CUDA tensors, not "
                             f"{symbols.device}")
        return decode_plain(symbols, cap, state, letters, figures)
    dev = symbols.device
    if symbols.dim() < 1 or symbols.shape[-1] < 1 or symbols.numel() == 0:
        raise ValueError(f"baudot: want symbols (..., n), n >= 1, got "
                         f"{tuple(symbols.shape)}")
    if cap < 1:
        raise ValueError(f"baudot: cap {cap} < 1")
    lead, n = tuple(symbols.shape[:-1]), symbols.shape[-1]
    rows = math.prod(lead)
    if symbols.dtype != torch.uint8:
        symbols = (symbols != 0).to(torch.uint8)
    sym = symbols.reshape(rows, n).contiguous()
    st = []
    for v in state:
        if not isinstance(v, torch.Tensor) or v.device != dev \
                or v.dtype != torch.int32:
            raise TypeError("baudot: the state is five int32 tensors on the "
                            "symbols' device")
        st.append(v.expand(lead).reshape(rows).contiguous())
    tables = []
    for t in (letters, figures):
        if t.device != dev or t.dtype != torch.int32 or t.shape != (32,):
            raise TypeError("baudot: the tables are (32,) int32 on the "
                            "symbols' device")
        tables.append(t.contiguous())
    data, count, out = _launch(sym, cap, st, tables, serial)
    LAUNCHES["baudot_scan"] += 1
    return (data.reshape(lead + (cap,)), count.reshape(lead),
            tuple(t.reshape(lead) for t in out))


def _launch(sym, cap, st, tables, serial=False, stamps=None):
    rows, n = sym.shape
    dev = sym.device
    data = torch.empty((rows, cap), dtype=torch.uint8, device=dev)
    count = torch.empty(rows, dtype=torch.int32, device=dev)
    out = [torch.empty(rows, dtype=torch.int32, device=dev)
           for _ in range(5)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (sym.data_ptr(), rows, n, cap, plan(n), int(serial),
            *(t.data_ptr() for t in tables), *(t.data_ptr() for t in st),
            data.data_ptr(), count.data_ptr(), *(t.data_ptr() for t in out))
    if stamps is None:
        _build.check(_build.lib().csdr_baudot_scan(*args, stream),
                     "baudot_scan")
    else:
        _build.check(_build.lib().csdr_baudot_phase_probe(
            *args, stamps.data_ptr(), stream), "baudot phase probe")
    return data, count, out


# the block-wide steps of a tile the timed kernel stamps (csrc/baudot.cu)
PHASES = ("staged", "first segment, maps", "map scan",
          "effects, their scan", "fig scan", "re-runs, count scan",
          "written")


def phase_cycles(symbols: torch.Tensor, cap: int, state, letters,
                 figures, serial: bool = False) -> list:
    """The kernel's timed instantiation over ``symbols`` (rows, n) uint8
    on the card from ``state`` (five (rows,) int32): SM cycles of each
    block-wide step (PHASES) of each tile of row 0, thread 0's clock, the
    first step from the previous tile's end (the first tile's from the
    launch's first stamp, so 0).  A serial tile has only its first two
    steps and its last.  Returns [{step: cycles}, ...] a tile; raises
    unless the outputs are :func:`decode`'s.  Not counted in
    ``LAUNCHES``."""
    rows, n = symbols.shape
    tiles = -(-n // (SEGMENT * plan(n)))
    stamps = torch.zeros((tiles, len(PHASES)), dtype=torch.int64,
                         device=symbols.device)
    got = _launch(symbols, cap, state, (letters, figures), serial, stamps)
    want = _launch(symbols, cap, state, (letters, figures), serial)
    for a, b in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        if not torch.equal(a, b):
            raise RuntimeError("baudot phase probe: the timed kernel's "
                               "outputs are not the kernel's")
    s = stamps.cpu().tolist()
    out, prev = [], s[0][0]
    for row in s:
        steps = {}
        for name, v in zip(PHASES, row):
            if v:
                steps[name] = v - prev
                prev = v
        out.append(steps)
    return out


def empty_launch() -> None:
    """One launch of an empty kernel (a warp) on the current stream,
    through the decoder's call path: what one launch costs at the least.
    Not counted in ``LAUNCHES``."""
    if not torch.cuda.is_available():
        raise RuntimeError("baudot: the empty kernel needs a card")
    _build.check(_build.lib().csdr_baudot_empty(
        torch.cuda.current_stream().cuda_stream), "baudot empty kernel")


def chain_cycles(symbols: torch.Tensor, letters: torch.Tensor,
                 figures: torch.Tensor, state=(0, 0, 0, 0, 0)) -> float:
    """SM cycles a symbol of the serial machine's shortest chain on the
    card (``csrc/baudot.cu``'s probe: the transition, branch-free, without
    the table read and the emit): one thread over ``symbols`` (one row of at
    most PROBE_MAX uint8 on the card) from shared memory, from the state
    given as numbers, timed.  Raises unless its last state is its step's
    and, with the characters the step emitted, the kernel's on the same
    symbols.  Not counted in ``LAUNCHES``."""
    if not symbols.is_cuda or symbols.dim() != 1 \
            or symbols.dtype != torch.uint8 \
            or not 0 < symbols.shape[0] <= PROBE_MAX:
        raise ValueError(f"baudot chain probe: want 1 to {PROBE_MAX} uint8 "
                         f"symbols on the card, got {tuple(symbols.shape)} "
                         f"{symbols.dtype} on {symbols.device}")
    dev = symbols.device
    x = symbols.contiguous()
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(7, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_build.lib().csdr_baudot_chain_probe(
        cycles.data_ptr(), x.data_ptr(), x.shape[0], letters.data_ptr(),
        figures.data_ptr(), *(int(v) for v in state), sink.data_ptr(),
        stream), "baudot chain probe")
    st = [torch.full((1,), int(v), dtype=torch.int32, device=dev)
          for v in state]
    _, count, out = _launch(x[None], x.shape[0], st, (letters, figures))
    want = [int(t) for t in out] + [int(count)]
    got = sink.cpu().tolist()
    if got[6] != 1:
        raise RuntimeError(f"baudot chain probe: the chain's last state "
                           f"{got[:5]} is not its step's")
    got = got[:6]
    if got != want:
        raise RuntimeError(f"baudot chain probe: the chain's last state and "
                           f"count {got} are not the kernel's {want}")
    return int(cycles.item()) / x.shape[0]


def decode_plain(symbols: torch.Tensor, cap: int, state,
                 letters: torch.Tensor, figures: torch.Tensor):
    """:func:`decode` as a Python loop of torch ops on the symbols'
    device, a symbol a step (csdr_tpu's scan step)."""
    sym_all = (symbols != 0).to(torch.int32)
    st, fig, shr, cnt, rcvd = state
    emits, chars = [], []
    for i in range(sym_all.shape[-1]):
        sym = sym_all[..., i]
        # WAITING_STOP_PULSE
        code = (shr & 31).to(torch.int64)
        is_fig_sel = code == FIGURE_SELECT
        is_let_sel = code == LETTER_SELECT
        ch = torch.where(fig != 0, figures[code], letters[code])
        one, zero = sym == 1, sym == 0
        at_stop, at_start, at_recv = st == WAIT_STOP, st == WAIT_START, \
            st == RECV
        got = at_stop & one & (rcvd != 0)
        emit_stop = got & ~is_fig_sel & ~is_let_sel
        fig_stop = torch.where(got, torch.where(
            is_fig_sel, 1, torch.where(is_let_sel, 0, fig)), fig)
        st_stop = torch.where(one, WAIT_START, WAIT_STOP)
        rcvd_stop = torch.where(one, rcvd, 0)
        # WAITING_START_PULSE
        st_start = torch.where(zero, RECV, WAIT_START)
        shr_start = torch.where(zero, 0, shr)
        cnt_start = torch.where(zero, 0, cnt)
        # RECEIVING_DATA
        shr_recv = ((shr << 1) | sym) & 0xFFFF
        done = cnt == 4
        st_recv = torch.where(done, WAIT_STOP, RECV)
        rcvd_recv = torch.where(done, 1, rcvd)

        emits.append(at_stop & emit_stop & (ch != 0))
        chars.append(ch)
        new_st = torch.where(at_stop, st_stop,
                             torch.where(at_start, st_start, st_recv))
        fig = torch.where(at_stop, fig_stop, fig)
        shr = torch.where(at_recv, shr_recv,
                          torch.where(at_start, shr_start, shr))
        cnt = torch.where(at_recv, cnt + 1,
                          torch.where(at_start, cnt_start, cnt))
        rcvd = torch.where(at_stop, rcvd_stop,
                           torch.where(at_start, 0, rcvd_recv))
        st = new_st
    state = tuple(t.to(torch.int32) for t in (st, fig, shr, cnt, rcvd))
    data, count = compact(torch.stack(emits, -1), torch.stack(chars, -1),
                          cap)
    return data.to(torch.uint8), count, state
