"""The RTTY Baudot decoder's kernel wrapper (``kernels/baudot_cuda``) on
the CPU, where it runs its plain version, against csdr_tpu bit for bit,
streamed; a Python model of the kernel's exact machine (csrc/baudot.cu)
against the plain version from any carried state, and of the transition
its serial chain's probe times; a Python model of the kernel's segmented
design (segment maps, the block scans, re-runs and compaction) against the
plain version and csdr_tpu; and the CLI's
rtty_line_decoder_u8_u8, which now runs on the command's device, against
csdr_tpu's bytes (with ``--device cpu``) and refusing without a card.  On
the card the kernel is held against the plain version bit for bit
(tests/test_torch_kernels.py, chip_smoke.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from csdr_tpu.ops import digital as jdig

from csdr_tpu_torch.kernels import baudot_cuda
from csdr_tpu_torch.ops import digital as tdig

from test_torch_cli import ROOT, run_both

torch.set_num_threads(2)


def _rtty_symbols(rng, n_chars):
    """Start bit 0, five data bits, stop bits 1, with random idle gaps."""
    out = []
    for _ in range(n_chars):
        out += [1] * int(rng.integers(1, 4))
        out += [0] + list(rng.integers(0, 2, 5)) + [1, 1]
    return np.asarray(out, np.uint8)


def _tables():
    return tdig._baudot_tables(torch.device("cpu"))


def test_decode_wrapper_matches_csdr_tpu_streamed():
    """Two rows of framed symbols (mode selects among them) in three calls
    with the state carried: each row's characters, count and state are
    csdr_tpu's bit for bit; a small cap drops the characters past it."""
    rng = np.random.default_rng(5)
    rows = [_rtty_symbols(rng, 80)[:600] for _ in range(2)]
    rows = np.stack(rows)
    cuts = (0, 170, 431, 600)
    st = baudot_cuda.zero_state((2,), "cpu")
    js = [None, None]
    for a, b in zip(cuts[:-1], cuts[1:]):
        part = rows[:, a:b]
        cap = (b - a) // 7 + 4
        data, count, st = baudot_cuda.decode(torch.from_numpy(part), cap, st,
                                             *_tables())
        for r in range(2):
            jo, js[r] = jdig.rtty_baudot_decoder(part[r], state=js[r])
            assert int(count[r]) == int(jo.count)
            np.testing.assert_array_equal(data[r].numpy(), np.asarray(jo.data))
            assert [int(t[r]) for t in st] == [int(v) for v in js[r]]
    data, count, _ = baudot_cuda.decode(torch.from_numpy(rows), 3,
                                        baudot_cuda.zero_state((2,), "cpu"),
                                        *_tables())
    for r in range(2):
        jo, _ = jdig.rtty_baudot_decoder(rows[r], max_out=3)
        assert int(count[r]) == int(jo.count) == 3
        np.testing.assert_array_equal(data[r].numpy(), np.asarray(jo.data))


def _kernel_model(sym, cap, state, letters, figures):
    """csrc/baudot.cu's machine in Python integers (int32 arithmetic
    wrapping as the kernel's unsigned forms do), one row."""
    def i32(v):
        return (v + (1 << 31)) % (1 << 32) - (1 << 31)

    st, fig, shr, cnt, rcvd = (int(v) for v in state)
    out = []
    for s in sym:
        one = int(s) != 0
        code = shr & 31
        is_fig, is_let = code == 27, code == 31
        ch = int(figures[code] if fig != 0 else letters[code])
        n = [st, fig, shr, cnt, rcvd]
        if st == 0:
            if one and rcvd != 0:
                if is_fig:
                    n[1] = 1
                elif is_let:
                    n[1] = 0
                elif ch != 0:
                    out.append(ch)
            n[0] = 1 if one else 0
            n[4] = rcvd if one else 0
        elif st == 1:
            if not one:
                n[0], n[2], n[3] = 2, 0, 0
            n[4] = 0
        else:
            done = cnt == 4
            if st == 2:
                n[2] = ((shr << 1) | int(one)) & 0xFFFF
                n[3] = i32(cnt + 1)
            n[0] = 0 if done else 2
            n[4] = 1 if done else rcvd
        st, fig, shr, cnt, rcvd = n
    data = np.zeros(cap, np.uint8)
    data[:min(len(out), cap)] = out[:cap]
    return data, min(len(out), cap), (st, fig, shr, cnt, rcvd)


def _transition_model(sym, state):
    """csrc/baudot.cu's baudot_next, the chain its probe times (the
    transition alone, branch-free, as selects), one row; returns the last
    state."""
    def i32(v):
        return (v + (1 << 31)) % (1 << 32) - (1 << 31)

    st, fig, shr, cnt, rcvd = (int(v) for v in state)
    for s in sym:
        one = int(s) != 0
        code = shr & 31
        s0, s1, s2 = st == 0, st == 1, st == 2
        done = cnt == 4
        sel = s0 and one and rcvd != 0
        start = s1 and not one
        fig = 1 if sel and code == 27 else 0 if sel and code == 31 else fig
        st, rcvd, shr, cnt = (
            (1 if one else 0) if s0 else (1 if one else 2) if s1 else
            (0 if done else 2),
            (rcvd if one else 0) if s0 else 0 if s1 else
            (1 if done else rcvd),
            0 if start else ((shr << 1) | int(one)) & 0xFFFF if s2 else shr,
            0 if start else i32(cnt + 1) if s2 else cnt)
    return st, fig, shr, cnt, rcvd


def _any_states(rng, rows):
    """Carried states the stream never makes (a machine state of -1, 3 or
    7, a counter at -1, 4 or int32's top, any shift register) and the usual
    ones, (5, rows) int32."""
    return np.stack([
        rng.choice([-1, 0, 1, 2, 3, 7], rows),
        rng.choice([0, 1, 5], rows),
        rng.integers(-(1 << 31), 1 << 31, rows, dtype=np.int64),
        rng.choice([-1, 0, 3, 4, 5, (1 << 31) - 1], rows),
        rng.choice([0, 1, -3], rows)]).astype(np.int32)


def test_kernel_model_matches_plain_from_any_state():
    """The kernel's machine (modelled here) against decode_plain from
    carried states the stream never makes (a machine state of -1, 3 or 7,
    a counter at -1, 4 or int32's top, any shift register) and from the
    usual ones, over random symbols (any nonzero byte a 1), caps small
    enough to drop characters: bit for bit."""
    rng = np.random.default_rng(6)
    letters, figures = (t.numpy() for t in _tables())
    rows, n = 48, 300
    states = _any_states(rng, rows)
    framed = np.stack([_rtty_symbols(rng, 50)[:n] for _ in range(rows)])
    noise = rng.integers(0, 3, (rows, n)).astype(np.uint8) * 7
    sym = np.where(np.arange(rows)[:, None] % 2 == 0, framed, noise)
    for cap in (2, n // 7 + 4):
        data, count, st = baudot_cuda.decode_plain(
            torch.from_numpy(sym), cap,
            tuple(torch.from_numpy(s) for s in states),
            *(torch.from_numpy(t) for t in (letters, figures)))
        for r in range(rows):
            d, c, s = _kernel_model(sym[r], cap, states[:, r], letters,
                                    figures)
            assert int(count[r]) == c, r
            np.testing.assert_array_equal(data[r].numpy(), d)
            assert [int(t[r]) for t in st] == list(s), r


def test_probe_transition_model_matches_plain_from_any_state():
    """The chain the decoder's bound is probed on (the machine's transition
    alone, branch-free; modelled here) ends in decode_plain's state from
    any carried state, over framed symbols and noise (any nonzero byte a
    1): what lets it stand for the machine."""
    rng = np.random.default_rng(16)
    rows, n = 48, 300
    states = _any_states(rng, rows)
    framed = np.stack([_rtty_symbols(rng, 50)[:n] for _ in range(rows)])
    noise = rng.integers(0, 3, (rows, n)).astype(np.uint8) * 7
    sym = np.where(np.arange(rows)[:, None] % 2 == 0, framed, noise)
    _, _, st = baudot_cuda.decode_plain(
        torch.from_numpy(sym), 4, tuple(torch.from_numpy(s) for s in states),
        *_tables())
    for r in range(rows):
        assert [int(t[r]) for t in st] == list(
            _transition_model(sym[r], states[:, r])), r


# ---------------------------------------------------------------------------
# a Python model of csrc/baudot.cu's segmented kernel, in 32-bit integer
# arithmetic, with its passes, scans, re-runs and compaction; the per-symbol
# forms of its passes (_segment_map's planes, _segment_effects, _exact_run)
# stand beside the kernel's (the table, a frame an iteration) as checks
# ---------------------------------------------------------------------------

_ALL = 0xFFFFFFFF
_CNT_KEPT, _RCVD_KEPT = 1 << 21, 1 << 22


def _i32(v):
    v &= _ALL
    return v - (1 << 32) if v >= 1 << 31 else v


def _entry_code(m):
    st, _, _, cnt, _ = m
    if st in (0, 1):
        return st
    if st == 2 and 0 <= cnt <= 4:
        return 3 + cnt
    return -1


def _exact_run(m, syms, tab):
    """baudot_step over syms from m (a list, updated); its characters."""
    out = []
    for s in syms:
        st, fig, shr, cnt, rcvd = m
        one = s != 0
        code = shr & 31
        s0, s1, s2 = st == 0, st == 1, st == 2
        check = s0 and one and rcvd != 0
        is_fig, is_let = code == 27, code == 31
        ch = tab[(32 if fig != 0 else 0) + code] \
            if check and not is_fig and not is_let else 0
        done, start = cnt == 4, s1 and not one
        m[0] = (1 if one else 0) if s0 else (1 if one else 2) if s1 else \
            (0 if done else 2)
        m[1] = 1 if check and is_fig else 0 if check and is_let else fig
        m[4] = (rcvd if one else 0) if s0 else 0 if s1 else \
            (1 if done else rcvd)
        m[2] = 0 if start else ((shr << 1) | one) & 0xFFFF if s2 else shr
        m[3] = 0 if start else _i32(cnt + 1) if s2 else cnt
        if ch != 0:
            out.append(ch & 0xFF)
    return out


def _spread4(x):
    """Bits 0-3 of x one to a byte: ((x & 15) * 0x00204081) & 0x01010101."""
    return (((x & 15) * 0x00204081) & _ALL) & 0x01010101


def _segment_map(syms):
    """segment_map: the seven codes' map on three bit planes (bit e of
    plane p: bit p of the code entry e has reached), returned as 8 bytes
    (lo, hi): byte e the code entry e reaches."""
    p0, p1, p2 = 0xAA, 0xCC, 0xF0
    for x in syms:
        s = _ALL if x != 0 else 0
        n2 = p2 ^ (p1 & p0)
        n1 = (p2 & (p1 ^ p0)) | (~p2 & ~p1 & p0 & ~s & _ALL)
        n0 = (p2 & ~p0 & _ALL) | (~p2 & ~p1 & (s | p0) & _ALL)
        p0, p1, p2 = n0 & _ALL, n1 & _ALL, n2 & _ALL
    return tuple(_spread4(p0 >> h) | _spread4(p1 >> h) << 1
                 | _spread4(p2 >> h) << 2 for h in (0, 4))


def _selector(x):
    """__byte_perm's selector of 4 bytes <= 7: nibble k = byte k."""
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0xFFFF


def _byte_perm(a, b, sel):
    """__byte_perm(a, b, sel) for selector nibbles <= 7."""
    both = a | b << 32
    return sum(((both >> (8 * ((sel >> (4 * k)) & 7))) & 0xFF) << (8 * k)
               for k in range(4))


def _map_then(f, g):
    """f, then g: byte e of the result is g's byte at f's byte e."""
    return tuple(_byte_perm(g[0], g[1], _selector(h)) for h in f)


def _map_code(f, c):
    return (f[c >> 2] >> (8 * (c & 3))) & 0xFF


_IDENT_MAP = (0x03020100, 0x07060504)

# the kernel's table: the map of each 8-symbol pattern (bit i symbol i)
_MAPS8 = [_segment_map([(b >> i) & 1 for i in range(8)]) for b in range(256)]


def _segment_map_table(syms):
    """The kernel's map of a segment: a full 32-symbol segment as its four
    bytes' table maps composed, else the planes a symbol a step."""
    if len(syms) != 32:
        return _segment_map(syms)
    bits = _bits(syms)
    m = _MAPS8[bits & 0xFF]
    for k in (1, 2, 3):
        m = _map_then(m, _MAPS8[(bits >> (8 * k)) & 0xFF])
    return m


_EFF_ID = (_ALL, _CNT_KEPT | _RCVD_KEPT, 0)


def _eff_then(a, b):
    bm = (b[1] >> 16) & 31
    m = min(((a[1] >> 16) & 31) + bm, 16)
    sb = (((a[1] & 0xFFFF) << bm) & b[0]) | (b[1] & 0xFFFF)
    rv = (a[1] >> 23) & 1 if b[1] & _RCVD_KEPT else (b[1] >> 23) & 1
    return (((a[0] << bm) & b[0]) & _ALL,
            (sb & 0xFFFF) | m << 16 | (a[1] & b[1] & (_CNT_KEPT | _RCVD_KEPT))
            | rv << 23,
            ((a[2] if b[1] & _CNT_KEPT else 0) + b[2]) & _ALL)


def _fig_then(a, b):
    return a if b & 1 else b


def _segment_effects(syms, q):
    """segment_effects: (effect, fig's known selects, the pending first stop
    pulse) of a segment from its entry code q."""
    sk, sb, m, cc, rv, fx, p = _ALL, 0, 0, 0, 0, 1, 0
    ckept = rkept = True
    for x in syms:
        one = int(x != 0)
        w0, w1, recv = q == 0, q == 1, q >= 3
        if w0 and one:
            if not rkept and (rv == 0 or sk & 31 == 0):
                code = sb & 31
                if rv and code == 27:
                    fx = 2
                elif rv and code == 31:
                    fx = 0
            else:
                # only the first stop pulse can read the entry
                assert p == 0 and fx == 1
                p = 1 | (2 if rkept else 0) | rv << 2 | m << 3 \
                    | (sk & 31) << 8 | (sb & 31) << 13
        if (w0 and not one) or w1:
            rkept, rv = False, 0
        elif q == 7:
            rkept, rv = False, 1
        if recv:
            sb = ((sb << 1) | one) & 0xFFFF
            sk = (sk << 1) & 0xFFFF
            m = min(m + 1, 16)
            cc = (cc + 1) & _ALL
        elif w1 and not one:
            sk = sb = cc = 0
            ckept = False
        q = (0 if q == 7 else q + 1) if recv else (one if w0 else
                                                    (1 if one else 3))
    eff = (sk, sb | m << 16 | (_CNT_KEPT if ckept else 0)
           | (_RCVD_KEPT if rkept else 0) | rv << 23, cc)
    return eff, fx, p


def _bits(syms):
    return sum(1 << i for i, v in enumerate(syms) if v != 0)


def _frame_bits(bits, i, s):
    """Symbols i .. i+s-1 of a segment, symbol i the highest bit: the
    kernel's (__brev(bits) << i) >> (32 - s)."""
    rev = int(f"{bits & _ALL:032b}"[::-1], 2)
    return ((rev << i) & _ALL) >> (32 - s)


def _fast_run(m, syms, tab):
    """run_fast: the exact machine from a state among the seven (m, a
    list, updated), a frame an iteration in three stages: a run of zeros
    and the stop pulse, a run of ones and the start pulse, the frame's
    bits at once."""
    n, bits = len(syms), _bits(syms)
    live = (1 << n) - 1
    ones, zeros = bits & live, ~bits & live
    q = _entry_code(m)
    _, fig, shr, cnt, rcvd = m
    i, out = 0, []
    while i < n:
        if q == 0:
            o = ones & (_ALL << i)
            j = (o & -o).bit_length() - 1 if o else n
            if j > i:
                rcvd = 0
            if j < n:
                if rcvd != 0:
                    code = shr & 31
                    if code == 27:
                        fig = 1
                    elif code == 31:
                        fig = 0
                    else:
                        ch = tab[(32 if fig != 0 else 0) + code]
                        if ch != 0:
                            out.append(ch & 0xFF)
                q = 1
            i = j + 1
        if q == 1 and i < n:
            rcvd = 0
            z = zeros & (_ALL << i)
            if z:
                i = (z & -z).bit_length()
                shr = cnt = 0
                q = 3
            else:
                i = n
        if q >= 3 and i < n:
            k = min(8 - q, n - i)
            shr = ((shr << k) | _frame_bits(bits, i, k)) & 0xFFFF
            cnt = _i32(cnt + k)
            q += k
            i += k
            if q == 8:
                q, rcvd = 0, 1
    m[:] = [q if q < 2 else 2, fig, shr, cnt, rcvd]
    return out


def _effects_fast(syms, q):
    """segment_effects, a frame an iteration as run_fast: the same effect,
    fig selects and pending stop pulse as _segment_effects."""
    n, bits = len(syms), _bits(syms)
    live = (1 << n) - 1
    ones, zeros = bits & live, ~bits & live
    sk, sb, m, cc, rv, fx, p = _ALL, 0, 0, 0, 0, 1, 0
    ckept = rkept = True
    i = 0
    while i < n:
        if q == 0:
            o = ones & (_ALL << i)
            j = (o & -o).bit_length() - 1 if o else n
            if j > i:
                rkept, rv = False, 0
            if j < n:
                if not rkept and (rv == 0 or sk & 31 == 0):
                    code = sb & 31
                    if rv and code == 27:
                        fx = 2
                    elif rv and code == 31:
                        fx = 0
                else:
                    assert p == 0 and fx == 1
                    p = 1 | (2 if rkept else 0) | rv << 2 | m << 3 \
                        | (sk & 31) << 8 | (sb & 31) << 13
                q = 1
            i = j + 1
        if q == 1 and i < n:
            rkept, rv = False, 0
            z = zeros & (_ALL << i)
            if z:
                i = (z & -z).bit_length()
                sk = sb = cc = 0
                ckept = False
                q = 3
            else:
                i = n
        if q >= 3 and i < n:
            k = min(8 - q, n - i)
            sb = ((sb << k) | _frame_bits(bits, i, k)) & 0xFFFF
            sk = (sk << k) & 0xFFFF
            m = min(m + k, 16)
            cc = (cc + k) & _ALL
            q += k
            i += k
            if q == 8:
                q, rkept, rv = 0, False, 1
    eff = (sk, sb | m << 16 | (_CNT_KEPT if ckept else 0)
           | (_RCVD_KEPT if rkept else 0) | rv << 23, cc)
    return eff, fx, p


def _resolve_pending(p, shr, rcvd):
    if not p & 1:
        return 1
    r = rcvd & _ALL if p & 2 else (p >> 2) & 1
    code = (((shr & _ALL) << ((p >> 3) & 31)) & ((p >> 8) & 31)) \
        | ((p >> 13) & 31)
    if r == 0:
        return 1
    return 2 if code == 27 else 0 if code == 31 else 1


def _block_exclusive(xs, then, ident, warp=32):
    """block_exclusive: shuffles up within each warp, the warps' totals
    scanned by the first warp, each thread's prefix from both."""
    n = len(xs)
    inc = list(xs)
    for w0 in range(0, n, warp):
        d = 1
        while d < warp:
            prev = list(inc)
            for lane in range(d, min(warp, n - w0)):
                inc[w0 + lane] = then(prev[w0 + lane - d], prev[w0 + lane])
            d *= 2
    tot = [inc[min(w0 + warp, n) - 1] for w0 in range(0, n, warp)]
    for i in range(1, len(tot)):
        tot[i] = then(tot[i - 1], tot[i])
    out = []
    for i in range(n):
        lane, w = i % warp, i // warp
        ex = ident if lane == 0 else inc[i - 1]
        out.append(ex if w == 0 else then(tot[w - 1], ex))
    return out


def _kernel_segmented(sym, cap, state, tab, seg=32, threads=None,
                      serial_only=False, warp=32):
    """csrc/baudot.cu's kernel over one row: tiles of seg x threads
    symbols; thread 0's exact first segment from an entry outside the seven
    states and the route; the segments' maps (the table's bytes composed),
    the map scan, the effects a frame an iteration and their scan, the
    stop pulses resolved and the fig scan, the re-runs a frame an
    iteration, the count scan and the packed characters; each fast pass
    checked against its per-symbol form.  Returns (data, count, state, the
    route of each tile: "serial" or "segmented")."""
    n = len(sym)
    if threads is None:
        threads = baudot_cuda.plan(n)
    tile = seg * threads
    carry = [int(v) for v in state]
    chars, routes = [], []
    for t0 in range(0, n, tile):
        s = [int(v) for v in sym[t0:t0 + tile]]
        segs = [s[i * seg:(i + 1) * seg] for i in range(threads)]
        m0 = list(carry)
        first = 0
        slot0 = []
        if serial_only or _entry_code(m0) < 0:
            first = 1                     # thread 0's exact first segment
            slot0 = _exact_run(m0, segs[0], tab)
            assert len(slot0) <= 1 + (seg - 1) // 7
        if serial_only or _entry_code(m0) < 0:
            routes.append("serial")
            packed = slot0 + _exact_run(m0, s[seg:], tab)
            carry = m0
        else:
            routes.append("segmented")
            # m0: the seed, the state after the first `first` segments
            maps = [_IDENT_MAP] * first + [_segment_map_table(g)
                                           for g in segs[first:]]
            assert maps[first:] == [_segment_map(g) for g in segs[first:]]
            pre = _block_exclusive(maps, _map_then, _IDENT_MAP, warp)
            c0 = _entry_code(m0)
            qs = [_map_code(p, c0) for p in pre]
            fx = [(_EFF_ID, 1, 0)] * first + [
                _effects_fast(g, q) for g, q in zip(segs[first:],
                                                    qs[first:])]
            assert fx[first:] == [_segment_effects(g, q) for g, q in
                                  zip(segs[first:], qs[first:])]
            pe = _block_exclusive([f[0] for f in fx], _eff_then, _EFF_ID,
                                  warp)
            ins = []
            for q, (sk, w, cc) in zip(qs, pe):
                shr = _i32((((m0[2] & _ALL) << ((w >> 16) & 31)) & sk)
                           | (w & 0xFFFF))
                cnt = _i32(((m0[3] & _ALL) if w & _CNT_KEPT else 0) + cc)
                rcvd = m0[4] if w & _RCVD_KEPT else (w >> 23) & 1
                ins.append([q if q < 2 else 2, None, shr, cnt, rcvd])
            figs = [1] * first + [
                _fig_then(_resolve_pending(p, m[2], m[4]), f)
                for (_, f, p), m in zip(fx[first:], ins[first:])]
            pf = _block_exclusive(figs, _fig_then, 1, warp)
            slots, exits = [slot0] * first, [m0] * first
            for g, m, f in zip(segs[first:], ins[first:], pf[first:]):
                m[1] = m0[1] if f & 1 else f >> 1
                slow = list(m)
                slots.append(_fast_run(m, g, tab))
                assert (slots[-1], m) == (_exact_run(slow, g, tab), slow)
                assert len(slots[-1]) <= 1 + (seg - 1) // 7
                exits.append(m)
            offs = _block_exclusive([len(c) for c in slots],
                                    lambda a, b: a + b, 0, warp)
            packed = [0] * (offs[-1] + len(slots[-1]))
            for o, c in zip(offs, slots):
                packed[o:o + len(c)] = c
            carry = exits[-1]
        assert len(packed) <= 1 + (len(s) - 1) // 7
        chars += packed
    data = np.zeros(cap, np.uint8)
    data[:min(len(chars), cap)] = chars[:cap]
    return data, min(len(chars), cap), tuple(carry), routes


def _tab():
    letters, figures = (t.numpy() for t in _tables())
    return [int(v) for v in letters] + [int(v) for v in figures]


# the carried states chip_smoke.baudot_cases holds the kernel to on the
# card (its first six those of its rows before it had twelve)
_SMOKE_STATES = np.asarray(
    [[0, 1, 2, 0, -1, 7, 0, 1, 2, 0, 2, 2],
     [0, 0, 1, 0, 5, 0, 1, 0, 5, 0, 0, 1],
     [0, 3, 27, 31, -9, 1 << 20, 27, 0, -4, 31, 5, 3],
     [0, 0, 4, 0, -1, (1 << 31) - 1, 0, 5, 2, 0, -60, 5],
     [0, 1, 0, 1, -3, 0, 1, 0, -3, 1, 1, 0]], np.int32)


def _plain_row(sym, cap, state):
    d, c, st = baudot_cuda.decode_plain(
        torch.from_numpy(np.asarray(sym, np.uint8)[None]), cap,
        tuple(torch.tensor([int(v)], dtype=torch.int32) for v in state),
        *_tables())
    return d[0].numpy(), int(c[0]), tuple(int(t[0]) for t in st)


def _nonconverging(rng, period=11, tries=400):
    """A periodic word whose framing never converges: its period's map of
    the seven codes keeps two or more codes apart however often it runs
    (the first such random word of the seed)."""
    for _ in range(tries):
        word = rng.integers(0, 2, period).astype(np.uint8)
        f = _segment_map(word)
        g = f
        for _ in range(8):
            g = _map_then(g, f)
        if len({_map_code(g, c) for c in (0, 1, 3, 4, 5, 6, 7)}) >= 2:
            return word
    raise AssertionError("no non-converging word found")


def _route_rule(sym, state, seg, tile, tab):
    """Each tile's route by the rule in csrc/baudot.cu: serial when the
    tile's entry state is outside the seven and its first segment, run
    exactly, ends outside them too."""
    m, routes = [int(v) for v in state], []
    for t0 in range(0, len(sym), tile):
        if _entry_code(m) < 0:
            _exact_run(m, [int(v) for v in sym[t0:t0 + seg]], tab)
            routes.append("serial" if _entry_code(m) < 0 else "segmented")
            _exact_run(m, [int(v) for v in sym[t0 + seg:t0 + tile]], tab)
        else:
            routes.append("segmented")
            _exact_run(m, [int(v) for v in sym[t0:t0 + tile]], tab)
    return routes


@pytest.mark.parametrize("seg,threads", [(1, 8), (2, 5), (3, 4), (5, 3),
                                         (7, 6), (8, 4), (32, 2),
                                         (32, None)])
def test_segmented_model_matches_plain(seg, threads):
    """The segmented kernel's model against decode_plain bit for bit, at
    segment sizes that put a seam in every position of a frame (1, 2, 3,
    5, 7, 8 and the kernel's 32; warps of 4 threads so the scans cross
    warps): framed symbols and noise, all ones, all zeros, a periodic word
    whose framing never converges, from the usual states and every carried
    state of _any_states and of chip_smoke.py, at a cap that drops
    characters and one that does not; the route the rule gives."""
    rng = np.random.default_rng(40 + seg)
    tab = _tab()
    n = 150
    word = _nonconverging(np.random.default_rng(41))
    rows = [_rtty_symbols(rng, 30)[:n],
            rng.integers(0, 3, n).astype(np.uint8) * 9,
            np.ones(n, np.uint8), np.zeros(n, np.uint8),
            np.resize(word, n)]
    states = np.concatenate([_any_states(rng, 10), _SMOKE_STATES,
                             np.zeros((5, 1), np.int32)], 1)
    warp = 4 if threads not in (None, 2) else 32
    tile = seg * (threads or baudot_cuda.plan(n))
    pairs = [(row, states[:, (j + r) % states.shape[1]])
             for r, row in enumerate(rows) for j in range(states.shape[1])]
    for cap in (3, n // 7 + 4):
        want = baudot_cuda.decode_plain(
            torch.from_numpy(np.stack([p[0] for p in pairs])), cap,
            tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in
                  np.stack([p[1] for p in pairs], 1)), *_tables())
        for i, (row, st) in enumerate(pairs):
            d, c, s, routes = _kernel_segmented(row, cap, st, tab, seg,
                                                threads, warp=warp)
            assert c == int(want[1][i]), (i, cap)
            np.testing.assert_array_equal(d, want[0][i].numpy())
            assert list(s) == [int(t[i]) for t in want[2]], (i, cap)
            assert routes == _route_rule(row, st, seg, tile, tab)


def test_segmented_model_routes_and_edges():
    """The rule's routes: st 2 with cnt -1 resolves inside the first
    segment (segmented), cnt -60 in the third tile of 32 (two serial
    tiles, then segmented ones), cnt 5 and int32's top never in 389
    symbols (every tile serial); the
    serial route asked for; n of 1, a ragged tail, a row shorter than the
    CTA's segments, many tiles; the periodic word from different entry
    states keeps its states apart to the end and still matches."""
    tab = _tab()
    rng = np.random.default_rng(44)
    row = _rtty_symbols(rng, 60)[:389]
    for st, serial in (((2, 0, 5, -1, 1), 0), ((2, 0, 5, 5, 1), 13),
                       ((2, 0, 5, -60, 1), 2),
                       ((2, 1, 3, (1 << 31) - 1, 0), 13),
                       ((7, 5, -4, 4, -3), 0), ((-1, 0, 0, 2, 0), 0)):
        d, c, s, routes = _kernel_segmented(row, 70, st, tab, 8, 4, warp=2)
        assert routes == ["serial"] * serial + ["segmented"] * (
            len(routes) - serial) == _route_rule(row, st, 8, 32, tab)
        assert (d.tolist(), c, s) == tuple(
            v.tolist() if isinstance(v, np.ndarray) else v
            for v in _plain_row(row, 70, st))
        d2, c2, s2, routes = _kernel_segmented(row, 70, st, tab, 8, 4,
                                               serial_only=True, warp=2)
        assert routes == ["serial"] * len(routes)
        assert (d2.tolist(), c2, s2) == (d.tolist(), c, s)
    for n in (1, 2, 31, 33, 64, 65, 97):
        part = row[:n]
        for st in ((0, 0, 0, 0, 0), (0, 1, 27, 5, 1), (2, 0, 3, 2, 1)):
            got = _kernel_segmented(part, 5, st, tab, 32, None)
            want = _plain_row(part, 5, st)
            assert (got[0].tolist(), got[1], got[2]) == (
                want[0].tolist(), want[1], want[2]), (n, st)
    word = _nonconverging(np.random.default_rng(41))
    periodic = np.resize(word, 400)
    finals = set()
    for st in ((0, 0, 0, 0, 0), (1, 0, 0, 0, 0), (2, 0, 0, 0, 0),
               (2, 0, 0, 2, 0)):
        got = _kernel_segmented(periodic, 80, st, tab, 7, 8, warp=4)
        want = _plain_row(periodic, 80, st)
        assert (got[0].tolist(), got[1], got[2]) == (
            want[0].tolist(), want[1], want[2])
        finals.add(_entry_code(list(got[2])))
    assert len(finals) >= 2


def test_segmented_model_matches_csdr_tpu_streamed():
    """The model streamed over three calls with the state carried (the
    kernel's 32-symbol segments and its CTA plan) against csdr_tpu's
    rtty_baudot_decoder, bit for bit: characters, count and state."""
    rng = np.random.default_rng(45)
    tab = _tab()
    row = _rtty_symbols(rng, 200)[:1300]
    st, js = (0, 0, 0, 0, 0), None
    for a, b in ((0, 1), (1, 700), (700, 1300)):
        part = row[a:b]
        cap = (b - a) // 7 + 4
        d, c, st, _ = _kernel_segmented(part, cap, st, tab)
        jo, js = jdig.rtty_baudot_decoder(part, state=js)
        assert c == int(jo.count)
        np.testing.assert_array_equal(d, np.asarray(jo.data))
        assert list(st) == [int(v) for v in js]


def test_cli_rtty_line_decoder_cpu_is_csdr_tpus():
    """rtty_line_decoder_u8_u8 with --device cpu, pumped at 200 symbols a
    chunk (the machine's state carried across chunks): csdr_tpu's bytes."""
    rng = np.random.default_rng(7)
    sym = _rtty_symbols(rng, 300)
    (rj, oj, ej), (rt, ot, et) = run_both(
        "rtty_line_decoder_u8_u8", [], sym.tobytes(),
        env={"CSDR_FIXED_BUFSIZE": "200"})
    assert rj == rt == 0 and et == ej
    assert len(ot) > 100 and ot == oj


@pytest.mark.parametrize("device", [None, "cpu"])
def test_cli_rtty_line_decoder_refuses_without_cuda(device):
    """No CUDA (CUDA_VISIBLE_DEVICES empty) and no --device cpu: the
    command exits non-zero and writes nothing, like every device command;
    with --device cpu it decodes."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    sym = _rtty_symbols(np.random.default_rng(8), 40)
    argv = [sys.executable, "-m", "csdr_tpu_torch.cli",
            "rtty_line_decoder_u8_u8"] + (["--device", device] if device
                                          else [])
    p = subprocess.run(argv, input=sym.tobytes(), capture_output=True,
                       cwd=ROOT, env=env, timeout=120)
    if device is None:
        assert p.returncode != 0 and p.stdout == b""
        assert b"CUDA is not available" in p.stderr, p.stderr
    else:
        assert p.returncode == 0 and len(p.stdout) > 10, p.stderr
