"""The chunked AGC's kernel (``csrc/agc.cu``, ``kernels/agc_cuda.relax``)
on the CPU: a model of the kernel's control flow in numpy float32 against
the port's ``agc_ff_chunked`` (its plain version here), bit for bit, and the
wrapper's routing and refusals.  Then the exact scan's kernel
(``csrc/agc_exact.cu``, ``kernels/agc_cuda.scan``): its cases streamed
through ``agc_block(method="scan")``, the wrapper's routing and
refusals, and the CLI's ``agc_ff`` with an attack wait reaching it.

The model (:func:`agc_model`) does what the kernel does and the plain
version does not: each chunk leaves its inner relaxation at the first
round whose attack and clip masks equal the round's before (a chunk that
never settles runs all ``iters``), the stop test runs on the rows' exit
values in float32 as every block of the kernel computes it, and it counts
the rounds.  The port's ``agc_ff_chunked`` is held to csdr_tpu's in
tests/test_torch_agc.py; the card tests (tests/test_torch_kernels.py) hold
the kernel to the plain version and to this model's rounds.  This file
imports no jax, so the card tests may import the model.

A plain relaxation over 50 000 samples takes ~1.2 s here; the cases stay
few and small."""

import numpy as np
import pytest
import torch

from csdr_tpu_torch import cli
from csdr_tpu_torch.kernels import agc_cuda
from csdr_tpu_torch.ops import agc

torch.set_num_threads(2)
NEG = -(1 << 30)
F32 = np.float32


def _row(c, live, f, ef, eh, start, p):
    """A row's inner relaxation at entries (ef, eh) from trajectory f, as a
    block of the kernel runs it; returns (trajectory, exit hang, rounds,
    settled)."""
    hang = p["hang_time"]
    entry_last = eh - hang if eh > 0 else NEG
    att_p = clip_p = None
    settled, rounds = False, 0
    for it in range(p["iters"]):
        rounds = it + 1
        fp = np.concatenate([[ef], f[:-1]]).astype(F32)
        att = live & (c < fp)
        dec = live & ~att
        dc = np.cumsum(dec, dtype=np.int64)
        last = np.maximum(np.maximum.accumulate(np.where(att, dc, NEG)),
                          entry_last)
        frozen = dec & (last > NEG // 2) & (dc - last <= hang)
        rate = np.where(att, p["ar"], np.where(dec & ~frozen, p["dr"],
                                               F32(0)))
        clip = (fp + rate * (c - fp)) > p["mg"]
        mul = np.where(clip, p["oma"], (F32(1) - rate) + p["oma"])
        add = np.where(clip, p["mg"], rate * c)
        if start:
            mul[0], add[0] = F32(1), F32(0)
        add[0] = add[0] + mul[0] * ef
        dc_e, last_e = int(dc[-1]), int(last[-1])
        if it > 0 and np.array_equal(att, att_p) \
                and np.array_equal(clip, clip_p):
            settled = True
            break
        att_p, clip_p = att, clip
        off = 1
        while off < len(f):                 # Hillis-Steele, step by step
            add = np.concatenate([add[:off], add[off:] + mul[off:]
                                  * add[:-off]])
            mul = np.concatenate([mul[:off], mul[off:] * mul[:-off]])
            off *= 2
        f = add
    h = hang - (dc_e - last_e) if last_e > NEG // 2 else 0
    return f, min(max(h, 0), hang), rounds, settled


def _slice_counts(att, dec, width):
    """The kernel's integer scans over a row cut into slices (axis 0) of
    segments of ``width`` samples: each segment's decays and latest
    attack, the segments scanned within their slice, the slices' totals
    combined over the earlier slices (the cluster's carry).  Returns dc and
    the latest attack's dc so far (NEG if none) for every sample."""
    K, S = att.shape
    a = att.reshape(K, S // width, width)
    d = dec.reshape(K, S // width, width).astype(np.int64)
    cs = np.cumsum(d, axis=2)                      # decays in the segment
    at = np.maximum.accumulate(np.where(a, cs, NEG), axis=2)
    seg_cnt, seg_last = cs[:, :, -1], at[:, :, -1]
    # one warp's scan of the slice's segments: exclusive counts, carries
    before = np.cumsum(seg_cnt, axis=1) - seg_cnt
    lasts = np.where(seg_last != NEG, before + seg_last, NEG)
    carry = np.concatenate([np.full((K, 1), NEG), np.maximum.accumulate(
        lasts, axis=1)[:, :-1]], axis=1)
    # the slice's summary, then the earlier slices' carry into it
    tot_cnt, tot_last = seg_cnt.sum(axis=1), np.max(lasts, axis=1)
    cnt_in = np.cumsum(tot_cnt) - tot_cnt
    abs_last = np.where(tot_last != NEG, cnt_in + tot_last, NEG)
    last_in = np.concatenate([[NEG], np.maximum.accumulate(abs_last)[:-1]])
    start = cnt_in[:, None, None] + before[:, :, None]
    dc = start + cs
    last = np.maximum(np.where(carry != NEG, cnt_in[:, None] + carry,
                               NEG)[:, :, None],
                      np.where(at != NEG, start + at, NEG))
    last = np.maximum(last, last_in[:, None, None])
    return dc.reshape(-1), last.reshape(-1)


def _scan_cluster(add, mul, K):
    """The Hillis-Steele scan of one row's pairs as a cluster of K > 1 CTAs
    runs it (csrc/agc.cu's affine_scan): CTA r holds a window of 2S
    positions, the previous slice's pairs (the halo, r > 0) below its own.
    A step at offset o < S updates the slice and the window positions
    w >= 2o - 1 from the window alone, two at once (w >= 4o - 1, the
    step-o pair at w - 2o computed beside) while 4o <= S; the positions no
    later step reads are left NaN, so a read of one shows.  A step at
    o >= S takes the slice's partners from slice r - o/S and the window's
    last position's from slice r - o/S - 1, as they were pushed.  Returns the new
    trajectory (K, S) and each slice's left neighbour's f (the window's
    last position; NaN for slice 0)."""
    S = add.shape[1]
    C = K * S
    nan = F32(np.nan)
    wa = np.full((K, 2 * S), nan, F32)
    wm = np.full((K, 2 * S), nan, F32)
    wa[:, S:], wm[:, S:] = add, mul
    wa[1:, :S], wm[1:, :S] = add[:-1], mul[:-1]

    def step(a, m, p, q, first):
        """Positions p after a step from their partners q (a partner below
        `first`, the lowest position the CTA holds, is none)."""
        ok = q >= first
        qc = np.maximum(q, 0)
        return (np.where(ok, a[p] + m[p] * a[qc], a[p]),
                np.where(ok, m[p] * m[qc], m[p]))
    off = 1
    while off < S:
        # two steps at once while 4 off <= S: the step-off pair at w - 2off
        # from w - 2off and w - 3off, as the kernel's thread computes it
        pair = 4 * off <= S
        na = np.full_like(wa, nan)
        nm = np.full_like(wm, nan)
        w = np.arange((4 if pair else 2) * off - 1, 2 * S)
        for r in range(K):
            first = 0 if r > 0 else S       # slice 0 has no window
            ww = w[w >= first]
            a1, m1 = step(wa[r], wm[r], ww, ww - off, first)
            if pair:
                p2 = ww - 2 * off
                a2, m2 = step(wa[r], wm[r], np.maximum(p2, 0), p2 - off,
                              first)
                has = p2 >= first
                a1, m1 = (np.where(has, a1 + m1 * a2, a1),
                          np.where(has, m1 * m2, m1))
            na[r, ww], nm[r, ww] = a1, m1
        wa, wm = na, nm
        off *= 4 if pair else 2
    sa, sm = wa[:, S:].copy(), wm[:, S:].copy()
    ha, hm = wa[:, S - 1].copy(), wm[:, S - 1].copy()
    while off < C:
        q = off // S
        na, nm, nha, nhm = sa.copy(), sm.copy(), ha.copy(), hm.copy()
        na[q:] = sa[q:] + sm[q:] * sa[:-q]
        nm[q:] = sm[q:] * sm[:-q]
        nha[q + 1:] = ha[q + 1:] + hm[q + 1:] * sa[:-q - 1, -1]
        nhm[q + 1:] = hm[q + 1:] * sm[:-q - 1, -1]
        sa, sm, ha, hm = na, nm, nha, nhm
        off *= 2
    ha[0] = nan
    return sa, ha


def _row_sliced(c, live, f, ef, eh, start, p, K):
    """:func:`_row` as the kernel runs it over a cluster of K CTAs: the row
    in K slices of S samples (S a power of two when K > 1), the integer
    scans by segment, slice and cluster (:func:`_slice_counts`), the
    affine scan as :func:`_scan_cluster` exchanges it, and each slice's
    left neighbour's f from its own window after a scan (from the
    trajectory before the first)."""
    hang = p["hang_time"]
    C = len(f)
    S = C // K
    assert S * K == C and (K == 1 or S & (S - 1) == 0)
    width = 32 if S % 32 == 0 else S
    entry_last = eh - hang if eh > 0 else NEG
    att_p = clip_p = None
    settled, rounds = False, 0
    left = np.concatenate([[ef], f.reshape(K, S)[:-1, -1]]).astype(F32)
    for it in range(p["iters"]):
        rounds = it + 1
        fs = f.reshape(K, S)
        left[0] = ef
        fp = np.concatenate([left[:, None], fs[:, :-1]], axis=1).reshape(-1)
        att = live & (c < fp)
        dec = live & ~att
        dc, last = _slice_counts(att.reshape(K, S), dec.reshape(K, S), width)
        last = np.maximum(last, entry_last)
        frozen = dec & (last > NEG // 2) & (dc - last <= hang)
        rate = np.where(att, p["ar"], np.where(dec & ~frozen, p["dr"],
                                               F32(0)))
        clip = (fp + rate * (c - fp)) > p["mg"]
        mul = np.where(clip, p["oma"], (F32(1) - rate) + p["oma"])
        add = np.where(clip, p["mg"], rate * c)
        if start:
            mul[0], add[0] = F32(1), F32(0)
        add[0] = add[0] + mul[0] * ef
        dc_e, last_e = int(dc[-1]), int(last[-1])
        if it > 0 and np.array_equal(att, att_p) \
                and np.array_equal(clip, clip_p):
            settled = True
            break
        att_p, clip_p = att, clip
        if K == 1:
            off = 1
            while off < C:
                add = np.concatenate([add[:off], add[off:] + mul[off:]
                                      * add[:-off]])
                mul = np.concatenate([mul[:off], mul[off:] * mul[:-off]])
                off *= 2
            f = add
        else:
            fs, left = _scan_cluster(add.reshape(K, S), mul.reshape(K, S), K)
            f = fs.reshape(-1)
    h = hang - (dc_e - last_e) if last_e > NEG // 2 else 0
    return f, min(max(h, 0), hang), rounds, settled


def agc_model(x, reference=0.2, attack_rate=0.01, decay_rate=0.0001,
              max_gain=65536.0, hang_time=200, gain_filter_alpha=0.999,
              last_gain=1.0, last_hang=0, started=False, chunk=8192,
              iters=14, cluster=None):
    """csrc/agc.cu's relaxation in numpy float32: (y, gain, hang,
    converged, rounds), rounds (2, B + 2, B) int32 as ``agc_cuda.relax``
    returns it (the inner rounds of each row in each outer round, then
    whether its masks settled).  ``cluster``: each row as K CTAs run it
    (:func:`_row_sliced`), else as one flat row (:func:`_row`)."""
    x = np.asarray(x, F32)
    n = len(x)
    f0, h0 = F32(last_gain), int(last_hang)
    if n == 0:
        return x, f0, h0, True, np.zeros((2, 2, 0), np.int32)
    cw = -(-chunk // 128) * 128
    rows = -(-n // cw)
    xr = np.zeros(rows * cw, F32)
    xr[:n] = x
    xr = xr.reshape(rows, cw)
    nz = xr != 0
    with np.errstate(all="ignore"):
        ax = np.abs(xr)
        ax = np.where(ax < F32(1e-30), F32(1e-30), ax)
        c = np.where(nz, (F32(1) / ax) * F32(reference), F32(0))
    live = nz.copy()
    live[0, 0] &= bool(started)
    p = {"hang_time": int(hang_time), "iters": iters, "ar": F32(attack_rate),
         "dr": F32(decay_rate), "mg": F32(max_gain),
         "oma": F32(1.0 - gain_filter_alpha)}
    traj = np.full((rows, cw), f0, F32)
    xf = np.zeros((3, rows), F32)
    xh = np.zeros((3, rows), np.int64)
    xs = np.zeros((3, rows), bool)
    table = np.zeros((2, rows + 2, rows), np.int32)
    with np.errstate(all="ignore"):
        for r in range(rows + 2):
            cur, prev = r % 3, (r + 2) % 3
            for b in range(rows):
                first = r == 0 or b == 0
                ef = f0 if first else xf[prev, b - 1]
                eh = h0 if first else int(xh[prev, b - 1])
                f, h, k, settled = (
                    _row(c[b], live[b], traj[b], ef, eh,
                         b == 0 and not started, p) if cluster is None
                    else _row_sliced(c[b], live[b], traj[b], ef, eh,
                                     b == 0 and not started, p, cluster))
                traj[b] = f
                xf[cur, b], xh[cur, b], xs[cur, b] = f[-1], h, settled
                table[:, r, b] = k, settled
            # the stop test, in float32 as every block computes it
            new_ef = np.concatenate([[f0], xf[cur, :-1]]).astype(F32)
            new_eh = np.concatenate([[h0], xh[cur, :-1]])
            old_ef = np.full(rows, f0, F32) if r == 0 else np.concatenate(
                [[f0], xf[prev, :-1]]).astype(F32)
            old_eh = np.full(rows, h0) if r == 0 else np.concatenate(
                [[h0], xh[prev, :-1]])
            aef = np.abs(old_ef)
            aef = np.where(aef < F32(1e-3), F32(1e-3), aef)
            stable = bool(np.all(np.abs(new_ef - old_ef) <= F32(1e-6) * aef)
                          and np.all(new_eh == old_eh))
            if stable:
                break
        y = traj.reshape(-1)[:n] * x
    return (y, traj.reshape(-1)[n - 1], int(xh[cur, rows - 1]),
            stable and bool(xs[cur].all()), table)


def agc_signal(n=50_000):
    """tests/test_agc.py's signal: a modulated tone with a zero run (the
    attack, hang, decay and zero branches all run)."""
    s = ((0.3 + 0.25 * np.sin(2 * np.pi * 0.0007 * np.arange(n)))
         * np.sin(2 * np.pi * 0.043 * np.arange(n))).astype(np.float32)
    s[10_000:10_100] = 0.0
    return s


def speech_like(n, seed):
    """SSB-like audio: noise low-passed by a moving average under a
    syllable envelope, with a pause."""
    r = np.random.default_rng(seed)
    w = np.convolve(r.standard_normal(n + 15), np.ones(16) / 16, "valid")
    env = 0.05 + 0.5 * np.abs(np.sin(2 * np.pi * 3.1 * np.arange(n) / 48e3))
    s = (w[:n] * env).astype(np.float32)
    s[n // 3: n // 3 + 2000] = 0.0
    return s


# name -> (input, agc_ff_chunked's keyword arguments): the cases the kernel
# is held to on the card as well (chip_smoke.agc_cases at full size)
CASES = {
    # stream start; its 7th chunk is padded and never settles
    "agc_signal_start": (lambda: agc_signal(), {}),
    "speech_continuing": (lambda: speech_like(20_000, 1),
                          {"started": True, "last_gain": 3.7,
                           "last_hang": 57}),
    "zero_run_max_gain_100": (
        lambda: np.concatenate([np.full(4096, 1e-6, F32),
                                np.zeros(15_904, F32)]),
        {"max_gain": 100.0}),
    "n0": (lambda: np.zeros(0, F32), {"last_gain": 2.5, "last_hang": 7}),
    "n1": (lambda: np.array([0.5], F32), {"last_gain": 2.0,
                                          "last_hang": 3}),
    "n8192": (lambda: speech_like(8192, 2), {"started": True}),
    "n8193": (lambda: speech_like(8193, 3), {}),
    "chunk256": (lambda: speech_like(3000, 4), {"chunk": 256,
                                                "last_hang": 150}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_equals_agc_ff_chunked_bit_for_bit(name):
    make, kw = CASES[name]
    x = make()
    y, g, h, conv = agc.agc_ff_chunked(torch.from_numpy(x), **kw)
    ym, gm, hm, convm, table = agc_model(x, **kw)
    assert y.dtype == torch.float32 and y.shape == (len(x),)
    assert np.array_equal(y.numpy().view(np.int32), ym.view(np.int32))
    assert np.float32(g).view(np.int32) == F32(gm).view(np.int32)
    assert (int(h), bool(conv)) == (hm, convm)
    rounds = table[0]
    outer = int((rounds[:, 0] > 0).sum()) if len(x) else 0
    assert np.all(rounds[:outer] >= 1) and np.all(rounds[outer:] == 0)
    assert np.all(rounds <= 14) and np.all(table[1][outer:] == 0)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_a_row_over_a_cluster_equals_the_flat_row_bit_for_bit(name,
                                                              cluster):
    """The kernel's exchange over K slices (partners from the own slice or
    an earlier one, segment summaries combined across slices) gives the
    flat Hillis-Steele row's outputs and rounds bit for bit, whatever K."""
    make, kw = CASES[name]
    x = make()
    flat = agc_model(x, **kw)
    sliced = agc_model(x, cluster=cluster, **kw)
    assert np.array_equal(sliced[0].view(np.int32), flat[0].view(np.int32))
    assert F32(sliced[1]).view(np.int32) == F32(flat[1]).view(np.int32)
    assert sliced[2:4] == flat[2:4]
    assert np.array_equal(sliced[4], flat[4])


def _fits(table):
    return lambda k, spread: table.get((k, spread), 0)


# (rows, chunk, most, the plan) with the clusters that fit by (K, spread)
# as an H100 gives them at 8192 (132 SMs, two samples a thread sharing
# SMs: a slice of 2048 samples an SM)
PLAN_FITS = {(16, True): 7, (8, True): 15, (4, True): 33, (2, True): 66,
             (1, True): 132, (16, False): 33, (8, False): 33,
             (4, False): 33, (2, False): 66, (1, False): 132}


@pytest.mark.parametrize("rows,chunk,most,want", [
    (6, 8192, 16, (16, True)),     # E's and F's chunks: 96 SMs
    (6, 8192, 8, (8, True)),
    (7, 8192, 16, (16, True)),
    (8, 8192, 16, (8, True)),
    (16, 8192, 16, (4, True)),
    (33, 8192, 16, (4, True)),
    (34, 8192, 16, (4, False)),    # in turns: 2 turns at every K, K = 4
    (134, 8192, 16, (4, False)),
    (1, 384, 16, (1, True)),       # 3 x 128: a slice of 384 is K = 1
    (12, 256, 16, (2, True)),
    (200, 2048, 16, (1, False)),   # in turns at K = 1
])
def test_cluster_plan_picks_the_size_from_the_rows(rows, chunk, most, want,
                                                   monkeypatch):
    monkeypatch.setattr(agc_cuda, "CLUSTER_MAX", most)
    assert agc_cuda.cluster_plan(rows, chunk, _fits(PLAN_FITS)) == want


def test_cluster_plan_takes_only_slices_the_kernel_holds(monkeypatch):
    """Slices of a multiple of 128 samples, at most 2048, a power of two
    when K > 1, at most CLUSTER_MAX CTAs: 8192 takes K >= 4, 384 and 768
    only K = 1; a chunk with no fitting size raises."""
    assert agc_cuda.cluster_sizes(8192) == [16, 8, 4]
    assert agc_cuda.cluster_sizes(4096) == [16, 8, 4, 2]
    assert agc_cuda.cluster_sizes(384) == [1]
    assert agc_cuda.cluster_sizes(768) == [1]      # 384-sample slices
    assert agc_cuda.cluster_sizes(2048) == [16, 8, 4, 2, 1]
    # fewest turns first, then the smallest K
    fits = _fits({(8, False): 40, (4, False): 50, (16, False): 30})
    assert agc_cuda.cluster_plan(100, 8192, fits) == (4, False)
    with pytest.raises(RuntimeError, match="no cluster fits"):
        agc_cuda.cluster_plan(3, 8192, _fits({}))
    monkeypatch.setattr(agc_cuda, "CLUSTER_MAX", 8)
    assert agc_cuda.cluster_sizes(8192) == [8, 4]


def test_the_padded_chunk_runs_every_round_and_the_rest_settle():
    """_agc_signal from the stream's start (tests/test_torch_agc.py): past
    the first outer round the padded 7th chunk flips one mask element a
    round, a 2-cycle, so it runs all 14 inner rounds and the call reports
    no convergence; the other chunks settle in fewer.  The model's output is
    the plain version's all the same (the case above)."""
    _, _, _, conv, table = agc_model(agc_signal())
    rounds, settled = table
    outer = int((rounds[:, 0] > 0).sum())
    assert outer == 3 and not conv
    assert np.all(rounds[1:outer, 6] == 14) and not settled[1:outer, 6].any()
    assert settled[1:outer, :6].all() and np.all(rounds[1:outer, :6] < 14)
    assert np.all(rounds[outer:] == 0)


def test_relax_sends_cpu_tensors_to_its_plain_version(monkeypatch):
    """agc_cuda.relax calls relax_plain through the module (so the lint's
    stand-in sees it), counts no launch, and raises for what only the
    kernel gives (its rounds)."""
    seen = []

    def plain(*a, **k):
        seen.append(a[0])
        return "plain"
    n0 = dict(agc_cuda.LAUNCHES)
    monkeypatch.setattr(agc_cuda, "relax_plain", plain)
    x = torch.ones(300)
    assert agc.agc_ff_chunked(x) == "plain" and seen[0] is x
    assert agc_cuda.LAUNCHES == n0
    with pytest.raises(ValueError, match="iters"):
        agc_cuda.relax(x, iters=0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        agc_cuda.relax(x, rounds=True)


class _OnTheCard(torch.Tensor):
    """A CPU tensor that says it is on the card: the wrapper's checks run
    before anything reaches the kernel library."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("kw,match", [
    ({"chunk": 8193}, "128 to 8192"),
    ({"hang_time": 200.5}, "not an integer"),
    ({"iters": 0}, "iters"),
])
def test_relax_refuses_what_the_kernel_cannot_take(kw, match):
    x = torch.ones(1000).as_subclass(_OnTheCard)
    with pytest.raises(ValueError, match=match):
        agc_cuda.relax(x, **kw)
    with pytest.raises(TypeError, match="1-D"):
        agc_cuda.relax(torch.ones(2, 8).as_subclass(_OnTheCard))


class _FakeLib:
    """The kernel library's exact-scan entry point, recording its launches
    and launching nothing."""

    def __init__(self):
        self.calls = []

    def csdr_agc_ff_scan(self, *args):
        self.calls.append(args)
        return 0


def test_cli_agc_with_attack_wait_stops_on_the_card(monkeypatch):
    """agc_ff with an attack wait time is the exact per-sample scan.  It
    used to stop under a CUDA device; since the scan has a kernel it no
    longer stops there: under a CUDA device (the CLI's default) the CLI
    builds agc_block(method="scan") and a step of it reaches the kernel's
    launch with the command's parameters (the library stubbed, a CPU
    tensor that says it is on the card standing in for a chunk), in both
    argument forms; the help names no host-only path."""
    import types
    monkeypatch.setattr(cli, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    lib = _FakeLib()
    monkeypatch.setattr(agc_cuda._build, "lib", lambda: lib)
    seen = []

    def pump(block, in_fmt, out_fmt, **kw):
        seen.append((block.method, cli._dev().type))
        x = torch.from_numpy(agc_signal(3000)).as_subclass(_OnTheCard)
        block(block.init("cpu"), x)
    monkeypatch.setattr(cli, "pump", pump)
    n0 = agc_cuda.LAUNCHES["agc_ff_scan"]
    argv = ["csdr_tpu_torch", "agc_ff", "200", "0.2", "0.01", "0.0001",
            "65536", "5"]
    assert not cli.main(argv)
    assert not cli.main(["csdr_tpu_torch", "agc_ff", "--attackwait", "3"])
    assert seen == [("scan", "cuda")] * 2
    assert agc_cuda.LAUNCHES["agc_ff_scan"] == n0 + 2
    (x, n, started, *f, hang, wait), (*_, wait3) = (
        c[:10] for c in lib.calls)
    assert (n, started, hang, wait, wait3) == (3000, 0, 200, 5, 3)
    assert [float(v) for v in f] == [float(F32(v)) for v in (
        0.2, 0.01, 0.0001, 65536, 0.999)]
    assert "host" not in cli.USAGE["agc_ff"]
    assert "--device cpu" not in cli.USAGE["agc_ff"]


# name -> (input, agc_ff's keyword arguments): the cases the exact scan's
# kernel is held to on the card (tests/test_torch_kernels.py; chip_smoke.py
# at its own sizes): the zero run at three attack waits, a continuation
# with a carried state, one sample, a NaN and an inf
def _nan_inf():
    s = agc_signal(6000)
    s[1000], s[3000], s[3001] = np.nan, np.inf, -np.inf
    return s


def _edges():
    """Samples that reach the clamp's and the error's edge cases: -0.0
    and subnormals (ref/|x| overflows to inf: the decay's sum is inf, the
    clamp's high end), loud bursts (at attack rate 2.5 the gain falls
    below 0: its low end)."""
    s = speech_like(6000, 11)
    s[100:110] = -0.0
    s[500:520] = np.float32(1e-40)
    s[2000:2040] = np.float32(3e4)
    s[2040:2050] = -np.float32(1e-44)
    return s


SCAN_CASES = {
    "wait0": (lambda: agc_signal(), {}),
    "wait5": (lambda: agc_signal(), {"attack_wait_time": 5}),
    "wait200": (lambda: agc_signal(), {"attack_wait_time": 200}),
    "continuing": (lambda: speech_like(9000, 7),
                   {"attack_wait_time": 5, "started": True,
                    "last_gain": 3.7, "last_hang": 57, "last_peak": 0.031,
                    "last_awc": 2}),
    "n1": (lambda: np.array([0.5], F32), {"attack_wait_time": 5,
                                          "last_gain": 2.0}),
    "nan_inf": (_nan_inf, {"attack_wait_time": 5}),
    "edges": (_edges, {"attack_wait_time": 3, "hang_time": 20,
                       "attack_rate": 2.5, "max_gain": 50.0,
                       "started": True, "last_gain": 0.5,
                       "last_peak": 0.05}),
    "max_gain_negative": (lambda: agc_signal(3000),
                          {"attack_wait_time": 2, "max_gain": -1.0}),
}


def exact_step_model(x, gain, hang, peak, awc, started=False,
                     reference=0.2, attack_rate=0.01, decay_rate=0.0001,
                     max_gain=65536.0, hang_time=200, attack_wait_time=0,
                     gain_filter_alpha=0.999):
    """csrc/agc_exact.cu's exact_step in numpy float32, select for select:
    the attack keyed on q < g, both rates' sums, the gain selected among g
    and them, the clamp as two compares of the selected gain and two
    selects.  Returns (y, gain, hang, peak, awc) and the samples that took
    the clamp's low end, its high end, and an infinite quotient."""
    ref, ar, dr = F32(reference), F32(attack_rate), F32(decay_rate)
    mg, alpha = F32(max_gain), F32(gain_filter_alpha)
    floor = mg if mg < F32(0) else F32(0)
    g, pk, hang, awc = F32(gain), F32(peak), int(hang), int(awc)
    y = np.empty_like(x)
    hits = {"low": 0, "high": 0, "inf_q": 0}
    with np.errstate(all="ignore"):
        for i, xi in enumerate(x):
            if i == 0 and not started:
                y[0] = g * xi
                continue
            ia = abs(xi)
            q = ref / ia
            hits["inf_q"] += bool(xi != 0 and np.isinf(q))
            error = q - g
            nz = xi != 0
            attack, decay = nz and q < g, nz and not q < g
            newpeak = attack and pk < ia
            pk = ia if newpeak else pk
            a = attack_wait_time if newpeak else awc
            waiting, hanging = a > 0, hang > 0
            up, down = g + error * ar, g + error * dr
            gain = (g if waiting else up) if attack else (
                down if decay and not hanging else g)
            awc = (a - 1 if waiting else a) if attack else awc
            hang = (hang if waiting else hang_time) if attack else (
                hang - 1 if decay and hanging else hang)
            low, high = F32(0) > gain, mg < gain
            gain = mg if high else gain
            gain = floor if low else gain
            hits["low"] += low
            hits["high"] += high and not low
            g = gain + g - alpha * g
            y[i] = g * xi
    return y, g, hang, pk, awc, hits


# the model's cases: the kernel's, and a gain of -0.0 kept by the clamp
# while the hang holds it (agc_block's init divides by the gain, so this
# one is not streamed)
MODEL_CASES = dict(SCAN_CASES, negative_zero_gain=(
    lambda: speech_like(3000, 12),
    {"attack_wait_time": 2, "started": True, "last_gain": -0.0,
     "last_hang": 4, "last_peak": 0.05}))


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_exact_step_model_equals_the_host_loop(name):
    """The kernel's branch-free step (exact_step_model) against the host
    loop agc_cuda.scan_plain, bit for bit with NaNs compared by place: y
    and the final gain, hang, peak and attack-wait count; the edge cases
    reach both ends of the clamp and an infinite quotient."""
    x, kw = MODEL_CASES[name][0](), dict(MODEL_CASES[name][1])
    state = (F32(kw.pop("last_gain", 1.0)), kw.pop("last_hang", 0))
    peak = kw.pop("last_peak", None)
    state += (F32(0.2 / float(state[0])) if peak is None else F32(peak),
              kw.pop("last_awc", 0))
    *got, hits = exact_step_model(x, *state, **kw)
    want = agc_cuda.scan_plain(torch.from_numpy(x), *state, **kw)
    y = want[0].numpy()
    assert np.array_equal(np.isnan(got[0]), np.isnan(y))
    ok = ~np.isnan(y)
    assert np.array_equal(got[0][ok].view(np.int32), y[ok].view(np.int32))
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(np.asarray(a, b.numpy().dtype).view(np.int32),
                              b.numpy().view(np.int32)), name
    if name == "edges":
        assert min(hits.values()) > 0, hits




@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_scan_block_streams_each_case_as_one_call(name):
    """agc_block(method="scan") over each case in three chunks (from the
    case's state) gives the one-call output and state bit for bit: the
    stream's start is skipped once, the counters and the peak carry."""
    make, kw = SCAN_CASES[name]
    x = make()
    kw = dict(kw)
    started = kw.pop("started", False)
    peak, awc = kw.pop("last_peak", None), kw.pop("last_awc", 0)
    y1, *st1 = agc.agc_ff(torch.from_numpy(x), full_state=True,
                          started=started, last_peak=peak, last_awc=awc,
                          **kw)
    blk = agc.agc_block(method="scan", **kw)
    state = list(blk.init("cpu"))
    if peak is not None:
        state[2] = torch.tensor(F32(peak))
    state[1] = torch.tensor(kw.get("last_hang", 0), dtype=torch.int32)
    state[3], state[4] = torch.tensor(awc, dtype=torch.int32), \
        torch.tensor(started)
    state, parts = tuple(state), []
    for part in np.array_split(x, 3):
        state, y = blk(state, torch.from_numpy(part))
        parts.append(y)
    y = torch.cat(parts)
    assert np.array_equal(y.numpy().view(np.int32), y1.numpy().view(np.int32))
    for a, b in zip(state[:4], st1):
        assert a.dtype == b.dtype
        assert np.array_equal(a.numpy().view(np.int32),
                              b.numpy().view(np.int32))
    if name == "nan_inf":
        assert np.isnan(y.numpy()).any()


def test_scan_sends_cpu_tensors_to_its_plain_version(monkeypatch):
    """agc_cuda.scan calls scan_plain through the module (so the lint's
    stand-in sees it) and counts no launch."""
    seen = []

    def plain(*a, **k):
        seen.append(a[0])
        return "plain"
    n0 = dict(agc_cuda.LAUNCHES)
    monkeypatch.setattr(agc_cuda, "scan_plain", plain)
    x = torch.ones(300)
    assert agc_cuda.scan(x, 1.0, 0, 0.2, 0) == "plain" and seen[0] is x
    assert agc_cuda.LAUNCHES == n0


def test_scan_refuses_what_the_kernel_cannot_take():
    """A 2-D stream, samples that are not float32, a state on another
    device or of another type, and counters that are not int32."""
    x = torch.ones(100).as_subclass(_OnTheCard)
    state = [torch.tensor(1.0), torch.tensor(0, dtype=torch.int32),
             torch.tensor(0.2), torch.tensor(0, dtype=torch.int32)]
    with pytest.raises(TypeError, match="1-D"):
        agc_cuda.scan(torch.ones(2, 8).as_subclass(_OnTheCard), *state)
    with pytest.raises(TypeError, match="float32"):
        agc_cuda.scan(torch.ones(100, dtype=torch.float64).as_subclass(
            _OnTheCard), *state)
    for i in range(4):
        moved = list(state)
        moved[i] = torch.zeros((), dtype=state[i].dtype, device="meta")
        with pytest.raises(ValueError, match="the stream on"):
            agc_cuda.scan(x, *moved)
    with pytest.raises(TypeError, match="int32"):
        agc_cuda.scan(x, state[0], torch.tensor(0.0), *state[2:])
    with pytest.raises(TypeError, match="one element"):
        agc_cuda.scan(x, 1.0, *state[1:])
    with pytest.raises(ValueError, match="not an int32"):
        agc_cuda.scan(x, *state, hang_time=200.5)
    with pytest.raises(ValueError, match="not an int32"):
        agc_cuda.scan(x, *state, attack_wait_time=1 << 31)
    with pytest.raises(ValueError, match="CUDA device only"):
        agc_cuda.exact_cycles(torch.ones(16))
