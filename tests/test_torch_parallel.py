"""The sharded banks of csdr_tpu_torch (parallel/: halo, WFM bank, fastddc
bank, and the mesh form of the config-5 flagship) against csdr_tpu's on
the same mesh shape, on the same seeded inputs.

The port's ranks are gloo processes on the CPU, one spawn a mesh shape
(``parallel.mesh.run_mesh``), every bank of that shape run inside it and
its results gathered to rank 0; csdr_tpu runs on the conftest's virtual
CPU devices on a Mesh of the same (chan, time) shape.  The rank jobs are
this module's ``_job_*`` functions, which a spawned rank imports, so the
module imports no jax at its top: the tests import csdr_tpu inside.

Bars: the WFM bank >= 90 dB and atol 5e-3 against csdr_tpu
(tests/test_sharded.py); the DDC bank atol 2e-4, and per channel the
bar of tests/test_torch_multichannel.py (D=16: csdr_tpu's fused inverse
against K4's factored form, ~116 dB); the flagship's bits within 2
errors a channel of csdr_tpu's and each channel's BER < 0.02 against its
TX bits (tests/test_multichannel.py); collective bytes exactly the count
the halo, fixup and corner-turn shapes give.

The captured steps (parallel/segments.SegmentedStep) run in the same
ranks with the CPU rehearsal of a CUDA graph (tests/torch_rehearsal) in
each segment's place: bit for bit the eager step on every rank, the same
collective bytes, one graph where time is 1, else a graph between each
two collectives, and held against csdr_tpu at the bars above."""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from csdr_tpu_torch.models import bpsk31 as tbpsk
from csdr_tpu_torch.models import multichannel as tmc
from csdr_tpu_torch.ops import fastddc as tfd
from csdr_tpu_torch.parallel import (halo, mesh as pm, segments, sharded_ddc,
                                     sharded_wfm)
from csdr_tpu_torch.utils import collectives as co
from torch_rehearsal import Rehearsal

torch.set_num_threads(2)

SHAPES = [(1, 4), (2, 2), (4, 1)]
N_WFM = 4 * 6400            # 8 channels, 128 audio samples a time shard
DDC_CASES = {16: (16, 8), 50: (100, 4)}   # D: (frames in all, channels)
SPS = 64
CENTERS = np.array([-0.3, -0.1, 0.15, 0.35])
TEXTS = [bytes(f"CHANNEL {i} DE CSDR_TPU PSE K ".encode()) * 4
         for i in range(4)]
HALO = 3
C8 = 8                      # bytes of a complex64 sample
# a captured step's segments: one graph where time is 1, else the split at
# the collectives
SEGMENTS = {"wfm": ["body", "finish"], "ddc16": ["body"], "ddc50": ["body"],
            "fwd_only": ["body"], "flagship": ["body", "modem"]}


def snr_db(ref, test) -> float:
    err = np.sum(np.abs(ref - test) ** 2)
    return np.inf if err == 0 else float(
        10 * np.log10(np.sum(np.abs(ref) ** 2) / err))


def _align(a, b):
    return tbpsk.align_errors(a, b, range(-6, 6))


def wideband(decim, texts, centers, steps, seed=9, delta=0.0, noise=0.01,
             shards=4):
    """Each text's BPSK31 baseband at SPS*decim samples a symbol, mixed to
    its centre, summed, plus noise: ``steps`` chunks that split into whole
    q-frame groups over ``shards`` time shards."""
    tx_bits, bbs = [], []
    for t in texts:
        bits, bb = tbpsk.tx_chain(t, interpolation=SPS * decim,
                                  device="cpu")
        tx_bits.append(bits)
        bbs.append(bb.numpy())
    ddc = tfd.fastddc_init(0.05, decim)
    q = tfd._class_plan(ddc)[0] if ddc.post_input_size % ddc.post_decimation \
        else 1
    unit = ddc.input_size * q * shards
    n = min(map(len, bbs)) // (unit * steps) * unit
    k = np.arange(n * steps)
    acc = np.zeros(n * steps, np.complex64)
    for bb, f in zip(bbs, centers):
        acc += (bb[: n * steps] * np.exp(2j * np.pi * (f + delta) * k)
                ).astype(np.complex64)
    rng = np.random.default_rng(seed)
    acc += (noise * (rng.standard_normal(n * steps)
                     + 1j * rng.standard_normal(n * steps))
            ).astype(np.complex64)
    return tx_bits, [acc[s * n:(s + 1) * n] for s in range(steps)]


# ---------------------------------------------------------------------------
# rank jobs (run in the spawned ranks; jax-free)
# ---------------------------------------------------------------------------

def _job_threads(mesh):
    torch.set_num_threads(1)


def _counted(mesh, run):
    """``run()``'s result and the mesh's collective bytes while it ran."""
    co.reset_collectives()
    out = run()
    return out, co.mesh_total(mesh)


def _job_halo(mesh, x, bs, as_):
    """halo_from_left and affine_scan_fixup on known values: the halos and
    carries gathered, and what they sent."""
    xl = pm.shard_input(torch.from_numpy(x), mesh)
    t = mesh.coords["time"]

    def run():
        h = halo.halo_from_left(xl, HALO, mesh)
        cat = halo.concat_with_left_halo(xl, HALO, mesh)
        carry = halo.affine_scan_fixup(torch.from_numpy(bs[t]),
                                       torch.from_numpy(as_[t]), 0.5, mesh)
        return h, cat, carry

    (h, cat, carry), nbytes = _counted(mesh, run)
    return {"halo": pm.gather_output(h[None], mesh),
            "cat": pm.gather_output(cat[None], mesh),
            "carry": pm.gather_output(carry[None], mesh),
            "bytes": nbytes}


def _rehearsed(step):
    """``step``'s SegmentedStep with the rehearsal in each graph's place
    (every state leaf on the "card")."""
    return segments.SegmentedStep(step, lambda fn: Rehearsal(fn, ()))


def _same_bits(a, b) -> bool:
    """Two pytrees of tensors bit for bit."""
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        u.dtype == v.dtype and u.shape == v.shape and torch.equal(
            u.contiguous().reshape(-1).view(torch.uint8),
            v.contiguous().reshape(-1).view(torch.uint8))
        for u, v in zip(la, lb))


def _every_rank(mesh, v) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, v)
    return out


def _captured(mesh, step, xs, gather=pm.gather_output) -> dict:
    """The stateless ``step`` eagerly and through its rehearsed capture on
    each of ``xs`` in turn: whether each call's output is bit for bit on
    every rank, the captured first output gathered, the collective bytes
    and the captures after each call, and the segments."""
    cap = _rehearsed(step)
    same, nbytes, captures, first = [], [], [], None
    for x in xs:
        want = step(x)
        got, b = _counted(mesh, lambda: cap(x))
        same.append(_same_bits(want, got))
        nbytes.append(b)
        captures.append(cap.captures)
        first = got if first is None else first
    return {"same": _every_rank(mesh, same), "y": gather(first, mesh),
            "bytes": nbytes, "captures": captures,
            "segments": sorted(cap.segments)}


def _job_wfm(mesh, n):
    """The WFM bank; captured, on the chunk twice and on a chunk of half
    its length (a key of its own), and captured whole where time > 1 (its
    halo collective inside the capture must raise)."""
    step, x = sharded_wfm.example_bank(mesh, n)
    xl = pm.shard_input(x, mesh)
    y, nbytes = _counted(mesh, lambda: step(xl))
    out = {"y": pm.gather_output(y, mesh), "bytes": nbytes,
           "tail_ext": step.tail_ext,
           "captured": _captured(mesh, step, [
               xl, xl, pm.shard_input(x[:n // 2], mesh)])}
    if mesh.shape["time"] > 1:
        whole = Rehearsal(lambda s, v: step.run(s, v, segments.eager), ())
        out["whole_capture_error"] = None
        try:
            whole((), xl)
        except RuntimeError as e:
            out["whole_capture_error"] = str(e)
    return out


def _job_ddc(mesh, d, frames, c_total):
    step, x, ddc, _ = sharded_ddc.example_ddc_bank(
        mesh, frames // mesh.shape["time"], c_total, d)
    xl = pm.shard_input(x, mesh)
    y, nbytes = _counted(mesh, lambda: step(xl))
    return {"y": pm.gather_output(y, mesh), "bytes": nbytes,
            "captured": _captured(mesh, step, [xl, xl])}


def _job_flagship(mesh, chunks, decim, rates, kw):
    """The mesh bank over the chunks, eagerly and through its rehearsed
    capture: bits, counts and state."""
    init, step, meta = tmc.build_ddc_bpsk31_bank(rates, decim, SPS, mesh=mesh,
                                                 **kw)
    bank = meta["bank"]
    cap, captures = _rehearsed(bank), []

    def run(step):
        st, outs = init(len(chunks[0])), []
        for x in chunks:
            xl = pm.shard_input(torch.from_numpy(x), mesh)
            st, out = step(st, xl)
            outs.append(out)
            if step is cap:
                captures.append(cap.captures)
        return st, outs

    def gathered(outs):
        return [(pm.gather_output(b, mesh, time_sharded=False),
                 pm.gather_output(c, mesh, time_sharded=False))
                for b, c in outs]

    (st, outs), nbytes = _counted(mesh, lambda: run(step))
    (cst, couts), cbytes = _counted(mesh, lambda: run(cap))
    m = bank.samples_per_chunk(len(chunks[0]))
    return {"outs": gathered(outs), "bytes": nbytes, "m": m,
            "captured": {"same": _every_rank(mesh, [
                _same_bits(o, c) for o, c in zip(outs, couts)] + [
                _same_bits(st, cst)]), "outs": gathered(couts),
                "bytes": [cbytes], "captures": captures,
                "segments": sorted(cap.segments)}}


def _job_fwd_only(mesh, frames):
    """build_fwd_only_step: each rank's spectra of its time slice."""
    ddc = tfd.fastddc_init(0.05, 50)
    _, x, _, _ = sharded_ddc.example_ddc_bank(
        mesh, frames // mesh.shape["time"], 4, 50)
    step = sharded_ddc.build_fwd_only_step(mesh, ddc)
    xl = pm.shard_input(x, mesh)
    spectra, nbytes = _counted(mesh, lambda: step(xl))

    # frames run along time: gather them as the last axis
    def gather(s, mesh):
        g = pm.gather_output(s.T.contiguous(), mesh)
        return None if g is None else g.T

    return {"spectra": gather(spectra, mesh), "x": x, "bytes": nbytes,
            "captured": _captured(mesh, step, [xl, xl], gather)}


@functools.cache
def _flagship_input():
    return wideband(16, TEXTS, CENTERS, 2)


def _halo_input():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(64) + 1j * rng.standard_normal(64)
         ).astype(np.complex64)
    bs = rng.uniform(0.5, 1.0, (4, 3)).astype(np.float32)
    as_ = rng.standard_normal((4, 3)).astype(np.float32)
    return x, bs, as_


def _jobs():
    x, bs, as_ = _halo_input()
    _, chunks = _flagship_input()
    rates = [-f for f in CENTERS]
    return ([_job_threads, functools.partial(_job_halo, x=x, bs=bs, as_=as_),
             functools.partial(_job_wfm, n=N_WFM)]
            + [functools.partial(_job_ddc, d=d, frames=f, c_total=c)
               for d, (f, c) in DDC_CASES.items()]
            + [functools.partial(_job_flagship, chunks=chunks, decim=16,
                                 rates=rates, kw={}),
               functools.partial(_job_fwd_only, frames=100)])


@pytest.fixture(scope="module")
def port():
    """Every shape's results: one spawn of 4 gloo ranks a shape."""
    out = {}
    for shape in SHAPES:
        res = pm.run_mesh(functools.partial(pm.run_jobs, jobs=_jobs()),
                          *shape, backend="gloo", device="cpu")
        out[shape] = dict(zip(("halo", "wfm", "ddc16", "ddc50", "flagship",
                               "fwd_only"), res[1:]))
    return out


# ---------------------------------------------------------------------------
# csdr_tpu on the same mesh shape
# ---------------------------------------------------------------------------

def _jmesh(chan, time):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:chan * time]).reshape(chan, time),
                ("chan", "time"))


def _jax_flagship(shape, chunks, decim, kw=None):
    import jax.numpy as jnp
    from csdr_tpu.core.cplx import CF
    from csdr_tpu.models import multichannel as jmc

    rates = [-f for f in CENTERS]
    init, step, _ = jmc.build_ddc_bpsk31_bank(_jmesh(*shape), rates, decim,
                                              SPS, **(kw or {}))
    st, outs = init(len(chunks[0])), []
    for x in chunks:
        st, (bits, counts) = step(st, CF(jnp.asarray(x.real.copy()),
                                         jnp.asarray(x.imag.copy())))
        outs.append((np.asarray(bits), np.asarray(counts)))
    return outs


@pytest.fixture(scope="module")
def jax_ref():
    from csdr_tpu.parallel import sharded_ddc as jsd, sharded_wfm as jsw

    _, chunks = _flagship_input()
    out = {}
    for shape in SHAPES:
        m = _jmesh(*shape)
        step, x = jsw.example_bank(m, N_WFM)
        r = {"wfm": np.asarray(step(x))}
        for d, (frames, c) in DDC_CASES.items():
            step, x, _, _ = jsd.example_ddc_bank(
                m, frames // shape[1], c, d)
            y = step(x)
            r[f"ddc{d}"] = np.asarray(y.re) + 1j * np.asarray(y.im)
        r["flagship"] = _jax_flagship(shape, chunks, 16)
        out[shape] = r
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_halo_and_fixup_against_numpy(port, shape):
    """Each time shard gets its left neighbour's last HALO samples (zeros
    on shard 0), [halo | shard] as concat_with_left_halo gives it, and the
    carry entering it from the shards to its left."""
    chan, time = shape
    x, bs, as_ = _halo_input()
    r = port[shape]["halo"]
    nl = len(x) // time
    want_h, want_cat, want_c = [], [], []
    for t in range(time):
        h = x[t * nl - HALO:t * nl] if t else np.zeros(HALO, np.complex64)
        want_h.append(h)
        want_cat.append(np.concatenate([h, x[t * nl:(t + 1) * nl]]))
        carry = np.full(3, 0.5, np.float32)
        for i in range(t):
            carry = bs[i] * carry + as_[i]
        want_c.append(carry)
    np.testing.assert_array_equal(r["halo"],
                                  np.tile(np.concatenate(want_h), (chan, 1)))
    np.testing.assert_array_equal(r["cat"],
                                  np.tile(np.concatenate(want_cat), (chan, 1)))
    np.testing.assert_allclose(r["carry"],
                               np.tile(np.concatenate(want_c), (chan, 1)),
                               rtol=1e-6)
    # halo and concat each send HALO samples per non-last time shard;
    # the fixup all-gathers a (2, 3) float32 pair to time-1 peers
    assert r["bytes"]["halo"] == 2 * chan * (time - 1) * HALO * C8
    assert r["bytes"]["fixup"] == chan * time * (time - 1) * 2 * 3 * 4
    assert r["bytes"]["corner_turn"] == 0


def _check_wfm(got, ref):
    assert got.shape == ref.shape == (8, N_WFM // 50)
    assert snr_db(ref, got) >= 90.0, snr_db(ref, got)
    np.testing.assert_allclose(got, ref, atol=5e-3)


def _check_ddc(got, ref, d):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.real, ref.real, atol=2e-4)
    np.testing.assert_allclose(got.imag, ref.imag, atol=2e-4)
    bar = 100.0 if d == 16 else 110.0
    for c in range(got.shape[0]):
        assert snr_db(ref[c], got[c]) >= bar, (c, snr_db(ref[c], got[c]))


def _check_flagship(outs, ref_outs):
    """Every channel decoded (BER < 0.02 over > 200 bits) and its bits
    within 2 errors of csdr_tpu's."""
    tx_bits, _ = _flagship_input()
    for c in range(4):
        got = np.concatenate([b[c, :k[c]] for b, k in outs])
        ref = np.concatenate([b[c, :k[c]] for b, k in ref_outs])
        errs, total = _align(tx_bits[c][8:], got[8:])
        assert total > 200 and errs / total < 0.02, (c, errs, total)
        errs, total = _align(ref, got)
        assert errs <= 2 and total > 200, (c, errs, total)


def _check_fwd_only(got, x, chan):
    """Every time shard's spectra, in order, are the single-card forward
    block's (kernel order) over the whole chunk, bit for bit."""
    blk = tfd.fastddc_fwd_block(tfd.fastddc_init(0.05, 50),
                                spectra_order="kernel")
    _, want = blk(blk.init("cpu"), torch.from_numpy(x))
    assert got.shape == (want.shape[0], chan * want.shape[1])
    for c in range(chan):
        np.testing.assert_array_equal(
            got[:, c * want.shape[1]:(c + 1) * want.shape[1]], want.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_wfm_bank_matches_csdr_tpu(port, jax_ref, shape):
    chan, time = shape
    _check_wfm(port[shape]["wfm"]["y"], jax_ref[shape]["wfm"])
    r = port[shape]["wfm"]
    assert r["bytes"]["halo"] == chan * (time - 1) * r["tail_ext"] * C8
    assert r["bytes"]["fixup"] == time * (time - 1) * 2 * 8 * 4


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d", sorted(DDC_CASES))
def test_ddc_bank_matches_csdr_tpu(port, jax_ref, shape, d):
    chan, time = shape
    _check_ddc(port[shape][f"ddc{d}"]["y"], jax_ref[shape][f"ddc{d}"], d)
    ov = tfd.fastddc_init(0.05, d).overlap_length
    assert port[shape][f"ddc{d}"]["bytes"] == {
        "halo": chan * (time - 1) * ov * C8, "fixup": 0, "corner_turn": 0,
        "gather": 0}


@pytest.mark.parametrize("shape", SHAPES)
def test_flagship_matches_csdr_tpu(port, jax_ref, shape):
    """Bits within 2 errors a channel of csdr_tpu's mesh bank, every
    channel decoded (BER < 0.02 over > 200 bits)."""
    chan, time = shape
    r = port[shape]["flagship"]
    _check_flagship(r["outs"], jax_ref[shape]["flagship"])
    # per step: the overlap halo, and the (C_l, m/time) corner turn to
    # time-1 peers from every rank
    ov, m = tfd.fastddc_init(0.05, 16).overlap_length, r["m"]
    assert r["bytes"]["halo"] == 2 * chan * (time - 1) * ov * C8
    assert r["bytes"]["corner_turn"] == 2 * (time - 1) * 4 * m * C8


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("key", sorted(SEGMENTS))
def test_captured_step_is_the_eager_step(port, shape, key):
    """Every rank's rehearsed capture against its eager step: every
    output (the flagship's state too) bit for bit on every call, the same
    collective bytes; one graph where time is 1, else a graph between each
    two collectives; each segment captured once a key, none on a later
    call of the key, and a new shard length (WFM) captured anew."""
    chan, time = shape
    r = port[shape][key]
    cap = r["captured"]
    assert len(cap["same"]) == chan * time
    assert all(all(rank) for rank in cap["same"]), cap["same"]
    assert cap["bytes"][0] == r["bytes"]
    assert len(set(map(str, cap["bytes"][:2]))) == 1
    segs = ["step"] if time == 1 else SEGMENTS[key]
    assert cap["segments"] == segs
    n = len(segs)
    assert cap["captures"] == {"wfm": [n, n, 2 * n]}.get(key, [n, n]), \
        cap["captures"]


@pytest.mark.parametrize("shape", SHAPES)
def test_captured_steps_match_csdr_tpu(port, jax_ref, shape):
    """The captured steps held against csdr_tpu at the eager steps' bars
    (the forward-only step against the single-card forward block)."""
    r, ref = port[shape], jax_ref[shape]
    _check_wfm(r["wfm"]["captured"]["y"], ref["wfm"])
    for d in DDC_CASES:
        _check_ddc(r[f"ddc{d}"]["captured"]["y"], ref[f"ddc{d}"], d)
    _check_flagship(r["flagship"]["captured"]["outs"], ref["flagship"])
    _check_fwd_only(r["fwd_only"]["captured"]["y"], r["fwd_only"]["x"],
                    shape[0])


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_a_collective_inside_a_capture_raises(port, shape):
    """The WFM step captured whole on a time-sharded mesh: its halo's
    send would run inside the graph, and the capture raises, naming it."""
    err = port[shape]["wfm"]["whole_capture_error"]
    assert err is not None and "cannot be captured" in err, err
    assert "'halo' collective inside a captured segment" in err, err


def test_a_collective_in_a_rehearsed_capture_raises():
    """utils/collectives.counted inside a capture raises (a one-process
    check of the guard the mesh steps' segments rest on)."""
    def fn(state, x):
        with co.counted("corner_turn", 8):
            pass
        return state, x + 1

    step = Rehearsal(fn, ())
    try:
        with pytest.raises(RuntimeError, match="'corner_turn' collective "
                           "inside a captured segment"):
            step((), torch.zeros(4))
    finally:
        co.reset_collectives()


@pytest.mark.parametrize("key", ["wfm", "ddc16", "ddc50", "flagship"])
def test_port_mesh_shape_invariance(port, key):
    """The same input through every mesh shape: the WFM bank at csdr_tpu's
    own invariance bars (80 dB, atol 5e-3: the float32 phase base rounds
    per shard count), the DDC banks within atol 2e-4, the flagship's bits
    within 2 errors a channel."""
    base = port[(4, 1)][key]
    for shape in [(1, 4), (2, 2)]:
        r = port[shape][key]
        if key == "flagship":
            for c in range(4):
                a = np.concatenate([b[c, :k[c]] for b, k in base["outs"]])
                b_ = np.concatenate([b[c, :k[c]] for b, k in r["outs"]])
                errs, total = _align(a, b_)
                assert errs <= 2 and total > 200, (shape, c, errs, total)
            continue
        a, b_ = base["y"], r["y"]
        if key == "wfm":
            assert snr_db(a, b_) >= 80.0
            np.testing.assert_allclose(b_, a, atol=5e-3)
        else:
            np.testing.assert_allclose(b_, a, atol=2e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_only_step_is_the_forward_block(port, shape):
    """The chan-replicated forward alone: every time shard's spectra, in
    order, are the single-card forward block's (kernel order) over the
    whole chunk, bit for bit (its halo is the block's carried tail)."""
    r = port[shape]["fwd_only"]
    _check_fwd_only(r["spectra"], r["x"], shape[0])


def test_chan_only_mesh_moves_no_bytes(port):
    """A (4, 1) mesh splits channels only: no halo, fixup or corner turn."""
    for key in ("wfm", "ddc16", "ddc50", "flagship"):
        b = port[(4, 1)][key]["bytes"]
        assert b["halo"] == b["fixup"] == b["corner_turn"] == 0, (key, b)


def test_divisibility_checks_raise():
    """csdr_tpu's trace-time checks as ValueErrors, on a one-rank view."""
    mesh = pm.Mesh(None, torch.device("cpu"), "gloo", {"chan": 1, "time": 1},
                   {"chan": 0, "time": 0})
    ddc = tfd.fastddc_init(0.05, 50)
    step, meta = sharded_ddc.build_ddc_bank_step(mesh, ddc, [0.1])
    with pytest.raises(ValueError, match="input_size"):
        step(torch.zeros(ddc.input_size + 1, dtype=torch.complex64))
    with pytest.raises(ValueError, match="post_decimation 25"):
        step(torch.zeros(5 * ddc.input_size, dtype=torch.complex64))
    wfm = sharded_wfm.build_wfm_bank_step(mesh, [0.1], np.ones(81,
                                                               np.float32))
    with pytest.raises(ValueError, match="D1\\*D2"):
        wfm(torch.zeros(1010, dtype=torch.complex64))
    with pytest.raises(ValueError, match="split"):
        sharded_wfm.build_wfm_bank_step(
            pm.Mesh(None, torch.device("cpu"), "gloo",
                    {"chan": 2, "time": 1}, {"chan": 0, "time": 0}),
            [0.1, 0.2, 0.3], np.ones(81, np.float32))
