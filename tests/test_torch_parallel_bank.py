"""The mesh form of the config-5 flagship bank of csdr_tpu_torch: a 1x1
mesh against the single-card bank bit for bit, and on a 2x2 mesh the
checkpoint round trips (csdr_tpu's mesh state resumed in the port, the
port's own save and load) and csdr_tpu's Costas, sub-chunked and
segmented-TED cases, held as tests/test_multichannel.py and
tests/test_checkpoint.py hold csdr_tpu's mesh bank.  The checkpoint round
trips also run through the captured step (parallel/segments, with the CPU
rehearsal of a CUDA graph in each segment's place), bit for bit the eager
step's.

One gloo spawn a mesh shape (``parallel.mesh.run_mesh``); the rank jobs
are this module's ``_job_*`` functions, so the module imports no jax at
its top.  The wideband inputs are test_torch_parallel's."""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from csdr_tpu_torch.core.checkpoint import (load_state, save_state,
                                            state_from_jax_leaves)
from csdr_tpu_torch.models import multichannel as tmc
from csdr_tpu_torch.parallel import mesh as pm
from test_torch_parallel import (CENTERS, SPS, TEXTS, _align, _jmesh,
                                 _rehearsed, wideband)

torch.set_num_threads(2)

RATES = [-f for f in CENTERS]
COSTAS_CENTERS = np.array([-0.25, 0.2])
COSTAS_TEXTS = [b"COSTAS CHANNEL %d TEST " % i * 2 for i in range(2)]


@functools.cache
def _inputs():
    """(TX bits, chunks) per case: the flagship at D=16 and D=50 (2
    chunks), the Costas case (one chunk, a carrier offset), the segmented
    TED's case (one chunk)."""
    return {"d16": wideband(16, TEXTS, CENTERS, 2),
            "d50": wideband(50, TEXTS, CENTERS, 2),
            "costas": wideband(16, COSTAS_TEXTS, COSTAS_CENTERS, 1,
                               delta=0.00025, noise=0.0),
            "segments": wideband(16, TEXTS, CENTERS, 1, seed=13)}


# ---------------------------------------------------------------------------
# rank jobs
# ---------------------------------------------------------------------------

def _run(mesh, chunks, decim, rates, state=None, captured=False, **kw):
    """The mesh bank over ``chunks`` (``captured``: its rehearsed capture):
    (state', [(bits, counts) gathered to rank 0 a chunk], bank)."""
    init, step, meta = tmc.build_ddc_bpsk31_bank(rates, decim, SPS,
                                                 mesh=mesh, **kw)
    if captured:
        step = _rehearsed(meta["bank"])
    st = init(len(chunks[0])) if state is None else state(meta["bank"])
    outs = []
    for x in chunks:
        st, (bits, counts) = step(st, pm.shard_input(torch.from_numpy(x),
                                                     mesh))
        outs.append((pm.gather_output(bits, mesh, time_sharded=False),
                     pm.gather_output(counts, mesh, time_sharded=False)))
    return st, outs, meta["bank"]


def _job_one_by_one(mesh, cases):
    """The 1x1 mesh bank and the single-card bank on the same chunks in
    this rank: channel streams, bits, counts and the final state."""
    torch.set_num_threads(1)
    out = {}
    for key, decim in cases:
        chunks = _inputs()[key][1]
        st, outs, bank = _run(mesh, chunks, decim, RATES)
        init, step, meta = tmc.build_ddc_bpsk31_bank(RATES, decim, SPS,
                                                     device="cpu")
        single = meta["bank"]
        ref_st, ref_outs = init(len(chunks[0])), []
        for x in chunks:
            ref_st, o = step(ref_st, torch.from_numpy(x))
            ref_outs.append(o)
        x0 = torch.from_numpy(chunks[0])
        out[key] = {"outs": outs, "ref_outs": ref_outs,
                    "streams": bank.channelize(x0),
                    "ref_streams": single.channelize(x0),
                    "state": st, "ref_state": ref_st,
                    "mesh_type": type(bank).__name__}
    return out


def _job_checkpoint(mesh, jax_state, path, captured=False):
    """Resume from csdr_tpu's mesh state after chunk 1; then the port's
    own round trip on ``example_flagship``'s bank and input, as
    tests/test_checkpoint.py runs csdr_tpu's: a step, a save (the state
    gathered, written by rank 0), the next step uninterrupted and from a
    fresh bank that loads the file (each rank its rows).  ``captured``:
    every step through the bank's rehearsed capture, which donates the
    state it is given (so the saved state is cloned to compare)."""
    torch.set_num_threads(1)
    chunks = _inputs()["d16"][1]
    _, resumed, _ = _run(mesh, chunks[1:], 16, RATES, captured=captured,
                         state=lambda bank: state_from_jax_leaves(
                             bank, jax_state, mesh.device))
    state, step, x, rates = tmc.example_flagship(
        mesh, frames_per_shard=2, c_total=4, decimation=16, sps=SPS)
    if captured:
        step = _rehearsed(step.__self__)
    xl = pm.shard_input(x, mesh)
    st1, _ = step(state, xl)
    whole = pm.gather_state(st1, mesh)
    kept = tuple(t.clone() for t in st1)
    if dist.get_rank() == 0:
        save_state(path, whole)
    dist.barrier()
    _, (bits_a, counts_a) = step(st1, xl)
    init2, step2, meta2 = tmc.build_ddc_bpsk31_bank(rates, 16, SPS,
                                                    mesh=mesh)
    if captured:
        step2 = _rehearsed(meta2["bank"])
    like = pm.gather_state(init2(x.shape[0]), mesh)
    loaded = pm.take_rows(load_state(path, like), mesh)
    same_state = all(torch.equal(a, b) for a, b in zip(kept, loaded))
    _, (bits_b, counts_b) = step2(loaded, xl)
    return {"resumed": resumed, "same_state": same_state,
            "bits": [pm.gather_output(b, mesh, time_sharded=False)
                     for b in (bits_a, bits_b)],
            "counts": [pm.gather_output(c, mesh, time_sharded=False)
                       for c in (counts_a, counts_b)]}


def _job_modem_cases(mesh):
    """csdr_tpu's modem options on the mesh: Costas on and off, TED
    sub-chunks 1 and 2 over three chunks, the segmented TED."""
    torch.set_num_threads(1)
    inp = _inputs()
    costas = inp["costas"][1]
    rates_c = [-f for f in COSTAS_CENTERS]
    out = {f"costas_{on}": _run(mesh, costas, 16, rates_c,
                                use_costas=on)[1] for on in (True, False)}
    rng = np.random.default_rng(21)
    n = 2 * 4 * tmc.fd.fastddc_init(0.05, 16).input_size
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    rates_s = [-0.2, 0.1, 0.25, -0.05]
    out["sub1"] = _run(mesh, [x] * 3, 16, rates_s)[1]
    out["sub2"] = _run(mesh, [x] * 3, 16, rates_s, tr_subchunks=2)[1]
    out["segments"] = _run(mesh, inp["segments"][1], 16, RATES,
                           tr_segments=4)[1]
    return out


# ---------------------------------------------------------------------------
# csdr_tpu on a 2x2 mesh
# ---------------------------------------------------------------------------

def _jax_run(chunks, decim, rates, **kw):
    import jax.numpy as jnp
    from csdr_tpu.core.cplx import CF
    from csdr_tpu.models import multichannel as jmc

    init, step, _ = jmc.build_ddc_bpsk31_bank(_jmesh(2, 2), rates, decim,
                                              SPS, **kw)
    st, outs, states = init(len(chunks[0])), [], []
    for x in chunks:
        st, (bits, counts) = step(st, CF(jnp.asarray(x.real.copy()),
                                         jnp.asarray(x.imag.copy())))
        outs.append((np.asarray(bits), np.asarray(counts)))
        states.append([np.asarray(a) for a in st])
    return outs, states


@pytest.fixture(scope="module")
def jax_ref():
    inp = _inputs()
    out = {"d16": _jax_run(inp["d16"][1], 16, RATES)}
    out["costas"] = _jax_run(inp["costas"][1], 16,
                             [-f for f in COSTAS_CENTERS], use_costas=True)
    out["segments"] = _jax_run(inp["segments"][1], 16, RATES, tr_segments=4)
    return out


@pytest.fixture(scope="module")
def two_by_two(jax_ref, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_ckpt") / "bank.npz")
    jobs = [functools.partial(_job_checkpoint,
                              jax_state=jax_ref["d16"][1][0], path=path),
            _job_modem_cases,
            functools.partial(_job_checkpoint,
                              jax_state=jax_ref["d16"][1][0],
                              path=path.replace(".npz", "_captured.npz"),
                              captured=True)]
    return pm.run_mesh(functools.partial(pm.run_jobs, jobs=jobs), 2, 2,
                       backend="gloo", device="cpu")


@pytest.fixture(scope="module")
def one_by_one():
    return pm.run_mesh(functools.partial(
        _job_one_by_one, cases=[("d16", 16), ("d50", 50)]), 1, 1,
        backend="gloo", device="cpu")


def _bits(outs, c):
    return np.concatenate([b[c, :k[c]] for b, k in outs])


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["d16", "d50"])
def test_one_by_one_mesh_is_the_single_card_bank(one_by_one, key):
    """A 1x1 mesh: channel streams, bits, counts and state bit for bit."""
    r = one_by_one[key]
    assert r["mesh_type"] == "MeshDdcBpsk31Bank"
    np.testing.assert_array_equal(r["streams"], r["ref_streams"])
    for (b, k), (rb, rk) in zip(r["outs"], r["ref_outs"]):
        np.testing.assert_array_equal(k, rk)
        np.testing.assert_array_equal(b, rb)
    for a, b in zip(r["state"], r["ref_state"]):
        np.testing.assert_array_equal(a, b)
    tx_bits = _inputs()[key][0]
    for c in range(4):
        errs, total = _align(tx_bits[c][8:], _bits(r["outs"], c)[8:])
        assert total > 200 and errs / total < 0.02, (c, errs, total)


def test_mesh_bank_resumes_from_csdr_tpu_mesh_state(two_by_two, jax_ref):
    """The port's 2x2 bank from csdr_tpu's 2x2 bank state after chunk 1
    (6 global arrays): chunk 2's bits within 2 errors a channel."""
    resumed = two_by_two[0]["resumed"]
    jouts = jax_ref["d16"][0]
    for c in range(4):
        errs, total = _align(_bits(jouts[1:], c), _bits(resumed, c))
        assert errs <= 2 and total > 100, (c, errs, total)


def test_mesh_bank_save_load_round_trip(two_by_two):
    """Saved on the mesh (gathered to rank 0), loaded by a fresh bank (each
    rank its rows): the same state, and the next chunk bit for bit."""
    r = two_by_two[0]
    assert r["same_state"]
    np.testing.assert_array_equal(r["counts"][0], r["counts"][1])
    np.testing.assert_array_equal(r["bits"][0], r["bits"][1])


def test_captured_mesh_bank_resumes_from_csdr_tpu_mesh_state(two_by_two,
                                                             jax_ref):
    """The same resume through the captured step: bit for bit the eager
    step's bits and counts, so within 2 errors a channel of csdr_tpu's."""
    eager, got = two_by_two[0]["resumed"], two_by_two[2]["resumed"]
    for (b, k), (rb, rk) in zip(got, eager):
        np.testing.assert_array_equal(k, rk)
        np.testing.assert_array_equal(b, rb)
    jouts = jax_ref["d16"][0]
    for c in range(4):
        errs, total = _align(_bits(jouts[1:], c), _bits(got, c))
        assert errs <= 2 and total > 100, (c, errs, total)


def test_captured_mesh_bank_save_load_round_trip(two_by_two):
    """The port's save and load through the captured step: the saved
    state loads back whole, and the next chunk from it is bit for bit the
    uninterrupted one's and the eager step's."""
    eager, r = two_by_two[0], two_by_two[2]
    assert r["same_state"]
    for i in range(2):
        np.testing.assert_array_equal(r["counts"][i], r["counts"][0])
        np.testing.assert_array_equal(r["bits"][i], r["bits"][0])
        np.testing.assert_array_equal(r["counts"][i], eager["counts"][i])
        np.testing.assert_array_equal(r["bits"][i], eager["bits"][i])


def test_mesh_bank_costas_recovers_carrier_offset(two_by_two, jax_ref):
    """With the Costas loop the text comes back (BER < 0.03) and agrees
    with csdr_tpu's mesh bank; without it the offset breaks DBPSK."""
    tx_bits = _inputs()["costas"][0]
    for on in (True, False):
        outs = two_by_two[1][f"costas_{on}"]
        bers = []
        for c in range(2):
            errs, total = _align(tx_bits[c][16:], _bits(outs, c)[16:])
            assert total > 150, (c, total)
            bers.append(errs / total)
        if on:
            assert max(bers) < 0.03, bers
            for c in range(2):
                errs, total = _align(_bits(jax_ref["costas"][0], c)[16:],
                                     _bits(outs, c)[16:])
                assert errs / total < 0.03, (c, errs, total)
        else:
            assert max(bers) > 0.1, bers


def test_mesh_bank_subchunked_modem_identical(two_by_two):
    r = two_by_two[1]
    for (b1, k1), (b2, k2) in zip(r["sub1"], r["sub2"]):
        np.testing.assert_array_equal(k1, k2)
        for c in range(4):
            np.testing.assert_array_equal(b1[c, :k1[c]], b2[c, :k2[c]])


def test_mesh_bank_segmented_ted_matches_csdr_tpu(two_by_two, jax_ref):
    tx_bits = _inputs()["segments"][0]
    outs = two_by_two[1]["segments"]
    for c in range(4):
        errs, total = _align(_bits(jax_ref["segments"][0], c),
                             _bits(outs, c))
        assert errs <= 2 and total > 200, (c, errs, total)
        errs, total = _align(tx_bits[c][8:], _bits(outs, c)[8:])
        assert errs / total < 0.02, (c, errs, total)
