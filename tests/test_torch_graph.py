"""The captured step (core/graph.CapturedStep, ``Block.jit_apply``) on the
CPU: eagerly it is the pipeline itself, and it matches csdr_tpu's jitted
``Pipeline.jit_apply`` on WFM at two shifts, SSB with its AGC, AM and NFM.

The graph's own bookkeeping is held here through a rehearsal: the same
class on CPU tensors with a stand-in graph that, like a CUDA graph, runs
the step on its static buffers with the host leaves frozen at their
capture values, the value leaves read from the scalars each call fills,
and the host results of the capture handed back on every replay.  Each
host-leaf block (``ShiftedFirDecimateBlock``, ``ShiftBlock``, the
fractional decimators, ``AgcBlock``) then gives, over 10 chunks, the next
leaves, counts, outputs and state of its eager forward bit for bit, and
the key sequence of WFM, C, D, E and F settles within two keys, without
the NCO phase in it.  The card's own capture is held to the eager step in
tests/test_torch_kernels.py (``cuda``) and chip_smoke.py's graph phase.
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from csdr_tpu.core import cplx as jcplx
from csdr_tpu.core.block import VarOut as JVarOut
from csdr_tpu.models import receivers as jrec
from csdr_tpu.models import wfm as jwfm

from csdr_tpu_torch.core.block import Pipeline, VarOut
from csdr_tpu_torch.core.graph import MAX_GRAPHS, CapturedStep
from csdr_tpu_torch.kernels import fir_cuda
from csdr_tpu_torch.models import receivers as trec
from csdr_tpu_torch.models import wfm as twfm
from csdr_tpu_torch.ops import agc, fir, resamp, shift

from tests.torch_rehearsal import Rehearsal, _Replayed  # noqa: F401
from tests.util import assert_snr

torch.set_num_threads(2)

FS = 2_400_000
SSB_SETTLE = 4000          # tests/test_torch_receivers.py's


def _fm_tone(n, carrier=0.0, fs=FS):
    t = np.arange(n) / fs
    audio = 0.5 * np.sin(2 * np.pi * 1000 * t)
    phase = 2 * np.pi * (np.cumsum(audio) * 75_000 / fs
                         + np.mod(carrier * np.arange(n), 1.0))
    return np.exp(1j * phase).astype(np.complex64)


def _noise(n, seed, real=False):
    rng = np.random.default_rng(seed)
    if real:
        return rng.standard_normal(n).astype(np.float32)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


def _same(a, b, what):
    """Two pytrees bit for bit: structure, host values, tensors (NaNs by
    place)."""
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb, what
    for i, (u, v) in enumerate(zip(la, lb)):
        if isinstance(u, torch.Tensor):
            assert isinstance(v, torch.Tensor), f"{what}: leaf {i}"
            assert (u.dtype, u.shape) == (v.dtype, v.shape), f"{what}: {i}"
            if u.is_floating_point() or u.is_complex():
                uu, vv = torch.view_as_real(u) if u.is_complex() else u, \
                    torch.view_as_real(v) if v.is_complex() else v
                assert torch.equal(torch.isnan(uu), torch.isnan(vv)), \
                    f"{what}: leaf {i} NaNs"
                uu, vv = torch.nan_to_num(uu), torch.nan_to_num(vv)
                assert torch.equal(uu, vv) and torch.equal(
                    torch.signbit(uu), torch.signbit(vv)), f"{what}: {i}"
            else:
                assert torch.equal(u, v), f"{what}: leaf {i}"
        else:
            assert u == v, f"{what}: leaf {i}: {u} != {v}"


def _rehearse(block, xs, like=None, graphs=MAX_GRAPHS):
    """The block eagerly and through its rehearsed capture (bounded at
    ``graphs``) over the chunks ``xs`` from one state: every output and
    state bit for bit.  Returns the rehearsal."""
    like = block.init("meta") if like is None else like
    step = Rehearsal(block, like, graphs)
    se, sg = block.init("cpu"), block.init("cpu")
    with torch.no_grad():
        for c, x in enumerate(xs):
            se, ye = block(se, x)
            sg, yg = step(sg, x)
            _same((se, ye), (sg, yg), f"{block.name} chunk {c}")
    return step


# --------------------------------------------------------------------------
# on the CPU, jit_apply is the eager step
# --------------------------------------------------------------------------

def test_jit_apply_on_cpu_tensors_is_the_eager_step():
    p = twfm.wfm_advanced(shift_rate=-0.123456789)
    step = p.jit_apply()
    assert isinstance(step, CapturedStep)
    x = _fm_tone(4 * 6400, carrier=0.123456789)
    se, sg = p.init("cpu"), p.init("cpu")
    with torch.no_grad():
        for c in range(4):
            xc = torch.from_numpy(x[c * 6400:(c + 1) * 6400])
            se, ye = p(se, xc)
            sg, yg = step(sg, xc)
            _same((se, ye), (sg, yg), f"chunk {c}")
    assert step.captures == 0 and step.replays == 0


# --------------------------------------------------------------------------
# against csdr_tpu's jitted step
# --------------------------------------------------------------------------

def _jax_stream(pj, x, n):
    """csdr_tpu's ``Pipeline.jit_apply()`` over the chunks of x."""
    apply, sj, out = pj.jit_apply(), pj.init(), []
    for c in range(len(x) // n):
        chunk = x[c * n:(c + 1) * n]
        sj, yj = apply(sj, jcplx.from_numpy(chunk))
        if isinstance(yj, JVarOut):
            yj = np.asarray(yj.data)[: int(yj.count)]
        elif isinstance(yj, jcplx.CF):
            yj = jcplx.to_numpy(yj)
        out.append(np.asarray(yj))
    return np.concatenate(out)


def _port_stream(pt, x, n):
    step, st, out = pt.jit_apply(), pt.init("cpu"), []
    with torch.no_grad():
        for c in range(len(x) // n):
            st, yt = step(st, torch.from_numpy(x[c * n:(c + 1) * n]))
            out.append((yt.compact() if isinstance(yt, VarOut)
                        else yt).numpy())
    return np.concatenate(out)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CSDR_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("chunk", [6400, 7010])
@pytest.mark.parametrize("rate", [-0.2, -0.123456789])
def test_wfm_jit_apply_matches_csdr_tpu(rate, chunk):
    """wfm_advanced at a shift whose phase repeats and one whose phase
    never does, 3 chunks, at tests/test_torch_wfm.py's bars."""
    x = _fm_tone(3 * chunk, carrier=-rate)
    a = _jax_stream(jwfm.wfm_advanced(shift_rate=rate), x, chunk)
    b = _port_stream(twfm.wfm_advanced(shift_rate=rate), x, chunk)
    assert len(a) == len(b) > 200
    assert_snr(a, b, 60, f"wfm_advanced({rate}) chunk {chunk}")
    np.testing.assert_allclose(b, a, rtol=2e-3, atol=5e-4)


def _receiver_input(kind, n):
    s = np.arange(n, dtype=np.float64)
    noise = _noise(n, 5)
    if kind == "nfm":
        phase = 2 * np.pi * np.cumsum(0.5 * np.sin(2 * np.pi * 1000 * s
                                                   / FS)) * 5000 / FS
        return (np.exp(1j * phase) + 0.01 * noise).astype(np.complex64)
    if kind == "am":
        return (0.3 * (1 + 0.5 * np.sin(2 * np.pi * 1000 * s / FS))
                + 0.003 * noise).astype(np.complex64)
    return (0.3 * np.exp(2j * np.pi * np.mod(0.0005 * s, 1.0))
            + 0.01 * noise).astype(np.complex64)


@pytest.mark.parametrize("size", [0, 1])
@pytest.mark.parametrize("kind", ["ssb", "am", "nfm"])
def test_receiver_jit_apply_matches_csdr_tpu(interpret, kind, size):
    """SSB with its AGC (from SSB_SETTLE on, as tests/test_torch_receivers
    holds it), AM and NFM (whose fastagc's lookahead fills the first two
    chunks), 3 chunks at two sizes, at 80 dB."""
    if kind == "ssb":
        pj, pt = jrec.ssb_receiver(), trec.ssb_receiver()
        chunk = 50 * pt.blocks[1].input_size * (12, 18)[size]
    elif kind == "am":
        pj, pt = jrec.am_receiver(), trec.am_receiver()
        chunk = 50 * (800, 1200)[size]
    else:
        chunk = 50 * (1000, 1200)[size]
        kw = dict(decimation=50, audio_rate=48000,
                  fastagc_block_size=chunk // 50)
        pj, pt = jrec.nfm_receiver(**kw), trec.nfm_receiver(**kw)
    x = _receiver_input(kind, 3 * chunk)
    a, b = _jax_stream(pj, x, chunk), _port_stream(pt, x, chunk)
    assert len(a) == len(b)
    skip = SSB_SETTLE if kind == "ssb" else 0
    assert len(a) - skip >= 2000 and np.abs(b[skip:]).max() > 0.1
    assert_snr(a[skip:], b[skip:], 80.0, f"{kind} receiver chunk {chunk}")


# --------------------------------------------------------------------------
# the capture's host bookkeeping, rehearsed
# --------------------------------------------------------------------------

def _chunks(x, n):
    return [torch.from_numpy(x[c * n:(c + 1) * n])
            for c in range(len(x) // n)]


@pytest.mark.parametrize("rate", [-0.2, -0.123456789])
def test_shifted_fir_decimate_block_rehearsed(rate):
    """theta is a value leaf: one graph for every chunk after the first,
    the phase advanced on the host as forward advances it."""
    taps = fir.firdes.firdes_lowpass_f(79, 0.05)
    blk = fir.shifted_fir_decimate_block(rate, taps, 10)
    step = _rehearse(blk, _chunks(_noise(10 * 640, 1), 640))
    assert step.captures == 1 and step.replays == 9
    assert step._value_pos == frozenset({0})        # theta, not in the key


def test_shift_block_rehearsed():
    step = _rehearse(shift.shift_block(-0.123456789),
                     _chunks(_noise(10 * 700, 2), 700))
    assert step.captures == 1 and step.replays == 9
    assert step._value_pos == frozenset({0})


@pytest.mark.parametrize("rate,kw", [
    (5.0, {}),                                   # integer rate (WFM)
    (4.8, {}),                                   # rational 24/5
    (5.3, {"rational": False}),                  # the generic path
    (3.7, {"taps": np.hanning(9).astype(np.float32)}),
    (5.0, {"chunk": 1 << 16}),                   # the CLI's chunk
])
def test_fractional_decimator_rehearsed(rate, kw):
    """occ and where are key leaves: each capture's count and next leaves
    are handed back on the replays of its key.  An integer or rational
    rate settles on a key; a generic rate's ``where`` never repeats, so
    each chunk is a key of its own (captured, within MAX_GRAPHS).  At the
    CLI's 65 536-sample chunk rate 5 goes round 5 keys after its first
    chunk's, one more than MAX_GRAPHS: a step bounded at its key cycle
    (as the CLI's pump bounds it) captures each once, none after the
    first lap."""
    kw = dict(kw)
    n = kw.pop("chunk", 1200)
    blk = resamp.fractional_decimator_block(rate, **kw)
    xs = _chunks(_noise(10 * n, 3, real=True), n)
    cycle = blk.key_cycle(n) if n != 1200 else None
    step = _rehearse(blk, xs, graphs=max(MAX_GRAPHS, cycle or 0))
    assert step.captures + step.replays == 10
    assert len(step._graphs) <= step.max_graphs
    if cycle is not None:
        assert cycle == 5 > MAX_GRAPHS
        assert step.captures == 1 + cycle and step.recaptures == 0
    elif rate in (5.0, 4.8):
        assert step.captures <= 2


def test_paired_encoder_rehearsed():
    """The paired ADPCM encoder (W1's last block) over chunks of odd
    length: its carry, a state leaf on the card, is 0 or 1 samples by
    turns.  The carry's shape is part of the key, and a leaf whose shape
    the step changes goes out as an output, not into a buffer: two keys,
    bytes and state bit for bit."""
    from csdr_tpu_torch.ops import adpcm

    rng = np.random.default_rng(11)
    x = rng.integers(-3000, 3000, 8 * 333).astype(np.int16)
    step = _rehearse(adpcm.paired_encode_block(), _chunks(x, 333))
    assert step.captures == 2 and step.replays == 6
    assert all(e.reshaped == {0} for e in step._graphs.values())


@pytest.mark.parametrize("method", ["chunked", "scan"])
def test_agc_block_rehearsed(method):
    """``started`` is a key leaf: the first chunk's key and the rest's."""
    blk = agc.agc_block(method=method)
    step = _rehearse(blk, _chunks(0.3 * _noise(10 * 800, 4, real=True), 800))
    assert step.captures == 2 and step.replays == 8


@pytest.mark.parametrize("path", ["WFM", "WFM'", "C", "D", "E", "F"])
def test_key_sequence_settles(interpret, path):
    """WFM (both shifts), C, D, E and F over 6 chunks: at most two keys,
    the last chunks all on one, the NCO phase in none."""
    if path.startswith("WFM"):
        rate = -0.2 if path == "WFM" else -0.123456789
        pipe, n = twfm.wfm_advanced(shift_rate=rate), 6400
        x = _fm_tone(6 * n, carrier=-rate)
    else:
        make = {"C": lambda: trec.ssb_receiver(agc_on=False),
                "D": lambda: trec.nfm_receiver(
                    50, audio_rate=48000, fastagc_block_size=800),
                "E": trec.ssb_receiver, "F": trec.am_receiver}[path]
        pipe = make()
        n = (50 * pipe.blocks[1].input_size * 6 if path in "CE"
             else 50 * 800)
        x = _receiver_input({"C": "ssb", "E": "ssb", "D": "nfm",
                             "F": "am"}[path], 6 * n)
    step = _rehearse(pipe, _chunks(x, n))
    keys = step.keys
    assert len(set(keys)) <= 2 and step.captures <= 2, path
    assert keys[-1] == keys[-2] == keys[-3], path
    if path.startswith("WFM"):
        assert step._value_pos == frozenset({0})    # theta
        assert step.captures - (keys[0] == keys[1]) <= 2


def test_unfused_wfm_rehearsed():
    """wfm_advanced(fuse_shift=False): ShiftBlock's phase and the plain
    FIR."""
    pipe = twfm.wfm_advanced(shift_rate=-0.123456789, fuse_shift=False)
    step = _rehearse(pipe, _chunks(_fm_tone(6 * 6400, 0.123456789), 6400))
    assert step.captures <= 2


def test_a_resumed_state_goes_into_the_buffers_and_a_donated_one_raises():
    """A state that did not come from the last call (a fresh init, a
    checkpoint) is copied in; a state an earlier call returned was
    donated, and passing it again raises."""
    pipe = twfm.wfm_advanced(shift_rate=-0.123456789)
    xs = _chunks(_fm_tone(6 * 6400, 0.123456789), 6400)
    step = Rehearsal(pipe, pipe.init("meta"))
    with torch.no_grad():
        s = pipe.init("cpu")
        for x in xs[:3]:
            s, _ = step(s, x)
        saved = pytree.tree_map(
            lambda v: v.clone() if isinstance(v, torch.Tensor) else v, s)
        s_eager, y_eager = pipe(saved, xs[3])
        s4, y4 = step(saved, xs[3])                # copied in
        _same((s_eager, y_eager), (s4, y4), "resumed")
        held = y4.data.clone()
        s5, _ = step(s4, xs[4])
        assert torch.equal(y4.data, held)           # outputs not overwritten
        with pytest.raises(ValueError, match="donated"):
            step(s4, xs[5])


def test_a_step_whose_state_changes_structure_raises():
    class Grows(Pipeline):
        def forward(self, state, x):
            return (state, state), x

    step = Rehearsal(Grows([]), (torch.zeros(2, device="meta"),))
    with pytest.raises(RuntimeError, match="changes structure"):
        step((torch.zeros(2),), torch.zeros(4))


def test_shift_fir_decimate_plain_takes_theta_as_a_tensor():
    """θ from a 0-dim float32 tensor is θ as a float, bit for bit."""
    rng = np.random.default_rng(6)
    tail = torch.from_numpy(_noise(80, 7))
    x = torch.from_numpy(_noise(640, 8))
    taps = torch.from_numpy(fir.firdes.firdes_lowpass_f(79, 0.05))
    theta = np.float32(rng.uniform())
    a = fir_cuda.shift_fir_decimate(tail, x, taps, 10, 64, -0.123456789,
                                    float(theta))
    b = fir_cuda.shift_fir_decimate(tail, x, taps, 10, 64, -0.123456789,
                                    torch.tensor(theta))
    assert torch.equal(a, b)
    c = fir_cuda.shift_fir_decimate_plain(tail, x, taps, 10, 64,
                                          -0.123456789, torch.tensor(theta))
    assert torch.equal(a, c)


@pytest.mark.parametrize("decim", [16, 50])
def test_bank_step_rehearsed(decim):
    """The BPSK31 bank's step (every leaf on the card): bits, counts and
    the modem's state bit for bit over 3 chunks, one capture."""
    from csdr_tpu_torch.models import multichannel
    from csdr_tpu_torch.ops import fastddc

    init, step, meta = multichannel.build_ddc_bpsk31_bank(
        [0.3, 0.1, -0.15, -0.35], decim, 64, device="cpu")
    bank = meta["bank"]
    assert step == bank.step                     # eager on the CPU
    ddc = fastddc.fastddc_init(0.05, decim)
    n = 4 * ddc.input_size * meta["q"]
    like = pytree.tree_map(lambda t: t.to("meta"), init(n))
    rehearsal = Rehearsal(bank.step, like)
    se, sg = init(n), init(n)
    for c, x in enumerate(_chunks(0.3 * _noise(3 * n, 9), n)):
        se, ye = bank.step(se, x)
        sg, yg = rehearsal(sg, x)
        _same((se, ye), (sg, yg), f"bank chunk {c}")
    assert rehearsal.captures == 1 and rehearsal.replays == 2


def test_tuple_input_rehearsed():
    """``x`` a tuple (a mesh segment's halo and shard): each tensor goes
    into a static input of its own, and the key covers every shape.  Over
    a run of shape pairs, outputs and state bit for bit against the eager
    step; one capture a pair, a change of either shape a new key."""
    def fn(state, xs):
        h, x = xs
        y = torch.cat([h, x]) * 2.0
        return (state[0] + y[:4],), y

    step = Rehearsal(fn, (torch.zeros(4, device="meta"),))
    rng = np.random.default_rng(10)
    shapes = [(3, 8), (3, 8), (3, 12), (5, 12), (5, 12), (3, 8)]
    se, sg = (torch.zeros(4),), (torch.zeros(4),)
    with torch.no_grad():
        for c, (nh, nx) in enumerate(shapes):
            xs = tuple(torch.from_numpy(rng.standard_normal(n).astype(
                np.float32)) for n in (nh, nx))
            se, ye = fn(se, xs)
            sg, yg = step(sg, xs)
            _same((se, ye), (sg, yg), f"call {c}")
    assert step.captures == 3 and step.replays == 3
    assert len(set(step.keys)) == 3
    for entry in step._graphs.values():
        assert isinstance(entry.x, tuple) and len(entry.x) == 2
        assert entry.x[0].data_ptr() != entry.x[1].data_ptr()
