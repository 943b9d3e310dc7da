"""The ddcd server's captured step (server/ddcd.DdcdServer._step, a
core/graph.CapturedStep of ``DdcdServer.step``) on the CPU, through the
rehearsal of tests/test_torch_graph.py: a CapturedStep on CPU tensors whose
stand-in graph re-runs the step on its static buffers.

On the plans d16_factored, d50_classed and d16_td at
tests/test_torch_ddcd.py's small sizes (4 slots), over 5 chunks with claims,
a retune before chunk 1, a release before chunk 2, the retune back before
chunk 3 and a new claim before chunk 4, the captured server gives the eager
server's outputs, counts and carried state bit for bit every chunk, and
csdr_tpu's jitted DdcdServer's counts and carried state bit for bit, its
outputs within tests/test_torch_ddcd.py's bar (max error over the peak
5e-5).  It captures once, and no retune or release moves the row buffers
the graph reads.  A csdr_tpu state loaded through ``state_from_jax``
before chunk 3 gives csdr_tpu's chunk 3.  A dropped server is freed, its
captured step and graph with it, without Python's cyclic collector (a
graph that collector destroys can fall in the middle of another capture
and invalidate it).  The card's own capture is held to
the eager server in tests/test_torch_kernels.py (``cuda``) and
chip_smoke.py's graph phase.
"""

import functools
import gc
import weakref

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from csdr_tpu.server.ddcd import DdcdServer as JServer

import csdr_tpu_torch
from csdr_tpu_torch.core.checkpoint import state_to_numpy_leaves
from csdr_tpu_torch.server import ddcd as tddcd

from tests.test_torch_ddcd import REL_BAR, _rel
from tests.test_torch_graph import Rehearsal, _same

torch.set_num_threads(2)

PLANS = {"d16_factored": (16, "fastddc", 8),
         "d50_classed": (50, "fastddc", 25), "d16_td": (16, "td", 2)}
SLOTS = 4
CHUNKS = 5
START = {0: -0.11, 1: 0.23, 3: 0.3}
LOADED_AT = 3              # the chunk a csdr_tpu state is loaded before


def _claim(s):
    for slot, r in START.items():
        s.set_shift(slot, r)


def _release(s):
    with s.lock:
        s._zero_slot_locked(0)


EVENTS = {0: _claim, 1: lambda s: s.set_shift(1, -0.31), 2: _release,
          3: lambda s: s.set_shift(1, START[1]),
          4: lambda s: s.set_shift(2, -0.2)}


def _noise(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64) for _ in range(CHUNKS)]


@functools.cache
def _jax_run(plan):
    """csdr_tpu's server over the schedule, once a plan: its inputs, and a
    chunk its outputs, counts and full state leaves."""
    d, method, frames = PLANS[plan]
    js = JServer(d, 0.05, SLOTS, method, frames, port=0)
    xs, run = _noise(d, js.chunk_in), []
    for k, x in enumerate(xs):
        EVENTS[k](js)
        dr, di, counts = js._run_chunk(x)
        run.append((dr + 1j * di, counts,
                    [np.asarray(a) for a in jax.tree_util.tree_leaves(
                        js.state)]))
    history = 3 if method == "fastddc" and js.factored else None
    return xs, run, history


def _servers(plan):
    """The eager server (a CPU server's ``_step`` is ``step`` itself) and
    one whose ``_step`` is the rehearsed capture."""
    d, method, frames = PLANS[plan]
    eager, graph = (tddcd.DdcdServer(d, 0.05, SLOTS, method, frames, port=0,
                                     device="cpu") for _ in range(2))
    like = pytree.tree_map(lambda t: t.to("meta"), graph.init())
    graph._step = Rehearsal(graph.step, like)
    return eager, graph


def _ptrs(srv):
    return [r.data_ptr() for r in srv.rows]


def _chunk_both(eager, graph, x, what):
    """One chunk through both servers: outputs, counts and state bit for
    bit.  Returns the captured server's (data, counts)."""
    de, ce = eager._run_chunk(x)
    dg, cg = graph._run_chunk(x)
    _same((torch.from_numpy(de), torch.from_numpy(ce), eager.state),
          (torch.from_numpy(dg), torch.from_numpy(cg), graph.state), what)
    return dg, cg


def _like_jax(got, ref, history, what):
    """The port's chunk against csdr_tpu's: counts and state bit for bit,
    outputs within REL_BAR."""
    data, counts, state = got
    y, cj, leaves = ref
    np.testing.assert_array_equal(counts, cj, err_msg=what)
    assert data.dtype == np.complex64 and data.shape == y.shape, what
    assert _rel(y, data) < REL_BAR, what
    ours = state_to_numpy_leaves(state)
    assert len(ours) == len(leaves[:history]), what
    for a, b in zip(ours, leaves[:history]):
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("plan", list(PLANS))
def test_captured_server_matches_eager_and_csdr_tpu(plan):
    xs, run, history = _jax_run(plan)
    eager, graph = _servers(plan)
    ptrs = _ptrs(graph)
    for k, x in enumerate(xs):
        for s in (eager, graph):
            EVENTS[k](s)
        data, counts = _chunk_both(eager, graph, x, f"{plan} chunk {k}")
        _like_jax((data, counts, graph.state), run[k], history,
                  f"{plan} chunk {k} against csdr_tpu")
        assert _ptrs(graph) == ptrs, f"{plan}: chunk {k} moved the rows"
        if PLANS[plan][1] == "fastddc" and k >= 2:
            assert not np.any(data[0])                  # released slot
    assert graph._step.captures == 1
    assert graph._step.replays == CHUNKS - 1


@pytest.mark.parametrize("plan", list(PLANS))
def test_captured_server_takes_a_csdr_tpu_state(plan):
    """Both servers stream other chunks first, then load csdr_tpu's state
    after chunk LOADED_AT - 1: the captured server copies it into its
    buffers and gives csdr_tpu's chunk LOADED_AT, without a new capture."""
    xs, run, history = _jax_run(plan)
    eager, graph = _servers(plan)
    ptrs = _ptrs(graph)
    other = _noise(PLANS[plan][0] + 1, len(xs[0]))
    for k in range(LOADED_AT):
        for s in (eager, graph):
            EVENTS[k](s)
        _chunk_both(eager, graph, other[k], f"{plan} other chunk {k}")
    for s in (eager, graph):
        s.state = csdr_tpu_torch.state_from_jax_leaves(
            s, run[LOADED_AT - 1][2], device="cpu")
        EVENTS[LOADED_AT](s)
    data, counts = _chunk_both(eager, graph, xs[LOADED_AT],
                               f"{plan} loaded chunk {LOADED_AT}")
    _like_jax((data, counts, graph.state), run[LOADED_AT], history,
              f"{plan} loaded chunk {LOADED_AT} against csdr_tpu")
    assert _ptrs(graph) == ptrs
    assert graph._step.captures == 1 and graph._step.replays == LOADED_AT


class _Forgets:
    """What a CUDA graph keeps of a capture: its outputs, not the body
    (the rehearsal's stand-in keeps the body to run it again)."""

    def capture(self, body):
        self.out = body()
        return self.out

    def replay(self):
        return self.out


@pytest.mark.parametrize("plan", list(PLANS))
def test_a_dropped_server_is_freed_without_the_cyclic_collector(plan):
    xs, _, _ = _jax_run(plan)
    servers = _servers(plan)
    servers[1]._step._new_graph = _Forgets
    for srv in servers:
        _claim(srv)
        for x in xs[:2]:
            srv._run_chunk(x)
    assert servers[1]._step.captures == 1
    refs = [weakref.ref(o) for srv in servers for o in (srv, srv._step)]
    collecting = gc.isenabled()
    gc.disable()
    try:
        del srv, servers
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        if collecting:
            gc.enable()
