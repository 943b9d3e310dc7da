"""A step captured once as a CUDA graph and replayed: the counterpart of
csdr_tpu's jitted step (``Pipeline.jit_apply``, ``StreamRunner``'s
``jax.jit(pipeline.apply, donate_argnums=(0,))`` and the bank's jitted
``step``).

csdr_tpu compiles a step into one XLA program; the port issues every op of
a step from Python, one launch at a time (PERF.md §5: 1.4-9x the card's
own time on the host-bound paths).  :class:`CapturedStep` wraps any
``fn(state, x) -> (state', y)`` and, on CUDA tensors, runs it as one
``torch.cuda.CUDAGraph`` replay a call.

Host leaves.  A state leaf that is not a tensor on the card (a 0-dim CPU
tensor or a number) is host bookkeeping, advanced on the host so that a
chunk never waits on the card (``core/block``).  Each host leaf is a
function of the host leaves and the input's shape only.  Two kinds:

- a *key leaf* sets a shape, an offset or a host count (the fractional
  decimator's ``occ`` and ``where``, the AGC's ``started``).  It is part of
  the graph's key, so a graph only ever replays the values it was captured
  with; the next key leaves and the host ``VarOut`` counts a key gives are
  recorded at its capture and handed back on every replay.
- a *value leaf* only carries a value into a launch (the NCO phase of
  ``ShiftedFirDecimateBlock`` and ``ShiftBlock``).  Its block reads it
  through :func:`carried_value`: eagerly the leaf itself, inside a capture
  a 0-dim tensor on the card that each call fills (one ``fill_`` launch,
  the value in its arguments) before the replay.  The host advances it
  with the block's own float32 arithmetic.  It is not part of the key, so
  a stream whose phase never repeats replays one graph.

A launch argument written into a pinned host buffer that a captured copy
reads would be read when the card reaches the copy, after the host, which
runs ahead, may have written the next call's value; a ``fill_`` carries
its value in its launch, in stream order.

Each call on the card: the key; on its first call, the step runs eagerly
on the capture stream (kernels build, tables upload, caches fill: the
warm-up, whose result is the call's) and is then captured; on every later
call the state goes into the graph's buffers (by copy, unless it is the
state the last call returned: csdr_tpu's ``StreamRunner`` donates it; a
state rebuilt from that one with some leaves replaced, as a FIFO retune
replaces a level or a rate, has only those copied in), the
input is copied into the graph's input, the value leaves are filled, the
graph replays, and each output on the card is copied once out of the
graph's pool, so an output never changes under a later call.

The key also holds the shapes of the state's leaves on the card.  A leaf
whose shape the step changes (W1's paired encoder holds back 0 or 1
samples) is not donated: the graph's value of it is copied out after each
replay, as an output is, and the next call copies it in.

A step keeps at most ``max_graphs`` graphs (``MAX_GRAPHS`` unless its
maker sizes it to the cycle of its keys: the least recently used one is
dropped past that); ``captures`` counts captures, ``captured_keys`` holds
the keys captured and ``recaptures`` the captures of a key dropped
earlier, which a stream whose keys fit the bound never makes after the
first lap of its key cycle.  A capture records the launches every kernel
wrapper counted while it ran; each replay adds them
to the kernels' ``LAUNCHES``, so the counts go on counting launches the
card ran.  A step that cannot be captured raises, naming its block, the
op and the exception; it is never run eagerly instead.

``x`` is a tensor or a tuple of tensors on one card (a mesh step's
segment takes the halo and the shard, parallel/segments): each is copied
into a static input of its own, and the key covers every shape.

On CPU tensors the call is ``fn`` itself: the tests hold that against
csdr_tpu.
"""

from __future__ import annotations

import contextvars
import functools
import gc
import importlib
import pkgutil
import traceback
import warnings
from collections import OrderedDict
from typing import Callable

import torch
from torch.utils import _pytree as pytree

MAX_GRAPHS = 4             # graphs a step keeps by default: start-up and
                           # steady keys

_RECORDER: contextvars.ContextVar = contextvars.ContextVar(
    "csdr_graph_recorder", default=None)


def carried_value(leaf, advance: Callable):
    """A value leaf of a block's state: ``(read, next)``, ``read`` what the
    block's launch takes, ``next = advance(leaf)`` the leaf's next value
    (a new host tensor).  Eagerly ``read`` is ``leaf``; while a
    :class:`CapturedStep` captures, a 0-dim tensor on the step's card that
    each replay fills with the then current leaf, whose next value the
    host computes with ``advance``."""
    nxt = advance(leaf)
    rec = _RECORDER.get()
    if rec is None:
        return leaf, nxt
    return rec.value(leaf, nxt, advance), nxt


def capturing() -> bool:
    """Whether a :class:`CapturedStep` is capturing its body in this
    context (a collective there raises: utils/collectives)."""
    return _RECORDER.get() is not None


@functools.cache
def launch_counts() -> dict:
    """Every kernel wrapper's ``LAUNCHES`` dict, by module name: each
    module of ``csdr_tpu_torch.kernels`` that counts launches."""
    import csdr_tpu_torch.kernels as pkg
    mods = (importlib.import_module(f"{pkg.__name__}.{m.name}")
            for m in pkgutil.iter_modules(pkg.__path__))
    return {m.__name__: m.LAUNCHES for m in mods if hasattr(m, "LAUNCHES")}


class _Value:
    """A value leaf of a captured step: its position among the input's
    host leaves, the scalar on the card its launch reads, and its step."""

    def __init__(self, pos: int, scalar: torch.Tensor, advance: Callable,
                 nxt):
        self.pos, self.scalar, self.advance, self.nxt = (pos, scalar,
                                                         advance, nxt)


class _Recorder:
    """What a capture learns of the step's value leaves: ``leaves`` are
    the input state's leaves as the capture passes them in, ``host_pos``
    the positions of its host leaves.

    Each host leaf gets its 0-dim tensor on ``device`` here, before the
    capture: one allocated inside it comes from the graph's pool, where
    it can take the memory of a temporary the body freed, which the graph
    then writes after the scalar's fill (seen on the card: the CLI's
    shift_addition_fc, a ``torch.complex`` before its NCO)."""

    def __init__(self, host_pos: list[int], leaves: list, device):
        self.host = [(i, leaves[i]) for i in host_pos]
        self.scalars = {i: torch.empty((), device=device, dtype=(
            leaves[i].dtype if isinstance(leaves[i], torch.Tensor)
            else torch.float32)) for i in host_pos}
        self.values: dict[int, _Value] = {}

    def value(self, leaf, nxt, advance):
        pos = next((i for i, h in self.host if h is leaf), None)
        if pos is None:
            raise RuntimeError("carried_value: the leaf is not a host leaf "
                               "of the captured step's state")
        if pos not in self.values:        # a second run of the body reuses it
            self.values[pos] = _Value(pos, self.scalars[pos], advance, nxt)
        return self.values[pos].scalar


class _Graph:
    """A CUDA graph of one body, captured on ``stream``.

    A graph destroyed while another is captured (an old step's, freed by
    Python's cyclic collector, in any thread) invalidates that capture in
    CUDA's global capture mode.  So the capture is thread-local (only the
    capturing thread's own unsafe calls fail it: a step that syncs still
    raises) and the cyclic collector waits until it ends; the DDC server
    captures on its device-loop thread while other threads run."""

    def __init__(self, stream):
        self.graph, self.stream, self.out = torch.cuda.CUDAGraph(), stream, \
            None

    def capture(self, body):
        collecting = gc.isenabled()
        gc.disable()
        try:
            # a step that only views its input (the CLI's realpart_cf)
            # captures no work: its graph replays nothing, as it should
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                with torch.cuda.graph(self.graph, stream=self.stream,
                                      capture_error_mode="thread_local"):
                    self.out = body()
        finally:
            if collecting:
                gc.enable()
        return self.out

    def replay(self):
        self.graph.replay()
        return self.out


class _Entry:
    """One key's graph: its static input, state buffers (by leaf
    position), value leaves, recorded host results, launches (counter,
    name, count) and the positions of the state leaves whose shape the
    step changes."""

    def __init__(self, graph, x, bufs, values, host_out, out_values, y_spec,
                 y_const, launches, reshaped):
        self.graph, self.x, self.bufs, self.values = graph, x, bufs, values
        self.host_out, self.out_values = host_out, out_values
        self.y_spec, self.y_const, self.launches = y_spec, y_const, launches
        self.reshaped = reshaped


def _inputs(x) -> tuple:
    """The step's input tensors: the tuple ``x`` or ``(x,)``."""
    return x if isinstance(x, tuple) else (x,)


def _signature(x) -> tuple:
    if isinstance(x, tuple):
        return (tuple(_signature(t) for t in x),)
    return (tuple(x.shape), x.dtype, x.device)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _host_key(v):
    if isinstance(v, torch.Tensor):
        return (str(v.dtype), tuple(v.shape), v.numpy().tobytes())
    return (type(v).__name__, v)


def _where(e: BaseException) -> str:
    """The innermost Block of ``e``'s traceback and the op it failed at."""
    from csdr_tpu_torch.core.block import Block

    block, last = None, None
    for frame, line in traceback.walk_tb(e.__traceback__):
        me = frame.f_locals.get("self")
        if isinstance(me, Block):
            block = me.name
        last = (frame.f_code.co_filename, line, frame.f_code.co_name)
    at = f"{last[0]}:{last[1]} in {last[2]}" if last else "?"
    return f"block '{block}', at {at}" if block else f"at {at}"


class CapturedStep:
    """``fn(state, x) -> (state', y)`` captured as one CUDA graph a key and
    replayed (module docstring).  ``captures`` counts captures,
    ``replays`` replays, ``recaptures`` captures of a key whose graph the
    bound ``max_graphs`` had dropped; ``captured_keys`` is the set of keys
    captured."""

    def __init__(self, fn: Callable, max_graphs: int = MAX_GRAPHS):
        self.fn = fn
        self.name = getattr(fn, "name", None) or getattr(
            fn, "__qualname__", repr(fn))
        self.max_graphs = max_graphs
        self.captures = self.replays = self.recaptures = 0
        self.captured_keys: set = set()
        self._graphs: OrderedDict = OrderedDict()
        self._value_pos: frozenset | None = None
        self._static: dict[int, _Entry] = {}   # id of a state buffer
        self._spec = None                      # the state's structure
        self._last = None                      # the state the last call gave
        self._last_leaves, self._host = None, None   # its leaves, host ones
        self._stream = None

    # -- what a backend decides; the tests' CPU rehearsal overrides these --

    def _on_card(self, x) -> bool:
        return all(isinstance(t, torch.Tensor) and t.is_cuda
                   for t in _inputs(x))

    def _host_positions(self, leaves: list, dev) -> list[int]:
        """Positions of the host leaves: every leaf but a tensor on the
        step's device; a tensor on another card raises."""
        host = []
        for i, v in enumerate(leaves):
            if isinstance(v, torch.Tensor) and v.device.type != "cpu":
                if v.device != dev:
                    raise ValueError(f"{self.name}: a state leaf on "
                                     f"{v.device}, the input on {dev}")
                continue
            host.append(i)
        return host

    def _capture_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def _new_graph(self):
        return _Graph(self._capture_stream())

    def _eager(self, state, x):
        """The first call of a key, on the capture stream, as the warm-up
        before its capture."""
        cur, side = torch.cuda.current_stream(), self._capture_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(state, x)
        cur.wait_stream(side)
        for t in pytree.tree_leaves((state, x)):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(side)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(cur)
        return out

    # -- the call ---------------------------------------------------------

    def __call__(self, state, x):
        if not self._on_card(x):
            return self.fn(state, x)
        dev = _inputs(x)[0].device
        with torch.no_grad():
            if state is self._last and self._last is not None:
                leaves, host_pos = self._last_leaves, self._host
            else:
                leaves, spec = pytree.tree_flatten(state)
                if not self._rebuilt(leaves, dev):
                    raise ValueError(
                        f"{self.name}: a state donated to an earlier call; "
                        "pass the state the last call returned")
                if self._spec is None:
                    self._spec = spec
                elif spec != self._spec:
                    raise ValueError(f"{self.name}: a state of structure "
                                     f"{spec}, the step's is {self._spec}")
                host_pos = self._host_positions(leaves, dev)
            key = None if self._value_pos is None else self._key(
                x, leaves, host_pos)
            entry = self._graphs.get(key)
            if entry is None:
                out = self._eager(state, x)
                self._capture(x, dev, leaves, host_pos)
                self._remember(out[0], dev)
                return out
            self._graphs.move_to_end(key)
            return self._replay(entry, x, leaves)

    def _rebuilt(self, leaves: list, dev) -> bool:
        """Whether ``leaves`` may go into the buffers: a state that holds
        none of the graphs' buffers (a fresh or a checkpoint state), or the
        last state with some of its leaves on the card replaced (a FIFO
        retune's new level), every other leaf, host ones included, the
        last state's own at its place.  A state an earlier call returned
        holds the buffers with that call's host leaves, which the last
        call replaced (where a state has no host leaf the two are one: its
        buffers hold the last call's values either way)."""
        if not any(id(v) in self._static for v in leaves):
            return True
        last = self._last_leaves
        if last is None or len(last) != len(leaves):
            return False
        host = set(self._host_positions(leaves, dev))
        return all(v is last[i] or (i not in host and id(v) not in
                                    self._static)
                   for i, v in enumerate(leaves))

    def _remember(self, state, dev) -> None:
        """``state`` as the last call's: the next call that passes it back
        skips its flattening and its checks."""
        self._last = state
        self._last_leaves = pytree.tree_leaves(state)
        self._host = self._host_positions(self._last_leaves, dev)

    def _key(self, x, leaves, host_pos) -> tuple:
        host = set(host_pos)
        return _signature(x) + (tuple(
            _host_key(leaves[i]) for i in host_pos
            if i not in self._value_pos), tuple(
            tuple(v.shape) for i, v in enumerate(leaves) if i not in host))

    def _capture(self, x, dev, leaves, host_pos) -> None:
        bufs = {i: leaves[i].clone() for i in range(len(leaves))
                if i not in set(host_pos)}
        xs = tuple(t.clone() for t in x) if isinstance(x, tuple) \
            else x.clone()
        static = list(leaves)
        for i, b in bufs.items():
            static[i] = b
        static_state = pytree.tree_unflatten(static, self._spec)
        rec = _Recorder(host_pos, static, dev)

        def body():
            token = _RECORDER.set(rec)
            try:
                new_state, y = self.fn(static_state, xs)
            finally:
                _RECORDER.reset(token)
            new, new_spec = pytree.tree_flatten(new_state)
            if new_spec != self._spec or self._host_positions(
                    new, dev) != host_pos:
                raise ValueError(f"{self.name}: the step's state changes "
                                 f"structure ({self._spec} -> {new_spec})")
            y_leaves, y_spec = pytree.tree_flatten(y)
            # what reads a state buffer is copied before the buffers are
            # written (the state donated, as csdr_tpu's runner donates it)
            ptrs = {_storage(b) for b in bufs.values()}
            for seq in (new, y_leaves):
                for j, v in enumerate(seq):
                    if (isinstance(v, torch.Tensor) and v.device == dev
                            and _storage(v) in ptrs
                            and not (seq is new and v is bufs.get(j))):
                        seq[j] = v.clone()
            for i, b in bufs.items():
                if new[i] is not b and new[i].shape == b.shape:
                    b.copy_(new[i])
            return new, (y_leaves, y_spec)

        graph = self._new_graph()
        counters = launch_counts()
        before = {m: dict(c) for m, c in counters.items()}
        try:
            new, (y_leaves, y_spec) = graph.capture(body)
        except Exception as e:
            raise RuntimeError(
                f"{self.name}: cannot be captured in a CUDA graph: "
                f"{_where(e)}: {type(e).__name__}: {e}") from e
        finally:
            launched = [(c, k, c[k] - before[m].get(k, 0))
                        for m, c in counters.items() for k in c
                        if c[k] != before[m].get(k, 0)]
            for m, c in counters.items():
                c.update(before[m])
        value_pos = frozenset(rec.values)
        if self._value_pos is None:
            self._value_pos = value_pos
        elif value_pos != self._value_pos:
            raise RuntimeError(f"{self.name}: value leaves at "
                               f"{sorted(value_pos)}, an earlier capture "
                               f"had {sorted(self._value_pos)}")
        out_values = {j: rec.values[p] for j, v in enumerate(new)
                      for p in rec.values if v is rec.values[p].nxt}
        # a leaf whose shape the step changes (a carry of 0 or 1 samples)
        # is not donated: it goes out as an output does
        reshaped = {i for i, b in bufs.items() if new[i].shape != b.shape}
        host_out = [None if (j in bufs or j in out_values) else v
                    for j, v in enumerate(new)]
        # outputs on the card are copied out after each replay; the rest
        # (host counts) are the capture's
        y_const = [(isinstance(v, torch.Tensor) and v.device == dev, v)
                   for v in y_leaves]
        entry = _Entry(graph, xs, bufs, list(rec.values.values()), host_out,
                       out_values, y_spec, y_const, launched, reshaped)
        key = self._key(x, leaves, host_pos)
        self._graphs[key] = entry
        for b in bufs.values():
            self._static[id(b)] = entry
        self.captures += 1
        self.recaptures += key in self.captured_keys
        self.captured_keys.add(key)
        while len(self._graphs) > self.max_graphs:
            _, old = self._graphs.popitem(last=False)
            for b in old.bufs.values():
                self._static.pop(id(b), None)

    def _replay(self, e: _Entry, x, leaves):
        for i, b in e.bufs.items():
            if leaves[i] is not b:
                b.copy_(leaves[i])
        for t, static in zip(_inputs(x), _inputs(e.x)):
            if t is not static:
                static.copy_(t)
        for val in e.values:
            v = leaves[val.pos]
            val.scalar.fill_(v.item() if isinstance(v, torch.Tensor) else v)
        new_static, (y_static, _) = e.graph.replay()
        self.replays += 1
        for counter, k, n in e.launches:
            counter[k] += n
        new = list(e.host_out)
        for i, b in e.bufs.items():
            new[i] = new_static[i].clone() if i in e.reshaped else b
        for j, val in e.out_values.items():
            new[j] = val.advance(leaves[val.pos])
        y = [v.clone() if on_card else c
             for v, (on_card, c) in zip(y_static, e.y_const)]
        state = pytree.tree_unflatten(new, self._spec)
        self._last, self._last_leaves = state, new
        return state, pytree.tree_unflatten(y, e.y_spec)
