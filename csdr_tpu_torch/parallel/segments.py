"""A rank's step captured between its collectives: the mesh counterpart of
core/graph.CapturedStep (csdr_tpu jits each mesh step into one program).

A rank's step is written once, as ``run(state, x, seg) -> (state', y)``.
It calls its collectives itself (the halo, the fixup's all-gather, the
corner turn), and each run of ops between two collectives, a *segment*, as
``seg(name, fn, state, xs)``, which returns ``fn(state, xs)``; ``xs`` is a
tuple of tensors (the halo and the shard, say).  The eager step passes
:func:`eager`.  :class:`SegmentedStep` passes a ``seg`` that runs each named
segment as a CapturedStep of its own: one CUDA graph a key, replayed, with
the collectives run eagerly between the replays.  Gloo's collectives are
host work and a staged one copies through the host, so neither can enter
a graph; a collective met inside a capture raises (utils/collectives).

Where the mesh's time axis is 1 no collective runs (the halo is zeros, the
fixup loop is empty, there is no corner turn), so the whole step is one
graph, the single-card step's.
"""

from __future__ import annotations

from csdr_tpu_torch.core.graph import CapturedStep


def eager(name, fn, state, xs):
    """The eager step's ``seg``: the segment's ops as they come."""
    return fn(state, xs)


class SegmentedStep:
    """``step.run`` (``step`` a rank's step on ``step.mesh``) with every
    segment captured: ``make(fn)`` makes a segment's CapturedStep (the
    CPU tests pass a rehearsal).  Called as ``(state, x) -> (state', y)``,
    or ``(x) -> y`` for a step without state.  ``eager`` is ``step``,
    ``segments`` each segment's CapturedStep by name (``"step"``, the whole
    step, where time is 1), ``captures`` their captures."""

    def __init__(self, step, make=CapturedStep):
        self.eager, self.make = step, make
        self.name = type(step).__name__
        self.segments: dict = {}
        self.whole = None
        if step.mesh.shape["time"] == 1:
            self.whole = self._segment(
                "step", lambda state, x: step.run(state, x, eager))

    def _segment(self, name, fn):
        seg = self.segments.get(name)
        if seg is None:
            seg = self.segments[name] = self.make(fn)
            seg.name = f"{self.name}/{name}"
        return seg

    def _seg(self, name, fn, state, xs):
        return self._segment(name, fn)(state, xs)

    @property
    def captures(self) -> int:
        return sum(s.captures for s in self.segments.values())

    def __call__(self, *args):
        state, x = args if len(args) == 2 else ((), args[0])
        out = self.whole(state, x) if self.whole is not None \
            else self.eager.run(state, x, self._seg)
        return out if len(args) == 2 else out[1]


def on_card(step):
    """``step`` as a mesh builder returns it: a :class:`SegmentedStep` on a
    card, the eager step itself on the CPU."""
    return SegmentedStep(step) if step.mesh.device.type == "cuda" else step
