"""The CUDA graph's stand-in on the CPU (jax-free, so that the mesh tests'
spawned ranks import it): :class:`Rehearsal` is a CapturedStep on CPU
tensors whose "graph" (:class:`_Replayed`) keeps the captured body and, on
each replay, runs it again on the same static buffers, with the host
leaves frozen at their capture values and the value leaves read from the
scalars each call fills, as a CUDA graph replays its capture."""

import torch
from torch.utils import _pytree as pytree

from csdr_tpu_torch.core.graph import MAX_GRAPHS, CapturedStep


class _Replayed:
    """A CUDA graph's semantics on the CPU: capture keeps the body, a
    replay runs it again on the same static buffers."""

    def capture(self, body):
        self.body = body
        return body()

    def replay(self):
        return self.body()


class Rehearsal(CapturedStep):
    """CapturedStep on CPU tensors with the stand-in graph.  ``like`` is
    the step's state from ``init("meta")``: its leaves on the meta device
    are the ones on the card, the rest the host leaves; ``max_graphs`` the
    step's bound, as a CapturedStep's."""

    def __init__(self, fn, like, max_graphs=MAX_GRAPHS):
        super().__init__(fn, max_graphs)
        self.mask = [not (isinstance(v, torch.Tensor)
                          and v.device.type == "meta")
                     for v in pytree.tree_leaves(like)]
        self.keys = []

    def _on_card(self, x):
        return True

    def _host_positions(self, leaves, dev):
        return [i for i, h in enumerate(self.mask) if h]

    def _new_graph(self):
        return _Replayed()

    def _eager(self, state, x):
        return self.fn(state, x)

    def _key(self, *args):
        key = super()._key(*args)
        self.keys.append(key)
        return key
