"""Collective traffic of the sharded banks (counterpart of
csdr_tpu.utils.collectives).

csdr_tpu reads the bytes each collective moves from the compiled HLO of a
jitted step.  The port has no compiled program to read, so it counts at
the source: every collective of ``parallel/`` (the halo, the de-emphasis
fixup, the corner turn, the gather of a result to rank 0) adds what this
rank sends to ``BYTES`` under its kind, and the host milliseconds the call
took (the staging copies included where the group's backend takes host
tensors) to ``HOST_MS``.  What a rank sends: the tensor's bytes once for
each rank that receives it (a halo its one right neighbour, an all-gather
the other members of the group).  ``reset_collectives`` and
``read_collectives`` work as the kernels' launch counters do; the counts
are per process, and :func:`mesh_total` sums them over a mesh's ranks.

A collective never runs inside a captured segment (gloo's are host work
and a staged one copies through the host): :func:`counted` raises there,
so a capture that would hold one fails, naming it (parallel/segments).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from csdr_tpu_torch.core.graph import capturing

KINDS = ("halo", "fixup", "corner_turn", "gather")

BYTES = {k: 0 for k in KINDS}
HOST_MS = {k: 0.0 for k in KINDS}


def reset_collectives() -> None:
    for table in (BYTES, HOST_MS):
        for k in table:
            table[k] = 0


def read_collectives() -> dict:
    """This process's counts since the last reset: {"bytes": {kind: n},
    "host_ms": {kind: ms}}."""
    return {"bytes": dict(BYTES), "host_ms": dict(HOST_MS)}


@contextmanager
def counted(kind: str, nbytes: int):
    """Count one collective of ``kind`` sending ``nbytes`` from this rank,
    and the host time of the block it wraps."""
    if kind not in BYTES:
        raise ValueError(f"collective kind {kind!r} not in {KINDS}")
    if capturing():
        raise RuntimeError(f"a {kind!r} collective inside a captured "
                           "segment: a rank's collectives run between its "
                           "graphs (parallel/segments)")
    t0 = time.perf_counter()
    yield
    HOST_MS[kind] += (time.perf_counter() - t0) * 1e3
    BYTES[kind] += int(nbytes)


def mesh_total(mesh) -> dict:
    """Every rank's bytes summed, {kind: n} (an uncounted gather over the
    world)."""
    import torch.distributed as dist

    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, read_collectives())
    return {k: sum(g["bytes"][k] for g in gathered) for k in KINDS}
