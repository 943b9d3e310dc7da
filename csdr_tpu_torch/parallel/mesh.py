"""The (chan, time) device mesh over torch.distributed.

csdr_tpu shards its banks over a ``jax.sharding.Mesh(devices, ('chan',
'time'))`` inside one program; JAX places the shards, moves them and
gathers the result.  Here every shard is a process (a rank), and this
module holds what JAX gives for free:

- :func:`init_mesh`: the process group and a
  ``torch.distributed.device_mesh.DeviceMesh`` of shape (chan, time) with
  ``mesh_dim_names=("chan", "time")``, rank ``c*time + t`` at (c, t);
- :func:`shard_input`: this rank's slice of a wideband chunk along time;
- :func:`gather_output`: a sharded result, whole, on rank 0;
- :func:`run_mesh`: ``chan*time`` ranks started with
  ``torch.multiprocessing`` (start method ``spawn``), each running
  ``fn(mesh)``; rank 0's result comes back to the caller.

Backends.  NCCL takes CUDA tensors, one rank a card.  Gloo takes CPU
tensors: on the CPU that is the tests' mode, and on one card it is how
several ranks share the card (NCCL refuses two ranks on one device).  The
compute stays on ``device`` either way; with gloo and a CUDA device the
collectives copy their (small) tensors to the host and back
(``Mesh.staged``), which no kernel or device choice depends on.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from time import monotonic

import torch
import torch.distributed as dist

from csdr_tpu_torch.core.block import resolve_device
from csdr_tpu_torch.utils import collectives

AXES = ("chan", "time")
RUN_TIMEOUT_S = 1800.0     # the longest run_mesh waits for its ranks


@dataclasses.dataclass
class Mesh:
    """One rank's view of the mesh: the DeviceMesh, the compute device,
    the backend, and this rank's coordinates."""

    device_mesh: object
    device: torch.device
    backend: str
    shape: dict
    coords: dict

    @property
    def staged(self) -> bool:
        """Collectives copy through the host (gloo with a CUDA device)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def comm(self) -> str:
        return f"{self.backend}, host-staged" if self.staged \
            else self.backend

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rank_at(self, chan: int, time: int) -> int:
        """The global rank at mesh coordinates (chan, time)."""
        return chan * self.shape["time"] + time

    def to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor as the backend sends it: real planes, on the host
        where staged, contiguous."""
        if t.is_complex():
            t = torch.view_as_real(t)
        return (t.cpu() if self.staged else t).contiguous()

    def from_wire(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Back to ``like``'s dtype and device."""
        if like.is_complex():
            t = torch.view_as_complex(t)
        return t.to(like.device)


def init_mesh(chan: int, time: int, device="cuda",
              backend: str | None = None) -> Mesh:
    """The process group (if not yet made) and the (chan, time) mesh of
    this rank.  The group's address, rank and world size come from the
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``), as :func:`run_mesh` sets them.  ``backend`` defaults
    to NCCL on CUDA and gloo on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL needs a CUDA device")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("RANK", 0))
                               % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend)
    if dist.get_world_size() != chan * time:
        raise ValueError(f"a {chan}x{time} mesh needs {chan * time} ranks, "
                         f"the group has {dist.get_world_size()}")
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          (chan, time), mesh_dim_names=AXES)
    rank = dist.get_rank()
    return Mesh(dm, dev, backend, {"chan": chan, "time": time},
                {"chan": rank // time, "time": rank % time})


def shard_input(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the wideband chunk ``x`` along time (its last
    axis), on the mesh's device.  The chunk must split evenly."""
    n, p = x.shape[-1], mesh.shape["time"]
    if n % p:
        raise ValueError(f"a chunk of {n} samples does not split over "
                         f"{p} time shards")
    nl = n // p
    t = mesh.coords["time"]
    return x[..., t * nl:(t + 1) * nl].to(mesh.device)


def chan_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of ``n`` channels."""
    c = mesh.shape["chan"]
    if n % c:
        raise ValueError(f"{n} channels do not split over {c} chan shards")
    per = n // c
    i = mesh.coords["chan"]
    return slice(i * per, (i + 1) * per)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str | None,
               kind: str) -> list:
    """Every member's ``t`` (equal shapes) over the group of ``axis``
    (None: the world), in rank order, counted under ``kind``."""
    group = None if axis is None else mesh.group(axis)
    size = dist.get_world_size(group)
    with collectives.counted(kind, t.numel() * t.element_size()
                             * (size - 1)):
        wire = mesh.to_wire(t)
        parts = [torch.empty_like(wire) for _ in range(size)]
        dist.all_gather(parts, wire, group=group)
        out = [mesh.from_wire(p, t) for p in parts]
    return out


def gather_output(y: torch.Tensor, mesh: Mesh, time_sharded: bool = True):
    """The whole result on rank 0 (None on the other ranks), from each
    rank's block ``y``: rows along chan and, where ``time_sharded``, the
    last axis along time (``(C_l, m_l)`` -> ``(C, time*m_l)``).  A result
    sharded only along chan (replicated along time) takes each chan
    shard's rows once.  Counted under "gather"."""
    parts = all_gather(y, mesh, None, "gather")
    if dist.get_rank():
        return None
    p = mesh.shape["time"]
    rows = []
    for c in range(mesh.shape["chan"]):
        row = parts[c * p:(c + 1) * p]
        rows.append(torch.cat(row, -1) if time_sharded else row[0])
    return torch.cat(rows, 0)


def gather_state(state, mesh: Mesh):
    """A chan-sharded state whole on every rank: each tensor of the nested
    tuple ``state`` holds this rank's chan rows along its first axis and
    is copied along time (the mesh bank's state); the result is
    csdr_tpu's global (C, ...) layout, for ``core.checkpoint.save_state``
    on rank 0 or as the ``like`` of ``load_state``.  Counted under
    "gather"."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(gather_state(s, mesh) for s in state)
    parts = all_gather(state, mesh, None, "gather")
    return torch.cat(parts[::mesh.shape["time"]], 0)


def take_rows(state, mesh: Mesh):
    """This rank's chan rows of every tensor of a global state (the
    inverse of :func:`gather_state`)."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(take_rows(s, mesh) for s in state)
    return state[chan_rows(state.shape[0], mesh)].to(mesh.device)


def run_jobs(mesh: Mesh, jobs) -> list:
    """Each of ``jobs`` (callables of the mesh) in turn on this rank; their
    results in order.  ``run_mesh(partial(run_jobs, jobs=[...]), ...)``
    runs several on one set of ranks."""
    return [job(mesh) for job in jobs]


def _host_tree(v):
    """Tensors in a result as numpy arrays (they cross a process)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (list, tuple)):
        return type(v)(_host_tree(a) for a in v)
    if isinstance(v, dict):
        return {k: _host_tree(a) for k, a in v.items()}
    return v


def _rank_main(rank, jobs, chan, time, backend, device, port, results):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(chan * time))
    fn = jobs.get()
    mesh = init_mesh(chan, time, device, backend)
    try:
        out = fn(mesh)
        if rank == 0:
            results.put(_host_tree(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_mesh(fn, chan: int, time: int, backend: str = "nccl",
             device="cuda"):
    """Run ``fn(mesh)`` on a (chan, time) mesh of ``chan*time`` new
    processes (``torch.multiprocessing``, start method ``spawn``) and
    return rank 0's result, its tensors as numpy arrays.  ``fn`` must
    pickle (a module-level function, or a ``functools.partial`` of one).
    A rank that raises, or exits, ends the others and raises here; so
    does a run longer than RUN_TIMEOUT_S.  The caller's main module must
    be a file whose work sits under ``if __name__ == "__main__":``: each
    rank imports it again."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if backend == "nccl" and dev.type == "cuda" \
            and chan * time > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one rank a card: {chan * time} ranks, "
                         f"{torch.cuda.device_count()} cards (use gloo)")
    spawn = mp.get_context("spawn")
    results = spawn.SimpleQueue()
    # ``fn`` (and the inputs it carries) goes through a queue, not the
    # process arguments: a start writes its arguments to the child's pipe
    # and waits for the child to read them after its imports, which would
    # start the ranks one after another
    jobs = spawn.Queue()
    for _ in range(chan * time):
        jobs.put(fn)
    ctx = mp.start_processes(
        _rank_main, args=(jobs, chan, time, backend, str(dev), free_port(),
                          results),
        nprocs=chan * time, join=False, start_method="spawn")
    deadline = monotonic() + RUN_TIMEOUT_S
    got = []
    try:
        while not ctx.join(timeout=0.1):
            if not got and not results.empty():
                got.append(results.get())
            if monotonic() > deadline:
                raise TimeoutError(f"run_mesh: ranks still running after "
                                   f"{RUN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join()
        jobs.close()
        jobs.cancel_join_thread()
    if not got:
        if results.empty():
            raise RuntimeError("run_mesh: rank 0 returned no result")
        got.append(results.get())
    return got[0]

