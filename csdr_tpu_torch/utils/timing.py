"""Device timing: CUDA events around repeated calls (:func:`time_cuda`), and
csdr_tpu's difference-quotient discipline on a CUDA graph
(:func:`time_kernel`).  A number from here is a time on the card; a CPU
tensor handed to :func:`time_kernel` is the caller's explicit request to
time the CPU, and nothing falls back to it."""

from __future__ import annotations

import os
import statistics
import time
from typing import Callable

import torch
from torch.utils import _pytree as pytree


def time_cuda(fn: Callable[[], object], iters: int = 20, warmup: int = 3,
              repeats: int = 5, queue_ahead_ms: float = 0.0) -> float:
    """Median over ``repeats`` of the mean milliseconds per call of ``fn``,
    each repeat timing ``iters`` back-to-back calls between two CUDA events
    on the current stream.

    queue_ahead_ms: keep the card busy this long (a spin kernel) before
    the first event, so the host queues the timed calls ahead of the
    device and the events time the device alone; 0 times the calls as
    issued, host overhead included."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        if queue_ahead_ms:
            torch.cuda._sleep(int(queue_ahead_ms * 2e6))   # ~2 GHz clocks
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times)


def _sum_leaves(y) -> list:
    """Each tensor leaf of ``y`` summed in float32 into one scalar: a
    complex leaf its real and imaginary parts together, as csdr_tpu's CF
    sums its two planes."""
    leaves = [v for v in pytree.tree_leaves(y) if isinstance(v, torch.Tensor)]
    if not leaves:
        raise TypeError("_scalarize: the kernel returned no tensor")
    return [torch.view_as_real(v) if v.is_complex() else v for v in leaves]


def _scalarize(y) -> torch.Tensor:
    """The sum of every leaf of ``y`` as one float32 scalar (csdr_tpu's
    ``_scalarize``)."""
    total = None
    for v in _sum_leaves(y):
        s = torch.sum(v, dtype=torch.float32)
        total = s if total is None else total + s
    return total


def _scalarize_into(y, row: torch.Tensor) -> None:
    """_scalarize's leaf sums written into ``row`` (one float32 slot a
    leaf): one reduction launch a leaf, no add."""
    for j, v in enumerate(_sum_leaves(y)):
        torch.sum(v.flatten(), 0, dtype=torch.float32, out=row[j])


def _name(kernel) -> str:
    return getattr(kernel, "__qualname__", None) or repr(kernel)


def time_kernel(kernel: Callable, x, reps: int = 3,
                target_ms: float = 80.0,
                k_pair: tuple[int, int] | None = None,
                aux=None, perturb: str = "dus") -> float:
    """Seconds per kernel invocation (steady state), ``kernel(x) -> y`` or
    ``kernel(x, aux) -> y``; ``x`` and ``aux`` are tensors or pytrees of
    them (csdr_tpu's ``utils/timing.time_kernel``, the same signature).

    k iterations of *perturb -> kernel -> acc += _scalarize(y)* are
    captured in one CUDA graph into a preallocated ``acc``, the card's
    counterpart of csdr_tpu's jitted ``fori_loop``: no host in the loop.
    Iteration i writes its leaf sums into row i of ``acc`` (one reduction
    launch a leaf) and the graph sums the rows once at its end, so the
    loop adds no separate accumulate launch to each call.  A host clock
    times a replay plus the fetch of the total, and the slope
    between two k cancels the replay's and the fetch's constants.  k
    escalates from (8, 64) by 4x up to 8192 until the loop time clearly
    exceeds the constants, unless ``k_pair`` fixes (k_small, k_big); every
    output of a graph comes from its private pool, so callers with large
    outputs pass a ``k_pair`` that keeps k_big modest.

    perturb:
      "dus"    adds (seed+i)*1e-30 in place to element 0 of every floating
               leaf of a working copy of ``x`` (integer leaves, such as u8
               I/Q and int16 audio, get 0: nothing is added);
      "add"    the whole-array add x + eps, a new tensor every iteration,
               kept for A/B (it charges the kernel an extra pass);
      "rotate" S copies of ``x`` whose total exceeds twice the card's L2
               cache (``L2_cache_size``; 50 MB on an H100), iteration i
               reading copy i % S, so no call finds its input in the L2.
               The index is a Python int at capture: the pick costs
               nothing.
    ``aux`` is passed through unperturbed (large constant operands).

    CSDR_TIMING_SMOKE=1 runs the kernel once and returns 1.0.  A CPU
    ``x`` runs the same loop eagerly under ``time.perf_counter``.  A
    kernel that cannot be captured in a CUDA graph raises, naming it."""
    if perturb not in ("dus", "add", "rotate"):
        raise ValueError(f"time_kernel: perturb={perturb!r}: 'dus', 'add' "
                         "or 'rotate'")

    def call(xp):
        return kernel(xp, aux) if aux is not None else kernel(xp)

    if os.environ.get("CSDR_TIMING_SMOKE"):
        float(_scalarize(call(x)))
        return 1.0
    leaves = [v for v in pytree.tree_leaves(x) if isinstance(v, torch.Tensor)]
    if not leaves:
        raise TypeError("time_kernel: x holds no tensor")
    dev = leaves[0].device
    on_card = dev.type == "cuda"
    if perturb == "rotate":
        xbytes = sum(v.numel() * v.element_size() for v in leaves)
        l2 = (torch.cuda.get_device_properties(dev).L2_cache_size
              if on_card else 0)
        s = max(2, -(-2 * l2 // max(xbytes, 1)) + 1)
        xs = pytree.tree_map(
            lambda a: (a.unsqueeze(0).repeat((s,) + (1,) * a.dim())
                       if isinstance(a, torch.Tensor) else a), x)

        def body(i, row):
            _scalarize_into(call(pytree.tree_map(
                lambda a: a[i % s] if isinstance(a, torch.Tensor) else a,
                xs)), row)
    elif perturb == "dus":
        # a working copy, updated in place: never the caller's x
        xc = pytree.tree_map(
            lambda a: a.clone() if isinstance(a, torch.Tensor) else a, x)

        def body(i, row):
            eps = (seed_of[0] + i) * 1e-30
            for a in pytree.tree_leaves(xc):
                if isinstance(a, torch.Tensor) and (
                        a.is_floating_point() or a.is_complex()):
                    a[(0,) * a.dim()].add_(eps)
            _scalarize_into(call(xc), row)
    else:
        def body(i, row):
            eps = (seed_of[0] + i) * 1e-30
            _scalarize_into(call(pytree.tree_map(
                lambda a: (a + eps if isinstance(a, torch.Tensor) and (
                    a.is_floating_point() or a.is_complex()) else a), x)),
                row)

    seed_of = [0.0]
    width = len(_sum_leaves(call(x)))      # also builds what the kernel
    graphs: dict[int, tuple] = {}          # sets up lazily, before capture

    def run_eager(k):
        acc = torch.zeros((k, width), dtype=torch.float32, device=dev)
        for i in range(k):
            body(i, acc[i])
        return float(acc.sum())

    def graph(k):
        if k not in graphs:
            acc = torch.zeros((k, width), dtype=torch.float32, device=dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):      # warm up outside capture
                body(0, acc[0])
            torch.cuda.current_stream(dev).wait_stream(side)
            g = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(g):
                    for i in range(k):
                        body(i, acc[i])
                    total = acc.sum()
            except Exception as e:
                raise RuntimeError(
                    f"time_kernel: {_name(kernel)} cannot be captured in "
                    f"a CUDA graph ({type(e).__name__}: {e})") from e
            graphs[k] = (g, total)
        return graphs[k]

    def run_graph(k):
        g, total = graph(k)
        g.replay()
        return float(total)

    run = run_graph if on_card else run_eager

    def measure(k, r):
        seed_of[0] = 0.0
        run(k)                                    # capture + settle
        best = float("inf")
        for i in range(r):
            seed_of[0] = float(i + 1)
            t0 = time.perf_counter()
            run(k)
            best = min(best, time.perf_counter() - t0)
        return best

    if k_pair is not None:
        k_small, k_big = k_pair
        t_small = measure(k_small, 2)
        t_big = measure(k_big, 2)
    else:
        k_small = 8
        t_small = measure(k_small, 2)
        k_big = 64
        while True:
            t_big = measure(k_big, 2)
            if t_big > max(3 * t_small, target_ms / 1e3) or k_big >= 8192:
                break
            k_big *= 4
    # refine with one more rep pair at the chosen sizes
    if reps > 1:
        t_small = min(t_small, measure(k_small, reps - 1))
        t_big = min(t_big, measure(k_big, reps - 1))
    return max((t_big - t_small) / (k_big - k_small), 1e-9)
