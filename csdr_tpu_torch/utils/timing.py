"""Device timing with CUDA events: warm-up launches, then the median of
repeated timed runs.  A number from here is a time on the card; there is no
CPU fallback."""

from __future__ import annotations

import statistics
from typing import Callable

import torch


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
