#!/usr/bin/env python3
"""K1 and K2 at chip_smoke.py's shapes under every launch the kernel takes:

    python3 tools/k2_tiles.py

For each shape (the WFM front end D=10/T=79 fused and unfused, D=50/T=801
of paths C, E and F, D=50/T=81 of path D, the BASELINE headline
D=10/T=1023) and each launch the kernel takes there
(``fir_cuda.plans``: outputs a thread, threads a block, one or two window
buffers), times the kernel on the card (CUDA events, four input sets cycled
so no launch finds its input in L2) and checks that its output equals
the planner's launch bit for bit.  Prints the card's name and power
limit, then one JSON line per launch, the planner's marked; exits
non-zero if an output differs.  This is the measurement that
``fir_cuda.plan_tile``'s choices rest on.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPES = (("shift_fir_decimate", 10, 79, 240_000),
          ("fir_decimate", 10, 79, 240_000),
          ("fir_decimate", 50, 801, 48_060),
          ("fir_decimate", 50, 81, 48_000),
          ("fir_decimate", 10, 1023, 262_144))


def main() -> int:
    import torch

    from csdr_tpu_torch import firdes
    from csdr_tpu_torch.kernels import fir_cuda
    from csdr_tpu_torch.utils.timing import time_cuda

    if not torch.cuda.is_available():
        print("k2_tiles: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for name, d, t, kout in SHAPES:
        tail_len = ((t - 1 + d - 1) // d) * d
        sets = [(torch.randn(tail_len, dtype=torch.complex64, device=dev,
                             generator=gen),
                 torch.randn(kout * d, dtype=torch.complex64, device=dev,
                             generator=gen)) for _ in range(4)]
        taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
        phase = (-0.2, 0.3) if name == "shift_fir_decimate" else ()
        kern = getattr(fir_cuda, name)
        chosen = fir_cuda.plan_tile(t, d, kout, bool(phase))
        ref = kern(*sets[0], taps, d, kout, *phase).cpu().numpy()
        for plan in fir_cuda.plans(t, d, kout, bool(phase)):
            y = kern(*sets[0], taps, d, kout, *phase, plan=plan).cpu().numpy()
            same = bool(np.array_equal(y.view(np.uint32),
                                       ref.view(np.uint32)))
            bad += not same
            it = iter(range(1 << 30))
            ms = time_cuda(lambda: kern(*sets[next(it) % 4], taps, d, kout,
                                        *phase, plan=plan),
                           iters=40, queue_ahead_ms=20.0)
            print(json.dumps({
                "name": name, "D": d, "T": t, "kout": kout, **plan,
                "ms": ms, "planner": plan == chosen,
                "equals_planner_bits": same}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
