#!/usr/bin/env python3
"""Where K5's time goes, and what its launch planner rests on, on one GPU:

    python3 tools/k5_phases.py

Builds copies of csdr_tpu_torch/csrc/fir_poly.cu with nvcc into
build/k5_phases/ (git-ignored): the kernel as it is ("full") and the
kernel without its window copies ("no_load"), without its phase sums
("no_sum"), with copies and sums both left out ("frame": the launch, the
tap table, the barrier and the stores), and with every product of the
column walk formed, its edge guards left out ("no_edge").  A variant's
output is wrong where it skips work; only its time is read.  Every copy
also takes one phase at a time (G=1) at R=4 and R=8, which the kernel
itself does not build.  Each variant is timed with CUDA events (40
launches after a 20 ms spin, four input sets cycled) at chip_smoke.py's
K5 shapes under the planner's launch; then the full kernel under every
launch ``fir_cuda.poly_plans`` lists there and under the same launches
at G=1 ("sweep").  Prints
the card's name and power limit, each variant's registers and spills
(ptxas), then one JSON line per timing.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "k5_phases"

# (text the guard starts before, text it ends before, macro)
GUARDS = (
    ("  // the window: sample i = c*D + p", "  // the taps: H[m][p]",
     "SKIP_LOAD"),
    ("  // G phases at a time, their chains side by side",
     "#pragma unroll\n  for (int r = 0; r < R; ++r) {\n"
     "    const long long k = k0", "SKIP_SUM"),
)
# G=1 at R=4 and R=8: the launches the sweep adds, and the lines of the
# source that take them
G1_PLANS = ((4, 1), (8, 1))
G1_TEXT = (("R == 1 ? G != 1 && G != 4 : G != 2",
            "R == 1 ? G != 1 && G != 4 : G != 2 && G != 1"),
           ("    CSDR_POLY_CASE(8, 2)\n",
            "    CSDR_POLY_CASE(8, 2) CSDR_POLY_CASE(4, 1) "
            "CSDR_POLY_CASE(8, 1)\n"))
# the edge guards of the column walk, replaced by "every product"
EDGE_TEST = "        if (EDGE == kAll ||"
NO_EDGE = ("#ifdef NO_EDGE\n        if (true ||\n#else\n" + EDGE_TEST
           + "\n#endif\n")
VARIANTS = {"full": (), "no_load": ("SKIP_LOAD",), "no_sum": ("SKIP_SUM",),
            "frame": ("SKIP_LOAD", "SKIP_SUM"), "no_edge": ("NO_EDGE",)}
# (D, T, kout, stream length or 0): chip_smoke.py's K5 shapes
SHAPES = ((10, 1023, 240_000, 1030 + 2_400_000), (10, 1023, 262_144, 0),
          (50, 81, 48_000, 0), (10, 7, 240_000, 0), (50, 801, 48_061, 0))
_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def guarded_source() -> str:
    src = (ROOT / "csdr_tpu_torch/csrc/fir_poly.cu").read_text()
    for start, end, macro in GUARDS:
        if src.count(start) != 1 or src.count(end) != 1:
            raise SystemExit(f"k5_phases: the source changed; guard {macro} "
                             "no longer matches")
        i = src.index(start)
        src = src[:i] + f"#ifndef {macro}\n" + src[i:]
        j = src.index(end)
        src = src[:j] + "#endif\n" + src[j:]
    if src.count(EDGE_TEST) != 1:
        raise SystemExit("k5_phases: the source changed; NO_EDGE no longer "
                         "matches")
    for old, new in G1_TEXT:
        if src.count(old) != 1:
            raise SystemExit("k5_phases: the source changed; G=1 no longer "
                             "matches")
        src = src.replace(old, new)
    return src.replace(EDGE_TEST, NO_EDGE)


def build(item):
    from csdr_tpu_torch.kernels import _build
    name, macros = item
    lib = OUT / f"libk5_{name}.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
         *(f"-D{m}" for m in macros), "-o", str(lib), str(OUT / "k5.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stderr[-3000:])
    regs = re.findall(r"fir_poly_kernelILi(\d+)E.*?Used (\d+) registers",
                      proc.stderr.replace("\n", " "))
    spills = re.findall(r"(\d+) bytes spill stores", proc.stderr)
    print(json.dumps({"variant": name, "registers": {
        f"R={a}": int(b) for a, b in regs},
        "spill_store_bytes": sorted({int(x) for x in spills})}), flush=True)
    fn = ctypes.CDLL(str(lib)).csdr_fir_poly
    fn.argtypes = [_VP, _LL, _VP, _I, _I, _LL, _I, _I, _I, _VP, _VP]
    fn.restype = ctypes.c_int
    return name, fn


def timer(torch, fn, d, t, kout, n, seed=1):
    """A function of a plan that returns its launch's mean ms."""
    from csdr_tpu_torch import firdes
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    sets = [torch.randn(n, dtype=torch.complex64, device=dev, generator=gen)
            for _ in range(4)]
    taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
    y = torch.empty(kout, dtype=torch.complex64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def ms(plan, fn=fn):
        def run(i):
            code = fn(sets[i % 4].data_ptr(), n, taps.data_ptr(), t, d, kout,
                      plan["tile"], plan["per_thread"], plan["groups"],
                      y.data_ptr(), stream)
            if code:
                raise SystemExit(f"{plan}: CUDA error {code}")
        for i in range(3):
            run(i)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(20e6))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(40):
            run(i)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 40
    return ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k5_phases: CUDA is not available", file=sys.stderr)
        return 2
    from csdr_tpu_torch.kernels import fir_cuda as fc
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "k5.cu").write_text(guarded_source())
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(build, VARIANTS.items()))
    keys = ("tile", "per_thread", "groups", "threads", "blocks",
            "blocks_per_sm")
    for d, t, kout, n in SHAPES:
        n = n or (kout - 1) * d + t
        chosen = fc.poly_plan(t, d, kout)
        for variant, fn in libs.items():
            ms = timer(torch, fn, d, t, kout, n)(chosen)
            print(json.dumps({"D": d, "T": t, "kout": kout, "variant": variant,
                              "plan": {k: chosen[k] for k in keys},
                              "ms": ms}), flush=True)
        full = timer(torch, libs["full"], d, t, kout, n)
        g1 = [fc._poly_plan(t, d, r, g, nt, kout) for r, g in G1_PLANS
              for nt in fc.POLY_THREADS
              if fc.poly_smem_bytes(t, d, nt * r, r, g) <= fc.MAX_SMEM]
        for plan in fc.poly_plans(t, d, kout) + g1:
            print(json.dumps({"D": d, "T": t, "kout": kout,
                              "variant": "sweep", "waves": fc.waves(plan),
                              "plan": {k: plan[k] for k in keys},
                              "ms": full(plan)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
