#!/usr/bin/env python3
"""Where K1's and K2's time goes, on one GPU:

    python3 tools/k2_phases.py

Builds copies of csdr_tpu_torch/csrc/fir_decimate.cu with nvcc into
build/k2_phases/ (git-ignored): the kernel as it is ("full") and the
kernel without its window copies ("no_load"), without its tap sums
("no_sum"), without the NCO mix of K1 ("no_mix"), and with copies and sums
both left out ("frame": the tap table, the barriers and the stores).  A
variant's output is wrong where it skips work; only its time is read.
Each variant is timed with CUDA events (40 launches after a 20 ms spin,
four input sets cycled) at chip_smoke.py's K1/K2 shapes under the
planner's launch and others.  Prints the card's name and power limit,
each variant's registers and spills (ptxas), then one JSON line per
timing.
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
OUT = ROOT / "build" / "k2_phases"

# (text the guard starts before, text it ends before, macro)
GUARDS = (
    ("        if (in_x) cp_async8(dst, xw + i);",
     "        c += dc; p += dp;\n        if (p >= D) { p -= D; ++c; }\n"
     "      }\n    } else {", "SKIP_LOAD"),
    ("          if (i < win) {\n            if (in_x) v[b] = xw[i];",
     "        }\n        double sd", "SKIP_LOAD"),
    ("  const float2* wt = w + tid;\n",
     "#pragma unroll\n  for (int g = 0; g < S; ++g)\n#pragma unroll\n"
     "    for (int r = 0; r < R; ++r) {\n      const long long k = k0",
     "SKIP_SUM"),
)
# K1's mix, replaced by the sample as it was loaded
MIX_CALL = "in_x || s0 + i < total ? mix(v[b], sd, rate, theta) : v[b];"
NO_MIX = ("\n#ifndef SKIP_MIX\nin_x || s0 + i < total ? mix(v[b], sd, rate, "
          "theta) : v[b];\n#else\nv[b];\n#endif\n")
VARIANTS = {"full": (), "no_load": ("SKIP_LOAD",), "no_sum": ("SKIP_SUM",),
            "no_mix": ("SKIP_MIX",), "frame": ("SKIP_LOAD", "SKIP_SUM")}
# (R, S, threads) timed beside the planner's launch
OTHERS = ((1, 1, 128), (2, 1, 480), (2, 2, 256), (4, 2, 128), (4, 1, 256))
_VP, _LL, _I, _D = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_double)


def guarded_source() -> str:
    src = (ROOT / "csdr_tpu_torch/csrc/fir_decimate.cu").read_text()
    for start, end, macro in GUARDS:
        if src.count(start) != 1 or src.count(end) != 1:
            raise SystemExit(f"k2_phases: the source changed; guard {macro} "
                             "no longer matches")
        i = src.index(start)
        src = src[:i] + f"#ifndef {macro}\n" + src[i:]
        j = src.index(end)
        src = src[:j] + "#endif\n" + src[j:]
    if src.count(MIX_CALL) != 1:
        raise SystemExit("k2_phases: the source changed; SKIP_MIX no longer "
                         "matches")
    return src.replace(MIX_CALL, NO_MIX)


def build(item):
    from csdr_tpu_torch.kernels import _build
    name, macros = item
    lib = OUT / f"libk2_{name}.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
         *(f"-D{m}" for m in macros), "-o", str(lib), str(OUT / "k2.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stderr[-3000:])
    regs = re.findall(r"kernelILb(\d)ELi(\d+)E.*?Used (\d+) registers",
                      proc.stderr.replace("\n", " "))
    spills = re.findall(r"(\d+) bytes spill stores", proc.stderr)
    print(json.dumps({"variant": name, "registers": {
        f"MIX={a} R={b}": int(c) for a, b, c in regs},
        "spill_store_bytes": sorted({int(x) for x in spills})}), flush=True)
    handle = ctypes.CDLL(str(lib))
    fns = {}
    for fn_name, mid in (("csdr_fir_decimate", []),
                         ("csdr_shift_fir_decimate", [_D, _D])):
        fn = getattr(handle, fn_name)
        fn.argtypes = [_VP, _LL, _VP, _LL, _VP, _I, _I, _LL, _VP, *mid,
                       _I, _I, _I, _VP]
        fn.restype = ctypes.c_int
        fns[fn_name] = fn
    return name, fns


def time_case(torch, libs, name, d, t, kout, plans):
    from csdr_tpu_torch import firdes
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    tail_len = ((t - 1 + d - 1) // d) * d
    sets = [(torch.randn(tail_len, dtype=torch.complex64, device=dev,
                         generator=gen),
             torch.randn(kout * d, dtype=torch.complex64, device=dev,
                         generator=gen)) for _ in range(4)]
    taps = torch.from_numpy(firdes.firdes_lowpass_f(t, 0.5 / d)).to(dev)
    phase = (-0.2, 0.3) if name == "shift_fir_decimate" else ()
    y = torch.empty(kout, dtype=torch.complex64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for plan in plans:
        for variant, fns in libs.items():
            if variant == "no_mix" and not phase:
                continue
            fn = fns["csdr_" + name]

            def run(i, fn=fn, plan=plan):
                tl, x = sets[i % 4]
                code = fn(tl.data_ptr(), tail_len, x.data_ptr(), x.shape[0],
                          taps.data_ptr(), t, d, kout, y.data_ptr(), *phase,
                          plan["tile"], plan["per_thread"], plan["groups"],
                          stream)
                if code:
                    raise SystemExit(f"{variant} {plan}: CUDA error {code}")
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
            print(json.dumps({"name": name, "D": d, "T": t, "kout": kout,
                              "plan": {k: plan[k] for k in (
                                  "tile", "per_thread", "groups", "threads",
                                  "blocks")}, "variant": variant,
                              "ms": start.elapsed_time(stop) / 40}),
                  flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_phases: CUDA is not available", file=sys.stderr)
        return 2
    from csdr_tpu_torch.kernels import fir_cuda as fc
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "k2.cu").write_text(guarded_source())
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(build, VARIANTS.items()))
    for name, d, t, kout in (("shift_fir_decimate", 10, 79, 240_000),
                             ("fir_decimate", 10, 79, 240_000),
                             ("fir_decimate", 50, 801, 48_060),
                             ("fir_decimate", 50, 81, 48_000),
                             ("fir_decimate", 10, 1023, 262_144)):
        chosen = fc.plan_tile(t, d, kout, name == "shift_fir_decimate")
        others = [p for p in fc.plans(t, d, kout, name == "shift_fir_decimate")
                  if (p["per_thread"], p["groups"], p["threads"]) in OTHERS]
        time_case(torch, libs, name, d, t, kout,
                  [chosen] + [p for p in others if p != chosen])
    return 0


if __name__ == "__main__":
    sys.exit(main())
