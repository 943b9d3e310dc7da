#!/usr/bin/env python3
"""Where K4's time goes, on one GPU:

    python3 tools/k4_phases.py

Builds copies of csdr_tpu_torch/csrc/fastddc_inv.cu with nvcc into
build/k4_phases/ (git-ignored): the kernel as it is ("full") and the kernel
without its tensor-core product ("no_mma"), without its fold arithmetic
("no_fold"), without its cp.async staging ("no_load"), and with all three
left out ("frame": barriers, the 3xTF32 splits and the epilogue).  A
variant's output is wrong where it skips work; only its time is read.
Each variant is timed with CUDA events (40 launches after a 20 ms spin,
four input sets cycled) at chip_smoke.py's K4 shapes with
fastddc_cuda.plan_tiles' tiles, and the full kernel also at other fold
stage lengths.  Prints the card's name and power limit, each variant's
registers and spills (ptxas), then one JSON line per timing; the full
kernel's lines carry its SNR against fastddc_inv_plain.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "k4_phases"

# (text the guard starts before, text it ends before, macro)
GUARDS = (
    ("    const float4* za =", "  }\n\n  // epilogue", "SKIP_MMA"),
    ("      for (int jj = jg; jj < jc_len; jj += JS) {",
     "    }\n\n    // the chunk's fold is complete", "SKIP_FOLD"),
    ("    float2* st = stages + (s & 1) * stage_len;\n    const int k0",
     "    cp_async_commit();\n  };", "SKIP_LOAD"),
)
VARIANTS = {"full": (), "no_mma": ("SKIP_MMA",), "no_fold": ("SKIP_FOLD",),
            "no_load": ("SKIP_LOAD",),
            "frame": ("SKIP_MMA", "SKIP_FOLD", "SKIP_LOAD")}


def guarded_source() -> str:
    src = (ROOT / "csdr_tpu_torch/csrc/fastddc_inv.cu").read_text()
    for start, end, macro in GUARDS:
        if src.count(start) != 1 or src.count(end) != 1:
            raise SystemExit(f"k4_phases: the source changed; guard {macro} "
                             "no longer matches")
        i = src.index(start)
        src = src[:i] + f"#ifndef {macro}\n" + src[i:]
        j = src.index(end)
        src = src[:j] + "#endif\n" + src[j:]
    return src


def build(item):
    from csdr_tpu_torch.kernels import _build
    name, macros = item
    lib = OUT / f"libk4_{name}.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
         *(f"-D{m}" for m in macros), "-o", str(lib), str(OUT / "k4.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stderr[-3000:])
    regs = re.findall(r"kernelILi(\d+)ELi(\d+)E.*?Used (\d+) registers",
                      proc.stderr.replace("\n", " "))
    spills = re.findall(r"(\d+) bytes spill stores", proc.stderr)
    print(json.dumps({"variant": name, "registers": {
        f"KC={a} NI={b}": int(c) for a, b, c in regs},
        "spill_store_bytes": [int(x) for x in spills]}), flush=True)
    fn = ctypes.CDLL(str(lib)).csdr_fastddc_inv
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return name, fn


def time_case(torch, fns, d, b, c, tile_list, names):
    from csdr_tpu_torch.kernels import fastddc_cuda as fc
    from csdr_tpu_torch.ops import fastddc as fd
    dev = torch.device("cuda")
    ddc = fd.fastddc_init(0.05, d)
    rates = np.random.default_rng(0).uniform(-0.4, 0.4, c)
    tq, w, dd, cyc = fd.channel_factored2_arrays(ddc, rates)
    rot = np.exp(2j * np.pi * np.mod(np.arange(b)[None, :] * cyc[:, None],
                                     1.0))
    mats = [torch.from_numpy(np.ascontiguousarray(a, np.complex64)).to(dev)
            for a in (tq, w, dd, rot)]
    gen = torch.Generator(device=dev).manual_seed(1)
    sets = [torch.randn(b, ddc.fft_size, dtype=torch.complex64, device=dev,
                        generator=gen) for _ in range(4)]
    _, pre, inv = tq.shape
    m = w.shape[1]
    ref = fc.fastddc_inv_plain(sets[0], *mats, m)
    for tiles in tile_list:
        for name in names:
            out = torch.empty((c, b, m), dtype=torch.complex64, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def run(i, fn=fns[name], out=out, stream=stream, tiles=tiles):
                code = fn(sets[i % 4].data_ptr(),
                          *(t.data_ptr() for t in mats), out.data_ptr(), b,
                          c, pre, inv, m, m, m, tiles["kc"], tiles["mt"],
                          tiles["jc"], stream)
                if code:
                    raise SystemExit(f"{name} {tiles}: CUDA error {code}")
            run(0)
            torch.cuda.synchronize()
            snr = None
            if name == "full":
                err = float((out - ref).abs().pow(2).sum())
                snr = 10 * np.log10(float(ref.abs().pow(2).sum()) / err)
            for i in range(3):
                run(i)
            torch.cuda._sleep(int(20e6))
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(40):
                run(i)
            stop.record()
            stop.synchronize()
            print(json.dumps({"D": d, "C": c, "B": b, "tiles": {
                k: tiles[k] for k in ("kc", "mt", "jc")}, "variant": name,
                "ms": start.elapsed_time(stop) / 40, "snr_db": snr}),
                flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k4_phases: CUDA is not available", file=sys.stderr)
        return 2
    from csdr_tpu_torch.kernels import fastddc_cuda as fc
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "k4.cu").write_text(guarded_source())
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(pool.map(build, VARIANTS.items()))
    every = list(VARIANTS)
    plan = fc.plan_tiles
    time_case(torch, fns, 16, 1024, 64,
              [plan(8, 128, 56), dict(plan(8, 128, 56), jc=4)], every)
    time_case(torch, fns, 4, 1024, 64, [plan(2, 512, 224)], every)
    time_case(torch, fns, 256, 1024, 64,
              [plan(128, 16, 7), dict(plan(128, 16, 7), jc=8)], every)
    time_case(torch, fns, 16, 512, 256, [plan(8, 128, 56)], ["full"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
