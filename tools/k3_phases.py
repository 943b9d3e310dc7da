#!/usr/bin/env python3
"""Where K3's time goes, and how its launch shape moves it, on one GPU:

    python3 tools/k3_phases.py

Builds copies of csdr_tpu_torch/csrc/fft_ko.cu with nvcc into
build/k3_phases/ (git-ignored), each with a few lines of the source
replaced: the kernel as it is ("full"); without its twiddle multiplies
("no_twiddle"), without its register DFTs ("no_dft"), without its
shared-memory exchanges and barriers ("no_exchange"), and with all three
left out ("copy": the device-memory loads and stores alone, in the
kernel's own order); and the full kernel launched differently: at most
128 or 256 threads a block ("block128", "block256"), frames a block halved
down to 2 or 8 blocks an SM ("sm2", "sm8"), and without the launch
bound's minimum of one block an SM, with which ptxas picks fewer
registers ("no_min_blocks").  A variant's output is wrong where it
skips work; only its time is read.  Each is timed with CUDA events (40
launches after a 20 ms spin, four input sets cycled) at chip_smoke.py's
K3 shapes, forward and inverse.  Prints the card's name and power limit,
each variant's registers and spills (ptxas), then one JSON line per
timing; the full kernel's lines carry its SNR against the plain version.
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
OUT = ROOT / "build" / "k3_phases"

TWIDDLE = [("constexpr bool TWIDDLE = I < S::P - 1;",
            "constexpr bool TWIDDLE = false;")]
DFT = [("    dft<R, INV>(w);\n", "")]
EXCHANGE = [
    (" else if constexpr (SB == 0) {\n#pragma unroll\n    for (int q = 0; "
     "q < G; ++q) {\n      const float4* row",
     "\n#if 0\n else if constexpr (SB == 0) {\n#pragma unroll\n    for (int "
     "q = 0; q < G; ++q) {\n      const float4* row"),
    ("\n\n  // DFTs over digit I", "\n#endif\n\n  // DFTs over digit I"),
    (" else if constexpr (SB == 0) {\n#pragma unroll\n    for (int q = 0; "
     "q < G; ++q) {\n      float4* row",
     "\n#if 0\n else if constexpr (SB == 0) {\n#pragma unroll\n    for (int "
     "q = 0; q < G; ++q) {\n      float4* row"),
    ("\n}\n\ntemplate <int LOGN, bool INV, int K>\n"
     "__device__ __forceinline__ void passes(",
     "\n#endif\n}\n\ntemplate <int LOGN, bool INV, int K>\n"
     "__device__ __forceinline__ void passes("),
    ("    __syncthreads();   // each pass", "    // each pass"),
]
VARIANTS = {
    "full": [],
    "no_twiddle": TWIDDLE,
    "no_dft": DFT,
    "no_exchange": EXCHANGE,
    "copy": TWIDDLE + DFT + EXCHANGE,
    "block128": [("constexpr int kBlockThreads = 64;",
                  "constexpr int kBlockThreads = 128;")],
    "block256": [("constexpr int kBlockThreads = 64;",
                  "constexpr int kBlockThreads = 256;")],
    "sm2": [("constexpr int kBlocksPerSm = 4;",
             "constexpr int kBlocksPerSm = 2;")],
    "sm8": [("constexpr int kBlocksPerSm = 4;",
             "constexpr int kBlocksPerSm = 8;")],
    "no_min_blocks": [("__launch_bounds__(Shape<LOGN>::THREADS, 1)",
                       "__launch_bounds__(Shape<LOGN>::THREADS)")],
}
SHAPES = ((1024, 3200), (256, 270))


def variant_source(edits) -> str:
    src = (ROOT / "csdr_tpu_torch/csrc/fft_ko.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"k3_phases: the source changed; {old!r} no "
                             "longer matches once")
        src = src.replace(old, new)
    return src


def build(item):
    from csdr_tpu_torch.kernels import _build
    name, edits = item
    cu, lib = OUT / f"k3_{name}.cu", OUT / f"libk3_{name}.so"
    cu.write_text(variant_source(edits))
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
         "-o", str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stderr[-3000:])
    info = re.findall(r"kernelILi(\d+)ELb([01]).*?(\d+) bytes spill "
                      r"stores.*?Used (\d+) registers",
                      proc.stderr.replace("\n", " "))
    print(json.dumps({"variant": name, "registers": {
        f"N={1 << int(n)} {'inv' if i == '1' else 'fwd'}": int(r)
        for n, i, _, r in info if int(n) in (8, 10)},
        "spill_store_bytes": sorted({int(s) for _, _, s, _ in info})}),
        flush=True)
    handle = ctypes.CDLL(str(lib))
    fns = {}
    for entry in ("csdr_fft_ko", "csdr_ifft_ko"):
        fn = getattr(handle, entry)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                ctypes.c_longlong,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[entry] = fn
    fpb = handle.csdr_fft_ko_frames_per_block
    fpb.argtypes = [ctypes.c_int, ctypes.c_longlong]
    fpb.restype = ctypes.c_int
    return name, (fns, fpb)


def time_case(torch, libs, name, n, b):
    from csdr_tpu_torch.kernels import fft_cuda
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sets = [torch.randn(b, n, dtype=torch.complex64, device=dev,
                        generator=gen) for _ in range(4)]
    tw = torch.from_numpy(fft_cuda.twiddles(n)).to(dev)
    ref = getattr(fft_cuda, name + "_plain")(sets[0])
    out = torch.empty_like(sets[0])
    stream = torch.cuda.current_stream().cuda_stream
    for variant, (fns, fpb) in libs.items():
        fn = fns["csdr_" + name]

        def run(i, fn=fn):
            code = fn(sets[i % 4].data_ptr(), out.data_ptr(), tw.data_ptr(),
                      n, b, stream)
            if code:
                raise SystemExit(f"{variant} {name}: CUDA error {code}")
        run(0)
        torch.cuda.synchronize()
        snr = None
        if variant == "full":
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
        print(json.dumps({"kernel": name, "N": n, "B": b, "variant": variant,
                          "frames_per_block": fpb(n, b),
                          "ms": start.elapsed_time(stop) / 40,
                          "snr_db": snr}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k3_phases: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(build, VARIANTS.items()))
    for n, b in SHAPES:
        for name in ("fft_ko", "ifft_ko"):
            time_case(torch, libs, name, n, b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
