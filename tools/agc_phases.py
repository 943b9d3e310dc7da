#!/usr/bin/env python3
"""Where the chunked AGC kernel's time goes on the card (csrc/agc.cu):

    python3 tools/agc_phases.py

1. ``barriers``: SM cycles of what a row over a cluster can exchange with,
   from a small CUDA program built with nvcc: a cluster barrier (arrive
   with release, wait with acquire), the same after a CTA barrier, a CTA
   barrier alone, and a store, a CTA barrier and a relaxed cluster
   arrive/wait, at clusters of 1, 2, 8 and 16 CTAs; a load from another
   CTA's shared memory against one from the CTA's own (a pointer chase);
   a cooperative grid.sync() over 6 to 132 CTAs.
2. ``phases``: a copy of csrc/agc.cu with clock64 counters on thread 0 of
   one CTA, inserted at fixed places of the source (the tool fails if one
   is gone), built alone and run through ``agc_cuda.relax`` on path E's
   second audio chunk (chip_smoke.pre_agc_audio) and on ``_agc_signal``,
   each output held bit for bit to ``relax_plain``.  For the first, a
   middle and the last CTA of the first row: SM cycles a round of each
   phase of a round (the scan's steps split into waits for pushed pairs,
   own work and CTA barriers), and the kernel's own phases a call; beside
   them the call's time (CUDA events, the counters on).

Prints the card's name and power limit, then one JSON line a result.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

BARRIERS = r'''
#include <cstdio>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void bar(long long* out, int iters, int mode) {
  __shared__ int buf[1024];
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (mode == 0) {
      asm volatile("barrier.cluster.arrive.release.aligned;\n"
                   "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    } else if (mode == 1) {
      __syncthreads();
      asm volatile("barrier.cluster.arrive.release.aligned;\n"
                   "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    } else if (mode == 2) {
      __syncthreads();
    } else {
      buf[threadIdx.x] = i;
      __syncthreads();
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
                   "barrier.cluster.wait.aligned;\n" ::: "memory");
    }
  }
  if (threadIdx.x == 0 && blockIdx.x == 0)
    out[0] = (clock64() - t0) / iters + buf[0] * 0;
}
__global__ void chase(long long* out, int iters, int remote) {
  __shared__ unsigned idx[1024];
  cg::cluster_group cl = cg::this_cluster();
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    idx[i] = (i * 97 + 13) & 1023;
  cl.sync();
  if (threadIdx.x == 0 && cl.block_rank() == 1) {
    const unsigned base = (unsigned)__cvta_generic_to_shared(idx);
    unsigned at, j = 0;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(at) : "r"(base), "r"(remote ? 0 : 1));
    const long long t0 = clock64();
    for (int i = 0; i < iters; ++i)
      asm volatile("ld.shared::cluster.u32 %0, [%1];"
                   : "=r"(j) : "r"(at + 4 * j));
    out[0] = (clock64() - t0) / iters;
    out[1] = j;
  }
  cl.sync();
}
__global__ void gridsync(long long* out, int iters, int) {
  cg::grid_group g = cg::this_grid();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) g.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0)
    out[0] = (clock64() - t0) / iters;
}
long long run(void (*k)(long long*, int, int), int grid, int block,
              int cluster, bool coop, int iters, int mode) {
  long long* d;
  long long h[2] = {0, 0};
  cudaMalloc(&d, sizeof(h));
  cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                       1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = coop ? 2 : 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, k, d, iters, mode);
  const cudaError_t e2 = cudaDeviceSynchronize();
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  cudaFree(d);
  return e || e2 ? -1 : h[0];
}
int main() {
  const int ks[] = {1, 2, 8, 16}, ts[] = {1024, 1024, 256, 128};
  const char* modes[] = {"cluster_release_acquire", "cta_then_cluster",
                         "cta_alone", "store_cta_cluster_relaxed"};
  for (int i = 0; i < 4; ++i)
    for (int m = 0; m < 4; ++m)
      printf("{\"barrier\": \"%s\", \"ctas\": %d, \"threads\": %d, "
             "\"cycles\": %lld}\n", modes[m], ks[i], ts[i],
             run(bar, ks[i] * 6, ts[i], ks[i], false, 2000, m));
  for (int r = 0; r < 2; ++r)
    printf("{\"load\": \"%s shared memory\", \"cycles\": %lld}\n",
           r ? "another CTA's" : "the CTA's own",
           run(chase, 2, 128, 2, false, 2000, r));
  const int grids[][3] = {{6, 1024, 1}, {96, 512, 16}, {132, 1024, 4}};
  for (const auto& g : grids)
    printf("{\"grid_sync\": true, \"ctas\": %d, \"threads\": %d, "
           "\"cluster\": %d, \"cycles\": %lld}\n", g[0], g[1], g[2],
           run(gridsync, g[0], g[1], g[2], true, 200, 0));
  return 0;
}
'''

HEAD = '''
__device__ long long g_prof[32];
__device__ int g_who;
__shared__ long long s_prof[32];
#define PROF_START long long prof_t = clock64(); \\
  const bool prof_on = threadIdx.x == 0 && blockIdx.x == g_who;
#define PROF(i) do { if (prof_on) { const long long prof_n = clock64(); \\
  s_prof[i] += prof_n - prof_t; prof_t = prof_n; } } while (0)
'''

ENTRY = '''extern "C" {
int csdr_agc_prof(void* out, int who) {
  if (out) return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  long long zero[32] = {0};
  cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)cudaMemcpyToSymbol(g_who, &who, sizeof(int));
}
'''

# (anchor in csrc/agc.cu, text, before the anchor?): counter i adds the
# cycles since the counter before it, in shared memory (a global update on
# the chain would cost an L2 round trip a counter); 20 counts the rounds
PLACES = [
    ("    rounds = it + 1;\n", "    PROF_START\n    if (prof_on) ++s_prof[20];\n",
     False),
    ("    // the masks from the trajectory, and each segment's summary\n",
     "    PROF(0);\n", True),
    ("    __syncthreads();\n    if (warp == 0) {\n", "    PROF(1);\n", True),
    ("    if (rank > 0 && t == 0) bar_expect(bars + 8 * kBarSum, 8 * rank);\n"
     "    __syncthreads();\n", "    PROF(2);\n", False),
    ("    // the branch of every sample, its affine pair and the clip mask",
     "    PROF(3);\n", True),
    ("    const bool changed = att_bits != att_prev", "    PROF(4);\n", True),
    ("    int any = __syncthreads_or(changed);\n", "    PROF(5);\n", False),
    ("    att_prev = att_bits;\n", "    PROF(6);\n", True),
    ("    affine_scan(v, L, bars, C, S, K, rank, hpar, ph);\n",
     "    PROF(7);\n", False),
    ("  int roff = 0;\n", "  PROF_START\n", False),
    ("    int steps = 1;\n", "    PROF(9);\n", True),
    ("        bar_wait(bars + 8 * (kBarStep + j), ph & 1u);\n",
     "        PROF(8);\n", False),
    ("        __syncthreads();\n        float2* tmp = src;\n",
     "        PROF(9);\n", True),
    ("        float2* tmp = src;\n", "        PROF(10);\n", True),
    ("#pragma unroll\n  for (int k = 0; k < E; ++k) L.f[k * T + t] = v[k].x;",
     "  PROF(9);\n", True),
    ("  const bool row_end = rank == K - 1 && t == T - 1;",
     "  PROF_START\n  if (prof_on) for (int i = 0; i < 32; ++i) s_prof[i] = 0;\n",
     True),
    ("  const int rows = p.rows;\n", "  PROF(11);\n", True),
    ("      int rounds, h;\n", "      PROF(12);\n", True),
    ("                   &settled, &h);\n", "      PROF(13);\n", False),
    ("    grid.sync();\n", "    PROF(14);\n", True),
    ("    grid.sync();\n", "    PROF(15);\n", False),
    ("    all_settled = __syncthreads_and(sett);\n", "    PROF(16);\n",
     False),
    ("  if (K > 1) cluster_sync_all();   // no CTA leaves while another pushes",
     "  PROF(17);\n  if (prof_on) for (int i = 0; i < 32; ++i) "
     "g_prof[i] += s_prof[i];\n", True),
]
ROUND = ["left f", "masks", "segment scan and push", "summaries' wait",
         "branch", "CTA OR", "flags' wait", "scan"]
STEPS = ["steps: waits for pushed pairs", "steps: own work",
         "steps: CTA barriers"]
CALL = ["start", "row loads", "relax_row", "exits and CTA barrier",
        "grid.sync", "stop test", "outputs"]


def instrumented(src: str) -> str:
    s = src.replace("namespace {\n", "namespace {\n" + HEAD, 1)
    for anchor, text, before in PLACES:
        if anchor not in s:
            raise SystemExit(f"agc_phases: {anchor!r} is no longer in "
                             f"csrc/agc.cu")
        s = s.replace(anchor, text + anchor if before else anchor + text, 1)
    return s.replace('extern "C" {\n', ENTRY, 1)


def phases(tmp: Path) -> None:
    import torch
    import chip_smoke as cs
    from csdr_tpu_torch.kernels import _build, agc_cuda
    from csdr_tpu_torch.models import receivers
    from csdr_tpu_torch.utils.timing import time_cuda
    from test_torch_agc_kernel import agc_signal

    s = np.arange(2 * cs.CHUNK_C, dtype=np.float64)
    xe = np.exp(2j * np.pi * np.mod(0.0005 * s, 1.0)).astype(np.complex64)
    e, e_kw = cs.pre_agc_audio(torch, lambda: receivers.ssb_receiver(
        0.0, 0.1, 0.05, decimation=50), xe, cs.CHUNK_C)
    cu, so = tmp / "agc_prof.cu", tmp / "agc_prof.so"
    cu.write_text(instrumented((_build.CSRC / "agc.cu").read_text()))
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    for name in ("csdr_agc_relax", "csdr_agc_chain_probe"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    for name in ("csdr_agc_relax_clusters", "csdr_agc_relax_threads"):
        getattr(lib, name).argtypes = _build._QUERIES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.csdr_agc_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    real = _build.lib
    _build.lib = lambda: lib
    try:
        dev = torch.device("cuda")
        for case, (x, kw) in {"E": (e, e_kw),
                              "agc_signal": (agc_signal(), {})}.items():
            a = torch.from_numpy(x).to(dev)
            want = agc_cuda.relax_plain(a, **kw)
            plan = agc_cuda.plan(len(x))
            k = plan["size"]
            for who in sorted({0, k // 2, k - 1}):
                lib.csdr_agc_prof(None, who)
                got = agc_cuda.relax(a, **kw)
                torch.cuda.synchronize()
                buf = np.zeros(32, np.int64)
                lib.csdr_agc_prof(buf.ctypes.data, 0)
                same = all(torch.equal(
                    g.reshape(-1).cpu().view(torch.uint8),
                    w.reshape(-1).cpu().to(g.dtype).view(torch.uint8))
                    for g, w in zip(got, want))
                if not same:
                    raise SystemExit(f"agc_phases: {case} differs from "
                                     f"relax_plain")
                rounds = max(int(buf[20]), 1)
                print(json.dumps({
                    "case": case, "cluster": plan, "cta_rank": who,
                    "rounds": int(buf[20]),
                    "cycles_a_round": {n: round(float(buf[i]) / rounds, 1)
                                       for i, n in enumerate(ROUND + STEPS)},
                    "cycles_a_call": {n: int(buf[11 + i])
                                      for i, n in enumerate(CALL)}}),
                    flush=True)
            ms = time_cuda(lambda: agc_cuda.relax(a, **kw), iters=20,
                           queue_ahead_ms=20.0)
            print(json.dumps({"case": case, "ms_with_counters": ms}),
                  flush=True)
    finally:
        _build.lib = real


def main() -> int:
    from csdr_tpu_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "barriers.cu").write_text(BARRIERS)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS[:4], "-o",
                        str(tmp / "barriers"), str(tmp / "barriers.cu")],
                       check=True)
        out = subprocess.run([str(tmp / "barriers")], capture_output=True,
                             text=True, check=True).stdout
        print(out, end="", flush=True)
        phases(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
