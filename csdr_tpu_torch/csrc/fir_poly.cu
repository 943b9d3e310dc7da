// Direct polyphase decimating FIR in f32 FMA: the exact-f32 form.
//
// Replaces the TPU kernel _fir_poly_kernel in
// csdr_tpu/kernels/fir_pallas.py (its wrappers there are
// _fir_decimate_pallas and fir_decimate_pallas_or_fallback).
//
// Computes, over a tail-extended complex stream xcat of len samples and real
// taps h[0..T), with M = ceil(T/D) and the tap matrix H[m][p] = h[m*D + p]
// (zero past T, in the last row only):
//   acc[p][k] = sum_{m<M} X[p][k+m] * H[m][p],   X[p][q] = xcat[q*D + p]
//   y[k]      = sum_{p<D} acc[p][k],             k < kout
// acc[p][k] is one fmaf chain from +0 over m = 0, 1, .., M-1 (real and
// imaginary part each), and y[k] adds the D chains in the order p = 0, 1,
// .., D-1 in plain f32 adds.  Exactly M tap rows: no output forms a product
// with a window column beyond k + M - 1, as in csdr_tpu's kernel, whose
// halo is M - 1 columns.
//
// What bounds it on an H100.  At the BASELINE shape (D=10, T=1023) a launch
// does 4T FP32 operations an output against ~8D bytes in and 8 out, so FP32
// FMA bounds it (14.7 us at path P); at m = 1 and at the D=50 receiver
// front ends device-memory bytes do (5.9-6.3 us).  The kernel this replaced
// padded the tap rows to a multiple of 8 (8 rows for 1 at m = 1, and zero
// taps times samples no output needs), staged its window one load at a
// time, read it with bank conflicts at D=10 and kept per-phase sums in a
// second array behind a second barrier.
//
// Design.  A block owns tile = NT*R consecutive outputs: NT threads, each
// with R consecutive outputs, summing G phases at once (R, G and NT from
// the host planner, fir_cuda.poly_plan, for the shape).  The block stages
//  - its input window phase-major with cp.async, every copy of a thread in
//    flight at once: X[p][c] = xcat[s0 + c*D + p] for the D phases p and
//    tile + M - 1 columns c, zero past len (the test for len is made once
//    a block, not once a sample).  Column c of a row goes to sub-row c % R,
//    position c / R, so a warp's 32 lanes read 32 consecutive words at
//    every step and every D; the row stride is odd, so the transposing
//    stores spread over the banks;
//  - its taps as exactly M rows, H[m][p] at row m, column p (the row
//    stride D rounded up to 4 where G = 4, so the taps of 4 phases at one
//    row are one aligned float4 broadcast), in front of the window; the
//    table is rounded up to 4 floats, so the window is 16-byte aligned at
//    every D and M (its 8-byte copies, stores and loads need that).
// Thread i runs the phases in order, G at a time side by side (so G times
// the loads are in flight).  In phase p it walks the columns c = 0 .. M +
// R - 2 of its outputs: column i*R + c is read once and serves output r at
// tap row m = c - r, for the r with 0 <= m < M (the first block of R
// columns is guarded at compile time, the last ones at run time; no
// product with a row outside [0, M) is formed).  For each output the rows
// come in the order m = 0, 1, .., M-1, so its chain is the contract's.
// The taps sit in a register window of the last 2R rows, so a column costs
// a lane one 8-byte window load and a share of a tap broadcast for 2R FMA.
// After a phase the thread adds its chains to running sums that start at
// -0.0f: -0 + a = a for every a, so the sums are the in-order phase sums of
// the contract, bit for bit, with no per-phase array in shared memory and
// no second barrier.  On finite inputs every output is bit for bit that of
// the kernel this replaced.  The last tile is masked; every m >= 1 and any
// kout run here.
//
// What is left (PERF.md, tools/k5_phases.py): all blocks of a launch fit
// in one wave, so they copy and then sum together and the two do not
// overlap; at D=50 a thread's outputs hold 400 B of window each, so only R
// = 1 leaves enough warps, and the sum is held by shared-memory wavefronts;
// at T=1023 by FMA issue on the busiest warp scheduler.

#include <cuda_runtime.h>

namespace {

constexpr size_t kMaxSmem = 232448;        // 227 KB opt-in limit on sm_90
constexpr int kMaxThreads = 512;

struct Layout {
  long long M, DP, H;       // tap rows, their stride, the table's floats
  long long L, RS;          // the window's sub-row and row stride
  size_t bytes;
};

Layout layout(long long T, long long D, long long tile, long long R,
              long long G) {
  Layout g;
  g.M = (T + D - 1) / D;
  g.DP = G == 4 ? (D + 3) & ~3LL : D;   // G = 4: a row's 4 taps aligned
  g.L = (tile + g.M - 1 + R - 1) / R;
  g.RS = (R * g.L) | 1;
  g.H = (g.M * g.DP + 3) & ~3LL;        // the window 16-byte aligned
  g.bytes = (size_t)g.H * sizeof(float) +
            (size_t)(D * g.RS) * sizeof(float2);
  return g;
}

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(d), "l"(src) : "memory");
}

// Columns c0 .. c0+R-1 (c0 a multiple of R) of G phases: wp[g] points at
// column c0 of the thread in phase g (sub-row 0), hc at the taps of row c0
// of the first phase.  tp[g] holds the taps of rows c0-R .. c0-1 in
// tp[g][0..R) and takes rows c0 .. c0+R-1 into tp[g][R..2R); output r at
// column c0+cc takes row m = c0+cc-r, tp[g][R+cc-r].  EDGE says which
// products exist: kAll (every row in [0, M)), kFirst (the first block
// where M >= R: m >= 0 is cc >= r, known at compile time) or kTail
// (0 <= m < M tested at run time).  The loads are not guarded: past the
// last column or row they read other words of the window or tap table,
// which no product uses.
enum Edge { kAll, kFirst, kTail };

template <int R, int G, Edge EDGE>
__device__ __forceinline__ void columns(float (&ar)[G][R], float (&ai)[G][R],
                                        float (&tp)[G][2 * R],
                                        const float2* const (&wp)[G],
                                        const float* hc, int DP, int L,
                                        int c0, int M) {
  // G = 4 (R = 1): the taps of the 4 phases at a row as one float4
  // broadcast, which costs less than 4 scalar ones; below, one scalar
  // broadcast a phase, each beside its window load
  float4 h4[R];
  if constexpr (G == 4) {
#pragma unroll
    for (int cc = 0; cc < R; ++cc)
      h4[cc] = *reinterpret_cast<const float4*>(hc + cc * DP);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float2 v[R];
#pragma unroll
    for (int cc = 0; cc < R; ++cc) {
      v[cc] = wp[g][c0 / R + cc * L];
      if constexpr (G == 4)
        tp[g][R + cc] = g == 0 ? h4[cc].x : g == 1 ? h4[cc].y
                      : g == 2 ? h4[cc].z : h4[cc].w;
      else
        tp[g][R + cc] = hc[cc * DP + g];
    }
#pragma unroll
    for (int cc = 0; cc < R; ++cc) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (EDGE == kAll || (EDGE == kFirst && cc >= r) ||
            (EDGE == kTail && (unsigned)(c0 + cc - r) < (unsigned)M)) {
          const float t = tp[g][R + cc - r];
          ar[g][r] = fmaf(v[cc].x, t, ar[g][r]);
          ai[g][r] = fmaf(v[cc].y, t, ai[g][r]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) tp[g][j] = tp[g][R + j];
  }
}

template <int R, int G>
__global__ void __launch_bounds__(kMaxThreads)
fir_poly_kernel(const float2* __restrict__ xcat, long long len,
                const float* __restrict__ taps, int T, int D,
                long long kout, float2* __restrict__ y, int M, int DP,
                int L, int RS) {
  extern __shared__ float4 smem4[];
  float* ht = reinterpret_cast<float*>(smem4);     // (M, DP) taps
  float2* w = reinterpret_cast<float2*>(ht + ((M * DP + 3) & ~3));

  const int nt = blockDim.x, tid = threadIdx.x;
  const int tile = nt * R;
  const long long k0 = (long long)blockIdx.x * tile;
  const long long s0 = k0 * D;
  const int win = (tile + M - 1) * D;

  // the window: sample i = c*D + p of the tile goes to row p, sub-row
  // c % R, position c / R; zero past len.  Every tile whose window lies in
  // the stream (all but the last, mostly) copies with no test a sample.
  {
    const float2* const xw = xcat + s0;
    const unsigned dc = nt / D, dp = nt - (nt / D) * D;
    unsigned c = tid / D, p = tid - (tid / D) * D;
    if (s0 + win <= len) {
      for (int i = tid; i < win; i += nt) {
        cp_async8(w + p * RS + (c % R) * L + c / R, xw + i);
        c += dc; p += dp;
        if (p >= D) { p -= D; ++c; }
      }
    } else {
      const long long have = len - s0;
      for (int i = tid; i < win; i += nt) {
        float2* dst = w + p * RS + (c % R) * L + c / R;
        if (i < have) cp_async8(dst, xw + i);
        else *dst = make_float2(0.f, 0.f);
        c += dc; p += dp;
        if (p >= D) { p -= D; ++c; }
      }
    }
  }
  // the taps: H[m][p] = h[m*D + p] at ht[m*DP + p], 0 past T and past D
  for (int i = tid; i < M * DP; i += nt) {
    const int m = i / DP, p = i - (i / DP) * DP;
    const int t = m * D + p;
    ht[i] = p < D && t < T ? taps[t] : 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // running phase sums from -0.0f: -0 + a = a, so after phase 0 they hold
  // acc[0] exactly, then acc[0] + acc[1], ... in order
  float sr[R], si[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sr[r] = si[r] = -0.f;
  // G phases at a time, their chains side by side so that the loads of
  // all of them are in flight at once; added to the sums in phase order
  const int cols = M + R - 1;
  for (int p0 = 0; p0 < D; p0 += G) {
    const float2* wp[G];
    float ar[G][R], ai[G][R], tp[G][2 * R];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int p = min(p0 + g, D - 1);    // a phase past D is not added
      wp[g] = w + p * RS + tid;            // column tid*R, sub-row 0
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ar[g][r] = ai[g][r] = 0.f;
        tp[g][r] = tp[g][R + r] = 0.f;
      }
    }
    const float* hp = ht + p0;             // row 0 of phase p0
    int c0 = 0;
    if (M >= R) {
      columns<R, G, kFirst>(ar, ai, tp, wp, hp, DP, L, 0, M);
      c0 = R;
    }
    for (; c0 < cols; c0 += R) {
      if (c0 + R <= M)
        columns<R, G, kAll>(ar, ai, tp, wp, hp + c0 * DP, DP, L, c0, M);
      else
        columns<R, G, kTail>(ar, ai, tp, wp, hp + c0 * DP, DP, L, c0, M);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (p0 + g < D) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          sr[r] += ar[g][r];
          si[r] += ai[g][r];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long k = k0 + (long long)tid * R + r;
    if (k < kout) y[k] = make_float2(sr[r], si[r]);
  }
}

template <int R, int G>
int launch_rg(const void* xcat, long long len, const void* taps, int T,
              int D, long long kout, int tile, const Layout& g, void* y,
              cudaStream_t stream) {
  auto kern = fir_poly_kernel<R, G>;
  if (g.bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (kout + tile - 1) / tile;
  kern<<<(unsigned)blocks, tile / R, g.bytes, stream>>>(
      (const float2*)xcat, len, (const float*)taps, T, D, kout, (float2*)y,
      (int)g.M, (int)g.DP, (int)g.L, (int)g.RS);
  return (int)cudaGetLastError();
}

bool valid_tile(long long tile, int R, int G) {
  if (R != 1 && R != 4 && R != 8) return false;
  if (R == 1 ? G != 1 && G != 4 : G != 2) return false;
  if (tile < R || tile % R) return false;
  const long long nt = tile / R;
  return nt >= 8 && nt % 8 == 0 && nt <= kMaxThreads;
}

}  // namespace

extern "C" {

// y[k] = sum_t xcat[k*D + t] * taps[t], k < kout, summed per phase over the
// M tap rows and then over the phases; one block for each `tile` outputs,
// `per_thread` (R) consecutive outputs a thread, `groups` (G) phases summed
// at once.  Returns a cudaError_t.
int csdr_fir_poly(const void* xcat, long long len, const void* taps, int T,
                  int D, long long kout, int tile, int per_thread, int groups,
                  void* y, void* stream) {
  if (T < 1 || D < 1 || len < 0 || kout < 0 ||
      !valid_tile(tile, per_thread, groups))
    return (int)cudaErrorInvalidValue;
  if (kout == 0) return 0;
  if ((kout - 1) * D + T > len) return (int)cudaErrorInvalidValue;
  const Layout g = layout(T, D, tile, per_thread, groups);
  if (g.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define CSDR_POLY_CASE(R_, G_)                                            \
  case R_ * 10 + G_:                                                      \
    return launch_rg<R_, G_>(xcat, len, taps, T, D, kout, tile, g, y, s);
  switch (per_thread * 10 + groups) {
    CSDR_POLY_CASE(1, 1) CSDR_POLY_CASE(1, 4) CSDR_POLY_CASE(4, 2)
    CSDR_POLY_CASE(8, 2)
  }
#undef CSDR_POLY_CASE
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block of `tile` outputs, `per_thread` (R) a thread,
// `groups` (G) phases at once, at (T, D); -1 for a launch the kernel does
// not take, and a size above the opt-in limit for a shape it refuses.
int csdr_fir_poly_smem_bytes(int T, int D, int tile, int per_thread,
                             int groups) {
  if (T < 1 || D < 1 || !valid_tile(tile, per_thread, groups)) return -1;
  const size_t b = layout(T, D, tile, per_thread, groups).bytes;
  return b > 0x7fffffff ? 0x7fffffff : (int)b;
}

}  // extern "C"
