// fastddc factored-v2 inverse: C channels x B frames in one launch.
//
// Replaces the TPU kernel _inv_kernel in
// csdr_tpu/kernels/fastddc_pallas.py.  Computes, for the raw spectra S
// (B, pre*inv), the per-channel folded taps TQ (C, pre, inv), the shared
// iDFT-and-select matrix W (inv, M), the per-channel output diagonal
// d (C, M) and the per-frame NCO rot (C, B), all complex64:
//   fold:  Z[c,b,m] = sum_{j<pre} S[b, j*inv + m] * TQ[c,j,m]
//   iDFT:  Y[c,b,o] = sum_{m<inv} Z[c,b,m] * W[m,o]
//   out[c,b,o] = (Y[c,b,o] * d[c,o]) * rot[c,b]          o < m_out
// (the same linear map as fastddc.c:106-166 per channel; csdr_tpu applies
// rot to Z before the product, which is equal up to f32 rounding: the
// order here is that of the plain version, fastddc_inv_plain).
//
// Design.  The TPU kernel keeps a 128-frame x 8-channel x inv Z slab in
// VMEM (1 MB at inv=128); a Hopper block has 227 KB, so Z is never held
// whole.  A block owns kCB=8 channels x kBT=8 frames (64 rows of Z) and
// kOT=64 output columns, and walks the inv axis in chunks of kKC=32 bins:
//   1. fold: each thread owns one (frame, bin) of the chunk, reads that
//      frame's pre spectrum values once and folds them against the 8
//      channels' TQ rows, leaving a 64 x 32 tile of Z in shared memory;
//   2. the chunk of W (32 x 64) is staged in shared memory beside it;
//   3. each thread accumulates a 4 x 4 register tile of Y over the chunk
//      (8 shared-memory loads feed 64 FMA).
// After the last chunk the epilogue applies d and rot and stores (C, B,
// m_out) with consecutive threads on consecutive columns.  Z never goes to
// device memory.  Shared memory is 33 KB whatever the plan, so every plan
// shape (pre=2 at D=4, inv=16 at D=256, M=224) and any B (ragged frame,
// channel and column tiles are masked) runs through this one kernel.  The
// fold and the product are this kernel's own FMA loops: no library call.
//
// Bound: at the 64-channel D=16 plan (pre=8, inv=128, M=56, B=1024) a
// launch moves ~38 MB (S, TQ, W, d, rot in; out) but does ~4.3 GFLOP of
// FP32 (8*B*C*pre*inv for the fold, 8*B*C*inv*M for the iDFT), so it is
// bound by FP32 operations outside the tensor cores (~64 us at 67 TFLOP/s,
// against ~11 us for the bytes).  The register tile keeps shared-memory
// traffic below the FMA rate; tensor-core 3xTF32 products are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCB = 8;                     // channels per block
constexpr int kBT = 8;                     // frames per block
constexpr int kRows = kCB * kBT;           // rows (channel, frame) of Z
constexpr int kKC = 32;                    // inverse bins per chunk
constexpr int kOT = 64;                    // output columns per block
static_assert(kBT * kKC == kThreads, "fold: one (frame, bin) per thread");
static_assert(kRows == 4 * 16 && kOT == 4 * 16, "4x4 tiles on 16x16 threads");

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

__global__ void __launch_bounds__(kThreads)
fastddc_inv_kernel(const float2* __restrict__ S, const float2* __restrict__ TQ,
                   const float2* __restrict__ W, const float2* __restrict__ D,
                   const float2* __restrict__ rot, float2* __restrict__ out,
                   long long B, int C, int pre, int inv, int ldw, int ldd,
                   int m_out) {
  __shared__ float2 zs[kRows][kKC + 1];    // +1: no bank conflicts on rows
  __shared__ float2 ws[kKC][kOT];

  const int tid = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * kBT;
  const int c0 = blockIdx.y * kCB;
  const int o0 = blockIdx.z * kOT;
  const long long fft = (long long)pre * inv;

  // fold mapping: frame fb, bin fk of the chunk
  const int fk = tid % kKC;
  const int fb = tid / kKC;
  const long long fbg = b0 + fb;
  // product mapping: rows ty + 16*i, columns tx + 16*jj
  const int tx = tid % 16;
  const int ty = tid / 16;

  float2 acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = make_float2(0.f, 0.f);

  for (int k0 = 0; k0 < inv; k0 += kKC) {
    const int k = k0 + fk;
    float2 z[kCB];
#pragma unroll
    for (int cl = 0; cl < kCB; ++cl) z[cl] = make_float2(0.f, 0.f);
    if (k < inv && fbg < B) {
      const float2* srow = S + fbg * fft + k;
      for (int j = 0; j < pre; ++j) {
        const float2 sv = __ldg(srow + (long long)j * inv);
#pragma unroll
        for (int cl = 0; cl < kCB; ++cl) {
          // channels past C fold channel C-1 again; never stored
          const int c = min(c0 + cl, C - 1);
          cmac(z[cl], sv, __ldg(TQ + ((long long)c * pre + j) * inv + k));
        }
      }
    }
#pragma unroll
    for (int cl = 0; cl < kCB; ++cl) zs[cl * kBT + fb][fk] = z[cl];
    for (int e = tid; e < kKC * kOT; e += kThreads) {
      const int kg = k0 + e / kOT;
      const int og = o0 + e % kOT;
      ws[e / kOT][e % kOT] = (kg < inv && og < m_out)
                                 ? __ldg(W + (long long)kg * ldw + og)
                                 : make_float2(0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      float2 zr[4], wc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) zr[i] = zs[ty + 16 * i][kk];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) wc[jj] = ws[kk][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) cmac(acc[i][jj], zr[i], wc[jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int c = c0 + r / kBT;
    const long long b = b0 + r % kBT;
    if (c >= C || b >= B) continue;
    const float2 rc = rot[(long long)c * B + b];
    float2* orow = out + ((long long)c * B + b) * m_out;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int o = o0 + tx + 16 * jj;
      if (o < m_out)
        orow[o] = cmul(cmul(acc[i][jj], D[(long long)c * ldd + o]), rc);
    }
  }
}

}  // namespace

extern "C" {

// out (C, B, m_out) from S (B, pre*inv), TQ (C, pre, inv), W (inv, ldw),
// D (C, ldd), rot (C, B); all complex64, contiguous.  Returns a
// cudaError_t.
int csdr_fastddc_inv(const void* S, const void* TQ, const void* W,
                     const void* D, const void* rot, void* out, long long B,
                     int C, int pre, int inv, int ldw, int ldd, int m_out,
                     void* stream) {
  if (B < 0 || C < 1 || pre < 1 || inv < 1 || m_out < 1 || m_out > ldw ||
      m_out > ldd)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const long long gx = (B + kBT - 1) / kBT;
  if (gx > 0x7fffffffLL || (C + kCB - 1) / kCB > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (unsigned)((C + kCB - 1) / kCB),
            (unsigned)((m_out + kOT - 1) / kOT));
  fastddc_inv_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)S, (const float2*)TQ, (const float2*)W, (const float2*)D,
      (const float2*)rot, (float2*)out, B, C, pre, inv, ldw, ldd, m_out);
  return (int)cudaGetLastError();
}

int csdr_fastddc_inv_smem_bytes(void) {
  return (int)((kRows * (kKC + 1) + kKC * kOT) * sizeof(float2));
}

}  // extern "C"
