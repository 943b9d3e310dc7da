// Direct polyphase decimating FIR in f32 FMA: the exact-f32 form.
//
// Replaces the TPU kernel _fir_poly_kernel in
// csdr_tpu/kernels/fir_pallas.py (its wrappers there are
// _fir_decimate_pallas and fir_decimate_pallas_or_fallback).
//
// Computes, over a tail-extended complex stream xcat of len samples and real
// taps h[0..T), with M = ceil(T/D) and the tap matrix H[m][p] = h[m*D + p]
// (zero past T):
//   acc[p][k] = sum_{m<M} X[p][k+m] * H[m][p],   X[p][q] = xcat[q*D + p]
//   y[k]      = sum_{p<D} acc[p][k],             k < kout
// that is y[k] = sum_t xcat[k*D + t] * h[t], summed per phase over m first,
// then across the D phases in order p = 0, 1, ..., D-1.
//
// Layout: one block owns tk consecutive outputs (tk from the wrapper, sized
// to the shared memory the shape needs).  It stages its contiguous input
// window xcat[k0*D, (k0 + tk + Mp)*D) with coalesced loads, zero past len:
// the polyphase view X[p][q] is then win[(q - k0)*D + p], so the stride-D
// reads hit shared memory rather than device memory, and the window's last
// Mp columns take the place of the TPU kernel's separate halo input.  The
// taps, zero-padded to Mp = round_up(M, kR) rows, sit beside it as the
// (Mp, D) matrix.  A work item is (phase p, kR consecutive outputs): its
// thread keeps kR complex accumulators and a ring of the kR window samples
// they need next in registers, so each step m reads one sample and one tap
// from shared memory for kR complex FMA.  The per-phase sums go to shared
// memory as part[p][k]; after a barrier one thread per output adds them over
// p in order and writes complex64.  Every m >= 1 and any kout run here: the
// last tile is masked, and there is no halo or pad-to-tile on the host.
//
// Bound: at the BASELINE shape (D=10, T=1023) a launch does 4*T FP32
// operations per output against ~8*D bytes in and 8 out, so FP32 FMA bounds
// it; at the D=50 receiver front ends (T=81, T=801) device-memory bytes do.
// The register block over outputs keeps shared-memory reads to 1/kR of the
// FMAs; tensor cores and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kR = 8;                      // outputs per work item
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;        // 227 KB opt-in limit on sm_90

long long padded_rows(int T, int D) {
  const long long m = (T + D - 1) / D;
  return (m + kR - 1) / kR * kR;
}

// taps (Mp, D) float + window (tk + Mp, D) float2 + partial sums (D, tk + 1)
// float2; Mp is a multiple of 8, so the float2 arrays stay 8-byte aligned.
size_t smem_bytes(int T, int D, int tk) {
  const long long mp = padded_rows(T, D);
  return (size_t)(mp * D) * sizeof(float) +
         (size_t)((tk + mp) * D) * sizeof(float2) +
         (size_t)((long long)D * (tk + 1)) * sizeof(float2);
}

__global__ void __launch_bounds__(kThreads)
fir_poly_kernel(const float2* __restrict__ xcat, long long len,
                const float* __restrict__ taps, int T, int D, int mp,
                long long kout, int tk, float2* __restrict__ y) {
  extern __shared__ float smem[];
  float* h = smem;                                           // (mp, D)
  float2* win = reinterpret_cast<float2*>(smem + (size_t)mp * D);
  float2* part = win + (size_t)(tk + mp) * D;                // (D, tk + 1)
  const int ps = tk + 1;          // row stride of part: spreads the banks

  const long long k0 = (long long)blockIdx.x * tk;
  const long long s0 = k0 * D;
  for (int i = threadIdx.x; i < mp * D; i += blockDim.x)
    h[i] = i < T ? taps[i] : 0.f;
  const int wlen = (tk + mp) * D;
  for (int i = threadIdx.x; i < wlen; i += blockDim.x) {
    const long long s = s0 + i;
    win[i] = s < len ? xcat[s] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  const int items = D * (tk / kR);
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int p = item % D;
    const int kb = (item / D) * kR;
    const float2* wp = win + (size_t)kb * D + p;   // X[p][k0+kb+q] = wp[q*D]
    const float* hp = h + p;                       // H[m][p] = hp[m*D]
    float2 ring[kR], acc[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      ring[r] = wp[r * D];
      acc[r] = make_float2(0.f, 0.f);
    }
    // before step m, ring slot q % kR holds column kb + q, q in [m, m+kR)
    for (int m0 = 0; m0 < mp; m0 += kR) {
#pragma unroll
      for (int mm = 0; mm < kR; ++mm) {
        const float hm = hp[(m0 + mm) * D];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float2 v = ring[(mm + r) % kR];
          acc[r].x = fmaf(v.x, hm, acc[r].x);
          acc[r].y = fmaf(v.y, hm, acc[r].y);
        }
        ring[mm] = wp[(m0 + mm + kR) * D];   // column < tk + mp
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) part[p * ps + kb + r] = acc[r];
  }
  __syncthreads();

  const long long rem = kout - k0;
  const int kcount = rem < tk ? (int)rem : tk;
  for (int j = threadIdx.x; j < kcount; j += blockDim.x) {
    float2 s = part[j];
    for (int p = 1; p < D; ++p) {
      const float2 v = part[p * ps + j];
      s.x += v.x;
      s.y += v.y;
    }
    y[k0 + j] = s;
  }
}

}  // namespace

extern "C" {

// y[k] = sum_t xcat[k*D + t] * taps[t], k < kout, summed per phase over m
// and then over the phases; tk outputs per block.  Returns a cudaError_t.
int csdr_fir_poly(const void* xcat, long long len, const void* taps, int T,
                  int D, long long kout, int tk, void* y, void* stream) {
  if (T < 1 || D < 1 || len < 0 || kout < 0 || tk < kR || tk % kR)
    return (int)cudaErrorInvalidValue;
  if (kout == 0) return 0;
  if ((kout - 1) * D + T > len) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, D, tk);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fir_poly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (kout + tk - 1) / tk;
  fir_poly_kernel<<<(unsigned)blocks, kThreads, smem,
                    (cudaStream_t)stream>>>(
      (const float2*)xcat, len, (const float*)taps, T, D,
      (int)padded_rows(T, D), kout, tk, (float2*)y);
  return (int)cudaGetLastError();
}

// Shared memory one block of csdr_fir_poly needs (the wrapper sizes tk by
// it), and the outputs per work item.
int csdr_fir_poly_smem_bytes(int T, int D, int tk) {
  return (int)smem_bytes(T, D, tk);
}

int csdr_fir_poly_outputs_per_item(void) { return kR; }

}  // extern "C"
