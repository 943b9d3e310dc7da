// Batched power-of-two DFT in "kernel bin order", forward and inverse.
//
// Replaces the TPU kernels in csdr_tpu/kernels/fft_pallas.py:
//   _fft_fwd_kernel (INV = false) and _fft_inv_kernel (INV = true),
// which share one pallas_call there as they share this template here.
//
// Contract (the TPU kernels' own, so that their consumers port unchanged):
// frames are (B, N) complex64, N a power of two in 128..16384, any B.
//   forward:  y[128*j + u] = X[T*u + bitrev_T(j)],  T = N/128,
//             X[k] = sum_n x[n] exp(-2*pi*i*k*n/N)            (FFTW sign)
//   inverse:  takes kernel order, returns natural order,
//             y[n] = sum_k X[k] exp(+2*pi*i*k*n/N)            (unnormalized)
// fastddc folds the bin order into its class matrices and fftfilt into
// its taps spectrum, so fwd -> pointwise -> inv never reorders.
//
// Design: one block owns max(1, 1024/N) frames, staged in shared memory
// (a 16384-point frame is 128 KB, above 48 KB through the opt-in
// attribute).  The forward runs log2(N) radix-2 decimation-in-frequency
// stages in place on the natural-order frame, which leaves bin
// bitrev_N(q) at position q.  Kernel order is that bit-reversed order with
// the low 7 position bits reversed once more:
//   kernel position 128*j + u  <->  DIF position 128*j + bitrev_7(u),
// so the store reads shared memory through bitrev_7 and writes device
// memory contiguously.  The inverse is the mirror image: the load scatters
// through the same map into bit-reversed order, and log2(N)
// decimation-in-time stages bring the frame to natural order.  The stage
// twiddles exp(-2*pi*i*k/N), k < N/2, are computed once per block with
// sincospif into shared memory (exact f32 arguments k/N).  All arithmetic
// is f32: csdr_tpu's "HIGH" (bf16x3 matmuls) and "HIGHEST" both run here
// as f32, at least as accurate as either.
//
// Bound: a launch reads and writes each complex sample once, 16 B per
// point, against ~5*log2(N) FP32 operations per point, so at the shapes
// the port runs (N=256 and N=1024) it is bound by device-memory bytes.
// The design touches device memory exactly once per sample each way, with
// contiguous loads and stores; the stages run out of shared memory and
// are latency-bound by one __syncthreads per stage (radix-4/8 stages in
// registers are later work).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinElems = 1024;            // points per block at small N
constexpr size_t kMaxSmem = 232448;        // 227 KB opt-in limit on sm_90

int frames_per_block(int n) { return n >= kMinElems ? 1 : kMinElems / n; }

size_t smem_bytes(int n) {
  return ((size_t)frames_per_block(n) * n + (size_t)(n / 2)) * sizeof(float2);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// DIF position of the point that kernel order keeps at p (and back:
// the map is its own inverse)
__device__ __forceinline__ int ko_swap(int p) {
  return (p & ~127) | (int)(__brev((unsigned)(p & 127)) >> 25);
}

template <bool INV>
__global__ void __launch_bounds__(kThreads)
fft_ko_kernel(const float2* __restrict__ x, float2* __restrict__ y,
              int log2n, long long batch, int fpb) {
  extern __shared__ float2 sm[];
  const int n = 1 << log2n;
  const int half = n >> 1;
  const int total = fpb << log2n;
  float2* s = sm;                          // fpb frames
  float2* tw = sm + total;                 // exp(-2*pi*i*k/n), k < n/2

  const long long f0 = (long long)blockIdx.x * fpb;
  const long long left = batch - f0;
  const int nf = left < fpb ? (int)left : fpb;
  const float2* xb = x + (f0 << log2n);
  float2* yb = y + (f0 << log2n);

  for (int k = threadIdx.x; k < half; k += kThreads) {
    float sn, cs;
    sincospif(-2.0f * (float)k / (float)n, &sn, &cs);
    tw[k] = make_float2(cs, sn);
  }
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const float2 v = (e >> log2n) < nf ? xb[e] : make_float2(0.f, 0.f);
    s[INV ? ko_swap(e) : e] = v;   // ko_swap keeps the frame bits
  }
  __syncthreads();

  const int nbf = fpb * half;              // butterflies per stage
  for (int st = 0; st < log2n; ++st) {
    // DIF: spans n, n/2, .., 2; DIT: spans 2, 4, .., n
    const int lspan = INV ? st + 1 : log2n - st;
    const int lh = lspan - 1;
    const int h = 1 << lh;
    const int tshift = log2n - lspan;      // twiddle stride n/span
    for (int t = threadIdx.x; t < nbf; t += kThreads) {
      const int f = t >> (log2n - 1);
      const int tt = t & (half - 1);
      const int i = tt & (h - 1);
      const int a = (f << log2n) + ((tt >> lh) << lspan) + i;
      const int b = a + h;
      float2 w = tw[i << tshift];
      const float2 u = s[a];
      if (INV) {
        w.y = -w.y;
        const float2 v = cmul(s[b], w);
        s[a] = make_float2(u.x + v.x, u.y + v.y);
        s[b] = make_float2(u.x - v.x, u.y - v.y);
      } else {
        const float2 v = s[b];
        s[a] = make_float2(u.x + v.x, u.y + v.y);
        s[b] = cmul(make_float2(u.x - v.x, u.y - v.y), w);
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < total; e += kThreads) {
    if ((e >> log2n) < nf) yb[e] = s[INV ? e : ko_swap(e)];
  }
}

template <bool INV>
int launch(const void* x, void* y, int n, long long batch, void* stream) {
  if (n < 128 || n > 16384 || (n & (n - 1)) || batch < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  if (x == y) return (int)cudaErrorInvalidValue;   // out of place only
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  const int fpb = frames_per_block(n);
  const size_t smem = smem_bytes(n);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fft_ko_kernel<INV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (batch + fpb - 1) / fpb;
  fft_ko_kernel<INV><<<(unsigned)blocks, kThreads, smem,
                       (cudaStream_t)stream>>>(
      (const float2*)x, (float2*)y, log2n, batch, fpb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward DFT of `batch` contiguous frames of n points, output in kernel
// bin order.  Returns a cudaError_t.
int csdr_fft_ko(const void* x, void* y, int n, long long batch,
                void* stream) {
  return launch<false>(x, y, n, batch, stream);
}

// Inverse DFT (unnormalized) of kernel-order frames, natural-order output.
int csdr_ifft_ko(const void* x, void* y, int n, long long batch,
                 void* stream) {
  return launch<true>(x, y, n, batch, stream);
}

}  // extern "C"
