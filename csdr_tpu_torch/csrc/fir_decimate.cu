// Decimating FIR over a carried stream, optionally NCO-mixed on load.
//
// Replaces the TPU kernels in csdr_tpu/kernels/fir_pallas.py:
//   _fir_vmem_shift_kernel (MIX = true: NCO shift fused into the FIR) and
//   _fir_vmem_kernel       (MIX = false: the plain decimating FIR),
// which share _vmem_core there as they share this template here.
//
// Computes, over the virtual stream v = [tail | x] (tail_len + n complex
// samples, indexed s = 0 .. tail_len + n - 1):
//   y[k] = sum_{t < T} m(s) * v[s] * h[t],   s = k*D + t,   k < kout
// with m(s) = exp(j*2*pi*(theta + rate*s)) when MIX, else 1.
//
// The kernel reads the carried tail and the new chunk through two base
// pointers, so one launch gives every output of a chunk: there is no
// concatenation pass over the chunk and no head/body/tail split.
//
// Layout: one block owns kTile consecutive outputs.  It stages the taps and
// its input window ((kTile-1)*D + T samples) in shared memory, mixing each
// sample once as it is loaded; then each thread accumulates one output in
// f32 FMA.  The last tile is masked.  The phase of sample s is frac(rate*s)
// in float64 (good to ~1e-10 cycles at any position in a chunk), plus
// theta, then an f32 sincospi: nothing is accumulated along the stream, so
// there is no drift.
//
// Precision: csdr_tpu's "HIGHEST" and "HIGH" (bf16x3) both run here as f32
// FMA, which is at least as accurate as either.
//
// Bound: at the WFM front end (D=10, T=79) a launch moves ~8 B per input
// sample and does ~2*T/D FMA per sample, far below the card's FP32 rate per
// byte: it is bound by device-memory bytes, and the design reads each input
// sample from device memory about once (neighbouring windows overlap by
// T-D samples).  At long taps (T=1023) it is bound by FP32 FMA and by the
// shared-memory reads that feed them; register blocking over outputs and
// tensor-core products are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;                 // outputs per block, one a thread
constexpr size_t kMaxSmem = 232448;        // 227 KB opt-in limit on sm_90

size_t smem_bytes(int T, int D) {
  return (size_t)((T + 1) & ~1) * sizeof(float) +
         (size_t)((long long)(kTile - 1) * D + T) * sizeof(float2);
}

template <bool MIX>
__global__ void __launch_bounds__(kTile)
fir_decimate_kernel(const float2* __restrict__ tail, long long tail_len,
                    const float2* __restrict__ x, long long n,
                    const float* __restrict__ taps, int T, int D,
                    long long kout, float2* __restrict__ y,
                    double rate, double theta) {
  extern __shared__ float smem[];
  float* h = smem;                                               // T taps
  float2* w = reinterpret_cast<float2*>(smem + ((T + 1) & ~1));  // window

  const long long k0 = (long long)blockIdx.x * kTile;
  const long long rem = kout - k0;
  const int kcount = rem < kTile ? (int)rem : kTile;
  const int win = (kcount - 1) * D + T;
  const long long s0 = k0 * D;

  for (int i = threadIdx.x; i < T; i += blockDim.x) h[i] = taps[i];
  for (int i = threadIdx.x; i < win; i += blockDim.x) {
    const long long s = s0 + i;            // s < tail_len + n (host check)
    float2 v = s < tail_len ? tail[s] : x[s - tail_len];
    if (MIX) {
      double c = rate * (double)s;
      c -= floor(c);
      c += theta;
      c -= floor(c);
      if (c >= 0.5) c -= 1.0;  // [-0.5, 0.5): the f32 argument stays small
      float sn, cs;
      sincospif(2.0f * (float)c, &sn, &cs);
      v = make_float2(v.x * cs - v.y * sn, v.x * sn + v.y * cs);
    }
    w[i] = v;
  }
  __syncthreads();

  const int j = threadIdx.x;
  if (j < kcount) {
    const float2* wp = w + j * D;
    float ar = 0.f, ai = 0.f;
#pragma unroll 4
    for (int t = 0; t < T; ++t) {
      const float2 v = wp[t];
      const float ht = h[t];
      ar = fmaf(v.x, ht, ar);
      ai = fmaf(v.y, ht, ai);
    }
    y[k0 + j] = make_float2(ar, ai);
  }
}

template <bool MIX>
int launch(const void* tail, long long tail_len, const void* x, long long n,
           const void* taps, int T, int D, long long kout, void* y,
           double rate, double theta, void* stream) {
  if (T < 1 || D < 1 || tail_len < 0 || n < 0 || kout < 0)
    return (int)cudaErrorInvalidValue;
  if (kout == 0) return 0;
  if ((kout - 1) * D + T > tail_len + n) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, D);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fir_decimate_kernel<MIX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (kout + kTile - 1) / kTile;
  fir_decimate_kernel<MIX><<<(unsigned)blocks, kTile, smem,
                             (cudaStream_t)stream>>>(
      (const float2*)tail, tail_len, (const float2*)x, n, (const float*)taps,
      T, D, kout, (float2*)y, rate, theta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y[k] = sum_t [tail|x][k*D + t] * taps[t], k < kout.  Returns a cudaError_t.
int csdr_fir_decimate(const void* tail, long long tail_len, const void* x,
                      long long n, const void* taps, int T, int D,
                      long long kout, void* y, void* stream) {
  return launch<false>(tail, tail_len, x, n, taps, T, D, kout, y, 0.0, 0.0,
                       stream);
}

// As csdr_fir_decimate, with [tail|x][s] mixed by exp(j*2*pi*(theta +
// rate*s)) first; rate and theta in cycles.
int csdr_shift_fir_decimate(const void* tail, long long tail_len,
                            const void* x, long long n, const void* taps,
                            int T, int D, long long kout, void* y,
                            double rate, double theta, void* stream) {
  return launch<true>(tail, tail_len, x, n, taps, T, D, kout, y, rate, theta,
                      stream);
}

int csdr_fir_decimate_tile(void) { return kTile; }

const char* csdr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
