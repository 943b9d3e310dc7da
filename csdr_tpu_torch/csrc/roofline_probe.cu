// The FP32 ceiling's probe: y <- fmaf(y, a, b), `chain` times an element.
//
// Replaces no Pallas kernel.  It stands in for the elementwise chain of
// csdr_tpu's measure_vpu_flops (csdr_tpu/utils/roofline.py:89-93, `y = y *
// a + b` unrolled `chain` times), which XLA fuses into one program that
// reads x once and writes y once.  Eager torch would run that chain as
// 2*chain launches, each a full pass over device memory, and so measure
// the memory, not the FP32 units; this kernel is that fused program.
//
// What bounds it: the FP32 units by design.  2*chain flops an element
// against 8 bytes (x read, y written): at the default chain of 2048 that
// is 512 flops a byte, far above the H100's ~20 (67 TFLOP/s over 3.35
// TB/s).  csdr_tpu's own default (chain=64) gives 16 flops a byte, under
// that ridge: on this card it would measure the memory.
//
// Design.  One fmaf a link, a and b kernel arguments, so nothing folds
// and no two links fuse.  An FFMA's result is ready ~4 cycles after it
// issues, so a single chain a thread would measure that latency: each
// thread carries kChains independent chains (elements t, t + threads,
// ..., coalesced across the warp), and the link loop is unrolled 16 deep
// so the loop's own counter and branch take ~1 % of the issue slots.
// Every output is one fmaf chain in order, so the kernel equals its
// plain version (kernels/probe_cuda.fma_chain_plain, the same chain
// through core/precision.fma_f32) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;        // independent chains a thread
constexpr int kThreads = 256;     // threads a block
constexpr int kUnroll = 16;       // links a loop trip

__global__ void __launch_bounds__(kThreads)
fma_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                 long long n, long long threads, int chain, float a,
                 float b) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= threads) return;
  float v[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    const long long i = t + j * threads;
    v[j] = i < n ? x[i] : 0.0f;
  }
  int c = 0;
  for (; c + kUnroll <= chain; c += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) v[j] = fmaf(v[j], a, b);
    }
  }
  for (; c < chain; ++c) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) v[j] = fmaf(v[j], a, b);
  }
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    const long long i = t + j * threads;
    if (i < n) y[i] = v[j];
  }
}

}  // namespace

extern "C" {

// y[i] = the chain of `chain` fmaf(., a, b) links from x[i], for n float32
// elements (x and y contiguous, may not alias).  Returns a cudaError_t.
int csdr_fma_chain(const void* x, void* y, long long n, int chain, float a,
                   float b, void* stream) {
  if (n < 0 || chain < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (x == nullptr || y == nullptr) return (int)cudaErrorInvalidValue;
  const long long threads = (n + kChains - 1) / kChains;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fma_chain_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, n, threads, chain, a, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
