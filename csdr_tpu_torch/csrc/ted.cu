// Gardner / early-late timing recovery: the symbol loop, one thread per
// (row, segment) lane, every slot of a chunk in registers, one launch.
//
// Replaces csdr_tpu's lax.scan over symbol slots in csdr_tpu/ops/sync.py
// (the serial scan at :374, the segments' vmapped scan at :397, the step at
// :248-312): no Pallas kernel there.  The loop is the reference's
// timing_recovery_cc (libcsdr.c:1977-2072): a serial, data-dependent
// recurrence, each slot's three picks placed by the bitstart and the
// correction the previous slot's error gave.  As a Python loop of torch ops
// it launched ~43 kernels a slot, 9 929 a chunk of BASELINE config 5.
//
// Contract (kernels/ted_cuda.py, scan_plain is the same loop on tensors):
//   planes  (R, 2*size) float32, interleaved re/im: each row a buffer of
//           `size` complex samples;
//   bs_in, corr_in: int32 per lane, lanes = R*S, lane r*S + s reading row
//           r (S = 1 in the serial mode);
//   span_hi, emit_lo: int32 per lane, or null (the serial mode: no span
//           end, every alive slot emits);
//   per lane and slot k < cap it writes v (3 picks, re/im), the raw error,
//   bitstart at the slot and emit (0/1 bytes); per lane the final bitstart
//   and corr.
// A slot (csdr_tpu's step, the reference :1995-2066):
//   alive &= bitstart + 3*nshb < size && bitstart < span_hi   (sticky)
//   corr = 0 where corr <= -0.9*nsqb or corr >= 0.9*nsqb (compared in
//          float32, as torch and jnp compare an int32 with a float)
//   picks at clamp(bitstart + off_j - (early-late && j == 1 ? corr : 0),
//          0, size - 1), j = 0, 1, 2
//   error = use_q ? fma(d_re, v2_re, d_im * v2_im) / 2 : d_re * v2_re,
//          d = v0 - v1 (XLA contracts csdr_tpu's d_re product into the sum;
//          core/precision.fma_f32 is that fma on tensors)
//   new_corr = trunc((nshb*err_sign) * clamp(error, +-max_error) * gain)
//   emit = alive && bitstart >= emit_lo; where alive, bitstart += nsb +
//          new_corr and corr = new_corr.
// Every float operation is an intrinsic (__fsub_rn, __fmul_rn, __fmaf_rn)
// so that nvcc contracts nothing of its own, and the truncation is
// __float2int_rz (cvt.rzi: saturating, NaN to 0, as torch's cast on the
// card): the outputs are scan_plain's bit for bit.  The clamp keeps a NaN
// (torch.clamp's and jnp.clip's rule).
//
// What bounds it.  Bytes are nothing: a lane reads 3 picks a slot (G: 64
// lanes x 230 slots x 24 B = 353 kB of a 29.9 MB buffer) and writes 33 B a
// slot.  Operations are nothing (~25 a slot).  What is left is the chain:
// slot k+1's picks are addressed by slot k's error, so a lane runs its
// slots in series, each one dependent load and the step's arithmetic from
// the loaded values to the next addresses (~15 dependent operations).  The
// next picks lie within bitstart + 2*nsb + nsqb, so the window can be
// staged ahead off the chain, and the fastest the function's chain can go
// is a shared-memory load and that arithmetic a slot.  The bound is slots
// x that, csdr_ted_chain_probe below, timed in SM cycles on the card; the
// lanes run side by side.
//
// Design: the simplest that is right.  A thread a lane, one lane a block
// (the lanes of one warp would read and write 32 different rows, each
// load or store instruction then 32 L1TEX sectors in series on the chain),
// the picks read from L2 through the read-only path (__ldg), the outputs
// stored beside the chain.  The L2 load is on this design's chain: staging
// the window in shared memory would take it off; it is not done here.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kProbeWindow = 4096;   // complex samples the probe stages

struct TedParams {
  int size;        // complex samples a row
  int cap;         // symbol slots
  int segs;        // S: lanes a row
  int nsb, nshb;   // samples a symbol, half of it
  int off0, off1, off2;   // the picks relative to bitstart
  int early_late;  // the left pick moves by -corr
  int use_q;
  float reset;     // 0.9*nsqb, rounded to float32
  float max_error;
  float gain;      // nshb*err_sign, rounded to float32
  float loop_gain;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// One slot's error from its three picks (right, left, mid), before the
// clamp: the operations csdr_tpu's jitted step rounds, in its order.
__device__ __forceinline__ float slot_error(float2 v0, float2 v1, float2 v2,
                                            int use_q) {
  const float dre = __fsub_rn(v0.x, v1.x);
  if (!use_q) return __fmul_rn(dre, v2.x);
  const float dim = __fsub_rn(v0.y, v1.y);
  return __fmul_rn(__fmaf_rn(dre, v2.x, __fmul_rn(dim, v2.y)), 0.5f);
}

// The correction an error gives: trunc(gain * clamp(error) * loop_gain),
// multiplied left to right.  The clamp is min(max(e, -m), m) with a NaN
// kept: both compares are false on a NaN.
__device__ __forceinline__ int slot_correction(float error,
                                               const TedParams& p) {
  float e = error < -p.max_error ? -p.max_error : error;
  e = e > p.max_error ? p.max_error : e;
  return __float2int_rz(__fmul_rn(__fmul_rn(p.gain, e), p.loop_gain));
}

__device__ __forceinline__ int reset_correction(int corr, float reset) {
  const float fc = __int2float_rn(corr);
  return (fc <= -reset || fc >= reset) ? 0 : corr;
}

__global__ void __launch_bounds__(1)
ted_scan_kernel(const float2* __restrict__ planes,
                const int* __restrict__ bs_in, const int* __restrict__ corr_in,
                const int* __restrict__ span_hi,
                const int* __restrict__ emit_lo, TedParams p,
                int* __restrict__ bs_out, int* __restrict__ corr_out,
                float2* __restrict__ v_out, float* __restrict__ err_out,
                int* __restrict__ start_out, uint8_t* __restrict__ emit_out) {
  const int lane = blockIdx.x;
  const float2* row = planes + (long long)(lane / p.segs) * p.size;
  const int hi = span_hi ? span_hi[lane] : INT_MAX;
  const int lo = emit_lo ? emit_lo[lane] : INT_MIN;
  const int last = p.size - 1;
  int bitstart = bs_in[lane];
  int corr = corr_in[lane];
  bool alive = true;
  const long long base = (long long)lane * p.cap;
  for (int k = 0; k < p.cap; ++k) {
    alive = alive && bitstart + 3 * p.nshb < p.size && bitstart < hi;
    corr = reset_correction(corr, p.reset);
    const int g0 = clampi(bitstart + p.off0, 0, last);
    const int g1 = clampi(bitstart + p.off1 - (p.early_late ? corr : 0), 0,
                          last);
    const int g2 = clampi(bitstart + p.off2, 0, last);
    const float2 v0 = __ldg(row + g0);
    const float2 v1 = __ldg(row + g1);
    const float2 v2 = __ldg(row + g2);
    const float error = slot_error(v0, v1, v2, p.use_q);
    const int new_corr = slot_correction(error, p);
    const long long at = base + k;
    v_out[3 * at] = v0;
    v_out[3 * at + 1] = v1;
    v_out[3 * at + 2] = v2;
    err_out[at] = error;
    start_out[at] = bitstart;
    emit_out[at] = (alive && bitstart >= lo) ? 1 : 0;
    if (alive) {
      bitstart = bitstart + p.nsb + new_corr;
      corr = new_corr;
    }
  }
  bs_out[lane] = bitstart;
  corr_out[lane] = corr;
}

// The probe that sets the kernel's bound: the block stages a window of
// kProbeWindow complex samples of `buf` in shared memory, then one thread
// runs `iters` TED slots twice as the kernel's chain runs them, the picks
// read from that window (the correction's reset, three picks at bitstart +
// offs, the error, its correction and the advance, wrapped back by a select
// before the window's end where the kernel selects on alive; no output is
// stored), and writes the SM cycles of the second pass (clock64) to
// cycles[0].
__global__ void ted_probe_kernel(long long* cycles, const float2* buf,
                                 int* sink, int iters, TedParams p) {
  __shared__ float2 win[kProbeWindow];
  for (int i = threadIdx.x; i < kProbeWindow; i += blockDim.x) win[i] = buf[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int wrap = kProbeWindow - 3 * p.nshb - p.nsb;
  long long t0 = 0;
  int x = 0;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) t0 = clock64();
    int bitstart = 0, corr = 0;
    for (int k = 0; k < iters; ++k) {
      corr = reset_correction(corr, p.reset);
      const float2 v0 = win[bitstart + p.off0];
      const float2 v1 = win[bitstart + p.off1 - (p.early_late ? corr : 0)];
      const float2 v2 = win[bitstart + p.off2];
      corr = slot_correction(slot_error(v0, v1, v2, p.use_q), p);
      bitstart = bitstart + p.nsb + corr;
      bitstart = bitstart >= wrap ? 0 : bitstart;
    }
    x += bitstart + corr;
  }
  cycles[0] = clock64() - t0;
  sink[0] = x;
}

TedParams make_params(int size, int cap, int segs, int nsb,
                      int nshb, int nsqb, int off0, int off1, int off2,
                      int gardner, int use_q, float max_error,
                      float err_sign, float loop_gain) {
  TedParams p;
  p.size = size;
  p.cap = cap;
  p.segs = segs;
  p.nsb = nsb;
  p.nshb = nshb;
  p.off0 = off0;
  p.off1 = off1;
  p.off2 = off2;
  p.early_late = !gardner;
  p.use_q = use_q;
  // as the plain version rounds them: the product in double, then float32
  p.reset = (float)(0.9 * (double)nsqb);
  p.gain = (float)((double)nshb * (double)err_sign);
  p.max_error = max_error;
  p.loop_gain = loop_gain;
  return p;
}

}  // namespace

extern "C" {

// `cap` slots of the symbol loop for lanes = rows*segs lanes over planes
// (rows, 2*size) float32 (8-byte aligned), one lane a block.  bs_in,
// corr_in, span_hi and emit_lo are int32 per lane (span_hi and emit_lo both
// null in the serial mode); v_out (lanes, cap, 3, 2) float32, err_out
// (lanes, cap) float32, start_out (lanes, cap) int32, emit_out (lanes, cap)
// bytes, bs_out and corr_out int32 per lane.  Returns a cudaError_t.
int csdr_ted_scan(const void* planes, int size, const void* bs_in,
                  const void* corr_in, const void* span_hi,
                  const void* emit_lo, int rows, int segs, int cap, int nsb,
                  int nshb, int nsqb, int off0, int off1, int off2,
                  int gardner, int use_q, float max_error, float err_sign,
                  float loop_gain, void* bs_out, void* corr_out, void* v_out,
                  void* err_out, void* start_out, void* emit_out,
                  void* stream) {
  if (planes == nullptr || bs_in == nullptr || corr_in == nullptr ||
      bs_out == nullptr || corr_out == nullptr || v_out == nullptr ||
      err_out == nullptr || start_out == nullptr || emit_out == nullptr ||
      (span_hi == nullptr) != (emit_lo == nullptr) || size < 1 || rows < 0 ||
      segs < 1 || cap < 0 || ((uintptr_t)planes & 7) ||
      (long long)rows * segs > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int lanes = rows * segs;
  if (lanes == 0) return 0;
  const TedParams p = make_params(size, cap, segs, nsb, nshb, nsqb,
                                  off0, off1, off2, gardner, use_q, max_error,
                                  err_sign, loop_gain);
  ted_scan_kernel<<<lanes, 1, 0, (cudaStream_t)stream>>>(
      (const float2*)planes, (const int*)bs_in, (const int*)corr_in,
      (const int*)span_hi, (const int*)emit_lo, p, (int*)bs_out,
      (int*)corr_out, (float2*)v_out, (float*)err_out, (int*)start_out,
      (uint8_t*)emit_out);
  return (int)cudaGetLastError();
}

// Run the latency probe for `iters` TED slots of BASELINE config 5's
// Gardner loop (sps 256, use_q) on one thread, the picks from the first
// kProbeWindow complex float32 samples of `buf` staged in shared memory;
// the SM cycles of the timed pass go to cycles[0] (int64) and the chain's
// end to sink[0] (int32).
int csdr_ted_chain_probe(void* cycles, const void* buf, void* sink,
                         int iters, void* stream) {
  if (cycles == nullptr || buf == nullptr || sink == nullptr || iters < 1)
    return (int)cudaErrorInvalidValue;
  const TedParams p = make_params(kProbeWindow, 0, 1, 256, 128, 64, 384,
                                  128, 256, 1, 1, 2.0f, -1.0f, 0.5f);
  ted_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      (long long*)cycles, (const float2*)buf, (int*)sink, iters, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
