// agc_ff's exact per-sample recurrence (any attack wait time): one warp a
// call, one thread carrying the recurrence.
//
// Replaces csdr_tpu's lax.scan in csdr_tpu/ops/agc.py:171 (the function at
// :90-175): no Pallas kernel there.  The port ran it as a numpy float32
// loop on the host, so agc_block(method="scan") and the CLI's agc_ff with
// an attack wait had no path on the card.
//
// Contract (kernels/agc_cuda.py; scan_plain, the host loop, is the same
// recurrence in numpy float32, bit for bit):
//   x (n,) float32, n >= 1; the state in as four one-element tensors on
//   the card (gain float32, hang int32, peak float32, attack-wait count
//   int32), the next state out to four fresh ones; y (n,) float32.
//   `started` (a host flag) = 0 skips sample 0: y[0] = gain*x[0], state
//   unchanged (the reference's output[0] at the stream's start).
// A sample xi (the reference's libcsdr_gpl.c:163-260, csdr_tpu's step):
//   gain' = g
//   if xi != 0 (a NaN passes, +-0 skips):
//     error = ref/|xi| - g
//     if error < 0:  (attack)
//       if peak < |xi|: peak = |xi|, awc = attack_wait
//       if awc > 0: awc -= 1  else: gain' = g + error*attack_rate,
//                                   hang = hang_time
//     elif hang > 0: hang -= 1
//     else: gain' = g + error*decay_rate
//   gain' = min(max(gain', 0), max_gain) as Python evaluates it: max(a, b)
//     keeps a unless b > a, min(a, b) keeps a unless b < a, so a NaN gain
//     passes both and -0.0 stays -0.0 (fmaxf/fminf would not)
//   g = (gain' + g) - alpha*g;  y = g*xi
// Every float operation is an intrinsic (__fdiv_rn, __fmul_rn, __fadd_rn,
// __fsub_rn): numpy's float32 order, each op rounded once, no fma.
//
// What bounds it.  Bytes are nothing (8 B a sample).  The recurrence is a
// chain: each sample's g needs the previous sample's, through the error,
// the rate's product and its sum, the choice between that and the kept
// gain, the clamp and the gain filter's two roundings; ref/|xi| depends
// on xi alone.  The bound is samples x the shortest such chain,
// csdr_agc_ff_chain_probe below (one thread from shared memory, what the
// step decides beside the chain read precomputed, SM cycles a sample),
// at the top SM clock.
//
// Design.  One warp: the 32 lanes load a tile of kTile samples coalesced
// into shared memory (double-buffered, the next tile's loads issued into
// registers before lane 0 runs the current one, so they land while it
// runs) and compute the tile's quotients ref/|xi| (an IEEE division is a
// subroutine of ~20 instructions: off the serial loop); lane 0 runs the
// recurrence branch-free over the tile from shared memory and stores each
// output straight to y (a store waits on nothing; staging the outputs in
// shared memory for a coalesced store by the warp cost more than it
// saved).  The state lives in lane 0's registers throughout; no host sync,
// no scalar upload.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;          // samples a tile: 32 a lane
constexpr int kPer = kTile / 32;
constexpr int kProbeMax = 4096;      // samples the probe stages

struct ExactParams {
  float ref, attack_rate, decay_rate, max_gain, alpha;
  float floor;     // min(0, max_gain) as Python takes it: the clamp's low
  int hang_time, attack_wait;
};

struct ExactState {
  float g, peak;
  int hang, awc;
};

// One sample of the recurrence from xi and q = ref/|xi| (computed beside
// the chain); returns the output sample.  Branch-free: both rates'
// products and every counter update are computed and selected, so one
// thread runs no divergent branch (and no warp-synchronising code) a
// sample.  The attack test is q < g (fl(q - g) < 0 exactly when q < g: a
// difference of floats is zero only when they are equal and keeps its
// sign, subnormals included, and a NaN fails both), so it does not wait
// for the error; the clamp's two compares both read the selected gain.
// On the card this form ran fastest of those tried (PERF.md §6): its g ->
// g chain is the error, a rate's product and sum, the two selects among
// g and the two sums, the clamp's compares and one select, and the
// filter's two adds.
__device__ __forceinline__ float exact_step(ExactState& s, float xi, float q,
                                            const ExactParams& p) {
  const float g = s.g;
  const float ia = fabsf(xi);
  const float error = __fsub_rn(q, g);
  const bool nz = xi != 0.0f;
  const bool attack = nz && q < g;
  const bool decay = nz && !(q < g);
  const bool newpeak = attack && s.peak < ia;
  s.peak = newpeak ? ia : s.peak;
  const int awc = newpeak ? p.attack_wait : s.awc;
  const bool waiting = awc > 0;
  const bool hanging = s.hang > 0;
  const float up = __fadd_rn(g, __fmul_rn(error, p.attack_rate));
  const float down = __fadd_rn(g, __fmul_rn(error, p.decay_rate));
  float gain = attack ? (waiting ? g : up) : (decay && !hanging ? down : g);
  s.awc = attack ? (waiting ? awc - 1 : awc) : s.awc;
  s.hang = attack ? (waiting ? s.hang : p.hang_time)
                  : (decay && hanging ? s.hang - 1 : s.hang);
  // min(max(gain, 0), max_gain) as Python evaluates it: 0 > gain gives
  // floor = min(0, max_gain), else max_gain < gain gives max_gain, else
  // gain (a NaN and -0.0 kept)
  const bool low = 0.0f > gain;
  const bool high = p.max_gain < gain;
  gain = high ? p.max_gain : gain;
  gain = low ? p.floor : gain;
  s.g = __fsub_rn(__fadd_rn(gain, g), __fmul_rn(p.alpha, g));
  return __fmul_rn(s.g, xi);
}

// What the step decides from g and the state before the sample, beside
// its chain: the rate its sum takes, and whether the gain moves (else g
// is kept).  The probe records these to run the chain without them.
__device__ __forceinline__ void step_choice(const ExactState& s, float xi,
                                            float q, const ExactParams& p,
                                            float* rate, bool* moves) {
  const bool nz = xi != 0.0f;
  const bool attack = nz && q < s.g;
  const int awc = s.peak < fabsf(xi) ? p.attack_wait : s.awc;
  *rate = attack ? p.attack_rate : p.decay_rate;
  *moves = attack ? !(awc > 0) : nz && !(s.hang > 0);
}

__global__ void __launch_bounds__(32, 1)
agc_exact_kernel(const float* __restrict__ x, long long n, int started,
                 ExactParams p, const float* __restrict__ g_in,
                 const int* __restrict__ h_in,
                 const float* __restrict__ p_in,
                 const int* __restrict__ a_in, float* __restrict__ y,
                 float* __restrict__ g_out, int* __restrict__ h_out,
                 float* __restrict__ p_out, int* __restrict__ a_out) {
  __shared__ float xs[2][kTile];
  __shared__ float qs[kTile];
  const int lane = threadIdx.x;
  ExactState s = {0.0f, 0.0f, 0, 0};
  if (lane == 0) {
    s.g = g_in[0];
    s.hang = h_in[0];
    s.peak = p_in[0];
    s.awc = a_in[0];
  }
  const long long tiles = (n + kTile - 1) / kTile;
  float next[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long i = (long long)j * 32 + lane;
    xs[0][j * 32 + lane] = i < n ? x[i] : 0.0f;
  }
  for (long long t = 0; t < tiles; ++t) {
    const long long base = t * kTile;
    const int len = (int)(n - base < kTile ? n - base : kTile);
    const int b = (int)(t & 1);
    if (t + 1 < tiles) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const long long i = base + kTile + (long long)j * 32 + lane;
        next[j] = i < n ? x[i] : 0.0f;
      }
    }
    // the quotients off the chain: every lane its own samples
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = j * 32 + lane;
      qs[k] = __fdiv_rn(p.ref, fabsf(xs[b][k]));
    }
    __syncwarp();
    if (lane == 0) {
      int k = 0;
      float* yt = y + base;
      if (t == 0 && !started) {    // the stream's first sample: skipped
        yt[0] = __fmul_rn(s.g, xs[b][0]);
        k = 1;
      }
#pragma unroll 4
      for (; k < len; ++k) yt[k] = exact_step(s, xs[b][k], qs[k], p);
    }
    __syncwarp();
    if (t + 1 < tiles) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) xs[b ^ 1][j * 32 + lane] = next[j];
    }
  }
  if (lane == 0) {
    g_out[0] = s.g;
    h_out[0] = s.hang;
    p_out[0] = s.peak;
    a_out[0] = s.awc;
  }
}

// The probe that sets the kernel's bound: the function's shortest g -> g
// chain, on one thread from shared memory.  Whatever implements agc_ff
// rounds, in series, a sample's error q - g, its product with the rate
// and the sum with g (numpy rounds each: no fma), the choice between that
// and the kept gain, the clamp (Python's min/max keep a NaN and -0.0, so
// a compare and a select, not fmaxf/fminf) and the gain filter's two
// adds, (gain + g) - alpha*g.  Everything else the step derives from g
// (the attack test, the counters, so the rate and whether the gain
// moves) is read here from shared memory, and the kept gain's clamp and
// the moved one's compares are laid beside the choice, so the chain
// holds only what no implementation can take off it.  The block stages
// the quotients ref/|x| of the n samples of `x`; one thread runs the
// kernel's exact_step over them from the given state, recording each
// sample's rate and choice; then runs the chain twice from the same gain,
// the second pass timed (clock64) into cycles[0].  sink[0] = the chain's
// last gain, sink[1] = 1 if it equals exact_step's bit for bit (the chain
// is the function, given the choices), else 0.
__global__ void agc_exact_probe_kernel(long long* cycles, const float* x,
                                       int n, ExactParams p, ExactState s0,
                                       float* sink) {
  __shared__ float quo[kProbeMax];
  __shared__ float rates[kProbeMax];
  __shared__ bool moves[kProbeMax];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    quo[i] = __fdiv_rn(p.ref, fabsf(x[i]));
  __syncthreads();
  if (threadIdx.x != 0) return;
  ExactState s = s0;
  for (int k = 0; k < n; ++k) {
    const float xi = x[k];
    step_choice(s, xi, quo[k], p, &rates[k], &moves[k]);
    exact_step(s, xi, quo[k], p);
  }
  float g = 0.0f;
  long long t0 = 0;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) t0 = clock64();
    g = s0.g;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const bool u = moves[k];
      const float moved =
          __fadd_rn(g, __fmul_rn(__fsub_rn(quo[k], g), rates[k]));
      float kept = p.max_gain < g ? p.max_gain : g;
      kept = 0.0f > g ? p.floor : kept;
      const bool low = u && 0.0f > moved;
      const bool high = u && p.max_gain < moved;
      float gain = u ? moved : kept;
      gain = high ? p.max_gain : gain;
      gain = low ? p.floor : gain;
      g = __fsub_rn(__fadd_rn(gain, g), __fmul_rn(p.alpha, g));
    }
  }
  cycles[0] = clock64() - t0;
  sink[0] = g;
  sink[1] = __float_as_uint(g) == __float_as_uint(s.g) ? 1.0f : 0.0f;
}

ExactParams make_params(float reference, float attack_rate,
                        float decay_rate, float max_gain, float alpha,
                        int hang_time, int attack_wait) {
  ExactParams p;
  p.ref = reference;
  p.attack_rate = attack_rate;
  p.decay_rate = decay_rate;
  p.max_gain = max_gain;
  p.alpha = alpha;
  p.floor = max_gain < 0.0f ? max_gain : 0.0f;
  p.hang_time = hang_time;
  p.attack_wait = attack_wait;
  return p;
}

}  // namespace

extern "C" {

// agc_ff's recurrence over x (n,) float32 into y (n,) float32, one warp.
// The state in: g_in float32, h_in int32, p_in float32, a_in int32, one
// element each on the card; the next state out to g_out, h_out, p_out,
// a_out.  `started` = 0 skips sample 0.  Returns a cudaError_t.
int csdr_agc_ff_scan(const void* x, long long n, int started,
                     float reference, float attack_rate, float decay_rate,
                     float max_gain, float alpha, int hang_time,
                     int attack_wait, const void* g_in, const void* h_in,
                     const void* p_in, const void* a_in, void* y,
                     void* g_out, void* h_out, void* p_out, void* a_out,
                     void* stream) {
  if (x == nullptr || y == nullptr || g_in == nullptr || h_in == nullptr ||
      p_in == nullptr || a_in == nullptr || g_out == nullptr ||
      h_out == nullptr || p_out == nullptr || a_out == nullptr || n < 1)
    return (int)cudaErrorInvalidValue;
  const ExactParams p = make_params(reference, attack_rate, decay_rate,
                                    max_gain, alpha, hang_time, attack_wait);
  agc_exact_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, started, p, (const float*)g_in, (const int*)h_in,
      (const float*)p_in, (const int*)a_in, (float*)y, (float*)g_out,
      (int*)h_out, (float*)p_out, (int*)a_out);
  return (int)cudaGetLastError();
}

// The bound's probe: the function's shortest chain over the first n <=
// 4096 samples of x (float32 on the card), from the state (g, hang, peak,
// awc), on one thread from shared memory; the SM cycles of the timed pass
// go to cycles[0] (int64), the chain's last gain to sink[0] and 1 (it
// equals the kernel's step bit for bit) or 0 to sink[1] (float32).
int csdr_agc_ff_chain_probe(void* cycles, const void* x, int n,
                            float reference, float attack_rate,
                            float decay_rate, float max_gain, float alpha,
                            int hang_time, int attack_wait, float g,
                            int hang, float peak, int awc, void* sink,
                            void* stream) {
  if (cycles == nullptr || x == nullptr || sink == nullptr || n < 1 ||
      n > kProbeMax)
    return (int)cudaErrorInvalidValue;
  const ExactParams p = make_params(reference, attack_rate, decay_rate,
                                    max_gain, alpha, hang_time, attack_wait);
  ExactState s0;
  s0.g = g;
  s0.hang = hang;
  s0.peak = peak;
  s0.awc = awc;
  agc_exact_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      (long long*)cycles, (const float*)x, n, p, s0, (float*)sink);
  return (int)cudaGetLastError();
}

}  // extern "C"
