// The carrier recovery loops: the BPSK Costas loop and the PLL, each a
// serial per-sample recurrence, one warp a row with one thread carrying it.
//
// Replaces csdr_tpu's lax.scans in csdr_tpu/ops/sync.py: the Costas loop
// (bpsk_costas_loop_cc, :105-144, the scan at :142) and the PLL (pll_cc,
// :45-68, the scan at :67); no Pallas kernel there.  In eager torch each
// was a Python loop of ~20 small ops a sample (1.15 M launches a chunk of
// BASELINE config 5 with the Costas loop), so they are hand-written CUDA.
//
// Contract (kernels/carrier_cuda.py; costas_plain and pll_plain are the
// same loops on tensors, and on the card the kernels give their bits):
//   x (R, n) complex64 as interleaved float2, n >= 1; the state in as
//   three (R,) float32 tensors on the card, the next state out to three
//   fresh ones; no host read, no scalar upload.
// Every torch op of the loops is one rounded operation here, in the
// loops' order: __fmul_rn, __fadd_rn, __fsub_rn (no fma contraction),
// cosf, sinf and atan2f from the CUDA math library (what torch's cos, sin
// and atan2 call on float32 on the card), and alpha, beta, dphase_max and
// pi as float32, as torch rounds a Python scalar.  torch.remainder(a, b)
// on floats is fmod, then + b where the signs differ (torch's CPU and CUDA
// kernels alike); for b = 2*pi and a in (-b, 2b), the range the loops'
// phases reach, that is a, a - b (exact: Sterbenz) or a + b (fmod(a, b) =
// a there, so the same rounded sum), chosen by compares; outside it, fmodf.
// The kernels choose by selects, with no branch (Near below), and note an
// argument outside the range; a tile that had one runs again with the
// reference's forms (Exact), so its outputs and state are those
// (tests/test_torch_carrier.py holds the forms bit for bit over the range
// and its edges).  torch.clamp keeps a NaN and is fminf(fmaxf(..)).
//
// A Costas sample (the reference libcsdr.c:2108-2142):
//   c, s = cos(ph), sin(ph)
//   y = (xr*c - xi*s, xr*s + xi*c)
//   error = dd ? (|op| < pi/2 ? -op : wrap_pi(pi - op)), op = atan2(y_im, y_re)
//             : (pi*y_re)*y_im
//   freq += error*beta;  dphase = error*alpha + freq
//   dphase = reset ? (|dphase| > dmax ? 0 : dphase) : clamp(dphase, +-dmax)
//   ph = remainder(ph + dphase, 2pi);  ph = ph <= 0 ? ph + 2pi : ph
// outputs y, error and dphase; state (ph, freq, dphase).
// A PLL sample (the reference libcsdr.c:1870-1915):
//   op = wrap_pi(op + dphase);  nco = (sin(op), cos(op))
//   nd = wrap_pi(atan2(x_re, x_im) - op)
//   P: dphase = nd*alpha
//   PI: dphase = wrap_pi(nd*alpha + iir);  iir += nd*beta
// outputs -dphase and nco; state (op, dphase, iir).
// wrap_pi(p) = remainder(p + pi, 2pi) - pi.
//
// What bounds them.  Bytes are nothing (the Costas loop 24 B a sample, the
// PLL 20 B).  Operations are few.  What is left is each loop's chain: a
// sample's phase needs the previous sample's.  The Costas chain holds
// nearly everything: cos and sin of the phase (one range reduction), the
// rotation, the error (in the decision-directed mode an atan2 and a wrap),
// the loop filter, the clamp, the phase add and its wrap.  The PLL's chain
// holds no transcendental: the phase detector's atan2 reads the input
// alone and the NCO's sin and cos the chain's phase, so both lie beside
// it; the chain is two wraps (three with the PI filter), a product and a
// sum.  What the step decides by compares (which way a wrap goes, whether
// the clamp bites, the decision-directed error's sign) any implementation
// can decide beside the chain, so the shortest chain reads those choices
// and keeps only an add and a select of each: a wrap is u + 0 or u +- 2pi,
// the clamp d or its bound.  Each bound is samples x that chain in SM
// cycles at the top SM clock, timed on one thread from shared memory by
// csdr_costas_chain_probe and csdr_pll_chain_probe below; the rows run
// side by side (G_c: 64 rows, 64 warps on 64 SMs).
//
// Design.  One warp a row, the layout of csrc/agc_exact.cu: the 32 lanes
// load a tile of kTile samples coalesced into shared memory, the next
// tile's loads issued into registers before the chain runs the current
// one, so they land while it runs.  Lane 0 runs a tile's recurrence with
// the Near wraps, and again with the Exact ones from the state the tile
// began with where an argument left their range (the Costas phase plus a
// dphase clamped under 2pi does not; the PLL's PI filter does once its
// integrator passes +-3pi).  The Costas loop: lane 0 reads the tile from shared
// memory and stores each sample's outputs straight to memory (a store
// waits on nothing; a tile run again stores over them).  The PLL: the
// lanes compute the tile's atan2s first, lane 0 runs the chain over them
// into shared memory, then the lanes compute the NCO's sin and cos and
// store the tile's outputs coalesced.  The state lives in lane 0's
// registers throughout.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 512;           // samples a tile: 16 a lane
constexpr int kPer = kTile / 32;
constexpr int kProbeMax = 2048;      // samples a probe stages

// float32(pi), float32(pi/2), float32(2pi): torch's Python scalars
constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kTwoPi = 6.28318530717958647692f;

struct CostasParams {
  float alpha, beta, dmax;
  int dd, reset;
};

struct PllParams {
  float alpha, beta;
  int pi;          // 1: the PI controller, 0: P
};

struct Loop {
  float a, b, c;   // Costas (phase, freq, dphase); PLL (phase, dphase, iir)
};

// torch.remainder(a, 2pi): a, a - 2pi or a + 2pi by compares where
// a in (-2pi, 4pi), else fmodf and torch's sign fix.
__device__ __forceinline__ float remainder_2pi(float a) {
  if (a > -kTwoPi && a < 2.0f * kTwoPi) {
    if (a < 0.0f) return __fadd_rn(a, kTwoPi);
    return a >= kTwoPi ? __fsub_rn(a, kTwoPi) : a;
  }
  float m = fmodf(a, kTwoPi);
  if (m < 0.0f) m = __fadd_rn(m, kTwoPi);
  return m;
}

// A wrap as a probe's chain reads it: how the wrap's result r comes from
// its argument u, u + v (v = 0 or +-2pi: the compares' choice) where that
// gives r's bits, else r itself (take: fmodf's far range, and an add that
// would not keep u's bits, -0.0 or a NaN's payload).
struct Pick {
  float v;
  bool take;
};

__device__ __forceinline__ Pick pick_of(float u, float r) {
  const unsigned want = __float_as_uint(r);
  if (__float_as_uint(__fadd_rn(u, 0.0f)) == want) return {0.0f, false};
  if (__float_as_uint(__fadd_rn(u, kTwoPi)) == want) return {kTwoPi, false};
  if (__float_as_uint(__fadd_rn(u, -kTwoPi)) == want) return {-kTwoPi, false};
  return {r, true};
}

// The steps are written once, over a policy W that makes what a step
// decides by compares: rem(u, slot), torch.remainder(u, 2pi) inside a
// wrap_pi; phase(a, slot), the Costas phase's remainder and its <= 0 fix;
// clamp(d, p), the Costas clamp; neg(op), the decision-directed error's
// sign; and sincos, the phase's sin and cos.  The slots name a step's
// wraps for the probes: the Costas error's 0, its phase 1, its clamp 2;
// the PLL's output phase 0, detector 1, PI filter 2.

// The reference's forms: compares, fmodf past (-2pi, 4pi).
struct Exact {
  __device__ __forceinline__ float rem(float u, int) {
    return remainder_2pi(u);
  }
  __device__ __forceinline__ float phase(float a, int) {
    const float r = remainder_2pi(a);
    return r <= 0.0f ? __fadd_rn(r, kTwoPi) : r;
  }
  __device__ __forceinline__ float clamp(float d, const CostasParams& p) {
    if (p.reset) return fabsf(d) > p.dmax ? 0.0f : d;
    return isnan(d) ? d : fminf(fmaxf(d, -p.dmax), p.dmax);
  }
  __device__ __forceinline__ bool neg(float op) {
    return fabsf(op) < kHalfPi;
  }
  __device__ __forceinline__ void sincos(float a, float* s, float* c) {
    *c = cosf(a);
    *s = sinf(a);
  }
};

// The kernels' forms: compares and selects, no branch, exact where the
// argument lies in (-2pi, 4pi); far notes one that does not (or a NaN),
// and the kernel runs that tile again with Exact.  In the range, the
// remainder is u + 2pi below 0, u - 2pi (exact: Sterbenz) from 2pi up,
// else u; with the <= 0 fix, a + 2pi up to 0, a - 2pi past 2pi, else a.
struct Near : Exact {
  bool far = false;
  __device__ __forceinline__ void note(float u) {
    far |= !(u > -kTwoPi && u < 2.0f * kTwoPi);
  }
  __device__ __forceinline__ float rem(float u, int) {
    note(u);
    const float up = __fadd_rn(u, kTwoPi), dn = __fsub_rn(u, kTwoPi);
    return u < 0.0f ? up : (u >= kTwoPi ? dn : u);
  }
  __device__ __forceinline__ float phase(float a, int) {
    note(a);
    const float up = __fadd_rn(a, kTwoPi), dn = __fsub_rn(a, kTwoPi);
    return a <= 0.0f ? up : (a > kTwoPi ? dn : a);
  }
};

// Exact, recording each slot's pick and the error's sign (a probe's pass
// before its chain).
struct Record : Exact {
  Pick pk[3] = {{0.0f, false}, {0.0f, false}, {0.0f, false}};
  bool negative = false;
  __device__ __forceinline__ float rem(float u, int slot) {
    const float r = Exact::rem(u, slot);
    pk[slot] = pick_of(u, r);
    return r;
  }
  __device__ __forceinline__ float phase(float a, int slot) {
    const float r = Exact::phase(a, slot);
    pk[slot] = pick_of(a, r);
    return r;
  }
  __device__ __forceinline__ float clamp(float d, const CostasParams& p) {
    const float r = Exact::clamp(d, p);
    pk[2] = {r, __float_as_uint(r) != __float_as_uint(d)};
    return r;
  }
  __device__ __forceinline__ bool neg(float op) {
    negative = Exact::neg(op);
    return negative;
  }
  // the picks packed: take bits 0-2 by slot, the sign bit 3
  __device__ __forceinline__ unsigned takes() const {
    return (pk[0].take ? 1u : 0u) | (pk[1].take ? 2u : 0u) |
           (pk[2].take ? 4u : 0u) | (negative ? 8u : 0u);
  }
};

// The shortest chain, given the recorded picks: each wrap an add and a
// select (u + v, or v where taken), the clamp a select, the sign read, and
// one sin/cos range reduction.  Nothing of the compares, branches or
// fmodf is on it: any implementation can make those choices beside it.
struct Link {
  float v[3];
  unsigned tk;
  __device__ __forceinline__ float rem(float u, int slot) {
    const float s = __fadd_rn(u, v[slot]);
    return (tk >> slot) & 1u ? v[slot] : s;
  }
  __device__ __forceinline__ float phase(float a, int slot) {
    return rem(a, slot);
  }
  __device__ __forceinline__ float clamp(float d, const CostasParams&) {
    return tk & 4u ? v[2] : d;
  }
  __device__ __forceinline__ bool neg(float) { return tk & 8u; }
  __device__ __forceinline__ void sincos(float a, float* s, float* c) {
    sincosf(a, s, c);
  }
};

// wrap_pi(p) = remainder(p + pi, 2pi) - pi.
template <class W>
__device__ __forceinline__ float wrap_pi(W& w, float p, int slot) {
  return __fsub_rn(w.rem(__fadd_rn(p, kPi), slot), kPi);
}

// One Costas sample from (xr, xi); returns y and the error, dphase in s.c.
template <class W>
__device__ __forceinline__ float2 costas_step(Loop& s, float xr, float xi,
                                              const CostasParams& p,
                                              float* error_out, W& w) {
  float c, sn;
  w.sincos(s.a, &sn, &c);
  const float yr = __fsub_rn(__fmul_rn(xr, c), __fmul_rn(xi, sn));
  const float yi = __fadd_rn(__fmul_rn(xr, sn), __fmul_rn(xi, c));
  float error;
  if (p.dd) {
    const float op = atan2f(yi, yr);
    const float wrapped = wrap_pi(w, __fsub_rn(kPi, op), 0);
    error = w.neg(op) ? -op : wrapped;
  } else {
    error = __fmul_rn(__fmul_rn(kPi, yr), yi);
  }
  s.b = __fadd_rn(s.b, __fmul_rn(error, p.beta));
  s.c = w.clamp(__fadd_rn(__fmul_rn(error, p.alpha), s.b), p);
  s.a = w.phase(__fadd_rn(s.a, s.c), 1);
  *error_out = error;
  return make_float2(yr, yi);
}

// One PLL chain link from the input's phase ip = atan2(x_re, x_im); returns
// the output phase (the NCO's argument); -dphase is the output sample.
template <class W>
__device__ __forceinline__ float pll_step(Loop& s, float ip,
                                          const PllParams& p, W& w) {
  const float op = wrap_pi(w, __fadd_rn(s.a, s.b), 0);
  const float nd = wrap_pi(w, __fsub_rn(ip, op), 1);
  if (p.pi) {
    s.b = wrap_pi(w, __fadd_rn(__fmul_rn(nd, p.alpha), s.c), 2);
    s.c = __fadd_rn(s.c, __fmul_rn(nd, p.beta));
  } else {
    s.b = __fmul_rn(nd, p.alpha);
  }
  s.a = op;
  return op;
}

// Tile t of a row into registers (zeros past n).
__device__ __forceinline__ void load_tile(float2 (&r)[kPer],
                                          const float2* __restrict__ x,
                                          long long base, int n, int lane) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long i = base + (long long)j * 32 + lane;
    r[j] = i < n ? x[i] : make_float2(0.0f, 0.0f);
  }
}

// Lane 0's pass of a Costas tile (len samples from shared memory, outputs
// straight to memory), with the policy W; returns W's state (Near's far).
template <class W>
__device__ __forceinline__ W costas_tile(Loop& s, const float2* xs, int len,
                                         const CostasParams& p, float2* y,
                                         float* err, float* dph) {
  W w;
#pragma unroll 2
  for (int k = 0; k < len; ++k) {
    const float2 v = xs[k];
    float e;
    y[k] = costas_step(s, v.x, v.y, p, &e, w);
    err[k] = e;
    dph[k] = s.c;
  }
  return w;
}

__global__ void __launch_bounds__(32, 1)
costas_kernel(const float2* __restrict__ x, int n, CostasParams p,
              const float* __restrict__ a_in, const float* __restrict__ b_in,
              const float* __restrict__ c_in, float2* __restrict__ y,
              float* __restrict__ err, float* __restrict__ dph,
              float* __restrict__ a_out, float* __restrict__ b_out,
              float* __restrict__ c_out) {
  __shared__ float2 xs[2][kTile];
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const long long off = (long long)row * n;
  x += off;
  y += off;
  err += off;
  dph += off;
  Loop s = {0.0f, 0.0f, 0.0f};
  if (lane == 0) s = {a_in[row], b_in[row], c_in[row]};
  const int tiles = (n + kTile - 1) / kTile;
  float2 next[kPer];
  load_tile(next, x, 0, n, lane);
#pragma unroll
  for (int j = 0; j < kPer; ++j) xs[0][j * 32 + lane] = next[j];
  for (int t = 0; t < tiles; ++t) {
    const long long base = (long long)t * kTile;
    const int len = (int)(n - base < kTile ? n - base : kTile);
    const int b = t & 1;
    if (t + 1 < tiles) load_tile(next, x, base + kTile, n, lane);
    __syncwarp();
    if (lane == 0) {
      const Loop start = s;
      if (costas_tile<Near>(s, xs[b], len, p, y + base, err + base,
                            dph + base).far) {
        s = start;     // a phase out of the near range: the tile exactly
        costas_tile<Exact>(s, xs[b], len, p, y + base, err + base,
                           dph + base);
      }
    }
    __syncwarp();
    if (t + 1 < tiles) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) xs[b ^ 1][j * 32 + lane] = next[j];
    }
  }
  if (lane == 0) {
    a_out[row] = s.a;
    b_out[row] = s.b;
    c_out[row] = s.c;
  }
}

// Lane 0's pass of a PLL tile: the chain over the tile's input phases
// into the output phases and -dphase, with the policy W.
template <class W>
__device__ __forceinline__ W pll_tile(Loop& s, const float* ips, int len,
                                      const PllParams& p, float* ops,
                                      float* dps) {
  W w;
#pragma unroll 2
  for (int k = 0; k < len; ++k) {
    ops[k] = pll_step(s, ips[k], p, w);
    dps[k] = -s.b;
  }
  return w;
}

__global__ void __launch_bounds__(32, 1)
pll_kernel(const float2* __restrict__ x, int n, PllParams p,
           const float* __restrict__ a_in, const float* __restrict__ b_in,
           const float* __restrict__ c_in, float* __restrict__ dph,
           float2* __restrict__ nco, float* __restrict__ a_out,
           float* __restrict__ b_out, float* __restrict__ c_out) {
  __shared__ float ips[kTile];
  __shared__ float ops[kTile];
  __shared__ float dps[kTile];
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const long long off = (long long)row * n;
  x += off;
  dph += off;
  nco += off;
  Loop s = {0.0f, 0.0f, 0.0f};
  if (lane == 0) s = {a_in[row], b_in[row], c_in[row]};
  const int tiles = (n + kTile - 1) / kTile;
  float2 cur[kPer], next[kPer];
  load_tile(cur, x, 0, n, lane);
  for (int t = 0; t < tiles; ++t) {
    const long long base = (long long)t * kTile;
    const int len = (int)(n - base < kTile ? n - base : kTile);
    if (t + 1 < tiles) load_tile(next, x, base + kTile, n, lane);
    // the phase detector off the chain: every lane its own samples
#pragma unroll
    for (int j = 0; j < kPer; ++j) ips[j * 32 + lane] = atan2f(cur[j].x,
                                                               cur[j].y);
    __syncwarp();
    if (lane == 0) {
      const Loop start = s;
      if (pll_tile<Near>(s, ips, len, p, ops, dps).far) {
        s = start;     // a phase out of the near range: the tile exactly
        pll_tile<Exact>(s, ips, len, p, ops, dps);
      }
    }
    __syncwarp();
    // the NCO off the chain, and the tile's outputs stored coalesced
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = j * 32 + lane;
      if (k < len) {
        const float op = ops[k];
        nco[base + k] = make_float2(sinf(op), cosf(op));
        dph[base + k] = dps[k];
      }
    }
    __syncwarp();
    if (t + 1 < tiles) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) cur[j] = next[j];
    }
  }
  if (lane == 0) {
    a_out[row] = s.a;
    b_out[row] = s.b;
    c_out[row] = s.c;
  }
}

// The probes that set the kernels' bounds: each loop's shortest chain
// (the policy Link) over the first n <= kProbeMax samples of one row, on
// one thread from shared memory, as csrc/agc_exact.cu's probe.  The
// thread runs the reference's step (Exact, recording: Record) over the
// samples from the given state, keeping each sample's picks; then runs the
// chain twice from the same state, reading them, the second pass timed
// (clock64) into cycles[0].  sink[0..2] = the chain's last state (the
// wrapper holds it against the kernel's, bit for bit), sink[3] = 1 if it
// equals the step's bit for bit, else 0.  The PLL's chain reads the
// atan2s the block computed beforehand, as the kernel's lanes do.
__device__ __forceinline__ float same_loop(const Loop& a, const Loop& b) {
  return __float_as_uint(a.a) == __float_as_uint(b.a) &&
                 __float_as_uint(a.b) == __float_as_uint(b.b) &&
                 __float_as_uint(a.c) == __float_as_uint(b.c)
             ? 1.0f
             : 0.0f;
}

__global__ void costas_probe_kernel(long long* cycles, const float2* x,
                                    int n, CostasParams p, Loop s0,
                                    float* sink) {
  __shared__ float2 xs[kProbeMax];
  __shared__ float v0[kProbeMax], v1[kProbeMax], v2[kProbeMax];
  __shared__ unsigned char tk[kProbeMax];
  for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = x[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  Loop s = s0;
  for (int k = 0; k < n; ++k) {
    Record r;
    float e;
    costas_step(s, xs[k].x, xs[k].y, p, &e, r);
    v0[k] = r.pk[0].v;
    v1[k] = r.pk[1].v;
    v2[k] = r.pk[2].v;
    tk[k] = (unsigned char)r.takes();
  }
  const Loop step = s;
  long long t0 = 0;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) t0 = clock64();
    s = s0;
#pragma unroll 2
    for (int k = 0; k < n; ++k) {
      Link w = {{v0[k], v1[k], v2[k]}, tk[k]};
      float e;
      costas_step(s, xs[k].x, xs[k].y, p, &e, w);
    }
  }
  cycles[0] = clock64() - t0;
  sink[0] = s.a;
  sink[1] = s.b;
  sink[2] = s.c;
  sink[3] = same_loop(s, step);
}

__global__ void pll_probe_kernel(long long* cycles, const float2* x, int n,
                                 PllParams p, Loop s0, float* sink) {
  __shared__ float ips[kProbeMax];
  __shared__ float v0[kProbeMax], v1[kProbeMax], v2[kProbeMax];
  __shared__ unsigned char tk[kProbeMax];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    ips[i] = atan2f(x[i].x, x[i].y);
  __syncthreads();
  if (threadIdx.x != 0) return;
  Loop s = s0;
  for (int k = 0; k < n; ++k) {
    Record r;
    pll_step(s, ips[k], p, r);
    v0[k] = r.pk[0].v;
    v1[k] = r.pk[1].v;
    v2[k] = r.pk[2].v;
    tk[k] = (unsigned char)r.takes();
  }
  const Loop step = s;
  long long t0 = 0;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) t0 = clock64();
    s = s0;
#pragma unroll 2
    for (int k = 0; k < n; ++k) {
      Link w = {{v0[k], v1[k], v2[k]}, tk[k]};
      pll_step(s, ips[k], p, w);
    }
  }
  cycles[0] = clock64() - t0;
  sink[0] = s.a;
  sink[1] = s.b;
  sink[2] = s.c;
  sink[3] = same_loop(s, step);
}

bool bad_state(const void* a, const void* b, const void* c) {
  return a == nullptr || b == nullptr || c == nullptr;
}

}  // namespace

extern "C" {

// The Costas loop over x (rows, n) complex64 into y (rows, n) complex64,
// error and dphase (rows, n) float32, one warp a row.  The state in:
// a_in (phase), b_in (freq), c_in (dphase), (rows,) float32 on the card;
// the next state out to a_out, b_out, c_out.  dd: the decision-directed
// error; reset: dphase past +-dmax resets to 0 (else it is clamped).
// Returns a cudaError_t.
int csdr_costas_scan(const void* x, int rows, int n, float alpha, float beta,
                     float dmax, int dd, int reset, const void* a_in,
                     const void* b_in, const void* c_in, void* y, void* err,
                     void* dph, void* a_out, void* b_out, void* c_out,
                     void* stream) {
  if (x == nullptr || y == nullptr || err == nullptr || dph == nullptr ||
      bad_state(a_in, b_in, c_in) || bad_state(a_out, b_out, c_out) ||
      rows < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const CostasParams p = {alpha, beta, dmax, dd, reset};
  costas_kernel<<<rows, 32, 0, (cudaStream_t)stream>>>(
      (const float2*)x, n, p, (const float*)a_in, (const float*)b_in,
      (const float*)c_in, (float2*)y, (float*)err, (float*)dph,
      (float*)a_out, (float*)b_out, (float*)c_out);
  return (int)cudaGetLastError();
}

// The PLL over x (rows, n) complex64 into dph (rows, n) float32 (-dphase)
// and nco (rows, n) complex64 (sin + j cos of the output phase), one warp
// a row.  The state in: a_in (output phase), b_in (dphase), c_in (iir),
// (rows,) float32 on the card; the next state out to a_out, b_out, c_out.
// pi: the PI controller (alpha, beta), else P (alpha).  Returns a
// cudaError_t.
int csdr_pll_scan(const void* x, int rows, int n, float alpha, float beta,
                  int pi, const void* a_in, const void* b_in,
                  const void* c_in, void* dph, void* nco, void* a_out,
                  void* b_out, void* c_out, void* stream) {
  if (x == nullptr || dph == nullptr || nco == nullptr ||
      bad_state(a_in, b_in, c_in) || bad_state(a_out, b_out, c_out) ||
      rows < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const PllParams p = {alpha, beta, pi};
  pll_kernel<<<rows, 32, 0, (cudaStream_t)stream>>>(
      (const float2*)x, n, p, (const float*)a_in, (const float*)b_in,
      (const float*)c_in, (float*)dph, (float2*)nco, (float*)a_out,
      (float*)b_out, (float*)c_out);
  return (int)cudaGetLastError();
}

// The bounds' probes: a loop's shortest chain over the first n <= 2048
// samples of x (complex64 on the card) from the state (a, b, c), on one
// thread from shared memory; the SM cycles of the timed pass go to
// cycles[0] (int64), the state after it to sink[0..2] and 1 (it equals the
// kernel's step bit for bit) or 0 to sink[3] (float32).
int csdr_costas_chain_probe(void* cycles, const void* x, int n, float alpha,
                            float beta, float dmax, int dd, int reset,
                            float a, float b, float c, void* sink,
                            void* stream) {
  if (cycles == nullptr || x == nullptr || sink == nullptr || n < 1 ||
      n > kProbeMax)
    return (int)cudaErrorInvalidValue;
  const CostasParams p = {alpha, beta, dmax, dd, reset};
  const Loop s0 = {a, b, c};
  costas_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      (long long*)cycles, (const float2*)x, n, p, s0, (float*)sink);
  return (int)cudaGetLastError();
}

int csdr_pll_chain_probe(void* cycles, const void* x, int n, float alpha,
                         float beta, int pi, float a, float b, float c,
                         void* sink, void* stream) {
  if (cycles == nullptr || x == nullptr || sink == nullptr || n < 1 ||
      n > kProbeMax)
    return (int)cudaErrorInvalidValue;
  const PllParams p = {alpha, beta, pi};
  const Loop s0 = {a, b, c};
  pll_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      (long long*)cycles, (const float2*)x, n, p, s0, (float*)sink);
  return (int)cudaGetLastError();
}

}  // extern "C"
