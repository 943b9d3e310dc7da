// The chunked AGC's waveform relaxation (agc_ff, attack_wait_time = 0):
// both relaxation loops in one cooperative launch, one block a chunk row.
//
// Replaces csdr_tpu's two jax.lax.while_loops in csdr_tpu/ops/agc.py (the
// inner mask relaxation at :385, the outer boundary wave at :437, the
// function at :228-450): no Pallas kernel there.  As Python loops of torch
// ops the port issued ~2 900 launches and two host syncs a chunk of the SSB
// and AM receivers' audio.
//
// Contract (kernels/agc_cuda.py; relax_plain is the same relaxation on
// tensors, bit for bit):
//   x (n,) float32, n >= 1, cut into rows of `chunk` samples (a multiple of
//   128, at most kMaxChunk), the last row zero-padded: row-major (B, chunk).
//   live = x != 0, but global sample 0 when the stream has not started;
//   c = live ? (1/max(|x|, 1e-30)) * reference : 0 (torch's reference/t is
//   t.reciprocal() * reference: two roundings).
// A trajectory step of a row from trajectory f, entry gain ef and entry
// "last attack" el (csdr_tpu's trajectory_step, the port's agc.py):
//   fp = f shifted by one, ef first;  attack = live & c < fp;
//   decay = live & !attack;  dc = inclusive count of decays;
//   last = max(latest dc at an attack so far (or kNeg), el);
//   frozen = decay & last > kNeg/2 & dc - last <= hang;
//   rate = attack ? ar : (decay & !frozen ? dr : 0);
//   clip = fp + rate*(c - fp) > max_gain   (three roundings, no fma);
//   (mul, add) = clip ? (1-alpha, max_gain) : ((1 - rate) + (1-alpha), rate*c),
//   (1, 0) at the stream's first sample;  add[0] += mul[0]*ef;
//   then the Hillis-Steele affine scan: for off = 1, 2, 4, ... < chunk,
//   add[i] += mul[i]*add[i-off], mul[i] *= mul[i-off], from the previous
//   step's values; the new f is add.
// The inner relaxation runs such steps from a seed trajectory at fixed
// entries.  A row stops after round i > 0 whose attack and clip masks
// equal round i-1's: every later round would give back its input bit for
// bit (the same masks give the same scan), so this is the plain version's
// fixed `iters` rounds; a row whose masks never settle runs all of them.
// The exit hang comes from the last round's dc and last at the row's end.
// The outer relaxation: each row's entry is the previous row's exit (gain,
// hang) of the round before (the first row's the call's), each round
// warm-started from the row's last trajectory, until |new_ef - ef| <=
// 1e-6*max(|ef|, 1e-3) in float32 and the hangs agree for every row, or
// rows + 2 rounds.  Outputs: y = f*x, the gain f[n-1], the last row's exit
// hang, and converged = stable & every row settled in the last round.
//
// Every float operation is an intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __frcp_rn), so nvcc contracts nothing; the integer scans are exact in any
// order, the float scan keeps the Hillis-Steele tree element by element.
//
// What bounds it.  Bytes are nothing (x in, y out, 8 B a sample).  The
// function is a chain: an outer round needs its rows' inner rounds, an
// inner round needs the previous round's trajectory, and a round's affine
// scan is log2(chunk) dependent steps, each reading another element's
// previous value.  The bound is the scans run (per outer round the most of
// any row, the rows side by side) x one scan of a row as affine_scan below
// runs it (at 8192 samples ten steps through shared memory, three in the
// thread's registers), csdr_agc_scan_probe, timed in SM cycles on the card.
//
// Design: the simplest that is right.  One block of 1024 threads a row,
// each owning the samples k*1024 + t, k < 8 (one build serves every chunk
// from 128 to 8192: each access is guarded by the chunk); the row's c and
// f and a pair of (add, mul) buffers in shared memory (24 B a sample,
// 197 kB at 8192); a thread's own (add, mul) in registers; a shared step
// reads the partner from one buffer and writes the other, one barrier a
// step; steps with off >= 1024 stay in the thread.  The integer scans run
// on warp ballots (a segment of 32 samples a warp and k), the segments'
// carries scanned by one warp.  The outer exchange goes through global
// memory behind a grid-wide barrier (cooperative launch); with more rows
// than blocks fit on the card, each block takes rows b, b+grid, ... and
// keeps their trajectories in global memory between rounds.  A row's exit
// values are triple-buffered by round, so no block overwrites what a
// slower block still reads.  No host sync: the stop test runs in every
// block on the same data and gives the same answer.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNeg = -(1 << 30);     // "no attack yet" in the distance scans
constexpr int kMaxChunk = 8192;
constexpr int kThreads = 1024;       // a block, whatever the chunk
constexpr int kE = kMaxChunk / kThreads;   // samples a thread
constexpr int kMaxSegs = kE * kThreads / 32;   // 32-sample segments

struct AgcParams {
  const float* x;
  long long n;
  int chunk, rows, iters, hang, started;
  float ref, ar, dr, max_gain, oma;   // oma = 1 - alpha, rounded to float32
  const float* f0_ptr;                // the entry gain on the card, or null
  float f0_val;
  const int* h0_ptr;                  // the entry hang on the card, or null
  int h0_val;
  float* y;
  float* gain_out;
  int* hang_out;
  uint8_t* conv_out;
  int* rounds_out;                    // (2, rows + 2, rows) or null
  float* traj;                        // (rows, chunk): each row's trajectory
  float* xf;                          // (3, rows): exit gains by round % 3
  int* xh;                            // (3, rows): exit hangs
  int* xs;                            // (3, rows): settled flags
};

size_t smem_bytes(int chunk) {
  // c, f (float) and two (add, mul) buffers (float2), the segments'
  // counts and carries, the row end's dc and last
  return (size_t)chunk * 24 + 2 * kMaxSegs * sizeof(int) + 4 * sizeof(int);
}

__device__ __forceinline__ unsigned lanes_upto(int lane) {
  return lane == 31 ? 0xffffffffu : ((2u << lane) - 1u);
}

// The segments' exclusive decay counts and carried "latest attack dc", in
// sample order, by one warp: cnt[s] holds segment s's decays and last[s]
// the decays up to and including its latest attack (kNeg if none) on
// entry; on exit cnt[s] is the decays before the segment and last[s] the
// dc at the latest attack before it (kNeg if none).
__device__ void scan_segments(int* cnt, int* last, int nseg, int lane) {
  const int per = (nseg + 31) / 32;
  const int lo = min(lane * per, nseg), hi = min(lo + per, nseg);
  int sum = 0, mx = kNeg;
  for (int s = lo; s < hi; ++s) {
    if (last[s] != kNeg) mx = sum + last[s];
    sum += cnt[s];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const int excl = incl - sum;
  int lmax = mx != kNeg ? excl + mx : kNeg;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, lmax, o);
    if (lane >= o) lmax = max(lmax, v);
  }
  int carry = __shfl_up_sync(0xffffffffu, lmax, 1);
  if (lane == 0) carry = kNeg;
  int run = excl;
  for (int s = lo; s < hi; ++s) {
    const int l = last[s], c = cnt[s];
    cnt[s] = run;
    last[s] = carry;
    if (l != kNeg) carry = max(carry, run + l);
    run += c;
  }
}

// The Hillis-Steele affine scan of a row of C (add, mul) pairs: v[k] is
// the thread's sample k*kThreads + t and src holds them all (behind a
// barrier).  For off = 1, 2, ... below min(kThreads, C) a step across
// threads through shared memory (the partner read from src, the new pair
// written to dst, one barrier a step; the last step writes nothing), then
// the steps off = dd*kThreads < C with the partner in the thread, k
// running down so v[k - dd] is still the previous step's.  Every pair
// takes add += mul*add[i-off], mul *= mul[i-off] from the previous step's
// values.
__device__ __forceinline__ void affine_scan(float2 (&v)[kE], float2* src,
                                            float2* dst, int C) {
  const int t = threadIdx.x;
  for (int off = 1; off < kThreads && off < C; off <<= 1) {
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int i = k * kThreads + t;
      if (i < C && i >= off) {
        const float2 q = src[i - off];
        v[k].x = __fadd_rn(v[k].x, __fmul_rn(v[k].y, q.x));
        v[k].y = __fmul_rn(v[k].y, q.y);
      }
    }
    if ((off << 1) < kThreads && (off << 1) < C) {
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int i = k * kThreads + t;
        if (i < C) dst[i] = v[k];
      }
      __syncthreads();
      float2* tmp = src;
      src = dst;
      dst = tmp;
    }
  }
#pragma unroll
  for (int dd = 1; dd < kE; dd <<= 1) {
    if (dd * kThreads < C) {
#pragma unroll
      for (int k = kE - 1; k >= dd; --k) {
        if (k * kThreads + t < C) {
          v[k].x = __fadd_rn(v[k].x, __fmul_rn(v[k].y, v[k - dd].x));
          v[k].y = __fmul_rn(v[k].y, v[k - dd].y);
        }
      }
    }
  }
}

// The relaxation of one row at fixed entries (ef, eh) from the trajectory
// in f (shared); leaves the final trajectory in f and returns the rounds
// run, whether the masks settled and the exit hang.
__device__ void relax_row(const AgcParams& p, int b, float ef, int eh,
                          unsigned live_bits, const float* c, float* f,
                          float2* buf0, float2* buf1, int* seg_cnt,
                          int* seg_last, int* tail, int* rounds_run,
                          bool* settled_out, int* h_out) {
  const int C = p.chunk, T = kThreads, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, wpk = T >> 5;
  const unsigned le = lanes_upto(lane);
  const int entry_last = eh > 0 ? eh - p.hang : kNeg;
  unsigned att_prev = 0, clip_prev = 0;
  bool settled = false;
  int rounds = 0;
  float2 v[kE];
  for (int it = 0; it < p.iters; ++it) {
    rounds = it + 1;
    // the masks from the trajectory, and each segment's summary
    unsigned att_bits = 0, dec_bits = 0;
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int i = k * T + t;
      bool att = false, dec = false;
      if (i < C) {
        const float fp = i == 0 ? ef : f[i - 1];
        const bool live = (live_bits >> k) & 1u;
        att = live && c[i] < fp;
        dec = live && !att;
      }
      att_bits |= (unsigned)att << k;
      dec_bits |= (unsigned)dec << k;
      const unsigned ab = __ballot_sync(0xffffffffu, att);
      const unsigned db = __ballot_sync(0xffffffffu, dec);
      if (lane == 0) {
        const int s = k * wpk + warp;
        seg_cnt[s] = __popc(db);
        seg_last[s] = ab ? __popc(db & lanes_upto(31 - __clz(ab))) : kNeg;
      }
    }
    __syncthreads();
    if (warp == 0) scan_segments(seg_cnt, seg_last, kE * wpk, lane);
    __syncthreads();
    // the branch of every sample, its affine pair and the clip mask
    unsigned clip_bits = 0;
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int i = k * T + t;
      const bool att = (att_bits >> k) & 1u, dec = (dec_bits >> k) & 1u;
      const unsigned ab = __ballot_sync(0xffffffffu, att);
      const unsigned db = __ballot_sync(0xffffffffu, dec);
      if (i < C) {
        const int s = k * wpk + warp;
        const int dc = seg_cnt[s] + __popc(db & le);
        int last = seg_last[s];
        const unsigned am = ab & le;
        if (am)
          last = max(last, seg_cnt[s] +
                               __popc(db & lanes_upto(31 - __clz(am))));
        last = max(last, entry_last);
        const bool frozen = dec && last > kNeg / 2 && dc - last <= p.hang;
        const float rate = att ? p.ar : ((dec && !frozen) ? p.dr : 0.0f);
        const float fp = i == 0 ? ef : f[i - 1], ci = c[i];
        const bool clip =
            __fadd_rn(fp, __fmul_rn(rate, __fsub_rn(ci, fp))) > p.max_gain;
        float mul = clip ? p.oma : __fadd_rn(__fsub_rn(1.0f, rate), p.oma);
        float add = clip ? p.max_gain : __fmul_rn(rate, ci);
        if (i == 0 && b == 0 && !p.started) {
          mul = 1.0f;
          add = 0.0f;
        }
        if (i == 0) add = __fadd_rn(add, __fmul_rn(mul, ef));
        clip_bits |= (unsigned)clip << k;
        v[k] = make_float2(add, mul);
        buf0[i] = v[k];
        if (i == C - 1) {
          tail[0] = dc;
          tail[1] = last;
        }
      }
    }
    const bool changed = att_bits != att_prev || clip_bits != clip_prev;
    const int any = __syncthreads_or(changed);
    att_prev = att_bits;
    clip_prev = clip_bits;
    if (it > 0 && !any) {
      settled = true;
      break;
    }
    affine_scan(v, buf0, buf1, C);
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int i = k * T + t;
      if (i < C) f[i] = v[k].x;
    }
    __syncthreads();
  }
  const int dc_e = tail[0], last_e = tail[1];
  const int h = last_e > kNeg / 2 ? p.hang - (dc_e - last_e) : 0;
  *h_out = min(max(h, 0), p.hang);
  *rounds_run = rounds;
  *settled_out = settled;
}

__global__ void __launch_bounds__(kThreads, 1)
agc_relax_kernel(AgcParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.chunk, T = kThreads, t = threadIdx.x;
  float2* buf0 = reinterpret_cast<float2*>(smem);
  float2* buf1 = buf0 + C;
  float* c = reinterpret_cast<float*>(buf1 + C);
  float* f = c + C;
  int* seg_cnt = reinterpret_cast<int*>(f + C);
  int* seg_last = seg_cnt + kMaxSegs;
  int* tail = seg_last + kMaxSegs;
  cg::grid_group grid = cg::this_grid();
  const int rows = p.rows;
  const float f0 = p.f0_ptr ? *p.f0_ptr : p.f0_val;
  const int h0 = p.h0_ptr ? *p.h0_ptr : p.h0_val;
  bool stable = false, all_settled = false;
  int r = 0;
  for (; r < rows + 2; ++r) {
    const int cur = r % 3, prev = (r + 2) % 3;
    for (int b = blockIdx.x; b < rows; b += gridDim.x) {
      // the row's entries: the previous row's exit of the round before
      const bool first = r == 0 || b == 0;
      const float ef = first ? f0 : __ldcg(p.xf + prev * rows + b - 1);
      const int eh = first ? h0 : __ldcg(p.xh + prev * rows + b - 1);
      const long long base = (long long)b * C;
      unsigned live_bits = 0;
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int i = k * T + t;
        if (i < C) {
          const long long g = base + i;
          const float xv = g < p.n ? __ldg(p.x + g) : 0.0f;
          float ci = 0.0f;
          if (xv != 0.0f) {
            float ax = fabsf(xv);
            ax = ax < 1e-30f ? 1e-30f : ax;      // a NaN stays a NaN
            ci = __fmul_rn(__frcp_rn(ax), p.ref);
          }
          c[i] = ci;
          live_bits |= (unsigned)(xv != 0.0f && (g != 0 || p.started)) << k;
          // warm start: the row's last trajectory (the flat entry gain at
          // first)
          f[i] = r == 0 ? f0 : __ldcg(p.traj + g);
        }
      }
      __syncthreads();
      int rounds, h;
      bool settled;
      relax_row(p, b, ef, eh, live_bits, c, f, buf0, buf1, seg_cnt,
                      seg_last, tail, &rounds, &settled, &h);
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int i = k * T + t;
        if (i < C) p.traj[base + i] = f[i];
      }
      if (t == 0) {
        p.xf[cur * rows + b] = f[C - 1];
        p.xh[cur * rows + b] = h;
        p.xs[cur * rows + b] = settled;
        if (p.rounds_out) {
          p.rounds_out[(long long)r * rows + b] = rounds;
          p.rounds_out[(long long)(rows + 2 + r) * rows + b] = settled;
        }
      }
      __syncthreads();
    }
    grid.sync();
    // the stop test, in every block on the same data
    int ok = 1, sett = 1;
    for (int b = t; b < rows; b += T) {
      const float new_ef = b == 0 ? f0 : __ldcg(p.xf + cur * rows + b - 1);
      const int new_eh = b == 0 ? h0 : __ldcg(p.xh + cur * rows + b - 1);
      const bool first = r == 0 || b == 0;
      const float ef = first ? f0 : __ldcg(p.xf + prev * rows + b - 1);
      const int eh = first ? h0 : __ldcg(p.xh + prev * rows + b - 1);
      float aef = fabsf(ef);
      aef = aef < 1e-3f ? 1e-3f : aef;           // a NaN stays a NaN
      const bool close =
          fabsf(__fsub_rn(new_ef, ef)) <= __fmul_rn(1e-6f, aef);
      ok &= close && new_eh == eh;
      sett &= __ldcg(p.xs + cur * rows + b) != 0;
    }
    stable = __syncthreads_and(ok);
    all_settled = __syncthreads_and(sett);
    if (stable) {
      ++r;
      break;
    }
  }
  // r rounds ran; the outputs from the last one
  const int last_round = (r - 1) % 3;
  for (int b = blockIdx.x; b < rows; b += gridDim.x) {
    const long long base = (long long)b * C;
    for (int i = t; i < C && base + i < p.n; i += T)
      p.y[base + i] = __fmul_rn(p.traj[base + i], __ldg(p.x + base + i));
    if (t == 0) {
      if (b == rows - 1) {
        *p.gain_out = p.traj[p.n - 1];
        *p.hang_out = p.xh[last_round * rows + b];
      }
      if (p.rounds_out)
        for (int q = r; q < rows + 2; ++q) {
          p.rounds_out[(long long)q * rows + b] = 0;
          p.rounds_out[(long long)(rows + 2 + q) * rows + b] = 0;
        }
    }
  }
  if (blockIdx.x == 0 && t == 0) *p.conv_out = stable && all_settled;
}

// The probe that sets the kernel's bound: one block of kThreads threads
// runs `scans` affine scans of a kMaxChunk-sample row of (add, mul) pairs
// twice, each as the kernel runs it (the pairs stored to shared memory, a
// barrier, then affine_scan), and writes the SM cycles of the second pass
// to cycles[0] (clock64, thread 0, between barriers).
__global__ void __launch_bounds__(kThreads, 1)
agc_scan_probe_kernel(long long* cycles, float* sink, int scans) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf0 = reinterpret_cast<float2*>(smem);
  float2* buf1 = buf0 + kMaxChunk;
  const int t = threadIdx.x;
  float2 v[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k)
    v[k] = make_float2(1e-3f * (float)(t + 1), 0.999f);
  long long t0 = 0;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      __syncthreads();
      t0 = clock64();
    }
    for (int s = 0; s < scans; ++s) {
#pragma unroll
      for (int k = 0; k < kE; ++k) buf0[k * kThreads + t] = v[k];
      __syncthreads();
      affine_scan(v, buf0, buf1, kMaxChunk);
    }
  }
  __syncthreads();
  if (t == 0) cycles[0] = clock64() - t0;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kE; ++k) acc = __fadd_rn(acc, v[k].x);
  sink[t] = acc;
}

// Blocks of agc_relax_kernel one SM holds at a chunk's shared memory (the
// attribute for the largest chunk set once).
cudaError_t blocks_per_sm(int chunk, int* per_sm) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        agc_relax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxChunk));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, agc_relax_kernel, kThreads, smem_bytes(chunk));
}

// The blocks that fit on the card at once for a chunk (cooperative launch:
// the grid), into *resident.
cudaError_t resident_blocks(int chunk, int* resident) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = blocks_per_sm(chunk, &per_sm);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *resident = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The relaxation of x (n float32 on the card) in rows of `chunk` samples
// (a multiple of 128, 128..8192), one cooperative launch: y (n,) float32,
// gain_out float32, hang_out int32 and conv_out one byte (0/1), each on
// the card.  The entry gain is f0_ptr[0] (a float32 on the card) or, when
// f0_ptr is null, f0_val; the entry hang likewise.  traj (rows*chunk)
// float32 and xstate (9*rows) int32 are scratch; rounds_out, if not null,
// (2, rows + 2, rows) int32: the inner rounds each row ran in each outer
// round (0 past the last), then whether its masks settled.  Returns a
// cudaError_t.
int csdr_agc_relax(const void* x, long long n, int chunk, int iters,
                   int hang, int started, float ref, float ar, float dr,
                   float max_gain, float oma, const void* f0_ptr,
                   float f0_val, const void* h0_ptr, int h0_val, void* y,
                   void* gain_out, void* hang_out, void* conv_out,
                   void* rounds_out, void* traj, void* xstate, void* stream) {
  if (x == nullptr || y == nullptr || gain_out == nullptr ||
      hang_out == nullptr || conv_out == nullptr || traj == nullptr ||
      xstate == nullptr || n < 1 || iters < 1 || chunk < 128 ||
      chunk > kMaxChunk || chunk % 128 ||
      (n + chunk - 1) / chunk > INT_MAX / 9)
    return (int)cudaErrorInvalidValue;
  AgcParams p;
  p.x = (const float*)x;
  p.n = n;
  p.chunk = chunk;
  p.rows = (int)((n + chunk - 1) / chunk);
  p.iters = iters;
  p.hang = hang;
  p.started = started;
  p.ref = ref;
  p.ar = ar;
  p.dr = dr;
  p.max_gain = max_gain;
  p.oma = oma;
  p.f0_ptr = (const float*)f0_ptr;
  p.f0_val = f0_val;
  p.h0_ptr = (const int*)h0_ptr;
  p.h0_val = h0_val;
  p.y = (float*)y;
  p.gain_out = (float*)gain_out;
  p.hang_out = (int*)hang_out;
  p.conv_out = (uint8_t*)conv_out;
  p.rounds_out = (int*)rounds_out;
  p.traj = (float*)traj;
  p.xf = (float*)xstate;
  p.xh = (int*)xstate + 3 * p.rows;
  p.xs = (int*)xstate + 6 * p.rows;
  int resident = 0;
  const cudaError_t e = resident_blocks(chunk, &resident);
  if (e != cudaSuccess) return (int)e;
  const int grid = p.rows < resident ? p.rows : resident;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(
      (void*)agc_relax_kernel, dim3(grid), dim3(kThreads), args,
      smem_bytes(chunk), (cudaStream_t)stream);
}

// Blocks of the relaxation kernel that fit on the card at once for a
// chunk: more rows than this run in turns inside each block.  Returns 0 on
// an error.
int csdr_agc_relax_resident(int chunk) {
  int resident = 0;
  if (chunk < 128 || chunk > kMaxChunk || chunk % 128 ||
      resident_blocks(chunk, &resident) != cudaSuccess)
    return 0;
  return resident;
}

// The bound's probe: `scans` affine scans of an 8192-sample row on one
// block of 1024 threads, as the relaxation kernel runs them; the SM cycles
// of the timed pass go to cycles[0] (int64), each thread's sum to sink[t]
// (1024 float32).
int csdr_agc_scan_probe(void* cycles, void* sink, int scans, void* stream) {
  if (cycles == nullptr || sink == nullptr || scans < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)(2 * kMaxChunk * sizeof(float2));
  const cudaError_t e = cudaFuncSetAttribute(
      agc_scan_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  agc_scan_probe_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (long long*)cycles, (float*)sink, scans);
  return (int)cudaGetLastError();
}

}  // extern "C"
