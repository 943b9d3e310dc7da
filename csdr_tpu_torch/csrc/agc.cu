// The chunked AGC's waveform relaxation (agc_ff, attack_wait_time = 0):
// both relaxation loops in one cooperative launch, a chunk row spread over
// a thread-block cluster.
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
// order, the float scan keeps the Hillis-Steele tree element by element,
// so the bits do not depend on how a row is laid over the card.
//
// What bounds it.  Bytes are nothing (x in, y out, 8 B a sample).  The
// function is a chain: an outer round needs its rows' inner rounds, an
// inner round needs the previous round's trajectory, and a round's affine
// scan is log2(chunk) dependent steps, each reading a pair that another
// thread computed in the step before.  Whatever runs the tree pays, a
// step, at least a store, a barrier among the threads that exchange, the
// partner's load and the add's product and sum.  The bound is the scans
// on the chain (per outer round the most of any row, the rows side by
// side) x that chain of 13 steps on one warp, csdr_agc_chain_probe below,
// timed in SM cycles on the card.
//
// Design.  A row over a cluster of K CTAs (K from kernels/agc_cuda.
// cluster_plan: 16 for up to 7 rows, fewer as the rows grow, so that every
// row's cluster is resident, a CTA an SM while they fit), CTA `rank`
// holding the slice of S = chunk/K samples from rank*S, E samples a thread
// (its samples k*T + t, T = S/E threads; E = 1 or 2).  Its shared memory:
// c, f and the scan's buffers for the slice, the slots and mbarriers its
// neighbours push into.  No cluster barrier in a round: one with release
// and acquire costs 929-1 410 SM cycles on an H100 (tools/agc_phases.py),
// so whatever a CTA tells another it writes into that CTA's shared memory
// with st.async, which completes on an mbarrier there counting bytes
// (phases tracked by parity; what two rounds may overlap is
// double-buffered).
//  - The integer scans: warp ballots give a segment (32 samples) its
//    decays and last attack, one warp scans the slice's segments (one
//    shuffle scan of both: a later attack wins) and pushes the slice's
//    total to every later CTA, each warp of those combines the earlier
//    slices' totals with a warp scan.  A cluster with one row keeps its
//    slice in shared memory from one outer round to the next.
//  - The round's "masks changed" test: the CTA's OR, pushed to the others.
//  - The affine scan (affine_scan below): beside the flags each CTA pushes
//    its pairs to the next CTA, which runs the steps below S on the window
//    of both slices (recomputing the previous slice's positions that later
//    steps read, the same operations on the same values), so those steps
//    need no exchange; a step at o >= S takes the slice of CTA rank - o/S,
//    pushed when that CTA finished the step before.  log2(K) exchanges a
//    scan instead of log2(chunk); the window's steps go two to a CTA
//    barrier.  The window's last position is the previous slice's last
//    sample, so the CTA also ends the scan with f of the sample before its
//    slice.
// The outer exchange goes through global memory behind a grid-wide barrier
// (cooperative launch); with more rows than clusters fit on the card, each
// cluster takes rows c, c + clusters, ... in turns and keeps their
// trajectories in global memory between rounds.  A row's exit values are
// triple-buffered by round, so no CTA overwrites what a slower CTA still
// reads.  No host sync: the stop test runs in every CTA on the same data
// and gives the same answer.  With `spread`, a CTA asks for more than half
// an SM's shared memory, so the cluster's CTAs take one SM each.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNeg = -(1 << 30);     // "no attack yet" in the distance scans
constexpr int kMaxChunk = 8192;
constexpr int kMaxThreads = 1024;
constexpr int kMaxE = 2;             // samples a thread, at most
constexpr int kMaxSlice = kMaxE * kMaxThreads;   // samples a CTA
constexpr int kMaxSegs = kMaxSlice / 32;         // 32-sample segments a CTA
constexpr int kMaxCluster = 16;
constexpr int kSpreadBytes = 116 * 1024;         // over half an SM's 228 KB
constexpr int kProbeSteps = 13;                  // log2(kMaxChunk)
constexpr unsigned kFull = 0xffffffffu;

struct AgcParams {
  const float* x;
  long long n;
  int chunk, rows, iters, hang, started;
  int cluster, slice;                 // K CTAs a row, S = chunk / K samples
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
  int* smid_out;                      // (grid,): each CTA's SM, or null
};

// A CTA's shared memory: a head (the mbarriers, the slots other CTAs push
// into), then the scan's two buffers (the slice, or in a cluster the
// window of the previous slice and this one), the halo's receive buffers
// (two, by round parity), the pairs pushed for the steps at offsets >= S
// (S and one more a step), c and f, the segments' summaries.
constexpr int kBarStep = 0;          // mbarriers: a scan step's (13),
constexpr int kBarSum = 13;          // the earlier slices' summaries,
constexpr int kBarFlag = 14;         // the changed flags (2, by round),
constexpr int kBarHalo = 16;         // the halo (2, by round)
constexpr int kBars = 18;
constexpr int kSummSlot = 256;       // int[2 * kMaxCluster]: (cnt, last)
constexpr int kFlagSlot = 384;       // int[2][kMaxCluster]
constexpr int kLeftSlot = 512;       // float: f of the sample before
constexpr int kHead = 768;

// The pairs a CTA of a cluster receives over a scan: S + 1 for each step
// at an offset o >= S (o < C).
__host__ __device__ __forceinline__ int recv_len(int C, int S) {
  int n = 0;
  for (int o = S; o < C; o <<= 1) n += S + 1;
  return n;
}

size_t smem_bytes(int chunk, int slice) {
  const size_t pairs = (size_t)(slice < chunk ? 6 : 2) * slice +
                       (size_t)recv_len(chunk, slice);
  return (size_t)kHead + pairs * 8 + (size_t)slice * 8 +
         2 * kMaxSegs * sizeof(int);
}

struct Slice {
  float2* a;                // the scan's buffers
  float2* b;
  float2* halo;             // 2 x S, by round parity (in a cluster)
  float2* recv;             // pushed pairs
  float* c;
  float* f;
  int* seg_cnt;
  int* seg_last;
};

__device__ __forceinline__ Slice slice_layout(unsigned char* smem, int C,
                                              int S) {
  const bool halo = S < C;
  Slice L;
  L.a = reinterpret_cast<float2*>(smem + kHead);
  L.b = L.a + (halo ? 2 * S : S);
  L.halo = L.b + (halo ? 2 * S : S);
  L.recv = L.halo + (halo ? 2 * S : 0);
  L.c = reinterpret_cast<float*>(L.recv + recv_len(C, S));
  L.f = L.c + S;
  L.seg_cnt = reinterpret_cast<int*>(L.f + S);
  L.seg_last = L.seg_cnt + kMaxSegs;
  return L;
}

__device__ __forceinline__ unsigned lanes_upto(int lane) {
  return lane == 31 ? kFull : ((2u << lane) - 1u);
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

// The shared::cluster address of a shared::cta address in CTA `rank`.
__device__ __forceinline__ unsigned mapa(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Stores into another CTA's shared memory that complete on its mbarrier
// (both shared::cluster addresses), counted in bytes: no fence, no
// cluster barrier.
__device__ __forceinline__ void push_f2(unsigned addr, float2 v,
                                        unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
      "[%0], {%1, %2}, [%3];\n"
      :: "r"(addr), "f"(v.x), "f"(v.y), "r"(bar) : "memory");
}

__device__ __forceinline__ void push_b32(unsigned addr, unsigned v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];\n"
      :: "r"(addr), "r"(v), "r"(bar) : "memory");
}

// The segments' exclusive decay counts and carried "latest attack dc", in
// sample order, by one warp: cnt[s] holds segment s's decays and last[s]
// the decays up to and including its latest attack (kNeg if none) on
// entry; on exit cnt[s] is the decays before the segment and last[s] the
// dc at the latest attack before it (kNeg if none), both counted from the
// slice's start.  Returns, in every lane, the slice's decays and the dc at
// its latest attack (kNeg if none).
__device__ int2 scan_segments(int* cnt, int* last, int nseg, int lane) {
  const int per = (nseg + 31) / 32;
  const int lo = min(lane * per, nseg), hi = min(lo + per, nseg);
  int sum = 0, mx = kNeg;
  for (int s = lo; s < hi; ++s) {
    if (last[s] != kNeg) mx = sum + last[s];
    sum += cnt[s];
  }
  // over the lanes, (decays, dc at the latest attack) combine as a later
  // attack wins: one scan of both
  int c = sum, a = mx;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int pc = __shfl_up_sync(kFull, c, o);
    const int pa = __shfl_up_sync(kFull, a, o);
    if (lane >= o) {
      a = a != kNeg ? pc + a : pa;
      c += pc;
    }
  }
  int run = c - sum;
  int carry = __shfl_up_sync(kFull, a, 1);
  if (lane == 0) carry = kNeg;
  for (int s = lo; s < hi; ++s) {
    const int l = last[s], n = cnt[s];
    cnt[s] = run;
    last[s] = carry;
    if (l != kNeg) carry = max(carry, run + l);
    run += n;
  }
  return make_int2(__shfl_sync(kFull, c, 31), __shfl_sync(kFull, a, 31));
}

__device__ __forceinline__ void affine_step(float2& v, float2 w) {
  v.x = __fadd_rn(v.x, __fmul_rn(v.y, w.x));
  v.y = __fmul_rn(v.y, w.y);
}

// The Hillis-Steele affine scan of the row's C pairs: v[k] is the
// thread's sample k*T + t of the slice, its pairs are in L.a (at S + l in
// a cluster).  A step at offset o takes sample i - o.
//  - Alone (K = 1): from the slice, behind a CTA barrier.
//  - In a cluster, the steps below S run on the window of the previous
//    slice and this one: the previous slice's pairs, pushed to the halo
//    buffer `hpar` once a round, lie below the slice, and each step also
//    updates the window positions that a later step still reads
//    (w >= 2o - 1) with the operations their own CTA runs on them, so no
//    pair crosses CTAs there.  A step at o >= S takes its partners from
//    the slice CTA rank - o/S pushed to it once the step's mbarrier
//    completes; the window's last position (the previous slice's last
//    sample, on thread T-1) takes its partner from CTA rank - o/S - 1, so
//    the CTA ends the scan knowing f of the sample before its slice.
// Steps below S go two at a time (o and 2o while 4o <= S), one CTA barrier
// a pair: the thread also computes the step-o pair at i - 2o that the
// step at 2o takes, from i - 2o and i - 3o, the operations its owner runs
// on them.  After the last step below S, and after each pushed step, the
// thread pushes its pairs to the CTA that takes them next.  The trajectory
// goes to f, the left neighbour's f to the left slot.  ph: bit 0 the step
// mbarriers' phase, 6-7 the halo buffers'.
template <int E>
__device__ __forceinline__ void affine_scan(float2 (&v)[E], const Slice& L,
                                            unsigned bars, int C, int S,
                                            int K, int rank, int hpar,
                                            unsigned& ph) {
  const int T = blockDim.x, t = threadIdx.x;
  const int base = K > 1 ? S : 0;          // the slice's place in a buffer
  const bool below = K > 1 && rank > 0;    // a window below the slice
  const unsigned recv = smem_addr(L.recv);
  float2* src = L.a;
  float2* dst = L.b;
  const float2* lo = src;                  // the buffer's positions below S
  float2 hv = make_float2(0.0f, 0.0f);     // thread T-1: window position S-1
  if (K > 1) {
    if (t == 0)
      for (int j = 0, o = 1; o < C; ++j, o <<= 1)
        if (o >= S && rank >= o / S)
          bar_expect(bars + 8 * (kBarStep + j),
                     8 * (S + (rank > o / S ? 1 : 0)));
    if (below) {
      bar_wait(bars + 8 * (kBarHalo + hpar), (ph >> (6 + hpar)) & 1u);
      lo = L.halo + hpar * S;
      if (t == T - 1) hv = lo[S - 1];
      ph ^= 64u << hpar;
    }
  }
  auto at = [&](int pos) { return pos < S ? lo[pos] : src[pos]; };
  int roff = 0;
  for (int j = 0, o = 1; o < C;) {
    int steps = 1;
    if (o < S) {
      const bool pair = 4 * o <= S;
      steps = pair ? 2 : 1;
      if (below) {
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const int w = k * T + t;
          if (w >= (2 << (steps - 1)) * o - 1) {
            float2 a = at(w);
            affine_step(a, at(w - o));
            if (pair) {
              float2 c = at(w - 2 * o);
              affine_step(c, at(w - 3 * o));
              affine_step(a, c);
            }
            dst[w] = a;
            if (w == S - 1) hv = a;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int l = k * T + t;
        const float2 p1 = at(base + (l >= o || below ? l - o : l));
        if (pair) {
          float2 p2 = at(base + (l >= 2 * o || below ? l - 2 * o : l));
          const float2 p3 = at(base + (l >= 3 * o || below ? l - 3 * o : l));
          if (l >= o || below) affine_step(v[k], p1);
          if (l >= 3 * o || below) affine_step(p2, p3);
          if (l >= 2 * o || below) affine_step(v[k], p2);
        } else if (l >= o || below) {
          affine_step(v[k], p1);
        }
      }
    } else {
      const int q = o / S;
      if (rank >= q) {
        bar_wait(bars + 8 * (kBarStep + j), ph & 1u);
#pragma unroll
        for (int k = 0; k < E; ++k)
          affine_step(v[k], L.recv[roff + k * T + t]);
        if (t == T - 1 && rank > q) affine_step(hv, L.recv[roff + S]);
      }
      roff += S + 1;
    }
    const int o2 = o << steps;
    if (o2 < C) {
      if (o2 < S) {
#pragma unroll
        for (int k = 0; k < E; ++k) dst[base + k * T + t] = v[k];
        __syncthreads();
        float2* tmp = src;
        src = dst;
        dst = tmp;
        lo = src;
      } else {
        // step j+steps' partners: the slice to CTA rank + o2/S, its last
        // pair also to the CTA after that
        const int to = rank + o2 / S;
        const int jn = j + steps;
        if (to < K) {
          const unsigned bar = mapa(bars + 8 * (kBarStep + jn), to);
#pragma unroll
          for (int k = 0; k < E; ++k)
            push_f2(mapa(recv + 8u * (roff + k * T + t), to), v[k], bar);
        }
        if (t == T - 1 && to + 1 < K)
          push_f2(mapa(recv + 8u * (roff + S), to + 1), v[E - 1],
                  mapa(bars + 8 * (kBarStep + jn), to + 1));
      }
    }
    j += steps;
    o = o2;
  }
#pragma unroll
  for (int k = 0; k < E; ++k) L.f[k * T + t] = v[k].x;
  if (below && t == T - 1)
    *reinterpret_cast<float*>(
        reinterpret_cast<unsigned char*>(L.a) - kHead + kLeftSlot) = hv.x;
  if (K > 1) ph ^= 1u;
  __syncthreads();
}

// The relaxation of row b's slice at fixed entries (ef, eh) from the
// trajectory in f; leaves the final trajectory in f and returns the rounds
// run and whether the masks settled (the same in every CTA of the row),
// and on the row's last thread the exit hang.  What CTAs of the row tell
// each other they push into each other's shared memory (st.async on an
// mbarrier): the earlier slices' decay summaries, the changed flags, the
// halo, the scan's pairs.  ph: the mbarriers' phases (bit 0 the steps', 1
// the summaries', 2-3 the flags' by round parity, 5 the round parity, 6-7
// the halo buffers').
template <int E>
__device__ void relax_row(const AgcParams& p, const Slice& L, unsigned bars,
                          int b, int rank, float ef, int eh,
                          unsigned live_bits, unsigned& ph, int* rounds_run,
                          bool* settled_out, int* h_out) {
  const int C = p.chunk, S = p.slice, K = p.cluster;
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, wpk = T >> 5;
  const unsigned le = lanes_upto(lane);
  const int base = K > 1 ? S : 0;       // the slice's place in L.a
  const int entry_last = eh > 0 ? eh - p.hang : kNeg;
  const int g0 = rank * S;               // the slice's first sample
  const int* summ = reinterpret_cast<const int*>(
      reinterpret_cast<const unsigned char*>(L.a) - kHead + kSummSlot);
  const int* flags = summ + (kFlagSlot - kSummSlot) / 4;
  const float* left_slot = reinterpret_cast<const float*>(summ) +
                           (kLeftSlot - kSummSlot) / 4;
  unsigned att_prev = 0, clip_prev = 0;
  bool settled = false;
  int rounds = 0, dc_e = 0, last_e = kNeg;
  float2 v[E];
  for (int it = 0; it < p.iters; ++it) {
    rounds = it + 1;
    // the left neighbour of the slice's first sample
    const float left = rank > 0 && t == 0 ? *left_slot : ef;
    // the masks from the trajectory, and each segment's summary
    unsigned att_bits = 0, dec_bits = 0;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int l = k * T + t;
      const float fp = l > 0 ? L.f[l - 1] : left;
      const bool live = (live_bits >> k) & 1u;
      const bool att = live && L.c[l] < fp;
      const bool dec = live && !att;
      att_bits |= (unsigned)att << k;
      dec_bits |= (unsigned)dec << k;
      const unsigned ab = __ballot_sync(kFull, att);
      const unsigned db = __ballot_sync(kFull, dec);
      if (lane == 0) {
        const int s = k * wpk + warp;
        L.seg_cnt[s] = __popc(db);
        L.seg_last[s] = ab ? __popc(db & lanes_upto(31 - __clz(ab))) : kNeg;
      }
    }
    __syncthreads();
    if (warp == 0) {
      const int2 tot = scan_segments(L.seg_cnt, L.seg_last, E * wpk, lane);
      if (lane > rank && lane < K) {        // to every later slice
        const unsigned to = mapa(bars + kSummSlot + 8 * rank, lane);
        const unsigned bar = mapa(bars + 8 * kBarSum, lane);
        push_b32(to, (unsigned)tot.x, bar);
        push_b32(to + 4, (unsigned)tot.y, bar);
      }
    }
    if (rank > 0 && t == 0) bar_expect(bars + 8 * kBarSum, 8 * rank);
    __syncthreads();
    // the decays before the slice and the latest attack's dc before it
    int cnt_in = 0, last_in = kNeg;
    if (rank > 0) {
      bar_wait(bars + 8 * kBarSum, (ph >> 1) & 1u);
      ph ^= 2u;
      int cq = 0, lq = kNeg;
      if (lane < rank) {
        cq = summ[2 * lane];
        lq = summ[2 * lane + 1];
      }
      int incl = cq;
#pragma unroll
      for (int o = 1; o < kMaxCluster; o <<= 1) {
        const int w = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += w;
      }
      cnt_in = __shfl_sync(kFull, incl, kMaxCluster - 1);
      last_in = __reduce_max_sync(kFull, lq != kNeg ? incl - cq + lq : kNeg);
    }
    // the branch of every sample, its affine pair and the clip mask; the
    // pairs also go to the next CTA's halo buffer of this round's parity
    const int hpar = (ph >> 5) & 1u;
    unsigned clip_bits = 0;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int l = k * T + t, g = g0 + l;
      const bool att = (att_bits >> k) & 1u, dec = (dec_bits >> k) & 1u;
      const unsigned ab = __ballot_sync(kFull, att);
      const unsigned db = __ballot_sync(kFull, dec);
      const int s = k * wpk + warp;
      const int before = cnt_in + L.seg_cnt[s];
      const int dc = before + __popc(db & le);
      int last = L.seg_last[s] != kNeg ? cnt_in + L.seg_last[s] : kNeg;
      const unsigned am = ab & le;
      if (am)
        last = max(last, before + __popc(db & lanes_upto(31 - __clz(am))));
      last = max(max(last, last_in), entry_last);
      const bool frozen = dec && last > kNeg / 2 && dc - last <= p.hang;
      const float rate = att ? p.ar : ((dec && !frozen) ? p.dr : 0.0f);
      const float fp = l > 0 ? L.f[l - 1] : left, ci = L.c[l];
      const bool clip =
          __fadd_rn(fp, __fmul_rn(rate, __fsub_rn(ci, fp))) > p.max_gain;
      float mul = clip ? p.oma : __fadd_rn(__fsub_rn(1.0f, rate), p.oma);
      float add = clip ? p.max_gain : __fmul_rn(rate, ci);
      if (g == 0 && b == 0 && !p.started) {
        mul = 1.0f;
        add = 0.0f;
      }
      if (g == 0) add = __fadd_rn(add, __fmul_rn(mul, ef));
      clip_bits |= (unsigned)clip << k;
      v[k] = make_float2(add, mul);
      L.a[base + l] = v[k];
      if (K > 1 && rank + 1 < K)              // the next CTA's halo
        push_f2(mapa(smem_addr(L.halo + hpar * S + l), rank + 1), v[k],
                mapa(bars + 8 * (kBarHalo + hpar), rank + 1));
      if (g == C - 1) {
        dc_e = dc;
        last_e = last;
      }
    }
    // the row's "masks changed": this CTA's, then every CTA's
    const bool changed = att_bits != att_prev || clip_bits != clip_prev;
    int any = __syncthreads_or(changed);
    if (K > 1) {
      const unsigned fbar = bars + 8 * (kBarFlag + hpar);
      if (t < K && t != rank)
        push_b32(mapa(bars + kFlagSlot + 4 * (kMaxCluster * hpar + rank), t),
                 (unsigned)any, mapa(fbar, t));
      if (t == 0) {
        bar_expect(fbar, 4 * (K - 1));
        if (rank > 0) bar_expect(bars + 8 * (kBarHalo + hpar), 8 * S);
      }
      bar_wait(fbar, (ph >> (2 + hpar)) & 1u);
      ph ^= (4u << hpar) | 32u;
      const int theirs = lane < K ? flags[kMaxCluster * hpar + lane] : 0;
      any = __any_sync(kFull, any || (lane != rank && theirs));
    }
    att_prev = att_bits;
    clip_prev = clip_bits;
    if (it > 0 && !any) {
      if (K > 1 && rank > 0) {           // the halo's phase still turns
        bar_wait(bars + 8 * (kBarHalo + hpar), (ph >> (6 + hpar)) & 1u);
        ph ^= 64u << hpar;
      }
      settled = true;
      break;
    }
    affine_scan(v, L, bars, C, S, K, rank, hpar, ph);
  }
  const int h = last_e > kNeg / 2 ? p.hang - (dc_e - last_e) : 0;
  *h_out = min(max(h, 0), p.hang);
  *rounds_run = rounds;
  *settled_out = settled;
}

template <int E>
__global__ void __launch_bounds__(kMaxThreads, 1)
agc_relax_kernel(AgcParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.chunk, S = p.slice, K = p.cluster;
  const int T = blockDim.x, t = threadIdx.x;
  const Slice L = slice_layout(smem, C, S);
  const unsigned bars = smem_addr(smem);
  cg::grid_group grid = cg::this_grid();
  const int rank = (int)cg::this_cluster().block_rank();
  const int clusters = gridDim.x / K, ci = blockIdx.x / K;
  const bool row_end = rank == K - 1 && t == T - 1;   // holds sample C-1
  if (p.smid_out && t == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    p.smid_out[blockIdx.x] = (int)smid;
  }
  unsigned ph = 0;                       // the mbarriers' phases
  if (K > 1) {
    if (t == 0) {
      for (int i = 0; i < kBars; ++i)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(bars + 8 * i) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_sync_all();
  }
  const int rows = p.rows;
  const float f0 = p.f0_ptr ? *p.f0_ptr : p.f0_val;
  const int h0 = p.h0_ptr ? *p.h0_ptr : p.h0_val;
  bool stable = false, all_settled = false;
  unsigned live_bits = 0;
  int r = 0;
  for (; r < rows + 2; ++r) {
    const int cur = r % 3, prev = (r + 2) % 3;
    for (int b = ci; b < rows; b += clusters) {
      // the row's entries: the previous row's exit of the round before
      const bool first = r == 0 || b == 0;
      const float ef = first ? f0 : __ldcg(p.xf + prev * rows + b - 1);
      const int eh = first ? h0 : __ldcg(p.xh + prev * rows + b - 1);
      const long long base = (long long)b * C + (long long)rank * S;
      // a cluster with one row keeps its c, f, live bits and left f in
      // place from one outer round to the next
      if (r == 0 || rows > clusters) {
        live_bits = 0;
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const int l = k * T + t;
          const long long g = base + l;
          const float xv = g < p.n ? __ldg(p.x + g) : 0.0f;
          float cq = 0.0f;
          if (xv != 0.0f) {
            float ax = fabsf(xv);
            ax = ax < 1e-30f ? 1e-30f : ax;      // a NaN stays a NaN
            cq = __fmul_rn(__frcp_rn(ax), p.ref);
          }
          L.c[l] = cq;
          live_bits |= (unsigned)(xv != 0.0f && (g != 0 || p.started)) << k;
          // warm start: the row's last trajectory (the flat entry gain at
          // first)
          L.f[l] = r == 0 ? f0 : __ldcg(p.traj + g);
        }
        if (rank > 0 && t == 0)      // f of the sample before the slice
          *reinterpret_cast<float*>(smem + kLeftSlot) =
              r == 0 ? f0 : __ldcg(p.traj + base - 1);
        __syncthreads();
      }
      int rounds, h;
      bool settled;
      relax_row<E>(p, L, bars, b, rank, ef, eh, live_bits, ph, &rounds,
                   &settled, &h);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int l = k * T + t;
        p.traj[base + l] = L.f[l];
      }
      if (row_end) {
        p.xf[cur * rows + b] = L.f[S - 1];
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
    // the stop test, in every CTA on the same data
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
  for (int b = ci; b < rows; b += clusters) {
    const long long base = (long long)b * C + (long long)rank * S;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const long long g = base + k * T + t;
      if (g < p.n) p.y[g] = __fmul_rn(__ldcg(p.traj + g), __ldg(p.x + g));
    }
    if (row_end) {
      if (b == rows - 1) {
        *p.gain_out = __ldcg(p.traj + p.n - 1);
        *p.hang_out = __ldcg(p.xh + last_round * rows + b);
      }
      if (p.rounds_out)
        for (int q = r; q < rows + 2; ++q) {
          p.rounds_out[(long long)q * rows + b] = 0;
          p.rounds_out[(long long)(rows + 2 + q) * rows + b] = 0;
        }
    }
  }
  if (blockIdx.x == 0 && t == 0) *p.conv_out = stable && all_settled;
  if (K > 1) cluster_sync_all();   // no CTA leaves while another pushes
}

// The probe that sets the kernel's bound: the chain of one affine scan of
// a kMaxChunk-sample row, which no way of running the Hillis-Steele tree
// (it fixes the bits) can shorten.  One warp runs kProbeSteps dependent
// steps a scan, each: the lane's pair stored to shared memory, a warp
// barrier, the partner's previous pair loaded, then the add's product and
// sum (the mul's product beside them).  `scans` scans run twice, the
// second pass timed (clock64, lane 0) into cycles[0]; sink[lane] keeps
// the result.
__global__ void __launch_bounds__(32, 1)
agc_chain_probe_kernel(long long* cycles, float* sink, int scans) {
  __shared__ float2 buf[2][32];
  const int lane = threadIdx.x;
  float2 v = make_float2(1e-3f * (float)(lane + 1), 1.0f);
  long long t0 = 0;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      __syncwarp();
      t0 = clock64();
    }
    for (int s = 0; s < scans; ++s) {
#pragma unroll
      for (int d = 0; d < kProbeSteps; ++d) {
        buf[d & 1][lane] = v;
        __syncwarp();
        affine_step(v, buf[d & 1][(lane - (1 << (d % 5))) & 31]);
      }
    }
  }
  __syncwarp();
  if (lane == 0) cycles[0] = clock64() - t0;
  sink[lane] = __fadd_rn(v.x, v.y);
}

// A cluster of k CTAs a row of `chunk` samples: slices of a multiple of
// 128 samples, at most kMaxSlice, and (k > 1) a power of two, so that a
// scan step's pushed partners of a slice come from one earlier slice.
bool valid_cluster(int chunk, int k) {
  const int s = chunk / k;
  return (k == 1 || k == 2 || k == 4 || k == 8 || k == kMaxCluster) &&
         chunk >= 128 && chunk <= kMaxChunk && chunk % (128 * k) == 0 &&
         s <= kMaxSlice && (k == 1 || (s & (s - 1)) == 0);
}

// Samples a thread: with a CTA an SM (`spread`) as few as a slice allows
// (more warps to hide each step's latency); sharing SMs, kMaxE (the most
// an SM holds).
int samples_a_thread(int slice, int spread) {
  return spread ? (slice + kMaxThreads - 1) / kMaxThreads : kMaxE;
}

using Kernel = void (*)(AgcParams);

Kernel kernel_for(int e) {
  return e == 1 ? agc_relax_kernel<1> : agc_relax_kernel<2>;
}

size_t launch_smem(int chunk, int k, int spread) {
  const size_t need = smem_bytes(chunk, chunk / k);
  return spread && need < (size_t)kSpreadBytes ? (size_t)kSpreadBytes : need;
}

// The kernels' attributes, once: the largest dynamic shared memory a
// launch asks for, clusters of 16 CTAs.
cudaError_t set_attributes() {
  static bool done = false;
  if (done) return cudaSuccess;
  size_t most = kSpreadBytes;
  for (int k = 1; k <= kMaxCluster; k <<= 1)
    for (int chunk = 128 * k; chunk <= kMaxChunk; chunk <<= 1)
      if (valid_cluster(chunk, k) && smem_bytes(chunk, chunk / k) > most)
        most = smem_bytes(chunk, chunk / k);
  for (int e = 1; e <= kMaxE; e <<= 1) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel_for(e), cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)most);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel_for(e), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  done = true;
  return cudaSuccess;
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int chunk, int k, int spread, int grid,
                    cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(chunk / k / samples_a_thread(chunk / k, spread));
  cfg->dynamicSmemBytes = launch_smem(chunk, k, spread);
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Clusters of K CTAs of the kernel that fit on the card at once for a
// chunk, into *fit.
cudaError_t clusters_fit(int chunk, int k, int spread, int* fit) {
  cudaError_t e = set_attributes();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cluster_config(&cfg, attr, chunk, k, spread, k, nullptr);
  return cudaOccupancyMaxActiveClusters(
      fit, (const void*)kernel_for(samples_a_thread(chunk / k, spread)),
      &cfg);
}

}  // namespace

extern "C" {

// The relaxation of x (n float32 on the card) in rows of `chunk` samples
// (a multiple of 128, 128..8192), one cooperative launch of clusters of
// `cluster` CTAs a row (1, 2, 4, 8 or 16; chunk a multiple of 128*cluster,
// at most 2048 samples a CTA, a power of two if cluster > 1), each CTA on
// an SM of its own if `spread`, `resident` clusters at once (what
// csdr_agc_relax_clusters gives for the same layout):
// y (n,) float32, gain_out float32, hang_out int32 and conv_out one byte
// (0/1), each on the card.  The entry gain is f0_ptr[0] (a float32 on the
// card) or, when f0_ptr is null, f0_val; the entry hang likewise.  traj
// (rows*chunk) float32 and xstate (9*rows) int32 are scratch; rounds_out,
// if not null, (2, rows + 2, rows) int32: the inner rounds each row ran in
// each outer round (0 past the last), then whether its masks settled;
// smid_out, if not null, (rows*cluster) int32: each CTA's SM (the grid's
// CTAs first).  Rows past the clusters that fit run in turns.  Returns a
// cudaError_t.
int csdr_agc_relax(const void* x, long long n, int chunk, int iters,
                   int hang, int started, float ref, float ar, float dr,
                   float max_gain, float oma, const void* f0_ptr,
                   float f0_val, const void* h0_ptr, int h0_val, int cluster,
                   int spread, int resident, void* y, void* gain_out, void* hang_out,
                   void* conv_out, void* rounds_out, void* traj, void* xstate,
                   void* smid_out, void* stream) {
  if (x == nullptr || y == nullptr || gain_out == nullptr ||
      hang_out == nullptr || conv_out == nullptr || traj == nullptr ||
      xstate == nullptr || n < 1 || iters < 1 || resident < 1 ||
      !valid_cluster(chunk, cluster) ||
      (n + chunk - 1) / chunk > INT_MAX / 9 / kMaxCluster)
    return (int)cudaErrorInvalidValue;
  AgcParams p;
  p.x = (const float*)x;
  p.n = n;
  p.chunk = chunk;
  p.rows = (int)((n + chunk - 1) / chunk);
  p.iters = iters;
  p.hang = hang;
  p.started = started;
  p.cluster = cluster;
  p.slice = chunk / cluster;
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
  p.smid_out = (int*)smid_out;
  const cudaError_t e = set_attributes();
  if (e != cudaSuccess) return (int)e;
  const int grid = (p.rows < resident ? p.rows : resident) * cluster;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cluster_config(&cfg, attr, chunk, cluster, spread, grid,
                 (cudaStream_t)stream);
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.numAttrs = 2;
  return (int)cudaLaunchKernelEx(
      &cfg, kernel_for(samples_a_thread(p.slice, spread)), p);
}

// Clusters of `cluster` CTAs of the relaxation kernel that fit on the card
// at once for a chunk (with one CTA an SM if `spread`): more rows than
// this run in turns inside each cluster.  Returns 0 on an error or for a
// cluster size the chunk does not take.
int csdr_agc_relax_clusters(int chunk, int cluster, int spread) {
  int fit = 0;
  if (!valid_cluster(chunk, cluster) ||
      clusters_fit(chunk, cluster, spread, &fit) != cudaSuccess)
    return 0;
  return fit;
}

// Threads a CTA of the relaxation kernel runs for a chunk, cluster size
// and layout (0 for a cluster size the chunk does not take).
int csdr_agc_relax_threads(int chunk, int cluster, int spread) {
  if (!valid_cluster(chunk, cluster)) return 0;
  return chunk / cluster / samples_a_thread(chunk / cluster, spread);
}

// The bound's probe: `scans` scans of kProbeSteps dependent Hillis-Steele
// steps on one warp, each a store to shared memory, a warp barrier, the
// partner's load and the add's product and sum; the SM cycles of the
// timed pass go to cycles[0] (int64), each lane's sum to sink[lane]
// (32 float32).
int csdr_agc_chain_probe(void* cycles, void* sink, int scans, void* stream) {
  if (cycles == nullptr || sink == nullptr || scans < 1)
    return (int)cudaErrorInvalidValue;
  agc_chain_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (long long*)cycles, (float*)sink, scans);
  return (int)cudaGetLastError();
}

}  // extern "C"
