// IMA ADPCM 4:1 codec: the encoder one thread per independent stream, the
// decoder one block per stream.
//
// Replaces csdr_tpu's lax.scan over nibbles in csdr_tpu/ops/adpcm.py
// (encode_ima_adpcm's :69, decode_ima_adpcm's :82, and through them the
// waterfall's compress_fft_adpcm_f_u8 :111): no Pallas kernel there.  The
// codec is the reference's (ima_adpcm.c:91-174, the public IMA/DVI
// standard): a serial integer recurrence over the state (prev, index).  A
// Python loop of torch ops in its place launches ~30 kernels a sample.
//
// Contract (kernels/adpcm_cuda.py):
//   encode: x (rows, 2*pairs) int16, state (rows, 2) int32 (prev, index)
//           -> y (rows, pairs) uint8, two nibbles a byte, the first sample
//              in the LOW nibble; state' after the last sample.
//   decode: y (rows, pairs) uint8 -> x (rows, 2*pairs) int16, and state'.
// The step-size table is read as csdr_tpu's gather reads it: a negative
// index counts from the end (index + 89), then clamps to 0..88; a state the
// codec wrote is always in range, so only a carried state's first step can
// tell.  Integer arithmetic only, so the output is its plain version's bit
// for bit by construction.
//
// What bounds it.  Bytes are nothing (a 9 x 4106 waterfall chunk moves
// 92 kB), and so are the operations (44 integer ops an encode step, 23
// a decode step, counted from csdr_tpu's _encode_step and _decode_step).
//
// The encoder is a serial recurrence: a step's nibble needs the state the
// last step left, so its bound is the shortest dependent chain of one
// step, the steps of a row in series, the rows side by side.  Every table
// read, and every value derived from a step size (the seven thresholds T_q,
// the eight dq_q), depends on index alone, and index moves by one of five
// amounts a step: each can be read and derived ahead for every index the
// state can reach, and picked by the same selects that pick prev.  What is
// left between prev and prev', with d = sample - prev:
//   level 1: the 15 compares that place d among -T7..-T1, 0, T1..T7 (as
//            prev >= sample + T_q, prev > sample, prev <= sample - T_q),
//            side by side with the 16 candidates of prev', one fused
//            add-clamp each (min(prev + dq_q, 32767), max(prev - dq_q,
//            -32768); VIADDMNMX on sm_90);
//   levels 2-5: a 16-way select by those compares, four 2:1 SELs deep.
// index' (and the step values read ahead for it) come out of the same
// select tree, no later.  csdr_adpcm_chain_probe kind 0 runs this chain on
// the card and reads its SM cycles: the bound is steps x those cycles at
// the top SM clock.
//
// The decoder waits on no such chain.  Its updates index' = clamp(index +
// adjust(nibble), 0, 88) and then prev' = clamp(prev + dq(step[index],
// nibble)) are clamped adds of known amounts, and clamped adds compose
// into clamped adds, min(max(x + a, lo), hi): each sequence is a prefix
// scan of ceil(log2 steps) levels, each level's longest path one
// max(x + a, lo) then one min (kind 1 of the probe).  Its bound is the
// larger of the bytes and those 2 x ceil(log2 steps) levels.
//
// Encoder design.  A thread a row, 32 rows a block, the state in registers:
// prev, and e, the packed entry of the current step size,
//   e = step << 16 | m << 12 | index << 5,
// so step, step>>1, >>2 and >>3 are one shift of e each, m is the magnitude
// that led here, and index << 5 is the byte offset of index's row in the
// shared table NEXT[89][8]: NEXT[i][m] is the entry of clamp(i + adjust(m),
// 0, 88), the step size a magnitude m leads to.  A step:
//   - reads its row of eight leaves (two 16-byte shared loads) as soon as e
//     is picked, a whole step before the leaves are needed, so no table
//     read sits on the chain;
//   - runs csdr_tpu's three compare-subtract stages as one add and one
//     unsigned min each (VIADDMNMX.U32): min(q - s, q) is q - s when
//     s <= q, else q, since q - s wraps above q.  The last remainder q0
//     gives T_m = |d| - q0, the largest of the seven thresholds T_q (sums
//     of step, step>>1, step>>2) that |d| reaches; the three stage
//     compares (b2, b1, b0, m = 4 b2 + 2 b1 + b0) pick the next e among
//     the eight leaves, b2 first, side by side with the stages;
//   - prev' = clamp(prev +- ((step>>3) + T_m)) is clamp(sample + (step>>3)
//     - q0) for d >= 0 and clamp(sample - (step>>3) + q0) for d < 0, both
//     formed beside the stages' end and picked by the sign: one side of
//     each clamp binds only while prev is out of range, at a carried
//     state's first step.
// The dependent chain is seven operations a step (d, |d|, three stages,
// the add-clamp, the select).  The card runs 32-bit integer operations
// at 64 lanes an SM a cycle, half its FP32 rate, so for one row the ~33
// instructions of a step weigh as much as the chain does.  The first
// step's leaves are computed from the carried index itself, so an
// out-of-range index takes the same reads as csdr_tpu.  Samples are read
// two at a time as one 32-bit word (rows hold an even count), eight words
// ahead of their steps; a byte is written a pair.
//
// Decoder design.  One block a row, up to 1024 threads, each a contiguous
// segment of nibbles.  Every thread takes the first nibble straight from
// the carried state (its index may be out of range, where the composition
// below is exact only on the domain), so the scans start from an in-range
// state (prev1, index1).  Then:
//   pass 1  each thread composes its segment's index functions; a block
//           scan (warp shuffles, then the 32 warp totals in shared memory)
//           gives the composition of all earlier segments, applied to
//           index1: the segment's first index;
//   pass 2  replaying the index from there, each thread looks up (signed
//           dq, next index's row) in a shared table DEC[89][16] and
//           composes its segment's prev functions; a second block scan
//           gives its first prev;
//   pass 3  the replay again, now writing prev after every nibble.
// A composition's offset is clamped to +-88 (index) or +-65535 (prev):
// past that every x of the domain already lands on lo or hi, so the
// function is unchanged, and a row of saturating nibbles (61 436 a step)
// cannot overflow int32.  Segment boundaries fall on 32-byte boundaries of
// the output, so each 16 samples leave as two 16-byte stores; a row's
// edges take scalar stores.  Nibbles are read a byte each (rows need no
// alignment), a group's bytes while the group before runs; the three
// passes read the same bytes, from L1 after the first.  One launch a call,
// whatever the row length; no host sync, no allocation (the launch may be
// captured in a CUDA graph).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 32;   // encoder: a thread a row
constexpr int kMaxScanThreads = 1024;   // decoder: threads a row's block
constexpr int kSteps = 89;
constexpr int kIndexK = 88;         // offset clamps of the compositions
constexpr int kPrevK = 65535;

__constant__ int kStepSizes[kSteps] = {
    7,     8,     9,     10,    11,    12,    13,    14,    16,    17,
    19,    21,    23,    25,    28,    31,    34,    37,    41,    45,
    50,    55,    60,    66,    73,    80,    88,    97,    107,   118,
    130,   143,   157,   173,   190,   209,   230,   253,   279,   307,
    337,   371,   408,   449,   494,   544,   598,   658,   724,   796,
    876,   963,   1060,  1166,  1282,  1411,  1552,  1707,  1878,  2066,
    2272,  2499,  2749,  3024,  3327,  3660,  4026,  4428,  4871,  5358,
    5894,  6484,  7132,  7845,  8630,  9493,  10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int clamp_index(int i) {
  return clampi(i, 0, kSteps - 1);
}

// csdr_tpu's _STEPS[index]: a negative index counts from the end, then the
// gather clamps.
__device__ __forceinline__ int read_index(int i) {
  return clamp_index(i < 0 ? i + kSteps : i);
}

// int32 addition that wraps, as the plain versions' torch arithmetic does
// (a carried state may hold any int32)
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// INDEX_ADJUST[delta]: -1 without the 4 bit, else 2, 4, 6, 8 by the low two.
__device__ __forceinline__ int index_adjust(int delta) {
  return (delta & 4) ? 2 * ((delta & 3) + 1) : -1;
}

// dq of csdr_tpu's _decode_step, negative with the sign bit
__device__ __forceinline__ int signed_dq(int step, int delta) {
  int diff = step >> 3;
  if (delta & 1) diff += step >> 2;
  if (delta & 2) diff += step >> 1;
  if (delta & 4) diff += step;
  return (delta & 8) ? -diff : diff;
}

// ----------------------------------------------------------------- encoder

// e for step size index j reached by magnitude m (the note's packing)
__device__ __forceinline__ int enc_entry(int j, int m) {
  return (kStepSizes[j] << 16) | (m << 12) | (j << 5);
}

// One encoder step: the nibble; prev, e and the leaves of the next step
// (r0 = leaves 0..3, r1 = 4..7) updated.  csdr_tpu's three compare-subtract
// stages are one add and one unsigned min each: a difference that goes
// negative wraps above its minuend, so min(q - s, q) is q - s when s <= q
// and q otherwise.  What is left, q0, gives T_m = |d| - q0, and csdr_tpu's
// prev' = clamp(prev +- ((step>>3) + T_m)) is clamp(sample + (step>>3) -
// q0) for d >= 0 and clamp(sample - (step>>3) + q0) for d < 0.  Once prev
// is in range (every step but a carried state's first: FIRST), one side of
// each clamp cannot bind.  The selects are written in PTX (setp, selp): as
// C++ ternaries on the leaves the compiler turned them into divergent
// branches.
template <bool FIRST>
__device__ __forceinline__ int encode_step(int sample, int& prev, int& e,
                                           int4& r0, int4& r1,
                                           const int* next) {
  const unsigned step = e >> 16, s1 = e >> 17, s2 = e >> 18;
  const int s3 = e >> 19;
  const int d = sample - prev;
  const unsigned ad = abs(d);
  const int up = sample + s3, down = sample - s3;
  const unsigned q2 = min(ad - step, ad);
  const unsigned q1 = min(q2 - s1, q2);
  const int q0 = (int)min(q1 - s2, q1);
  const int pos = FIRST ? clampi(up - q0, -32768, 32767) : min(up - q0, 32767);
  const int neg = FIRST ? clampi(down + q0, -32768, 32767)
                        : max(down + q0, -32768);
  // the leaf of m = 4 b2 + 2 b1 + b0, b2 first (it is known first), and
  // prev' by the sign
  int en, pn;
  asm("{\n\t"
      ".reg .pred b2, b1, b0, sg;\n\t"
      ".reg .b32 a0, a1, a2, a3, c0, c1;\n\t"
      "setp.ge.u32 b2, %2, %3;\n\t"
      "setp.ge.u32 b1, %4, %5;\n\t"
      "setp.ge.u32 b0, %6, %7;\n\t"
      "setp.lt.s32 sg, %16, 0;\n\t"
      "selp.b32 a0, %12, %8, b2;\n\t"
      "selp.b32 a1, %13, %9, b2;\n\t"
      "selp.b32 a2, %14, %10, b2;\n\t"
      "selp.b32 a3, %15, %11, b2;\n\t"
      "selp.b32 c0, a2, a0, b1;\n\t"
      "selp.b32 c1, a3, a1, b1;\n\t"
      "selp.b32 %1, %17, %18, sg;\n\t"
      "selp.b32 %0, c1, c0, b0;\n\t"
      "}"
      : "=r"(en), "=r"(pn)
      : "r"(ad), "r"(step), "r"(q2), "r"(s1), "r"(q1), "r"(s2), "r"(r0.x),
        "r"(r0.y), "r"(r0.z), "r"(r0.w), "r"(r1.x), "r"(r1.y), "r"(r1.z),
        "r"(r1.w), "r"(d), "r"(neg), "r"(pos));
  prev = pn;
  e = en;
  const int4* row = reinterpret_cast<const int4*>(
      reinterpret_cast<const char*>(next) + (en & 0xfe0));
  r0 = row[0];
  r1 = row[1];
  return ((en >> 12) & 7) | ((d >> 28) & 8);
}

// The samples of a row are read kPairsAhead pairs (32-bit words) ahead of
// their steps, so the load of the next words overlaps the steps of these.
constexpr int kPairsAhead = 8;

__global__ void __launch_bounds__(kRowsPerBlock)
adpcm_encode_kernel(const int* __restrict__ x, uint8_t* __restrict__ y,
                    const int* __restrict__ state_in,
                    int* __restrict__ state_out, int rows, long long pairs) {
  __shared__ __align__(16) int next[kSteps * 8];
  for (int k = threadIdx.x; k < kSteps * 8; k += blockDim.x)
    next[k] = enc_entry(clamp_index(k / 8 + index_adjust(k % 8)), k % 8);
  __syncthreads();
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  int prev = state_in[2 * row];
  const int index = state_in[2 * row + 1];
  // the first step: its step size read as csdr_tpu reads it, its leaves
  // from the carried index itself, prev clamped on both sides
  int e = kStepSizes[read_index(index)] << 16;
  int leaf[8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
    leaf[m] = enc_entry(clamp_index(wrap_add(index, index_adjust(m))), m);
  int4 r0 = make_int4(leaf[0], leaf[1], leaf[2], leaf[3]);
  int4 r1 = make_int4(leaf[4], leaf[5], leaf[6], leaf[7]);
  const int* xr = x + row * pairs;         // two int16 a word
  uint8_t* yr = y + row * pairs;
  const int w0 = __ldg(xr);
  {
    const int d0 = encode_step<true>((int)((unsigned)w0 << 16) >> 16, prev,
                                     e, r0, r1, next);
    const int d1 = encode_step<false>(w0 >> 16, prev, e, r0, r1, next);
    yr[0] = (uint8_t)(d0 | (d1 << 4));
  }
  auto pair = [&](int w, long long p) {
    const int lo = (int)((unsigned)w << 16) >> 16;   // the first sample
    const int d0 = encode_step<false>(lo, prev, e, r0, r1, next);
    const int d1 = encode_step<false>(w >> 16, prev, e, r0, r1, next);
    yr[p] = (uint8_t)(d0 | (d1 << 4));
  };
  // the pairs after the first, kPairsAhead at a time, the next ones loaded
  // while these run
  long long p = 1;
  int w[kPairsAhead];
  if (p + kPairsAhead <= pairs) {
#pragma unroll
    for (int j = 0; j < kPairsAhead; ++j) w[j] = __ldg(xr + p + j);
  }
  for (; p + kPairsAhead <= pairs; p += kPairsAhead) {
    int ahead[kPairsAhead];
    if (p + 2 * kPairsAhead <= pairs) {
#pragma unroll
      for (int j = 0; j < kPairsAhead; ++j)
        ahead[j] = __ldg(xr + p + kPairsAhead + j);
    }
#pragma unroll
    for (int j = 0; j < kPairsAhead; ++j) pair(w[j], p + j);
#pragma unroll
    for (int j = 0; j < kPairsAhead; ++j) w[j] = ahead[j];
  }
  for (; p < pairs; ++p) pair(__ldg(xr + p), p);
  state_out[2 * row] = prev;
  state_out[2 * row + 1] = (e & 0xfe0) >> 5;
}

// ----------------------------------------------------------------- decoder

// x -> clamp(x + a, lo, hi)
struct Fn {
  int a, lo, hi;
};

// g after f; the offset clamped to +-k (exact on the domain: the note)
__device__ __forceinline__ Fn then(Fn f, Fn g, int k) {
  return {clampi(f.a + g.a, -k, k), clampi(f.lo + g.a, g.lo, g.hi),
          clampi(f.hi + g.a, g.lo, g.hi)};
}

__device__ __forceinline__ int apply(Fn f, int x) {
  return clampi(x + f.a, f.lo, f.hi);
}

__device__ __forceinline__ Fn shfl_up(Fn f, int o) {
  return {__shfl_up_sync(0xffffffffu, f.a, o),
          __shfl_up_sync(0xffffffffu, f.lo, o),
          __shfl_up_sync(0xffffffffu, f.hi, o)};
}

// The composition of the functions of all lower threads of the block (id
// for thread 0).  blockDim.x is a multiple of 32; part holds 32 Fn.
__device__ Fn block_exclusive_scan(Fn f, Fn id, int k, Fn* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Fn p = shfl_up(f, o);
    if (lane >= o) f = then(p, f, k);
  }
  if (lane == 31) part[warp] = f;
  __syncthreads();
  if (warp == 0) {
    Fn w = lane < warps ? part[lane] : id;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Fn p = shfl_up(w, o);
      if (lane >= o) w = then(p, w, k);
    }
    part[lane] = w;
  }
  __syncthreads();
  Fn ex = shfl_up(f, 1);
  if (lane == 0) ex = id;
  const Fn r = warp > 0 ? then(part[warp - 1], ex, k) : ex;
  __syncthreads();                        // part is reused by the next scan
  return r;
}

__device__ __forceinline__ int nibble_at(const uint8_t* in, int k) {
  return (__ldg(in + (k >> 1)) >> ((k & 1) << 2)) & 15;
}

// Calls f(n, j, k) for the nibbles k of [b, e) in order: j is k's place in
// its group of 16 that starts on a 32-byte boundary of the output (a
// constant inside the unrolled full groups), or -1 outside full groups;
// g(k) follows each full group at k.  (k + a) % 16 == 0 starts a group; a
// group's 8 bytes are loaded while the group before it runs.
template <class F, class G>
__device__ __forceinline__ void for_nibbles(const uint8_t* in, int b, int e,
                                            int a, F f, G g) {
  int k = b;
  for (; k < e && ((k + a) & 15); ++k) f(nibble_at(in, k), -1, k);
  int by[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    by[j] = k + 16 <= e ? __ldg(in + (k >> 1) + j) : 0;
  for (; k + 16 <= e; k += 16) {
    int ahead[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      ahead[j] = k + 32 <= e ? __ldg(in + (k >> 1) + 8 + j) : 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      f((by[j >> 1] >> ((j & 1) * 4)) & 15, j, k + j);
    g(k);
#pragma unroll
    for (int j = 0; j < 8; ++j) by[j] = ahead[j];
  }
  for (; k < e; ++k) f(nibble_at(in, k), -1, k);
}

__global__ void __launch_bounds__(kMaxScanThreads)
adpcm_decode_kernel(const uint8_t* __restrict__ y, short* __restrict__ x,
                    const int* __restrict__ state_in,
                    int* __restrict__ state_out, int len, int seg) {
  // DEC[i][n] = signed dq << 13 | 64 * next index (the byte offset of the
  // next index's row), for index i and nibble n; ADJ[n] = INDEX_ADJUST[n]
  __shared__ int dec[kSteps * 16];
  __shared__ int adj[16];
  __shared__ Fn part[32];
  for (int k = threadIdx.x; k < kSteps * 16; k += blockDim.x)
    dec[k] = signed_dq(kStepSizes[k >> 4], k & 15) * 8192
             | clamp_index(k / 16 + index_adjust(k & 15)) * 64;
  if (threadIdx.x < 16) adj[threadIdx.x] = index_adjust(threadIdx.x);
  __syncthreads();
  const char* row_of = reinterpret_cast<const char*>(dec);
  const long long row = blockIdx.x;
  const uint8_t* in = y + row * (len / 2);
  short* out = x + row * len;
  const int a = (int)((reinterpret_cast<uintptr_t>(out) >> 1) & 15);
  const int t = threadIdx.x;
  // the first nibble, from the carried state
  const int prev0 = state_in[2 * row], index0 = state_in[2 * row + 1];
  const int n0 = __ldg(in) & 15;
  const int prev1 = clampi(
      wrap_add(prev0, signed_dq(kStepSizes[read_index(index0)], n0)),
      -32768, 32767);
  const int index1 = clamp_index(wrap_add(index0, index_adjust(n0)));
  // this thread's nibbles [b, e): boundaries on 32-byte output boundaries
  const int b = t == 0 ? 1 : min(len, t * seg - a);
  const int e = min(len, (t + 1) * seg - a);

  // pass 1: the index functions
  const Fn index_id{0, 0, kSteps - 1};
  Fn g = index_id;
  for_nibbles(in, b, e, a, [&](int n, int j, int) {
    const int da = adj[n];
    g.a = (j < 0 || j == 15) ? clampi(g.a + da, -kIndexK, kIndexK)
                             : g.a + da;
    g.lo = clamp_index(g.lo + da);
    g.hi = clamp_index(g.hi + da);
  }, [](int) {});
  const int i0 = 64 * apply(block_exclusive_scan(g, index_id, kIndexK, part),
                            index1);

  // pass 2: the prev functions, the index replayed (as its row's offset)
  const Fn prev_id{0, -32768, 32767};
  Fn h = prev_id;
  int i = i0;
  for_nibbles(in, b, e, a, [&](int n, int j, int) {
    const int d = *reinterpret_cast<const int*>(row_of + i + 4 * n);
    const int dq = d >> 13;
    i = d & 0x1fc0;
    h.a = (j < 0 || j == 15) ? clampi(h.a + dq, -kPrevK, kPrevK) : h.a + dq;
    h.lo = clampi(h.lo + dq, -32768, 32767);
    h.hi = clampi(h.hi + dq, -32768, 32767);
  }, [](int) {});
  int p = apply(block_exclusive_scan(h, prev_id, kPrevK, part), prev1);

  // pass 3: the samples
  if (t == 0) out[0] = (short)prev1;
  i = i0;
  unsigned v[8] = {};
  for_nibbles(in, b, e, a, [&](int n, int j, int k) {
    const int d = *reinterpret_cast<const int*>(row_of + i + 4 * n);
    p = clampi(p + (d >> 13), -32768, 32767);
    i = d & 0x1fc0;
    if (j < 0)
      out[k] = (short)p;
    else if (j & 1)
      v[j >> 1] |= (unsigned)p << 16;
    else
      v[j >> 1] = (unsigned)p & 0xffffu;
  }, [&](int k) {
    uint4* o = reinterpret_cast<uint4*>(out + k);
    o[0] = make_uint4(v[0], v[1], v[2], v[3]);
    o[1] = make_uint4(v[4], v[5], v[6], v[7]);
  });
  if (b < e && e == len) {                // the thread of the last nibble
    state_out[2 * row] = p;
    state_out[2 * row + 1] = i / 64;
  }
}

// The probe that sets this kernel's bound (see the note above): one thread
// runs `iters` links of a dependent chain on values the compiler cannot
// know and writes the SM cycles they took (clock64) to cycles[0].  An
// empty asm after each link keeps the compiler from reshaping the chain
// (an add sunk below a select would lengthen it).
//   KIND 0: the encoder step's shortest chain: four compares and five
//           fused add-clamps of x side by side, then four 2:1 selects in
//           series, each on its own compare (a 16-way select's depth).
//   KIND 1: one level of the decoder's scan: min(max(x + a, b), h).
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

template <int KIND>
__global__ void chain_probe_kernel(long long* cycles, int* sink, int iters,
                                   int x, int a, int b, int c, int d, int h) {
  if (threadIdx.x != 0) return;
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < iters; ++i) {
    if (KIND == 0) {
      const bool p0 = x >= a, p1 = x >= b, p2 = x >= c, p3 = x >= d;
      const int l0 = opaque(min(x + a, h)), l1 = opaque(min(x + b, h));
      const int l2 = opaque(min(x + c, h)), l3 = opaque(min(x + d, h));
      const int l4 = opaque(max(x - a, -h));
      int s = opaque(p0 ? l1 : l0);
      s = opaque(p1 ? s : l2);
      s = opaque(p2 ? s : l3);
      x = p3 ? s : l4;
    } else {
      x = min(max(x + a, b), h);
    }
    x = opaque(x);
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = x;
}

bool bad_args(const void* in, const void* out, const void* state_in,
              const void* state_out, int rows, long long pairs) {
  return rows < 0 || pairs < 0 || in == nullptr || out == nullptr ||
         state_in == nullptr || state_out == nullptr;
}

}  // namespace

extern "C" {

// Encode `rows` streams of 2*pairs int16 samples (contiguous, 4-byte
// aligned) into rows x pairs bytes; state_in and state_out are rows x 2
// int32 (prev, index) and may not alias the data.  Returns a cudaError_t.
int csdr_adpcm_encode(const void* x, void* y, const void* state_in,
                      void* state_out, int rows, long long pairs,
                      void* stream) {
  if (bad_args(x, y, state_in, state_out, rows, pairs) ||
      ((uintptr_t)x & 3))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  adpcm_encode_kernel<<<blocks, kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      (const int*)x, (uint8_t*)y, (const int*)state_in, (int*)state_out,
      rows, pairs);
  return (int)cudaGetLastError();
}

// Decode rows x pairs bytes into rows x 2*pairs int16 samples (4-byte
// aligned); the state as for the encoder.  One block a row: a row holds at
// most 2^29 pairs.
int csdr_adpcm_decode(const void* y, void* x, const void* state_in,
                      void* state_out, int rows, long long pairs,
                      void* stream) {
  if (bad_args(y, x, state_in, state_out, rows, pairs) ||
      ((uintptr_t)x & 3) || pairs > (1ll << 29))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || pairs == 0) return 0;
  const int len = (int)(2 * pairs);
  // about 16 nibbles a thread or more; segments a multiple of 16 nibbles,
  // long enough that the threads cover the row after its 32-byte offset
  int threads = (len / 16 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > kMaxScanThreads ? kMaxScanThreads
                                                          : threads;
  const int seg = ((len + 14 + threads - 1) / threads + 15) / 16 * 16;
  adpcm_decode_kernel<<<rows, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (short*)x, (const int*)state_in, (int*)state_out,
      len, seg);
  return (int)cudaGetLastError();
}

// Run the latency probe (kind 0: the encoder step's shortest chain, 1: a
// level of the decoder's scan) for `iters` links on one thread; the SM
// cycles go to cycles[0] (int64) and the chain's end to sink[0] (int32).
int csdr_adpcm_chain_probe(void* cycles, void* sink, int kind, int iters,
                           void* stream) {
  if (cycles == nullptr || sink == nullptr || iters < 1 || kind < 0 ||
      kind > 1)
    return (int)cudaErrorInvalidValue;
  // operands the compiler cannot see: thresholds and offsets of a step
  const int x = 1000, a = 7, b = 300, c = 900, d = 1500, h = 32767;
  if (kind == 0)
    chain_probe_kernel<0><<<1, 32, 0, (cudaStream_t)stream>>>(
        (long long*)cycles, (int*)sink, iters, x, a, b, c, d, h);
  else
    chain_probe_kernel<1><<<1, 32, 0, (cudaStream_t)stream>>>(
        (long long*)cycles, (int*)sink, iters, x, a, -b, h, d, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
