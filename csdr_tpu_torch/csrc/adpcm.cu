// IMA ADPCM 4:1 codec, encode and decode, one thread per independent stream.
//
// Replaces csdr_tpu's lax.scan over nibbles in csdr_tpu/ops/adpcm.py
// (encode_ima_adpcm's :69, decode_ima_adpcm's :82, and through them the
// waterfall's compress_fft_adpcm_f_u8 :111): no Pallas kernel there.  The
// codec is the reference's (ima_adpcm.c:91-174, the public IMA/DVI
// standard): a serial integer recurrence over the state (prev, index), so
// on a GPU it is one thread per stream, the state in registers.  A Python
// loop of torch ops in its place issues ~30 launches a sample.
//
// Contract (kernels/adpcm_cuda.py):
//   encode: x (rows, 2*pairs) int16, state (rows, 2) int32 (prev, index)
//           -> y (rows, pairs) uint8, two nibbles a byte, the first sample
//              in the LOW nibble; state' after the last sample.
//   decode: y (rows, pairs) uint8 -> x (rows, 2*pairs) int16, and state'.
// The table read clamps index to 0..88 (XLA's gather clamps the same way);
// a state the codec wrote is always in range.  Integer arithmetic only, so
// the output is its plain version's bit for bit by construction.
//
// What bounds it.  Bytes are nothing (a 9 x 4106 waterfall chunk moves
// 92 kB), and so are the operations (44 integer ops an encode step, 23
// a decode step, counted from csdr_tpu's _encode_step and _decode_step).
//
// The encoder is a serial recurrence: a step's nibble needs the state the
// last step left, so its bound is the shortest dependent chain of one
// step, the steps of a row in series, the rows side by side.  That chain
// is shorter than this kernel's.  Every table read, and every value
// derived from a step size (the seven thresholds T_q, the eight dq_q),
// depends on index alone, and index moves by one of five amounts a step:
// each can be read and derived some steps ahead for every index the state
// can reach, and picked by the same selects that pick prev.  What is left
// between prev and prev', with d = sample - prev:
//   level 1: the 15 compares that place d among -T7..-T1, 0, T1..T7 (as
//            prev >= sample + T_q, prev > sample, prev <= sample - T_q),
//            side by side with the 16 candidates of prev', one fused
//            add-clamp each (min(prev + dq_q, 32767), max(prev - dq_q,
//            -32768); VIADDMNMX on sm_90);
//   levels 2-5: a 16-way select by those compares, four 2:1 SELs deep.
// index' (and the step values read ahead for it) come out of the same
// select tree, no later.  csdr_adpcm_chain_probe kind 0 runs this chain on
// the card and reads its SM cycles: the bound is steps x those cycles at
// the top SM clock.  This kernel's step is longer: it reads the table on
// the chain, then compares, subtracts and selects in series.
//
// The decoder waits on no such chain.  Its updates index' = clamp(index +
// adjust(nibble), 0, 88) and then prev' = clamp(prev + dq(step[index],
// nibble)) are clamped adds of known amounts, and clamped adds compose
// into clamped adds, min(max(x + a, lo), hi): each sequence is a prefix
// scan of ceil(log2 steps) levels, each level's longest path one
// max(x + a, lo) then one min (kind 1 of the probe).  Its bound is the
// larger of the bytes and those 2 x ceil(log2 steps) levels.  This kernel
// runs the decoder serially, one thread a stream, far above that bound.
//
// Design: the 89-entry step table lives in __constant__ memory and is
// copied once into shared memory by each block: the rows of a warp read
// different entries, which the constant cache would serialise.  The index
// adjustment is computed (-1, or 2, 4, 6, 8), not read.  Samples are read
// two at a time as one 32-bit word (rows hold an even count), a byte is
// written a pair; the loads do not depend on the chain, so the unrolled
// loop issues them ahead.  32 rows a block: rows spread over SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 32;
constexpr int kSteps = 89;

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

struct State {
  int prev;
  int index;
};

__device__ __forceinline__ int clamp_index(int i) {
  return min(max(i, 0), kSteps - 1);
}

// INDEX_ADJUST[delta]: -1 without the 4 bit, else 2, 4, 6, 8 by the low two.
__device__ __forceinline__ int index_adjust(int delta) {
  return (delta & 4) ? 2 * ((delta & 3) + 1) : -1;
}

// The decoder's step (csdr_tpu _decode_step): the new prev.
__device__ __forceinline__ int decode_step(State& s, int delta,
                                           const int* steps) {
  const int step = steps[clamp_index(s.index)];
  int diff = step >> 3;
  if (delta & 1) diff += step >> 2;
  if (delta & 2) diff += step >> 1;
  if (delta & 4) diff += step;
  if (delta & 8) diff = -diff;
  s.prev = min(max(s.prev + diff, -32768), 32767);
  s.index = clamp_index(s.index + index_adjust(delta));
  return s.prev;
}

// The encoder's step (csdr_tpu _encode_step): the nibble, then the state
// the decoder reaches on it.
__device__ __forceinline__ int encode_step(State& s, int sample,
                                           const int* steps) {
  const int step = steps[clamp_index(s.index)];
  int diff = sample - s.prev;
  const int sign = diff < 0;
  if (sign) diff = -diff;
  const int b2 = diff >= step;
  if (b2) diff -= step;
  const int step1 = step >> 1;
  const int b1 = diff >= step1;
  if (b1) diff -= step1;
  const int b0 = diff >= (step1 >> 1);
  const int delta = (sign << 3) | (b2 << 2) | (b1 << 1) | b0;
  decode_step(s, delta, steps);
  return delta;
}

template <bool ENCODE>
__global__ void __launch_bounds__(kRowsPerBlock)
adpcm_kernel(const void* __restrict__ in, void* __restrict__ out,
             const int* __restrict__ state_in, int* __restrict__ state_out,
             int rows, long long pairs) {
  __shared__ int steps[kSteps];
  for (int i = threadIdx.x; i < kSteps; i += blockDim.x)
    steps[i] = kStepSizes[i];
  __syncthreads();
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  State s{state_in[2 * row], state_in[2 * row + 1]};
  if (ENCODE) {
    const int* x = (const int*)in + row * pairs;       // two int16 a word
    uint8_t* y = (uint8_t*)out + row * pairs;
#pragma unroll 4
    for (long long p = 0; p < pairs; ++p) {
      const int w = __ldg(x + p);
      const int lo = (int)((unsigned)w << 16) >> 16;   // the first sample
      const int hi = w >> 16;
      const int d0 = encode_step(s, lo, steps);
      const int d1 = encode_step(s, hi, steps);
      y[p] = (uint8_t)(d0 | (d1 << 4));
    }
  } else {
    const uint8_t* x = (const uint8_t*)in + row * pairs;
    unsigned* y = (unsigned*)out + row * pairs;
#pragma unroll 4
    for (long long p = 0; p < pairs; ++p) {
      const int b = __ldg(x + p);
      const int s0 = decode_step(s, b & 15, steps);
      const int s1 = decode_step(s, b >> 4, steps);
      y[p] = ((unsigned)s0 & 0xffffu) | ((unsigned)s1 << 16);
    }
  }
  state_out[2 * row] = s.prev;
  state_out[2 * row + 1] = s.index;
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

template <bool ENCODE>
int launch(const void* in, void* out, const void* state_in, void* state_out,
           int rows, long long pairs, void* stream) {
  if (rows < 0 || pairs < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (in == nullptr || out == nullptr || state_in == nullptr ||
      state_out == nullptr || ((uintptr_t)(ENCODE ? in : out) & 3))
    return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  adpcm_kernel<ENCODE><<<blocks, kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      in, out, (const int*)state_in, (int*)state_out, rows, pairs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Encode `rows` streams of 2*pairs int16 samples (contiguous, 4-byte
// aligned) into rows x pairs bytes; state_in and state_out are rows x 2
// int32 (prev, index) and may not alias the data.  Returns a cudaError_t.
int csdr_adpcm_encode(const void* x, void* y, const void* state_in,
                      void* state_out, int rows, long long pairs,
                      void* stream) {
  return launch<true>(x, y, state_in, state_out, rows, pairs, stream);
}

// Decode rows x pairs bytes into rows x 2*pairs int16 samples (4-byte
// aligned); the state as for the encoder.
int csdr_adpcm_decode(const void* y, void* x, const void* state_in,
                      void* state_out, int rows, long long pairs,
                      void* stream) {
  return launch<false>(y, x, state_in, state_out, rows, pairs, stream);
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
