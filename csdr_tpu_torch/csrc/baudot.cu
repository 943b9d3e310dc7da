// The RTTY Baudot decoder: the reference's start/stop-pulse state machine
// over bit symbols, one warp a row with one thread running the machine.
//
// Replaces csdr_tpu's lax.scan in csdr_tpu/ops/digital.py:182
// (rtty_baudot_decoder, :130-187); no Pallas kernel there.  In eager torch
// it was a Python loop of ~60 small ops a symbol, and the CLI's
// rtty_line_decoder_u8_u8 ran it on the host.
//
// Contract (kernels/baudot_cuda.py; decode_plain is the same loop on
// tensors, with the compaction of ops/digital, bit for bit):
//   sym (R, n) uint8, a symbol 1 where nonzero, n >= 1; the letters and
//   figures tables (32,) int32 on the card; the state in as five (R,)
//   int32 tensors (machine state, figures mode, shift register, bit
//   counter, char received), the next state out to five fresh ones;
//   data (R, cap) uint8: the row's emitted characters packed to the front,
//   zeros after, the ones past cap dropped; count (R,) int32, at most cap.
// A symbol (the reference libcsdr.c:1622-1654, csdr_tpu's step; a state
// other than 0, 1 and 2 takes the step's where-chains as they read):
//   code = shr & 31;  ch = fig ? figures[code] : letters[code]
//   state 0 (waiting for the stop pulse): on a 1, if rcvd: a figures or
//     letters select code sets fig, any other code emits ch where ch != 0;
//     then state 1; on a 0, rcvd = 0
//   state 1 (waiting for the start pulse): on a 0, state 2, shr = cnt = 0;
//     rcvd = 0
//   else (receiving): shr = ((shr << 1) | sym) & 0xFFFF, cnt += 1 (both
//     only in state 2); after the fifth bit (cnt was 4) state 0, rcvd = 1
// Integer arithmetic wraps as torch's int32 does (unsigned here).
//
// What bounds it.  Bytes: a byte a symbol in, about a seventh out.  The
// machine is a chain of a few integer operations a symbol: its state
// feeds the next symbol's transition, while the table read and the emit
// hang off it; the bound is symbols x the transition, branch-free, in SM
// cycles at the top SM clock, timed on one thread from shared memory by
// csdr_baudot_chain_probe below.  Design: the
// lanes stage a tile of symbols coalesced into shared memory (the next
// tile's bytes loaded into registers before the machine runs the current
// one), lane 0 runs the machine over it and stores each emitted character
// straight to memory; the warp zero-fills the row past its count.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4096;          // symbols a tile: 128 a lane
constexpr int kWords = kTile / 4 / 32;   // 32-bit words a lane a tile
constexpr int kFigureSelect = 27;    // 0b11011
constexpr int kLetterSelect = 31;    // 0b11111

struct Machine {
  int st, fig, shr, cnt, rcvd;
};

// One symbol; returns the character to emit, or 0.
__device__ __forceinline__ int baudot_step(Machine& m, int sym,
                                           const int* letters,
                                           const int* figures) {
  const int code = m.shr & 31;
  const bool is_fig = code == kFigureSelect;
  const bool is_let = code == kLetterSelect;
  const int ch = m.fig != 0 ? figures[code] : letters[code];
  const bool one = sym != 0;
  int emit = 0;
  Machine n = m;
  if (m.st == 0) {
    if (one && m.rcvd != 0) {
      if (is_fig) n.fig = 1;
      else if (is_let) n.fig = 0;
      else emit = ch;
    }
    n.st = one ? 1 : 0;
    n.rcvd = one ? m.rcvd : 0;
  } else if (m.st == 1) {
    if (!one) {
      n.st = 2;
      n.shr = 0;
      n.cnt = 0;
    }
    n.rcvd = 0;
  } else {
    const bool done = m.cnt == 4;
    if (m.st == 2) {
      n.shr = (int)((((unsigned)m.shr << 1) | (unsigned)one) & 0xFFFFu);
      n.cnt = (int)((unsigned)m.cnt + 1u);
    }
    n.st = done ? 0 : 2;
    n.rcvd = done ? 1 : m.rcvd;
  }
  m = n;
  return emit;
}

// The machine's state-to-state transition alone, branch-free: what the
// next symbol needs.  The table read and the emit hang off it (nothing of
// the next state reads them), so the shortest chain is this.
__device__ __forceinline__ Machine baudot_next(const Machine& m, int sym) {
  const bool one = sym != 0;
  const int code = m.shr & 31;
  const bool s0 = m.st == 0, s1 = m.st == 1, s2 = m.st == 2;
  const bool done = m.cnt == 4;
  const bool sel = s0 && one && m.rcvd != 0;
  const bool start = s1 && !one;
  Machine n;
  n.fig = sel && code == kFigureSelect ? 1
          : sel && code == kLetterSelect ? 0 : m.fig;
  n.st = s0 ? (one ? 1 : 0) : s1 ? (one ? 1 : 2) : (done ? 0 : 2);
  n.rcvd = s0 ? (one ? m.rcvd : 0) : s1 ? 0 : (done ? 1 : m.rcvd);
  n.shr = start ? 0
          : s2 ? (int)((((unsigned)m.shr << 1) | (unsigned)one) & 0xFFFFu)
               : m.shr;
  n.cnt = start ? 0 : s2 ? (int)((unsigned)m.cnt + 1u) : m.cnt;
  return n;
}

__device__ __forceinline__ void load_words(unsigned (&r)[kWords],
                                           const uint8_t* __restrict__ row,
                                           long long base, int n, int lane) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const long long i = base + 4LL * (j * 32 + lane);
    unsigned w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (i + b < n) w |= (unsigned)row[i + b] << (8 * b);
    r[j] = w;
  }
}

__global__ void __launch_bounds__(32, 1)
baudot_kernel(const uint8_t* __restrict__ sym, int n, int cap,
              const int* __restrict__ letters_g,
              const int* __restrict__ figures_g,
              const int* __restrict__ st_in, const int* __restrict__ fig_in,
              const int* __restrict__ shr_in, const int* __restrict__ cnt_in,
              const int* __restrict__ rcvd_in, uint8_t* __restrict__ data,
              int* __restrict__ count, int* __restrict__ st_out,
              int* __restrict__ fig_out, int* __restrict__ shr_out,
              int* __restrict__ cnt_out, int* __restrict__ rcvd_out) {
  __shared__ unsigned tile[2][kTile / 4];
  __shared__ int letters[32], figures[32];
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const uint8_t* x = sym + (long long)row * n;
  uint8_t* out = data + (long long)row * cap;
  letters[lane] = letters_g[lane];
  figures[lane] = figures_g[lane];
  Machine m = {0, 0, 0, 0, 0};
  if (lane == 0)
    m = {st_in[row], fig_in[row], shr_in[row], cnt_in[row], rcvd_in[row]};
  int k_out = 0;
  const int tiles = (n + kTile - 1) / kTile;
  unsigned next[kWords];
  load_words(next, x, 0, n, lane);
#pragma unroll
  for (int j = 0; j < kWords; ++j) tile[0][j * 32 + lane] = next[j];
  for (int t = 0; t < tiles; ++t) {
    const long long base = (long long)t * kTile;
    const int len = (int)(n - base < kTile ? n - base : kTile);
    const int b = t & 1;
    if (t + 1 < tiles) load_words(next, x, base + kTile, n, lane);
    __syncwarp();
    if (lane == 0) {
      const uint8_t* s = reinterpret_cast<const uint8_t*>(tile[b]);
      for (int k = 0; k < len; ++k) {
        const int ch = baudot_step(m, s[k], letters, figures);
        if (ch != 0) {
          if (k_out < cap) out[k_out] = (uint8_t)ch;
          ++k_out;
        }
      }
    }
    __syncwarp();
    if (t + 1 < tiles) {
#pragma unroll
      for (int j = 0; j < kWords; ++j) tile[b ^ 1][j * 32 + lane] = next[j];
    }
  }
  const int kept = __shfl_sync(0xffffffffu, k_out < cap ? k_out : cap, 0);
  for (int i = kept + lane; i < cap; i += 32) out[i] = 0;
  if (lane == 0) {
    count[row] = kept;
    st_out[row] = m.st;
    fig_out[row] = m.fig;
    shr_out[row] = m.shr;
    cnt_out[row] = m.cnt;
    rcvd_out[row] = m.rcvd;
  }
}

// The probe that sets the kernel's bound: the machine's shortest chain
// (baudot_next: the transition, without the table read and the emit) over
// the first n <= kTile symbols of `sym` on one thread from shared memory,
// from the given state, as csrc/agc_exact.cu's probe.  The thread runs the
// kernel's step over the symbols first, counting the characters it emits;
// then runs the chain twice from the same state, the second pass timed
// (clock64) into cycles[0].  sink[0..4] = the chain's last state, sink[5]
// = the step's characters (the wrapper holds them against the kernel's,
// bit for bit), sink[6] = 1 if the chain's state is the step's, else 0.
__global__ void baudot_probe_kernel(long long* cycles, const uint8_t* sym,
                                    int n, const int* letters_g,
                                    const int* figures_g, Machine m0,
                                    int* sink) {
  __shared__ uint8_t s[kTile];
  __shared__ int letters[32], figures[32];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = sym[i];
  if (threadIdx.x < 32) {
    letters[threadIdx.x] = letters_g[threadIdx.x];
    figures[threadIdx.x] = figures_g[threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  Machine m = m0;
  int emitted = 0;
  for (int k = 0; k < n; ++k)
    emitted += baudot_step(m, s[k], letters, figures) != 0;
  const Machine step = m;
  long long t0 = 0;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) t0 = clock64();
    m = m0;
#pragma unroll 4
    for (int k = 0; k < n; ++k) m = baudot_next(m, s[k]);
  }
  cycles[0] = clock64() - t0;
  sink[0] = m.st;
  sink[1] = m.fig;
  sink[2] = m.shr;
  sink[3] = m.cnt;
  sink[4] = m.rcvd;
  sink[5] = emitted;
  sink[6] = m.st == step.st && m.fig == step.fig && m.shr == step.shr &&
            m.cnt == step.cnt && m.rcvd == step.rcvd;
}

}  // namespace

extern "C" {

// The Baudot decoder over sym (rows, n) uint8 into data (rows, cap) uint8
// and count (rows,) int32, one warp a row; letters and figures (32,) int32
// on the card.  The state in: st, fig, shr, cnt, rcvd (rows,) int32 on the
// card; the next state out to the five *_out.  Returns a cudaError_t.
int csdr_baudot_scan(const void* sym, int rows, int n, int cap,
                     const void* letters, const void* figures,
                     const void* st_in, const void* fig_in,
                     const void* shr_in, const void* cnt_in,
                     const void* rcvd_in, void* data, void* count,
                     void* st_out, void* fig_out, void* shr_out,
                     void* cnt_out, void* rcvd_out, void* stream) {
  if (sym == nullptr || letters == nullptr || figures == nullptr ||
      st_in == nullptr || fig_in == nullptr || shr_in == nullptr ||
      cnt_in == nullptr || rcvd_in == nullptr || data == nullptr ||
      count == nullptr || st_out == nullptr || fig_out == nullptr ||
      shr_out == nullptr || cnt_out == nullptr || rcvd_out == nullptr ||
      rows < 1 || n < 1 || cap < 1)
    return (int)cudaErrorInvalidValue;
  baudot_kernel<<<rows, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sym, n, cap, (const int*)letters, (const int*)figures,
      (const int*)st_in, (const int*)fig_in, (const int*)shr_in,
      (const int*)cnt_in, (const int*)rcvd_in, (uint8_t*)data, (int*)count,
      (int*)st_out, (int*)fig_out, (int*)shr_out, (int*)cnt_out,
      (int*)rcvd_out);
  return (int)cudaGetLastError();
}

// The bound's probe: the machine's shortest chain over the first n <=
// 4096 symbols of sym (uint8 on the card) from the state (st, fig, shr,
// cnt, rcvd), on one thread from shared memory; the SM cycles of the timed
// pass go to cycles[0] (int64), the state after it, the characters the
// step emitted and 1 (the chain's state is the step's) or 0 to sink[0..6]
// (int32).
int csdr_baudot_chain_probe(void* cycles, const void* sym, int n,
                            const void* letters, const void* figures, int st,
                            int fig, int shr, int cnt, int rcvd, void* sink,
                            void* stream) {
  if (cycles == nullptr || sym == nullptr || letters == nullptr ||
      figures == nullptr || sink == nullptr || n < 1 || n > kTile)
    return (int)cudaErrorInvalidValue;
  const Machine m0 = {st, fig, shr, cnt, rcvd};
  baudot_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      (long long*)cycles, (const uint8_t*)sym, n, (const int*)letters,
      (const int*)figures, m0, (int*)sink);
  return (int)cudaGetLastError();
}

}  // extern "C"
