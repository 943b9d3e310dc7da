// The RTTY Baudot decoder: the reference's start/stop-pulse state machine
// over bit symbols, a row split into segments whose state maps compose in
// a block-wide scan, one CTA a row.
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
// Why a row splits.  The next state's st depends only on st, on cnt in
// state 2 and on the symbol: from a state a stream makes, the machine is
// one of seven behavioural states (codes: 0 waiting for the stop pulse, 1
// waiting for the start pulse, 3 + k receiving bit k), and stays among
// them.  fig, rcvd and shr only decide what is emitted at a stop pulse.
// So a segment of symbols is a map of the seven codes, and maps compose;
// beside it a segment does to shr, cnt and rcvd something of the form
// "keep (shifted or added to) or set", which composes too, and to fig
// "keep or set" once its first stop pulse is resolved.
//
// Design.  One CTA a row (rows in turns past the resident CTAs); a thread
// a segment of kSeg symbols, a tile of kSeg x threads symbols at a time:
//   0. the tile's symbols are staged into shared memory by cp.async.bulk
//      on an mbarrier, the next tile's copy in flight while this one runs
//      (a row whose start is not 16-byte aligned is loaded by the threads);
//   1. each thread computes its segment's map over the seven codes (8
//      bytes, composed by two PRMTs): four lookups of its bytes in the
//      CTA's table of every 8-symbol pattern's map (built on three bit
//      planes, a few LOP3s a symbol), composed; but from a tile entry
//      outside the seven states (only a carried state a stream never
//      makes), thread 0 first runs the tile's first segment exactly, a
//      symbol a step;
//   2. the route: when that first segment too ends outside the seven
//      (st 2 with cnt outside 0-4) or the caller asks for it, thread 0
//      runs the rest of the tile a symbol a step (the serial route), else:
//   3. a block scan of the maps gives each segment its entry code;
//   4. each segment runs once from its code, a frame an iteration (a run
//      of zeros and the stop pulse, a run of ones and the start pulse,
//      the frame's bits at once, by bit scans of the segment's symbols),
//      recording its effect on shr, cnt and rcvd and its first stop pulse
//      if that depends on the entry;
//      a block scan of the effects gives each its exact shr, cnt, rcvd;
//   5. each resolves its stop pulse, a block scan of the fig effects gives
//      its exact fig (raw: fig may be 5, rcvd -3: nothing is normalised);
//   6. each re-runs its segment exactly from its exact state, a frame an
//      iteration, its characters into a slot; a block scan of the counts
//      packs them, the block writes them out coalesced (past cap dropped);
//      the last segment's exit is the next tile's entry.
// The row's zero fill past its count and the state out end the launch.
//
// What bounds it.  Bytes: a byte a symbol in, about a seventh out.  The
// serial machine is a chain of a few integer operations a symbol
// (baudot_next, timed on one thread by csdr_baudot_chain_probe below):
// the floor of any one-thread design, which this design is not bound by.
// Split, a row is integer instructions on one SM: Hopper issues a warp's
// integer instruction over two cycles (16 INT32 lanes a sub-partition),
// so the design spends few of them a symbol (the table's maps, a frame
// an iteration) and the rest is the four scans' barriers.  The timed
// instantiation (csdr_baudot_phase_probe) stamps each block-wide step.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 32;             // symbols a segment (a thread's)
constexpr int kSlot = 8;             // characters a segment holds: >= 1 +
                                     // (kSeg - 1) / 7 (7 symbols apart)
constexpr int kMaxThreads = 1024;
constexpr int kProbeMax = 4096;      // symbols the chain probe stages
constexpr int kFigureSelect = 27;    // 0b11011
constexpr int kLetterSelect = 31;    // 0b11111
constexpr unsigned kAll = 0xFFFFFFFFu;

struct Machine {
  int st, fig, shr, cnt, rcvd;
};

// A tile's packed characters: at most 1 + (tile - 1) / 7.
__host__ __device__ constexpr int packed_bytes(int tile) {
  return (tile / 7 + 2 + 15) & ~15;
}

// Dynamic shared memory: two symbol tiles, the segments' character slots,
// a tile's packed characters.
__host__ __device__ constexpr size_t smem_bytes(int threads) {
  return 2 * (size_t)threads * kSeg + (size_t)threads * kSlot +
         (size_t)packed_bytes(threads * kSeg);
}

// The behavioural code of a state, or -1 outside the seven.
__device__ __forceinline__ int entry_code(const Machine& m) {
  if (m.st == 0 || m.st == 1) return m.st;
  if (m.st == 2 && (unsigned)m.cnt <= 4u) return 3 + m.cnt;
  return -1;
}

// One symbol of the exact machine, branch-free but for the table read;
// returns the character to emit, or 0.  tab: letters, then figures.
__device__ __forceinline__ int baudot_step(Machine& m, bool one,
                                           const int* tab) {
  const int code = m.shr & 31;
  const bool s0 = m.st == 0, s1 = m.st == 1, s2 = m.st == 2;
  const bool check = s0 && one && m.rcvd != 0;
  const bool is_fig = code == kFigureSelect, is_let = code == kLetterSelect;
  int ch = 0;
  if (check && !is_fig && !is_let) ch = tab[(m.fig != 0 ? 32 : 0) + code];
  const bool done = m.cnt == 4;
  const bool start = s1 && !one;
  const int st = s0 ? (one ? 1 : 0) : s1 ? (one ? 1 : 2) : (done ? 0 : 2);
  m.fig = check && is_fig ? 1 : check && is_let ? 0 : m.fig;
  m.rcvd = s0 ? (one ? m.rcvd : 0) : s1 ? 0 : (done ? 1 : m.rcvd);
  m.shr = start ? 0
          : s2 ? (int)((((unsigned)m.shr << 1) | (unsigned)one) & 0xFFFFu)
               : m.shr;
  m.cnt = start ? 0 : s2 ? (int)((unsigned)m.cnt + 1u) : m.cnt;
  m.st = st;
  return ch;
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

// Bit i of the result: byte i of w nonzero, i < 4.
__device__ __forceinline__ unsigned nonzero4(unsigned w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return (((w & 0x01010101u) * 0x01020408u) >> 24) & 15u;
}

// A segment's 32 symbols (16-byte aligned in shared memory) as bits.
__device__ __forceinline__ unsigned segment_bits(const uint8_t* s) {
  const uint4 a = reinterpret_cast<const uint4*>(s)[0];
  const uint4 b = reinterpret_cast<const uint4*>(s)[1];
  return nonzero4(a.x) | nonzero4(a.y) << 4 | nonzero4(a.z) << 8 |
         nonzero4(a.w) << 12 | nonzero4(b.x) << 16 | nonzero4(b.y) << 20 |
         nonzero4(b.z) << 24 | nonzero4(b.w) << 28;
}

// The exact machine over len <= kSeg symbols (bit i of bits symbol i),
// each character to out[k++].
__device__ __forceinline__ void run_exact(Machine& m, unsigned bits, int len,
                                          const int* tab, uint8_t* out,
                                          int& k) {
#pragma unroll
  for (int i = 0; i < kSeg; ++i) {
    if (i >= len) break;
    const int ch = baudot_step(m, (bits >> i) & 1u, tab);
    if (ch != 0) out[k++] = (uint8_t)ch;
  }
}

// The exact machine over len <= kSeg symbols from a state among the seven
// (its code q), a frame an iteration in three stages: a run of zeros and
// the stop pulse, a run of ones and the start pulse, the frame's bits at
// once (bit scans of the segment's symbol word; __brev puts symbol i at
// the top of a shift).  The same states and characters as run_exact.
__device__ __forceinline__ void run_fast(Machine& m, int q, unsigned bits,
                                         int len, const int* tab,
                                         uint8_t* out, int& k) {
  const unsigned live = len >= 32 ? kAll : (1u << len) - 1u;
  const unsigned ones = bits & live, zeros = ~bits & live;
  const unsigned rev = __brev(bits);
  int i = 0;
  while (i < len) {
    if (q == 0) {                    // waiting for the stop pulse
      const unsigned o = ones & (kAll << i);
      const int j = o ? __ffs(o) - 1 : len;
      if (j > i) m.rcvd = 0;
      if (j < len) {
        if (m.rcvd != 0) {
          const int code = m.shr & 31;
          if (code == kFigureSelect) {
            m.fig = 1;
          } else if (code == kLetterSelect) {
            m.fig = 0;
          } else {
            const int ch = tab[(m.fig != 0 ? 32 : 0) + code];
            if (ch != 0) out[k++] = (uint8_t)ch;
          }
        }
        q = 1;
      }
      i = j + 1;
    }
    if (q == 1 && i < len) {         // waiting for the start pulse
      m.rcvd = 0;
      const unsigned z = zeros & (kAll << i);
      if (z) {
        i = __ffs(z);
        m.shr = 0;
        m.cnt = 0;
        q = 3;
      } else {
        i = len;
      }
    }
    if (q >= 3 && i < len) {         // the frame's bits
      const int s = min(8 - q, len - i);
      m.shr = (int)((((unsigned)m.shr << s) | ((rev << i) >> (32 - s))) &
                    0xFFFFu);
      m.cnt = (int)((unsigned)m.cnt + (unsigned)s);
      q += s;
      i += s;
      if (q == 8) {
        q = 0;
        m.rcvd = 1;
      }
    }
  }
  m.st = q < 2 ? q : 2;
}

// A segment's map of the seven codes: bit e of plane p is bit p of the
// code entry e has reached (entry 2, no state, goes along unused).  The
// step: receiving k < 4 -> k + 1, receiving 4 -> 0; 0 -> one; 1 -> one ?
// 1 : 3.  Returned as 8 bytes, byte e the code entry e reaches.
struct Map {
  unsigned lo, hi;                   // bytes 0-3, 4-7
};

constexpr Map kIdentMap = {0x03020100u, 0x07060504u};

// Bits 0-3 of x, one to a byte.
__device__ __forceinline__ unsigned spread4(unsigned x) {
  return ((x & 15u) * 0x00204081u) & 0x01010101u;
}

// One symbol on the planes (s: all ones for a 1).
__device__ __forceinline__ void plane_step(unsigned& p0, unsigned& p1,
                                           unsigned& p2, unsigned s) {
  const unsigned n2 = p2 ^ (p1 & p0);
  const unsigned n1 = (p2 & (p1 ^ p0)) | (~p2 & ~p1 & p0 & ~s);
  const unsigned n0 = (p2 & ~p0) | (~p2 & ~p1 & (s | p0));
  p0 = n0;
  p1 = n1;
  p2 = n2;
}

// The map of len symbols on the planes, a symbol a step.
__device__ __forceinline__ Map plane_map(unsigned bits, int len) {
  unsigned p0 = 0xAAu, p1 = 0xCCu, p2 = 0xF0u;
  for (int i = 0; i < len; ++i)
    plane_step(p0, p1, p2, 0u - ((bits >> i) & 1u));
  return {spread4(p0) | spread4(p1) << 1 | spread4(p2) << 2,
          spread4(p0 >> 4) | spread4(p1 >> 4) << 1 | spread4(p2 >> 4) << 2};
}

// __byte_perm's selector of 4 bytes <= 7: nibble k = byte k.
__device__ __forceinline__ unsigned selector(unsigned x) {
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0xFFFFu;
}

// f, then g: byte e of the result is g's byte at f's byte e.
__device__ __forceinline__ Map map_then(const Map& f, const Map& g) {
  return {__byte_perm(g.lo, g.hi, selector(f.lo)),
          __byte_perm(g.lo, g.hi, selector(f.hi))};
}

__device__ __forceinline__ int map_code(const Map& f, int c) {
  return (int)((((c < 4) ? f.lo : f.hi) >> (8 * (c & 3))) & 0xFFu);
}

// A segment's map: a full segment as its four bytes' maps from the
// CTA's table of every 8-symbol pattern (maps8), composed; a shorter one
// (a row's last) on the planes.
__device__ __forceinline__ Map segment_map(unsigned bits, int len,
                                           const Map* maps8) {
  if (len < kSeg) return plane_map(bits, len);
  Map m = maps8[bits & 0xFFu];
#pragma unroll
  for (int b = 8; b < kSeg; b += 8)
    m = map_then(m, maps8[(bits >> b) & 0xFFu]);
  return m;
}

// What a segment does to shr, cnt and rcvd:
//   shr' = ((shr << m) & sk) | sb       (m <= 16; sk 0 once set)
//   cnt' = (kept ? cnt : 0) + cc        (wrapping)
//   rcvd' = kept ? rcvd : rv
// w packs sb (bits 0-15), m (16-20), cnt kept (21), rcvd kept (22), rv
// (23).
struct Eff {
  unsigned sk, w, cc;
};

constexpr unsigned kCntKept = 1u << 21, kRcvdKept = 1u << 22;

__device__ __forceinline__ Eff eff_identity() {
  return {kAll, kCntKept | kRcvdKept, 0u};
}

// a, then b.
__device__ __forceinline__ Eff eff_then(const Eff& a, const Eff& b) {
  const unsigned bm = (b.w >> 16) & 31u;
  const unsigned m = min(((a.w >> 16) & 31u) + bm, 16u);
  const unsigned sb = (((a.w & 0xFFFFu) << bm) & b.sk) | (b.w & 0xFFFFu);
  const unsigned rv = (b.w & kRcvdKept) ? (a.w >> 23) & 1u : (b.w >> 23) & 1u;
  Eff r;
  r.sk = (a.sk << bm) & b.sk;
  r.w = (sb & 0xFFFFu) | m << 16 | (a.w & b.w & (kCntKept | kRcvdKept)) |
        rv << 23;
  r.cc = ((b.w & kCntKept) ? a.cc : 0u) + b.cc;
  return r;
}

// fig's effect: bit 0 kept, bit 1 the value set.  a, then b.
__device__ __forceinline__ unsigned fig_then(unsigned a, unsigned b) {
  return (b & 1u) ? a : b;
}

// Pass 2: the segment from its entry code q, a frame an iteration as
// run_fast.  Its effect on shr, cnt and rcvd; on fig, the stop pulses
// whose outcome it knows (fig_fx); and its first stop pulse when that
// reads the entry's rcvd or shr (pend: 1 if so, rcvd kept (1), rv (2), m
// (3-7), sk & 31 (8-12), sb & 31 (13-17)).  Only the first stop pulse
// can: after it rcvd is set, and rcvd comes back only at the end of a
// frame that a start pulse began, which set shr.
__device__ __forceinline__ void segment_effects(unsigned bits, int len, int q,
                                                Eff& e, unsigned& fig_fx,
                                                unsigned& pend) {
  const unsigned live = len >= 32 ? kAll : (1u << len) - 1u;
  const unsigned ones = bits & live, zeros = ~bits & live;
  const unsigned rev = __brev(bits);
  unsigned sk = kAll, sb = 0u, m = 0u, cc = 0u, rv = 0u, fx = 1u, p = 0u;
  bool ckept = true, rkept = true;
  int i = 0;
  while (i < len) {
    if (q == 0) {                    // waiting for the stop pulse
      const unsigned o = ones & (kAll << i);
      const int j = o ? __ffs(o) - 1 : len;
      if (j > i) {
        rkept = false;
        rv = 0u;
      }
      if (j < len) {
        if (!rkept && (rv == 0u || (sk & 31u) == 0u)) {
          const unsigned code = sb & 31u;
          if (rv != 0u && code == (unsigned)kFigureSelect) fx = 2u;
          else if (rv != 0u && code == (unsigned)kLetterSelect) fx = 0u;
        } else {
          p = 1u | (rkept ? 2u : 0u) | rv << 2 | m << 3 | (sk & 31u) << 8 |
              (sb & 31u) << 13;
        }
        q = 1;
      }
      i = j + 1;
    }
    if (q == 1 && i < len) {         // waiting for the start pulse
      rkept = false;
      rv = 0u;
      const unsigned z = zeros & (kAll << i);
      if (z) {
        i = __ffs(z);
        sk = 0u;
        sb = 0u;
        ckept = false;
        cc = 0u;
        q = 3;
      } else {
        i = len;
      }
    }
    if (q >= 3 && i < len) {         // the frame's bits
      const int s = min(8 - q, len - i);
      sb = ((sb << s) | ((rev << i) >> (32 - s))) & 0xFFFFu;
      sk = (sk << s) & 0xFFFFu;
      m = min(m + (unsigned)s, 16u);
      cc += (unsigned)s;
      q += s;
      i += s;
      if (q == 8) {
        q = 0;
        rkept = false;
        rv = 1u;
      }
    }
  }
  e.sk = sk;
  e.w = sb | m << 16 | (ckept ? kCntKept : 0u) | (rkept ? kRcvdKept : 0u) |
        rv << 23;
  e.cc = cc;
  fig_fx = fx;
  pend = p;
}

// The first stop pulse's effect on fig, given the segment's exact shr and
// rcvd at entry.
__device__ __forceinline__ unsigned resolve_pending(unsigned p, int shr,
                                                    int rcvd) {
  if (!(p & 1u)) return 1u;
  const unsigned r = (p & 2u) ? (unsigned)rcvd : (p >> 2) & 1u;
  const unsigned m = (p >> 3) & 31u;
  const unsigned code =
      (((unsigned)shr << m) & ((p >> 8) & 31u)) | ((p >> 13) & 31u);
  if (r == 0u) return 1u;
  return code == (unsigned)kFigureSelect ? 2u
         : code == (unsigned)kLetterSelect ? 0u : 1u;
}

struct MapOp {
  using T = Map;
  __device__ static T id() { return kIdentMap; }
  __device__ static T then(const T& a, const T& b) { return map_then(a, b); }
  __device__ static T up(const T& x, int d) {
    return {__shfl_up_sync(kAll, x.lo, d), __shfl_up_sync(kAll, x.hi, d)};
  }
};

struct EffOp {
  using T = Eff;
  __device__ static T id() { return eff_identity(); }
  __device__ static T then(const T& a, const T& b) { return eff_then(a, b); }
  __device__ static T up(const T& x, int d) {
    return {__shfl_up_sync(kAll, x.sk, d), __shfl_up_sync(kAll, x.w, d),
            __shfl_up_sync(kAll, x.cc, d)};
  }
};

struct FigOp {
  using T = unsigned;
  __device__ static T id() { return 1u; }
  __device__ static T then(T a, T b) { return fig_then(a, b); }
  __device__ static T up(T x, int d) { return __shfl_up_sync(kAll, x, d); }
};

struct SumOp {
  using T = int;
  __device__ static T id() { return 0; }
  __device__ static T then(T a, T b) { return a + b; }
  __device__ static T up(T x, int d) { return __shfl_up_sync(kAll, x, d); }
};

// The block's exclusive scan of x in thread order (Op::then(a, b): a,
// then b); tot: 32 of Op::T in shared memory, this scan's own.
template <class Op>
__device__ __forceinline__ typename Op::T block_exclusive(
    typename Op::T x, typename Op::T* tot) {
  using T = typename Op::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = Op::up(inc, d);
    if (lane >= d) inc = Op::then(o, inc);
  }
  if (lane == 31) tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < (int)(blockDim.x >> 5) ? tot[lane] : Op::id();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T o = Op::up(w, d);
      if (lane >= d) w = Op::then(o, w);
    }
    tot[lane] = w;
  }
  __syncthreads();
  T ex = Op::up(inc, 1);
  if (lane == 0) ex = Op::id();
  return warp == 0 ? ex : Op::then(tot[warp - 1], ex);
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

// Thread 0: the bulk copy of a tile's first bytes (a multiple of 16) into
// shared memory, completing on bar (an arrival even with no bytes, so the
// barrier's phases keep step with the tiles).
__device__ __forceinline__ void issue_tile(uint8_t* dst, const uint8_t* src,
                                           unsigned bytes,
                                           unsigned long long* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(b), "r"(bytes) : "memory");
  if (bytes > 0u)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  const unsigned b = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  } while (!done);
}

// kPhases: SM clock stamps a tile, thread 0's, each after a block-wide
// step (the timed instantiation, csdr_baudot_phase_probe).
constexpr int kPhases = 7;

template <bool kTimed>
__global__ void __launch_bounds__(kMaxThreads, 1)
baudot_kernel(const uint8_t* __restrict__ sym, int n, int cap, int serial_only,
              const int* __restrict__ letters_g,
              const int* __restrict__ figures_g,
              const int* __restrict__ st_in, const int* __restrict__ fig_in,
              const int* __restrict__ shr_in, const int* __restrict__ cnt_in,
              const int* __restrict__ rcvd_in, uint8_t* __restrict__ data,
              int* __restrict__ count, int* __restrict__ st_out,
              int* __restrict__ fig_out, int* __restrict__ shr_out,
              int* __restrict__ cnt_out, int* __restrict__ rcvd_out,
              long long* __restrict__ stamps) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) unsigned long long bar[2];
  __shared__ int tab[64];
  __shared__ Map tot_map[32];
  __shared__ Map maps8[256];         // the map of each 8-symbol pattern
  __shared__ unsigned tot_fig[32];
  __shared__ Eff tot_eff[32];
  __shared__ int tot_cnt[32];
  __shared__ Machine exit0, tile_out;
  __shared__ int serial, first, chars0, tile_chars;

  const int tid = threadIdx.x, threads = blockDim.x;
  const int tile = threads * kSeg;
  uint8_t* const slots = smem + 2 * tile;
  uint8_t* const packed = slots + threads * kSlot;
  const long long row = blockIdx.x;
  const uint8_t* x = sym + row * n;
  uint8_t* out = data + row * cap;
  const bool aligned = ((uintptr_t)x & 15u) == 0u;
  const int tiles = (n + tile - 1) / tile;
  auto stamp = [&](int t, int phase) {
    if (kTimed && tid == 0) stamps[t * kPhases + phase] = clock64();
  };
  auto tile_len = [&](int t) {
    const long long left = (long long)n - (long long)t * tile;
    return (int)(left < tile ? left : tile);
  };
  if (tid < 32) {
    tab[tid] = letters_g[tid];
    tab[32 + tid] = figures_g[tid];
  }
  for (int b = tid; b < 256; b += threads) maps8[b] = plane_map(b, 8);
  Machine carry = {0, 0, 0, 0, 0};   // the tile's entry: thread 0's
  if (tid == 0) {
    carry = {st_in[row], fig_in[row], shr_in[row], cnt_in[row],
             rcvd_in[row]};
    if (aligned) {
      for (int i = 0; i < 2; ++i)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_addr(&bar[i])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      issue_tile(smem, x, (unsigned)tile_len(0) & ~15u, &bar[0]);
    }
  }
  __syncthreads();

  long long total = 0;               // characters of the row so far
  for (int t = 0; t < tiles; ++t) {
    const long long base = (long long)t * tile;
    const int len = tile_len(t);
    uint8_t* const buf = smem + (t & 1) * tile;
    if (aligned) {
      if (tid == 0 && t + 1 < tiles)
        issue_tile(smem + ((t + 1) & 1) * tile, x + base + tile,
                   (unsigned)tile_len(t + 1) & ~15u, &bar[(t + 1) & 1]);
      bar_wait(&bar[t & 1], (unsigned)(t >> 1) & 1u);
      for (int j = (len & ~15) + tid; j < len; j += threads)
        buf[j] = x[base + j];
    } else {
      for (int j = tid; j < len; j += threads) buf[j] = x[base + j];
    }
    __syncthreads();
    stamp(t, 0);

    const int a = tid * kSeg;
    const int slen = len - a < 0 ? 0 : len - a < kSeg ? len - a : kSeg;
    const unsigned bits = slen > 0 ? segment_bits(buf + a) : 0u;
    // thread 0 runs the first segment exactly only from a state outside
    // the seven; exit0 is then the seed, the state after the first
    // `first` segments, from which the segmented route starts
    Machine m = carry;
    int k = 0;
    Map map = kIdentMap;
    if (tid == 0) {
      const bool pre = serial_only || entry_code(m) < 0;
      if (pre) run_exact(m, bits, slen, tab, slots, k);
      else map = segment_map(bits, slen, maps8);
      exit0 = m;
      first = pre ? 1 : 0;
      chars0 = k;
      serial = serial_only || entry_code(m) < 0;
    } else if (slen > 0) {
      map = segment_map(bits, slen, maps8);
    }
    __syncthreads();
    stamp(t, 1);

    if (serial) {                    // the serial route: thread 0
      if (tid == 0) {
        for (int j = 0; j < k; ++j) packed[j] = slots[j];
        for (int s = kSeg; s < len; s += kSeg)
          run_exact(m, segment_bits(buf + s),
                    len - s < kSeg ? len - s : kSeg, tab, packed, k);
        tile_out = m;
        tile_chars = k;
      }
    } else {
      const Machine e0 = exit0;
      const bool mine = tid >= first;
      const Map pre = block_exclusive<MapOp>(map, tot_map);
      stamp(t, 2);
      const int q = map_code(pre, entry_code(e0));
      Eff fx = eff_identity();
      unsigned fig_fx = 1u, pend = 0u;
      if (mine) segment_effects(bits, slen, q, fx, fig_fx, pend);
      const Eff pe = block_exclusive<EffOp>(fx, tot_eff);
      stamp(t, 3);
      Machine in;
      in.st = q < 2 ? q : 2;
      in.shr = (int)((((unsigned)e0.shr << ((pe.w >> 16) & 31u)) & pe.sk) |
                     (pe.w & 0xFFFFu));
      in.cnt = (int)(((pe.w & kCntKept) ? (unsigned)e0.cnt : 0u) + pe.cc);
      in.rcvd = (pe.w & kRcvdKept) ? e0.rcvd : (int)((pe.w >> 23) & 1u);
      const unsigned f =
          mine ? fig_then(resolve_pending(pend, in.shr, in.rcvd), fig_fx)
               : 1u;
      const unsigned pf = block_exclusive<FigOp>(f, tot_fig);
      stamp(t, 4);
      in.fig = (pf & 1u) ? e0.fig : (int)(pf >> 1);
      if (mine) {
        m = in;
        run_fast(m, q, bits, slen, tab, slots + tid * kSlot, k);
      }
      const int off = block_exclusive<SumOp>(k, tot_cnt);
      stamp(t, 5);
      for (int j = 0; j < k; ++j) packed[off + j] = slots[tid * kSlot + j];
      if (tid == threads - 1) {
        tile_out = m;
        tile_chars = off + k;
      }
    }
    __syncthreads();

    const int tc = tile_chars;
    for (int j = tid; j < tc; j += threads)
      if (total + j < cap) out[total + j] = packed[j];
    total += tc;
    if (tid == 0) carry = tile_out;
    __syncthreads();
    stamp(t, 6);
  }
  const int kept = total < cap ? (int)total : cap;
  for (int j = kept + tid; j < cap; j += threads) out[j] = 0;
  if (tid == 0) {
    count[row] = kept;
    st_out[row] = carry.st;
    fig_out[row] = carry.fig;
    shr_out[row] = carry.shr;
    cnt_out[row] = carry.cnt;
    rcvd_out[row] = carry.rcvd;
  }
}

// The probe that times the serial machine: its shortest chain
// (baudot_next: the transition, without the table read and the emit) over
// the first n <= kProbeMax symbols of `sym` on one thread from shared
// memory, from the given state, as csrc/agc_exact.cu's probe.  The thread
// runs the exact step over the symbols first, counting the characters it
// emits; then runs the chain twice from the same state, the second pass
// timed (clock64) into cycles[0].  sink[0..4] = the chain's last state,
// sink[5] = the step's characters (the wrapper holds them against the
// kernel's, bit for bit), sink[6] = 1 if the chain's state is the step's,
// else 0.
__global__ void baudot_probe_kernel(long long* cycles, const uint8_t* sym,
                                    int n, const int* letters_g,
                                    const int* figures_g, Machine m0,
                                    int* sink) {
  __shared__ uint8_t s[kProbeMax];
  __shared__ int tab[64];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = sym[i];
  if (threadIdx.x < 32) {
    tab[threadIdx.x] = letters_g[threadIdx.x];
    tab[32 + threadIdx.x] = figures_g[threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  Machine m = m0;
  int emitted = 0;
  for (int k = 0; k < n; ++k) emitted += baudot_step(m, s[k] != 0, tab) != 0;
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

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// The Baudot decoder over sym (rows, n) uint8 into data (rows, cap) uint8
// and count (rows,) int32, one CTA of `threads` (a multiple of 32, 32 to
// 1024) a row; letters and figures (32,) int32 on the card.  The state in:
// st, fig, shr, cnt, rcvd (rows,) int32 on the card; the next state out to
// the five *_out.  serial_only != 0 takes the serial route for every tile.
// Returns a cudaError_t.
namespace {

int launch(const void* sym, int rows, int n, int cap, int threads,
           int serial_only, const void* letters, const void* figures,
           const void* st_in, const void* fig_in, const void* shr_in,
           const void* cnt_in, const void* rcvd_in, void* data, void* count,
           void* st_out, void* fig_out, void* shr_out, void* cnt_out,
           void* rcvd_out, void* stamps, void* stream) {
  if (sym == nullptr || letters == nullptr || figures == nullptr ||
      st_in == nullptr || fig_in == nullptr || shr_in == nullptr ||
      cnt_in == nullptr || rcvd_in == nullptr || data == nullptr ||
      count == nullptr || st_out == nullptr || fig_out == nullptr ||
      shr_out == nullptr || cnt_out == nullptr || rcvd_out == nullptr ||
      rows < 1 || n < 1 || cap < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const uint8_t*, int, int, int, const int*, const int*,
                 const int*, const int*, const int*, const int*, const int*,
                 uint8_t*, int*, int*, int*, int*, int*, int*, long long*) =
      stamps ? baudot_kernel<true> : baudot_kernel<false>;
  const size_t smem = smem_bytes(threads);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)sym, n, cap, serial_only, (const int*)letters,
      (const int*)figures, (const int*)st_in, (const int*)fig_in,
      (const int*)shr_in, (const int*)cnt_in, (const int*)rcvd_in,
      (uint8_t*)data, (int*)count, (int*)st_out, (int*)fig_out,
      (int*)shr_out, (int*)cnt_out, (int*)rcvd_out, (long long*)stamps);
  return (int)cudaGetLastError();
}

}  // namespace

int csdr_baudot_scan(const void* sym, int rows, int n, int cap, int threads,
                     int serial_only, const void* letters,
                     const void* figures, const void* st_in,
                     const void* fig_in, const void* shr_in,
                     const void* cnt_in, const void* rcvd_in, void* data,
                     void* count, void* st_out, void* fig_out, void* shr_out,
                     void* cnt_out, void* rcvd_out, void* stream) {
  return launch(sym, rows, n, cap, threads, serial_only, letters, figures,
                st_in, fig_in, shr_in, cnt_in, rcvd_in, data, count, st_out,
                fig_out, shr_out, cnt_out, rcvd_out, nullptr, stream);
}

// The decoder as csdr_baudot_scan, timed: the CTA of row 0 writes thread
// 0's SM clock after each block-wide step of each tile to stamps (int64,
// tiles x 7: staged; the first segment and the maps; the map scan; the
// effects and their scan; the fig scan; the re-runs and the count scan;
// the characters written; a serial tile writes 0, 1 and 6).
int csdr_baudot_phase_probe(const void* sym, int rows, int n, int cap,
                            int threads, int serial_only,
                            const void* letters, const void* figures,
                            const void* st_in, const void* fig_in,
                            const void* shr_in, const void* cnt_in,
                            const void* rcvd_in, void* data, void* count,
                            void* st_out, void* fig_out, void* shr_out,
                            void* cnt_out, void* rcvd_out, void* stamps,
                            void* stream) {
  if (stamps == nullptr) return (int)cudaErrorInvalidValue;
  return launch(sym, rows, n, cap, threads, serial_only, letters, figures,
                st_in, fig_in, shr_in, cnt_in, rcvd_in, data, count, st_out,
                fig_out, shr_out, cnt_out, rcvd_out, stamps, stream);
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
      figures == nullptr || sink == nullptr || n < 1 || n > kProbeMax)
    return (int)cudaErrorInvalidValue;
  const Machine m0 = {st, fig, shr, cnt, rcvd};
  baudot_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      (long long*)cycles, (const uint8_t*)sym, n, (const int*)letters,
      (const int*)figures, m0, (int*)sink);
  return (int)cudaGetLastError();
}

// An empty kernel, one warp: the floor one launch cannot beat, timed
// through the same call path as the decoder.
int csdr_baudot_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
