// Gardner / early-late timing recovery: the symbol loop, one block per
// (row, segment) lane with one thread on its chain, every slot of a chunk
// in registers, one launch.
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
// Design (since the redesign): take the L2 load off the chain.  One lane a
// block of kRingThreads threads: lane 0 of warp 0 runs the chain, warps 1-3
// stream the lane's row ahead into a ring of `tiles` tiles of 2^log2_tile
// complex samples in shared memory (tile t of the row in ring slot t mod
// tiles, so sample i sits at ring[i & (tiles*tile - 1)]), with cp.async
// copies and a flag a slot that names the tile it holds (a release store
// after the copies, an acquire load before the reads).  The chain thread
// reads its three picks from the ring.  When its window first reaches a
// tile, which landed long before, it publishes the lowest tile that its
// window or any later one may reach, the tile of bitstart + lo_off (the
// copies overwrite only tiles below it; between publications they run
// on behind a lower one), and waits on the tile's flag; a bitstart below
// the last publication's, so a pick possibly below its tile, traps.  The picks are read ahead of that test and read
// again in the rare case it waits, and the waiting code is laid out off
// the straight path, so the test is not on the chain.  What else kept the chain long, and what the kernel does about
// it: the algorithm and the error's form are template parameters
// (Gardner's left pick does not wait for the correction's reset), the
// loop's invariants are held in registers, the ring is read by its
// shared-window address, and the loop is unrolled twice (a taken branch a
// slot cost more than the chain's arithmetic).  The ring needs bitstart
// to stay monotone, so that the envelope never comes back to a tile below
// one it left (a pick itself may: early-late's left pick after a reset).
// kernels/ted_cuda.ring_plan sizes the tiles from the block's constants
// (a tile at least as wide as the window and a slot's longest step, four
// tiles, so the copies run at least two tiles ahead) and routes a
// parameter set whose correction can step bitstart backwards (|corr| >
// nsb) or is unbounded, or whose window does not fit, to the L2 design
// below (csdr_ted_scan_l2), chosen from the parameters alone, before
// launch.  The per-slot stores stay beside the chain.

// The L2 design (the first port, csdr_ted_scan_l2): a thread a lane, one
// lane a block (the lanes of one warp would read and write 32 different
// rows, each load or store instruction then 32 L1TEX sectors in series on
// the chain), the picks read from L2 through the read-only path (__ldg),
// the outputs stored beside the chain.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kProbeWindow = 4096;   // complex samples the probe stages
constexpr int kRingThreads = 128;    // warp 0: the chain; warps 1-3: copies
constexpr int kProducers = kRingThreads - 32;
constexpr int kMaxRingTiles = 8;
constexpr long long kSpinLimit = 1LL << 26;   // a wait past it traps

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

struct RingParams {
  int log2_tile;   // complex samples a tile, log2
  int tiles;       // ring slots, a power of two
  int lo_off;      // the lowest pick relative to bitstart, any slot
};

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *(const volatile int*)p;
}

__device__ __forceinline__ void st_volatile(int* p, int v) {
  *(volatile int*)p = v;
}

// A flag's load with acquire semantics (the loads after it see what was
// written before the matching release), and that release: no fence, so
// the chain thread does not wait for its own stores in flight to land.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

// A ring sample by its shared-window address (computed once from the
// ring's base: indexing the dynamic shared array directly re-reads the
// CTA's window base, a special-register read, on the chain every slot).
__device__ __forceinline__ float2 lds_float2(unsigned addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(p)),
               "r"(v)
               : "memory");
}

__device__ __forceinline__ void cp_async8(float2* smem, const float2* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
}

// A loop-invariant value the compiler must keep in a register: it would
// otherwise re-read a launch parameter from the constant bank (LDC, tens
// of cycles) inside the chain's loop and put that latency on the chain.
__device__ __forceinline__ int held(int v) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(v));
  return v;
}

__device__ __forceinline__ float held(float v) {
  asm volatile("mov.b32 %0, %0;\n" : "+f"(v));
  return v;
}

template <bool kEarlyLate, bool kUseQ>
__global__ void __launch_bounds__(kRingThreads, 1)
ted_ring_kernel(const float2* __restrict__ planes,
                const int* __restrict__ bs_in, const int* __restrict__ corr_in,
                const int* __restrict__ span_hi,
                const int* __restrict__ emit_lo, TedParams p, RingParams r,
                int* __restrict__ bs_out, int* __restrict__ corr_out,
                float2* __restrict__ v_out, float* __restrict__ err_out,
                int* __restrict__ start_out, uint8_t* __restrict__ emit_out) {
  extern __shared__ __align__(16) float2 ring[];
  __shared__ int ready[kMaxRingTiles];   // the tile each slot holds
  __shared__ int need_lo;                // the lowest tile the chain needs
  __shared__ int done;                   // the chain has ended
  __shared__ int go;                     // the producers' next tile is on
  const int lane = blockIdx.x;
  const float2* row = planes + (long long)(lane / p.segs) * p.size;
  const int last = p.size - 1;
  const int lt = r.log2_tile;
  const int b0 = bs_in[lane];
  const int t_first =
      (int)min(max((long long)b0 + r.lo_off, 0LL), (long long)last) >> lt;
  const int t_last = last >> lt;
  if (threadIdx.x == 0) {
    need_lo = t_first;
    done = 0;
  }
  if (threadIdx.x < kMaxRingTiles) ready[threadIdx.x] = -1;
  __syncthreads();

  if (threadIdx.x >= 32) {   // the producers: tiles t_first.. in order
    const int pt = threadIdx.x - 32;
    const int tile = 1 << lt;
    for (int t = t_first; t <= t_last; ++t) {
      if (pt == 0) {   // room: slot t mod tiles no longer needed
        long long spins = 0;
        while (t >= ld_volatile(&need_lo) + r.tiles && !ld_volatile(&done)) {
          __nanosleep(64);
          if (++spins > kSpinLimit) __trap();
        }
        go = !ld_volatile(&done);
      }
      producers_sync();
      if (!go) break;
      const int slot = t & (r.tiles - 1);
      const int start = t << lt;
      const int count = min(tile, p.size - start);
      float2* dst = ring + ((long long)slot << lt);
      for (int i = pt; i < count; i += kProducers)
        cp_async8(dst + i, row + start + i);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      producers_sync();
      if (pt == 0) st_release(&ready[slot], t);
    }
    return;
  }
  if (threadIdx.x != 0) return;

  // the chain: its loop invariants held in registers, the algorithm and
  // the error's form fixed at compile time
  const unsigned mask =
      (unsigned)held((int)(((unsigned)r.tiles << lt) - 1u));
  unsigned long long ring_w;   // the ring's shared-window address, once
  asm volatile("cvta.to.shared.u64 %0, %1;\n" : "=l"(ring_w) : "l"(ring));
  const unsigned ring_s = (unsigned)ring_w;
  const int hi = held(span_hi ? span_hi[lane] : INT_MAX);
  const int lo = held(emit_lo ? emit_lo[lane] : INT_MIN);
  const int size = held(p.size), lastc = held(last), lth = held(lt);
  const int off0 = held(p.off0), off1 = held(p.off1), off2 = held(p.off2);
  const int nsb = held(p.nsb), span3 = held(3 * p.nshb);
  const int tiles1 = held(r.tiles - 1), lo_off = held(r.lo_off);
  TedParams q = p;
  q.reset = held(p.reset);
  q.max_error = held(p.max_error);
  q.gain = held(p.gain);
  q.loop_gain = held(p.loop_gain);
  int bitstart = b0;
  int corr = corr_in[lane];
  int have = t_first - 1;   // tiles through `have` are known to be in
  int pub = t_first;        // the lowest tile last published
  int b_pub = b0;           // bitstart then
  bool alive = true;
  const long long base = (long long)lane * p.cap;
#pragma unroll 2
  for (int k = 0; k < p.cap; ++k) {
    // bitstart + 3*nshb < size in int32 as the plain version wraps it
    alive = alive && (int)((unsigned)bitstart + (unsigned)span3) < size &&
            bitstart < hi;
    corr = reset_correction(corr, q.reset);
    const int g0 = clampi(bitstart + off0, 0, lastc);
    const int g1 = clampi(bitstart + off1 - (kEarlyLate ? corr : 0), 0,
                          lastc);
    const int g2 = clampi(bitstart + off2, 0, lastc);
    const unsigned a0 = ring_s + (((unsigned)g0 & mask) << 3);
    const unsigned a1 = ring_s + (((unsigned)g1 & mask) << 3);
    const unsigned a2 = ring_s + (((unsigned)g2 & mask) << 3);
    float2 v0 = lds_float2(a0), v1 = lds_float2(a1), v2 = lds_float2(a2);
    const int t_hi = max(max(g0, g1), g2) >> lth;
    if (__builtin_expect(t_hi > have || bitstart < b_pub, 0)) {
      // a tile first.  Publish the lowest tile this slot or any later one
      // may read: the window's envelope, bitstart + lo_off, monotone in
      // the walk (an early-late left pick alone is not: after a large
      // correction it may land below the slot before's).  Every pick
      // lies in its slot's envelope, so a bitstart below the one of the
      // last publication (a pick may then lie below the published tile)
      // or a window past the ring breaks the plan.
      const int need = clampi(bitstart + lo_off, 0, lastc) >> lth;
      if (bitstart < b_pub || t_hi - need > tiles1) __trap();
      b_pub = bitstart;
      pub = max(pub, need);
      st_volatile(&need_lo, pub);
      long long spins = 0;
      while (ld_acquire(&ready[t_hi & tiles1]) != t_hi)
        if (++spins > kSpinLimit) __trap();
      have = t_hi;
      v0 = lds_float2(a0);
      v1 = lds_float2(a1);
      v2 = lds_float2(a2);
    }
    const float error = slot_error(v0, v1, v2, kUseQ);
    const int new_corr = slot_correction(error, q);
    const long long at = base + k;
    v_out[3 * at] = v0;
    v_out[3 * at + 1] = v1;
    v_out[3 * at + 2] = v2;
    err_out[at] = error;
    start_out[at] = bitstart;
    emit_out[at] = (alive && bitstart >= lo) ? 1 : 0;
    if (alive) {
      bitstart = bitstart + nsb + new_corr;
      corr = new_corr;
    }
  }
  bs_out[lane] = bitstart;
  corr_out[lane] = corr;
  st_volatile(&done, 1);
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

// The arguments both designs check: non-null pointers, span_hi and emit_lo
// together, shapes, planes 8-byte aligned.
bool bad_args(const void* planes, int size, const void* bs_in,
              const void* corr_in, const void* span_hi, const void* emit_lo,
              int rows, int segs, int cap, void* bs_out, void* corr_out,
              void* v_out, void* err_out, void* start_out, void* emit_out) {
  return planes == nullptr || bs_in == nullptr || corr_in == nullptr ||
         bs_out == nullptr || corr_out == nullptr || v_out == nullptr ||
         err_out == nullptr || start_out == nullptr || emit_out == nullptr ||
         (span_hi == nullptr) != (emit_lo == nullptr) || size < 1 ||
         rows < 0 || segs < 1 || cap < 0 || ((uintptr_t)planes & 7) ||
         (long long)rows * segs > INT_MAX;
}

}  // namespace

extern "C" {

// `cap` slots of the symbol loop for lanes = rows*segs lanes over planes
// (rows, 2*size) float32 (8-byte aligned), one lane a block of
// kRingThreads threads, the row streamed through a ring of `tiles` (a
// power of two, at most kMaxRingTiles) tiles of 2^log2_tile complex
// samples in shared memory; lo_off is the lowest pick relative to
// bitstart in any slot (kernels/ted_cuda.ring_plan).  bs_in, corr_in,
// span_hi and emit_lo are int32 per lane (span_hi and emit_lo both null in
// the serial mode); v_out (lanes, cap, 3, 2) float32, err_out (lanes, cap)
// float32, start_out (lanes, cap) int32, emit_out (lanes, cap) bytes,
// bs_out and corr_out int32 per lane.  Returns a cudaError_t.
int csdr_ted_scan(const void* planes, int size, const void* bs_in,
                  const void* corr_in, const void* span_hi,
                  const void* emit_lo, int rows, int segs, int cap, int nsb,
                  int nshb, int nsqb, int off0, int off1, int off2,
                  int gardner, int use_q, float max_error, float err_sign,
                  float loop_gain, int log2_tile, int tiles, int lo_off,
                  void* bs_out, void* corr_out, void* v_out, void* err_out,
                  void* start_out, void* emit_out, void* stream) {
  const long long smem = (long long)tiles * 8 << (log2_tile < 0 ? 0
                                                                 : log2_tile);
  if (bad_args(planes, size, bs_in, corr_in, span_hi, emit_lo, rows, segs,
               cap, bs_out, corr_out, v_out, err_out, start_out, emit_out) ||
      log2_tile < 4 || log2_tile > 16 || tiles < 2 ||
      tiles > kMaxRingTiles || (tiles & (tiles - 1)) || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const int lanes = rows * segs;
  if (lanes == 0) return 0;
  void (*kernel)(const float2*, const int*, const int*, const int*,
                 const int*, TedParams, RingParams, int*, int*, float2*,
                 float*, int*, uint8_t*) =
      gardner ? (use_q ? ted_ring_kernel<false, true>
                       : ted_ring_kernel<false, false>)
              : (use_q ? ted_ring_kernel<true, true>
                       : ted_ring_kernel<true, false>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const TedParams p = make_params(size, cap, segs, nsb, nshb, nsqb,
                                  off0, off1, off2, gardner, use_q, max_error,
                                  err_sign, loop_gain);
  RingParams r;
  r.log2_tile = log2_tile;
  r.tiles = tiles;
  r.lo_off = lo_off;
  kernel<<<lanes, kRingThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const float2*)planes, (const int*)bs_in, (const int*)corr_in,
      (const int*)span_hi, (const int*)emit_lo, p, r, (int*)bs_out,
      (int*)corr_out, (float2*)v_out, (float*)err_out, (int*)start_out,
      (uint8_t*)emit_out);
  return (int)cudaGetLastError();
}

// The L2 design, for parameter sets the ring does not hold
// (kernels/ted_cuda.ring_plan routes them here): the same arguments
// without the ring's, one thread a lane, the picks read from L2.
int csdr_ted_scan_l2(const void* planes, int size, const void* bs_in,
                     const void* corr_in, const void* span_hi,
                     const void* emit_lo, int rows, int segs, int cap,
                     int nsb, int nshb, int nsqb, int off0, int off1,
                     int off2, int gardner, int use_q, float max_error,
                     float err_sign, float loop_gain, void* bs_out,
                     void* corr_out, void* v_out, void* err_out,
                     void* start_out, void* emit_out, void* stream) {
  if (bad_args(planes, size, bs_in, corr_in, span_hi, emit_lo, rows, segs,
               cap, bs_out, corr_out, v_out, err_out, start_out, emit_out))
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
