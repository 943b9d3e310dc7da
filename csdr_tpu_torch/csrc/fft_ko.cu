// Batched power-of-two DFT in "kernel bin order", forward and inverse.
//
// Replaces the TPU kernels in csdr_tpu/kernels/fft_pallas.py:
//   _fft_fwd_kernel (INV = false) and _fft_inv_kernel (INV = true),
// which share one pallas_call there as they share this template here,
// and fft_natural (that pallas_call, then ko_to_natural's relayout) as
// one launch of the forward in natural bin order (NAT = true).
//
// Contract (the TPU kernels' own, so that their consumers port unchanged):
// frames are (B, N) complex64, N a power of two in 128..16384, any B.
//   forward:  y[128*j + u] = X[T*u + bitrev_T(j)],  T = N/128,
//             X[k] = sum_n x[n] exp(-2*pi*i*k*n/N)            (FFTW sign)
//   inverse:  takes kernel order, returns natural order,
//             y[n] = sum_k X[k] exp(+2*pi*i*k*n/N)            (unnormalized)
//   natural:  the forward, y[k] = X[k]: the same arithmetic and bits as
//             the forward followed by the gather to natural order
// fastddc folds the bin order into its class matrices and fftfilt into
// its taps spectrum, so fwd -> pointwise -> inv never reorders.
//
// What bounds it.  A launch reads and writes each complex sample once,
// 16 B a point, against ~5*log2(N) FP32 operations a point: ~3 FLOP/B at
// N=1024, far below the H100's FP32 ridge (~20 FLOP/B), so device-memory
// bytes bound it at every N the port runs, and f32 FMA on the CUDA cores
// is enough (no tensor cores).  What stood between the first version of
// this kernel and that bound was on-chip: log2(N) radix-2 stages through
// shared memory with a barrier each, twiddles recomputed by every block,
// and a bit-reversed (bank-conflicted) store.
//
// Design: a four-step plan, N = T x 128, written as a mixed-radix
// decimation in frequency whose passes run in registers.
//   - Digits.  N = R_0 R_1 .. R_{P-1}, every R <= 16 and the last R = 16
//     (radix_plan in kernels/fft_cuda.py; 1024 = 8x8x16, 256 = 16x16).
//     Pass i takes the DFT over input digit i (stride S_i, the product of
//     the radices after it), multiplies its output k_i by the twiddle
//     W_N^(k_i * r * W_i) (r the lower digits, W_i the product of the
//     radices before it), and leaves k_i in place of digit i.  The first
//     passes, whose radices multiply to T, are the T-point column DFTs
//     with the W_N^(n1*k2) twiddle; the rest are the 128-point row DFT,
//     and where T and a row radix fit 16 points together they share one
//     pass (256 = 16x16: T=2 and the row's first radix 8).
//   - Registers.  A thread holds E=16 points (32 at N=16384) and runs its
//     radix-R DFTs on them as radix-2 stages with compile-time twiddles,
//     no barrier inside a pass.  Between passes the frame goes once
//     through shared memory, padded by two points every sixteen so that
//     the strided pass-to-pass exchange and the last pass's 16-point
//     rows (read as float4) are free of bank conflicts: P-1 exchanges
//     and barriers a frame (2 at N=1024, 1 at N=256; 10 and 8 radix-2
//     stages before).
//   - Kernel order for free.  After the last pass a thread holds the
//     16 bins kb + j*N/16 of one row, whose kernel positions are
//     ko(kb) + 8*j: it stores them straight to device memory, with the
//     lanes of a warp on consecutive positions of a row (full 32-byte
//     sectors).  No bit-reversed shared-memory traffic.  The inverse is
//     the transpose: the same passes in reverse order, reading kernel
//     order as the forward writes it, conjugate twiddles before each
//     DFT, natural order stored by the last pass.
//   - Natural order in one launch.  The forward's last pass then writes
//     its 16 bins kb + j*N/16 into the frame's own shared buffer at their
//     natural positions (after a barrier: every thread has read its
//     last-pass points), and after a second barrier the frame's threads
//     copy the N points out as float4s, consecutive lanes on consecutive
//     16 B (two float2 loads each).  The buffer is laid out by nat_slot,
//     an XOR swizzle of each point's bank pair (its position mod 16) by
//     a linear map of its row (position / 16), chosen so that both the
//     scatter (a half-warp's 16 bins at one j) and the copy's loads hit
//     16 distinct bank pairs at every N from 256 to 16384: no bank
//     conflict.  (The passes' pad would conflict 2-way on the scatter at
//     N = 512 and 4096 and 8-way at 8192 and 16384.)  At N = 128 kernel
//     order is natural order and the forward's own store is kept.
//     Storing the registers straight to natural positions instead puts
//     a warp's lanes N/256 points apart at N = 4096, each 8 B store a
//     partial sector; that form measured slower on the H100 (PERF.md).
//   - Twiddles.  One table per N, computed in float64 on the host and
//     rounded to complex64 (fft_cuda.twiddles), held on the card per
//     (N, device): pass by pass, the R-1 rows of S entries
//     W_N^(j * low * W_i), so that a warp reads consecutive entries (an
//     N-entry table indexed by j*low*W_i gathered up to 32 lines an
//     instruction and cost 13-25 % of the kernel's time).  A pass loads
//     its twiddles through the read-only path before its points; no
//     block computes a sine.
//   - Occupancy.  A block owns fpb frames of N/E threads each; fpb is the
//     largest power of two up to 64 threads a block that leaves at least
//     4 blocks an SM (paths B and C: one frame a block, 3200 blocks of 64
//     threads and 270 of 16).  One frame a block measured faster than
//     two or four at path B's shape (tools/k3_phases.py), and the frame
//     count does not change a block's barrier count.
// All arithmetic is f32: csdr_tpu's "HIGH" (bf16x3 matmuls) and
// "HIGHEST" both run here as f32, at least as accurate as either.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockThreads = 64;       // a block's threads up to N = 1024
constexpr int kBlocksPerSm = 4;         // fpb leaves at least this many
constexpr size_t kMaxSmem = 232448;     // 227 KB opt-in limit on sm_90

// ---- the plan (mirrored by fft_cuda.radix_plan) --------------------------

__host__ __device__ constexpr int num_passes(int logn) {
  return (logn + 3) / 4;
}

// log2 of pass i's radix: the last is 16, the others share the remaining
// bits, the earlier passes taking the odd ones
__host__ __device__ constexpr int pass_bits(int logn, int i) {
  return i == num_passes(logn) - 1
             ? 4
             : (logn - 4) / (num_passes(logn) - 1) +
                   (i < (logn - 4) % (num_passes(logn) - 1) ? 1 : 0);
}

// log2 of W_i, the product of the radices before pass i (the weight of
// k_i in the bin index)
__host__ __device__ constexpr int bits_before(int logn, int i) {
  int b = 0;
  for (int j = 0; j < i; ++j) b += pass_bits(logn, j);
  return b;
}

// log2 of S_i, the stride of digit i in the frame
__host__ __device__ constexpr int stride_bits(int logn, int i) {
  return logn - bits_before(logn, i) - pass_bits(logn, i);
}

// offset of digit i's twiddles in the table: the digits before it hold
// (R - 1) * S entries each (the last digit has none)
__host__ __device__ constexpr int tw_offset(int logn, int i) {
  int o = 0;
  for (int j = 0; j < i; ++j)
    o += ((1 << pass_bits(logn, j)) - 1) << stride_bits(logn, j);
  return o;
}

// bits <= 4, in closed form: a loop here is left rolled inside the
// unrolled DFT, and an index into the register arrays that is not a
// constant puts them in local memory
__host__ __device__ constexpr int bitrev(int k, int bits) {
  return (((k & 1) << 3) | ((k & 2) << 1) | ((k & 4) >> 1) | ((k & 8) >> 3))
         >> (4 - bits);
}

template <int LOGN>
struct Shape {
  static constexpr int N = 1 << LOGN;
  static constexpr int P = num_passes(LOGN);
  static constexpr int E = LOGN > 13 ? 32 : 16;   // points a thread holds
  static constexpr int TPF = N / E;               // threads a frame
  static constexpr int FRAME = N + N / 8;         // padded float2 a frame
  static constexpr int THREADS = TPF > kBlockThreads ? TPF : kBlockThreads;
};

// ---- arithmetic ----------------------------------------------------------

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {  // a*conj(b)
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

constexpr float kC1 = 0.923879532511286756f;   // cos(pi/8)
constexpr float kS1 = 0.382683432365089772f;   // sin(pi/8)
constexpr float kR2 = 0.707106781186547524f;   // sqrt(1/2)

__device__ __forceinline__ float2 mulk(float2 x, float c, float s) {
  return make_float2(x.x * c - x.y * s, x.x * s + x.y * c);
}

// x * exp(-2*pi*i*e/16); e is a constant once the DFT loops unroll, so the
// switch folds to the one case, with the multiplies by 0 and 1 left out
__device__ __forceinline__ float2 rot16(float2 x, int e) {
  switch (e & 15) {
    case 0: return x;
    case 1: return mulk(x, kC1, -kS1);
    case 2: return make_float2(kR2 * (x.x + x.y), kR2 * (x.y - x.x));
    case 3: return mulk(x, kS1, -kC1);
    case 4: return make_float2(x.y, -x.x);
    case 5: return mulk(x, -kS1, -kC1);
    case 6: return make_float2(kR2 * (x.y - x.x), -kR2 * (x.x + x.y));
    case 7: return mulk(x, -kC1, -kS1);
    case 8: return make_float2(-x.x, -x.y);
    case 9: return mulk(x, -kC1, kS1);
    case 10: return make_float2(-kR2 * (x.x + x.y), kR2 * (x.x - x.y));
    case 11: return mulk(x, -kS1, kC1);
    case 12: return make_float2(-x.y, x.x);
    case 13: return mulk(x, kS1, kC1);
    case 14: return make_float2(kR2 * (x.x - x.y), kR2 * (x.x + x.y));
    default: return mulk(x, kC1, kS1);
  }
}

// The radix-2 decimation-in-frequency stages of half-span H down to 1 on
// v[0..R): a template per stage, so every loop has a constant trip count
// and every register index is a constant once it unrolls
template <int R, int H, bool INV>
__device__ __forceinline__ void dif_stages(float2* v) {
#pragma unroll
  for (int a = 0; a < R; a += 2 * H) {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float2 p = v[a + i], q = v[a + i + H];
      constexpr int kStep = 8 / H;              // W_(2H)^i = W_16^(i*8/H)
      v[a + i] = make_float2(p.x + q.x, p.y + q.y);
      v[a + i + H] = rot16(make_float2(p.x - q.x, p.y - q.y),
                           INV ? -i * kStep : i * kStep);
    }
  }
  if constexpr (H > 1) dif_stages<R, H / 2, INV>(v);
}

// R-point DFT of v[0..R) in registers (sign by INV), natural order out:
// the radix-2 stages leave bin k at v[bitrev(k)], undone by renaming
// registers
template <int R, bool INV>
__device__ __forceinline__ void dft(float2* v) {
  dif_stages<R, R / 2, INV>(v);
  constexpr int B = R == 16 ? 4 : R == 8 ? 3 : R == 4 ? 2 : 1;
  float2 t[R];
#pragma unroll
  for (int k = 0; k < R; ++k) t[k] = v[bitrev(k, B)];
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = t[k];
}

__device__ __forceinline__ int pad(int p) { return p + ((p >> 4) << 1); }

// the bin held at in-place position p once every pass has run: digit i
// (at stride S_i) holds k_i, whose weight in the bin is W_i
template <int LOGN, int I = 0>
__device__ __forceinline__ int bin_of(int p) {
  constexpr int SB = stride_bits(LOGN, I), RB = pass_bits(LOGN, I);
  constexpr int WB = bits_before(LOGN, I);
  const int k = ((p >> SB) & ((1 << RB) - 1)) << WB;
  if constexpr (I + 1 < num_passes(LOGN)) {
    return k | bin_of<LOGN, I + 1>(p);
  } else {
    return k;
  }
}

// kernel-order position of bin k: 128*bitrev_T(k mod T) + k/T
template <int LOGN>
__device__ __forceinline__ int ko_pos(int k) {
  constexpr int LOGT = LOGN - 7;
  if constexpr (LOGT == 0) {
    return k;
  } else {
    return (int)((__brev((unsigned)k) >> (32 - LOGT)) << 7) | (k >> LOGT);
  }
}

// The natural-order buffer's layout: point a at a ^ h(a >> 4), where row
// bit b flips the bank pair (the low 4 bits) by nibble b of kNatSwizzle
// (5, 2, 9, 4, 2, 8 for row bits 0..5; higher bits flip none).  h is
// linear, so nat_slot(a ^ c) = nat_slot(a) ^ nat_slot(c): a thread finds
// its 16 slots from one call and constants.  The four bits of a that a
// half-warp's lanes vary in the scatter (which four depends on N's
// plan), and the four they vary in the copy (bits 1-4), move the bank
// pair independently at every N: 16 lanes, 16 bank pairs
// (tests/test_torch_fft_natural.py models the store and counts the
// conflicts).
constexpr int kNatSwizzle = 0x824925;

__host__ __device__ constexpr int nat_slot(int a) {
  int h = 0;
  for (int b = 0; b < 6; ++b)
    if ((a >> (4 + b)) & 1) h ^= (kNatSwizzle >> (4 * b)) & 15;
  return a ^ h;
}

// ---- one pass ------------------------------------------------------------

// The K-th pass run (digit I = K forward, P-1-K inverse) on the E points
// of thread t of its frame: load (device memory on the first pass, else
// shared), DFTs and twiddles, store (device memory on the last pass).
// Group q of the thread fixes every digit but I, with consecutive lanes on
// consecutive low digits (those below I): base is its position with digit
// I at 0.  NAT: the forward's last pass stores natural order through s.
template <int LOGN, bool INV, bool NAT, int K>
__device__ __forceinline__ void pass(float2* v, float2* s,
                                     const float2* __restrict__ xf,
                                     float2* __restrict__ yf,
                                     const float2* __restrict__ tw, int t,
                                     bool live) {
  using S = Shape<LOGN>;
  constexpr int I = INV ? S::P - 1 - K : K;
  constexpr int RB = pass_bits(LOGN, I), R = 1 << RB;
  constexpr int SB = stride_bits(LOGN, I), STRIDE = 1 << SB;
  constexpr int TO = tw_offset(LOGN, I);
  constexpr int G = S::E / R;                     // DFTs a thread runs
  constexpr bool FIRST = K == 0, LAST = K == S::P - 1;
  constexpr bool TWIDDLE = I < S::P - 1;          // the last digit has none
  static_assert(SB > 0 || R == 16, "the last digit is radix 16");
  static_assert(!(NAT && INV), "natural order is a forward's");

  int base[G], low[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int g = t + q * S::TPF;
    low[q] = g & (STRIDE - 1);
    base[q] = ((g >> SB) << (RB + SB)) | low[q];
  }
  // this pass's twiddles W_N^(j * low * W_I), j = 1..R-1, at TO + (j-1)*S
  // + low: consecutive lanes read consecutive entries, loaded ahead of
  // the points
  float2 twr[TWIDDLE ? G * (R - 1) : 1];
  if constexpr (TWIDDLE) {
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int j = 1; j < R; ++j)
        twr[q * (R - 1) + j - 1] = __ldg(tw + TO + (j - 1) * STRIDE + low[q]);
  }

  // load
  if constexpr (FIRST) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
      // forward: natural order; inverse (I = P-1, stride 1): the 16 bins
      // kb + j*N/16 sit at kernel positions ko(kb) + 8*j
      const int p0 = INV ? ko_pos<LOGN>(bin_of<LOGN>(base[q])) : base[q];
#pragma unroll
      for (int j = 0; j < R; ++j)
        v[q * R + j] = live ? xf[p0 + j * (INV ? 8 : STRIDE)]
                            : make_float2(0.f, 0.f);
    }
  } else if constexpr (SB == 0) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const float4* row = reinterpret_cast<const float4*>(s + pad(base[q]));
#pragma unroll
      for (int j = 0; j < R / 2; ++j) {
        const float4 a = row[j];
        v[q * R + 2 * j] = make_float2(a.x, a.y);
        v[q * R + 2 * j + 1] = make_float2(a.z, a.w);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int j = 0; j < R; ++j)
        v[q * R + j] = s[pad(base[q] + j * STRIDE)];
  }

  // DFTs over digit I; the twiddles after the DFT forward, conjugated
  // before it inverse
#pragma unroll
  for (int q = 0; q < G; ++q) {
    float2* w = v + q * R;
    if constexpr (INV && TWIDDLE) {
#pragma unroll
      for (int j = 1; j < R; ++j)
        w[j] = cmulc(w[j], twr[q * (R - 1) + j - 1]);
    }
    dft<R, INV>(w);
    if constexpr (!INV && TWIDDLE) {
#pragma unroll
      for (int j = 1; j < R; ++j)
        w[j] = cmul(w[j], twr[q * (R - 1) + j - 1]);
    }
  }

  // store
  if constexpr (LAST && NAT && LOGN > 7) {
    __syncthreads();   // every thread has read its points from s
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int k0 = nat_slot(bin_of<LOGN>(base[q]));
#pragma unroll
      for (int j = 0; j < R; ++j)
        s[k0 ^ nat_slot(j * (S::N / 16))] = v[q * R + j];
    }
    __syncthreads();
    if (live) {
      const int p0 = nat_slot(2 * t);
      float4* y4 = reinterpret_cast<float4*>(yf);
#pragma unroll
      for (int i = 0; i < S::E / 2; ++i) {
        const int p = p0 ^ nat_slot(2 * i * S::TPF);
        const float2 a = s[p], b = s[p ^ 1];
        y4[t + i * S::TPF] = make_float4(a.x, a.y, b.x, b.y);
      }
    }
  } else if constexpr (LAST) {
    if (live) {
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int p0 = INV ? base[q] : ko_pos<LOGN>(bin_of<LOGN>(base[q]));
#pragma unroll
        for (int j = 0; j < R; ++j)
          yf[p0 + j * (INV ? STRIDE : 8)] = v[q * R + j];
      }
    }
  } else if constexpr (SB == 0) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
      float4* row = reinterpret_cast<float4*>(s + pad(base[q]));
#pragma unroll
      for (int j = 0; j < R / 2; ++j)
        row[j] = make_float4(v[q * R + 2 * j].x, v[q * R + 2 * j].y,
                             v[q * R + 2 * j + 1].x, v[q * R + 2 * j + 1].y);
    }
  } else {
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int j = 0; j < R; ++j)
        s[pad(base[q] + j * STRIDE)] = v[q * R + j];
  }
}

template <int LOGN, bool INV, bool NAT, int K>
__device__ __forceinline__ void passes(float2* v, float2* s,
                                       const float2* __restrict__ xf,
                                       float2* __restrict__ yf,
                                       const float2* __restrict__ tw, int t,
                                       bool live) {
  pass<LOGN, INV, NAT, K>(v, s, xf, yf, tw, t, live);
  if constexpr (K + 1 < Shape<LOGN>::P) {
    __syncthreads();   // each pass stores only the points it loaded
    passes<LOGN, INV, NAT, K + 1>(v, s, xf, yf, tw, t, live);
  }
}

// (a minimum of one block an SM leaves ptxas free to hold a pass's loads
// in flight together: ~105 registers at N=1024 and 78 at N=256, and 4-8 %
// faster at paths B's and C's shapes than the 56-72 it picks unasked)
template <int LOGN, bool INV, bool NAT>
__global__ void __launch_bounds__(Shape<LOGN>::THREADS, 1)
fft_ko_kernel(const float2* __restrict__ x, float2* __restrict__ y,
              const float2* __restrict__ tw, long long batch, int fpb) {
  using S = Shape<LOGN>;
  extern __shared__ float4 smem4[];
  const int fl = threadIdx.x / S::TPF;            // frame in the block
  const int t = threadIdx.x % S::TPF;
  const long long f = (long long)blockIdx.x * fpb + fl;
  const bool live = f < batch;
  float2* s = reinterpret_cast<float2*>(smem4) + fl * S::FRAME;
  float2 v[S::E];
  passes<LOGN, INV, NAT, 0>(v, s, x + f * S::N, y + f * S::N, tw, t, live);
}

// ---- launch --------------------------------------------------------------

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess || count <= 0)
      count = 132;
  }
  return count;
}

// frames a block: the most that fit kBlockThreads, halved while the grid
// would give an SM fewer than kBlocksPerSm blocks
int frames_per_block(int logn, long long batch) {
  const int tpf = (1 << logn) / (logn > 13 ? 32 : 16);
  int fpb = tpf >= kBlockThreads ? 1 : kBlockThreads / tpf;
  while (fpb > 1 && batch / fpb < (long long)kBlocksPerSm * sm_count())
    fpb >>= 1;
  return fpb;
}

template <int LOGN, bool INV, bool NAT>
int launch_n(const float2* x, float2* y, const float2* tw, long long batch,
             cudaStream_t stream) {
  using S = Shape<LOGN>;
  const int fpb = frames_per_block(LOGN, batch);
  const size_t smem = (size_t)fpb * S::FRAME * sizeof(float2);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fft_ko_kernel<LOGN, INV, NAT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (batch + fpb - 1) / fpb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fft_ko_kernel<LOGN, INV, NAT>
      <<<(unsigned)blocks, fpb * S::TPF, smem, stream>>>(x, y, tw, batch, fpb);
  return (int)cudaGetLastError();
}

template <bool INV, bool NAT>
int launch(const void* x, void* y, const void* tw, int n, long long batch,
           void* stream) {
  if (n < 128 || n > 16384 || (n & (n - 1)) || batch < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  if (x == y || tw == nullptr) return (int)cudaErrorInvalidValue;
  const float2* xs = (const float2*)x;
  float2* ys = (float2*)y;
  const float2* ts = (const float2*)tw;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 128: return launch_n<7, INV, NAT>(xs, ys, ts, batch, st);
    case 256: return launch_n<8, INV, NAT>(xs, ys, ts, batch, st);
    case 512: return launch_n<9, INV, NAT>(xs, ys, ts, batch, st);
    case 1024: return launch_n<10, INV, NAT>(xs, ys, ts, batch, st);
    case 2048: return launch_n<11, INV, NAT>(xs, ys, ts, batch, st);
    case 4096: return launch_n<12, INV, NAT>(xs, ys, ts, batch, st);
    case 8192: return launch_n<13, INV, NAT>(xs, ys, ts, batch, st);
    default: return launch_n<14, INV, NAT>(xs, ys, ts, batch, st);
  }
}

int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

extern "C" {

// Forward DFT of `batch` contiguous frames of n points, output in kernel
// bin order; tw is fft_cuda.twiddles(n) (complex64, on the device).
// Returns a cudaError_t.
int csdr_fft_ko(const void* x, void* y, const void* tw, int n,
                long long batch, void* stream) {
  return launch<false, false>(x, y, tw, n, batch, stream);
}

// Forward DFT as csdr_fft_ko, output in natural bin order (bit for bit the
// kernel-order output gathered by fft_cuda.kernel_perm).
int csdr_fft_natural(const void* x, void* y, const void* tw, int n,
                     long long batch, void* stream) {
  return launch<false, true>(x, y, tw, n, batch, stream);
}

// Inverse DFT (unnormalized) of kernel-order frames, natural-order output;
// tw is the same table as the forward's.
int csdr_ifft_ko(const void* x, void* y, const void* tw, int n,
                 long long batch, void* stream) {
  return launch<true, false>(x, y, tw, n, batch, stream);
}

// log2 of the radix of pass i of the n-point plan; 0 past its last pass,
// -1 for an n the kernel refuses.
int csdr_fft_ko_pass_bits(int n, int i) {
  if (n < 128 || n > 16384 || (n & (n - 1)) || i < 0) return -1;
  const int logn = log2_of(n);
  return i < num_passes(logn) ? pass_bits(logn, i) : 0;
}

// Frames a block of the launch for (n, batch), as the launch picks them.
int csdr_fft_ko_frames_per_block(int n, long long batch) {
  if (n < 128 || n > 16384 || (n & (n - 1)) || batch < 1) return -1;
  return frames_per_block(log2_of(n), batch);
}

}  // extern "C"
