// fastddc factored-v2 inverse: C channels x B frames in one launch.
//
// Replaces the TPU kernel _inv_kernel in
// csdr_tpu/kernels/fastddc_pallas.py.  Computes, for the raw spectra S
// (B, pre*inv), the per-channel folded taps TQ (C, pre, inv), the shared
// iDFT-and-select matrix W (inv, M), the per-channel output diagonal
// d (C, M) and the per-frame NCO rot (C, B), all complex64:
//   fold:  Z[c,b,m] = sum_{j<pre} S[b, j*inv + m] * TQ[c,j,m]
//   iDFT:  Y[c,b,o] = sum_{m<inv} Z[c,b,m] * W[m,o]
//   out[c,b,o] = (Y[c,b,o] * d[c,o]) * rot[c,b]          o < m_out
// (the same linear map as fastddc.c:106-166 per channel; csdr_tpu applies
// rot to Z before the product, which is equal up to f32 rounding: the
// order here is that of the plain version, fastddc_inv_plain).
//
// What bounds it.  At the 64-channel D=16 plan (pre=8, inv=128, M=56,
// B=1024) a launch moves ~38 MB but does 4.3 GFLOP, 3.76 of them in the
// iDFT: in FP32 FMA that is 64 us of operations against 11 us of bytes.
// The iDFT is a dense (C*B x inv) x (inv x M) complex product, so it runs
// on the tensor cores; the fold (8 complex MAC per Z element at D=16, 128
// at D=256) stays exact FP32 FMA.
//
// Design.  A block owns kCB=8 channels x kBT=16 frames, 128 rows of Z (one
// 16-row MMA tile per warp), and MT = 8*NI output columns: M rounded up to
// a multiple of 8, all of M in one block up to 56 columns.  Wider plans
// (D <= 8) take several column blocks: a warp keeps 16 rows x MT columns
// of f32 sums in registers, and at 112 columns (and 3xTF32 operands
// beside them) the kernel spilled and ran no faster than 2 x 56.  Its
// grid runs channel tiles fastest, so blocks resident together share the
// S rows they stage.  It
// walks the inv axis in chunks of KC = min(inv, 32) bins and, inside a
// chunk, the pre axis in stages of JC folds (chosen on the host by
// fastddc_cuda.plan_tiles: the longest stage, up to 16 folds, at which
// two blocks share an SM, else the longest that fits one):
//   1. staging: each stage's S rows (16 frames x JC x KC), TQ rows
//      (8 channels x JC x KC) and, on a chunk's last stage, the W chunk
//      (KC x MT) are copied with cp.async into one of two buffers; the
//      next stage's copy is issued before this stage's fold and product,
//      so the loads overlap them;
//   2. fold: a warp owns 4 channels x 4 frames and its lanes the KC bins
//      of the chunk; each lane keeps that 4x4 register tile of Z (8 shared
//      loads feed 16 complex FMA).  When KC < 32 (inv=16 at D=256) the
//      lanes the chunk leaves free split the j sum: lane group jg takes
//      j = jg, jg + 32/KC, ..., and one __shfl_xor butterfly per chunk
//      adds the partial sums.  A shuffle, not shared memory or a tensor-
//      core fold: the partial sums are already in the lanes of one warp,
//      and it keeps the fold exact FP32 with every lane busy (the earlier
//      kernel left half the fold threads idle at inv=16 and ran a serial
//      128-step chain of global loads per thread);
//   3. the chunk's Z tile goes to shared memory already split for 3xTF32
//      (hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), as one float4 per
//      complex value), and the staged W chunk is split the same way;
//   4. product: each warp runs mma.sync.m16n8k8 TF32 on its 16 rows and
//      the NI n-tiles, the complex product as four real products
//      (Yr += Zr Wr - Zi Wi, Yi += Zr Wi + Zi Wr) and each real product as
//      lo*hi + hi*lo + hi*hi; each 8-bin step goes into fresh f32
//      accumulators that are then added to the running sums, since the
//      tensor cores truncate as they accumulate.  f32-accurate (~2^-22
//      a product, ~130 dB against the plain version) whatever
//      torch.backends.cuda.matmul.allow_tf32 says: the rounding is this
//      kernel's own arithmetic.
// After the last chunk the epilogue applies d and rot and stores
// (C, B, m_out).  Z never goes to device memory.  Ragged frame, channel
// and column tiles are zero-filled by cp.async and masked at the store.
// No library call: the fold and the product are this kernel's own code.
//
// Bounds (chip_smoke.py computes them per case): FP32 operations over
// 67 TFLOP/s ("bound_ms"), or, with the iDFT on tensor cores, the fold
// over 67 TFLOP/s plus 3x the iDFT over 495 TFLOP/s ("bound_tc_ms"):
// ~31 us at the D=16 plan, against 64 us in FP32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCB = 8;                     // channels per block
constexpr int kBT = 16;                    // frames per block
constexpr int kRows = kCB * kBT;           // rows (channel, frame) of Z
constexpr int kCR = 4;                     // fold tile: channels per warp
constexpr int kBR = 4;                     //            frames per warp
constexpr int kMaxSmem = 232448;           // opt-in shared memory a block
static_assert(kRows == 16 * kWarps, "one 16-row MMA tile per warp");
static_assert((kCB / kCR) * (kBT / kBR) == kWarps, "one fold tile per warp");

// bytes of dynamic shared memory for bin chunk kc, column tile mt, fold
// stage jc: two staging buffers (S, TQ, W raw) and the split Z and W
__host__ __device__ constexpr long long smem_bytes(int kc, int mt, int jc) {
  return 2LL * 8 * ((long long)kBT * jc * kc + (long long)kCB * jc * kc +
                    (long long)kc * mt) +
         16LL * ((long long)kRows * (kc + 4) + (long long)kc * (mt + 2));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// 8 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0));
}

// 16 bytes global -> shared (both 16-byte aligned); zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// (re_hi, re_lo, im_hi, im_lo): x = hi + lo to ~2^-22, each part a TF32
__device__ __forceinline__ float4 split(float2 z) {
  const float rh = tf32(z.x), ih = tf32(z.y);
  return make_float4(rh, tf32(z.x - rh), ih, tf32(z.y - ih));
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// c += a (16x8, row) * b (8x8, col), TF32 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: the two small terms first, then hi*hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

template <int KC, int NI>
__global__ void __launch_bounds__(kThreads, 1)
fastddc_inv_kernel(const float2* __restrict__ S, const float2* __restrict__ TQ,
                   const float2* __restrict__ W, const float2* __restrict__ D,
                   const float2* __restrict__ rot, float2* __restrict__ out,
                   long long B, int C, int pre, int inv, int ldw, int ldd,
                   int m_out, int jc_len) {
  constexpr int MT = 8 * NI;               // output columns per block
  constexpr int ZLD = KC + 4;              // float4 row stride of split Z
  constexpr int WLD = MT + 2;              // float4 row stride of split W
  constexpr int JS = 32 / KC;              // lane groups splitting j
  static_assert(KC % 8 == 0 && 32 % KC == 0, "KC: 8, 16 or 32");

  extern __shared__ float4 smem[];
  float4* zs = smem;                       // [kRows][ZLD]
  float4* ws = zs + kRows * ZLD;           // [KC][WLD]
  float2* stages = reinterpret_cast<float2*>(ws + KC * WLD);
  const int s_len = kBT * jc_len * KC;     // S rows of a stage
  const int t_len = kCB * jc_len * KC;     // TQ rows of a stage
  const int stage_len = s_len + t_len + KC * MT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // channel tiles vary fastest, so blocks running together share S rows
  const int c0 = blockIdx.x * kCB;
  const long long b0 = (long long)blockIdx.y * kBT;
  const int o0 = blockIdx.z * MT;
  const long long fft = (long long)pre * inv;
  const int n_j = pre / jc_len;
  const int n_stages = n_j * (inv / KC);

  // stage s: fold stage s % n_j of bin chunk s / n_j, into buffer s & 1.
  // S and TQ rows go as pairs of bins (16 bytes; the wrapper checks the
  // alignment); jc_len and KC are powers of two, so the indices are
  // shifts and masks
  const int lg_row = __ffs(jc_len) - 1 + __ffs(KC) - 1;   // log2(jc*KC)
  auto load_stage = [&](int s) {
    float2* st = stages + (s & 1) * stage_len;
    const int k0 = (s / n_j) * KC;
    const int j0 = (s % n_j) * jc_len;
    float2* tt = st + s_len;
    for (int e = 2 * tid; e < s_len; e += 2 * kThreads) {
      const int jj = (e & ((1 << lg_row) - 1)) / KC, kk = e % KC;
      const long long b = b0 + (e >> lg_row);
      const bool ok = b < B;
      cp_async16(st + e,
                 ok ? S + b * fft + (long long)(j0 + jj) * inv + k0 + kk : S,
                 ok);
    }
    for (int e = 2 * tid; e < t_len; e += 2 * kThreads) {
      const int jj = (e & ((1 << lg_row) - 1)) / KC, kk = e % KC;
      const int c = c0 + (e >> lg_row);
      const bool ok = c < C;
      cp_async16(tt + e,
                 ok ? TQ + ((long long)c * pre + j0 + jj) * inv + k0 + kk
                    : TQ,
                 ok);
    }
    if (s % n_j == n_j - 1) {              // the chunk's W, on its last stage
      float2* wt = tt + t_len;
      for (int e = tid; e < KC * MT; e += kThreads) {
        const int o = o0 + e % MT;
        const bool ok = o < m_out;
        cp_async8(wt + e, ok ? W + (long long)(k0 + e / MT) * ldw + o : W,
                  ok);
      }
    }
    cp_async_commit();
  };

  // fold mapping: bin kk of the chunk, j group jg; the warp's 4 channels
  // (cg) x 4 frames (fg)
  const int kk = lane % KC;
  const int jg = lane / KC;
  const int cg = warp / (kBT / kBR);
  const int fg = warp % (kBT / kBR);
  // product mapping (mma fragments): group g, thread-in-group t
  const int g = lane >> 2;
  const int t = lane & 3;

  float acc[NI][2][4];                     // [n-tile][re, im][fragment]
#pragma unroll
  for (int n = 0; n < NI; ++n)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n][p][q] = 0.f;

  load_stage(0);
  for (int s0 = 0; s0 < n_stages; s0 += n_j) {   // one bin chunk
    // the fold's register tile lives only while the chunk folds
    float2 z[kCR][kBR];
#pragma unroll
    for (int ci = 0; ci < kCR; ++ci)
#pragma unroll
      for (int bi = 0; bi < kBR; ++bi) z[ci][bi] = make_float2(0.f, 0.f);
    const float2* st = stages;
    for (int s = s0; s < s0 + n_j; ++s) {
      cp_async_wait_all();
      // stage s is visible to all, and every thread is done with the
      // other buffer and with the previous chunk's Z and W
      __syncthreads();
      if (s + 1 < n_stages) load_stage(s + 1);
      st = stages + (s & 1) * stage_len;
      const float2* ss = st + fg * kBR * jc_len * KC + kk;
      const float2* ts = st + s_len + cg * kCR * jc_len * KC + kk;
      for (int jj = jg; jj < jc_len; jj += JS) {
        float2 sv[kBR], tv[kCR];
#pragma unroll
        for (int bi = 0; bi < kBR; ++bi) sv[bi] = ss[(bi * jc_len + jj) * KC];
#pragma unroll
        for (int ci = 0; ci < kCR; ++ci) tv[ci] = ts[(ci * jc_len + jj) * KC];
#pragma unroll
        for (int ci = 0; ci < kCR; ++ci)
#pragma unroll
          for (int bi = 0; bi < kBR; ++bi) cmac(z[ci][bi], sv[bi], tv[ci]);
      }
    }

    // the chunk's fold is complete: add the j groups' partial sums
#pragma unroll
    for (int off = KC; off < 32; off <<= 1)
#pragma unroll
      for (int ci = 0; ci < kCR; ++ci)
#pragma unroll
        for (int bi = 0; bi < kBR; ++bi) {
          z[ci][bi].x += __shfl_xor_sync(0xffffffffu, z[ci][bi].x, off);
          z[ci][bi].y += __shfl_xor_sync(0xffffffffu, z[ci][bi].y, off);
        }
    // split Z into shared memory (row = channel * kBT + frame); the j
    // groups share the writes
#pragma unroll
    for (int ci = 0; ci < kCR; ++ci)
#pragma unroll
      for (int bi = 0; bi < kBR; ++bi)
        if ((ci * kBR + bi) % JS == jg)
          zs[((cg * kCR + ci) * kBT + fg * kBR + bi) * ZLD + kk] =
              split(z[ci][bi]);
    const float2* wt = st + s_len + t_len;   // staged on the last stage
    for (int e = tid; e < KC * MT; e += kThreads)
      ws[(e / MT) * WLD + e % MT] = split(wt[e]);
    __syncthreads();

    // the chunk's product on the tensor cores: rows 16*warp.., all columns.
    // One 8-bin step at a time: unrolled over the chunk, the compiler
    // hoisted every step's fragments and spilled (255 registers at 56
    // columns); stepwise it fits in ~226 and ran 13-16 % faster
    const float4* za = zs + (warp * 16 + g) * ZLD + t;
#pragma unroll 1
    for (int k8 = 0; k8 < KC; k8 += 8) {
      const float4 f0 = za[k8], f1 = za[8 * ZLD + k8];
      const float4 f2 = za[k8 + 4], f3 = za[8 * ZLD + k8 + 4];
      const uint32_t neg = 0x80000000u;
      const uint32_t arh[4] = {bits(f0.x), bits(f1.x), bits(f2.x), bits(f3.x)};
      const uint32_t arl[4] = {bits(f0.y), bits(f1.y), bits(f2.y), bits(f3.y)};
      const uint32_t aih[4] = {bits(f0.z), bits(f1.z), bits(f2.z), bits(f3.z)};
      const uint32_t ail[4] = {bits(f0.w), bits(f1.w), bits(f2.w), bits(f3.w)};
      const uint32_t nih[4] = {aih[0] ^ neg, aih[1] ^ neg, aih[2] ^ neg,
                               aih[3] ^ neg};
      const uint32_t nil[4] = {ail[0] ^ neg, ail[1] ^ neg, ail[2] ^ neg,
                               ail[3] ^ neg};
      const float4* wb = ws + (k8 + t) * WLD + g;
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const float4 w0 = wb[n * 8], w1 = wb[4 * WLD + n * 8];
        const uint32_t brh0 = bits(w0.x), brh1 = bits(w1.x);
        const uint32_t brl0 = bits(w0.y), brl1 = bits(w1.y);
        const uint32_t bih0 = bits(w0.z), bih1 = bits(w1.z);
        const uint32_t bil0 = bits(w0.w), bil1 = bits(w1.w);
        // this step's Yr = Zr Wr + (-Zi) Wi, Yi = Zr Wi + Zi Wr, in fresh
        // accumulators, then added to the running sums in f32: the tensor
        // cores truncate as they accumulate, which over the 6 * inv/8
        // products of one chain cost ~30 dB at inv=512 (102.8 dB against
        // the plain version on the card); chains of 6 keep ~130 dB
        float pr[4] = {0.f, 0.f, 0.f, 0.f}, pi[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(pr, arh, arl, brh0, brh1, brl0, brl1);
        mma3(pi, arh, arl, bih0, bih1, bil0, bil1);
        mma3(pr, nih, nil, bih0, bih1, bil0, bil1);
        mma3(pi, aih, ail, brh0, brh1, brl0, brl1);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[n][0][q] += pr[q];
          acc[n][1][q] += pi[q];
        }
      }
    }
  }

  // epilogue: fragment q of n-tile n is row g + 8*(q/2), column 2t + q%2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    const int c = c0 + r / kBT;
    const long long b = b0 + r % kBT;
    if (c >= C || b >= B) continue;
    const float2 rc = rot[(long long)c * B + b];
    float2* orow = out + ((long long)c * B + b) * m_out;
#pragma unroll
    for (int n = 0; n < NI; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = o0 + n * 8 + 2 * t + e;
        if (o < m_out) {
          const float2 y = make_float2(acc[n][0][2 * h + e],
                                       acc[n][1][2 * h + e]);
          orow[o] = cmul(cmul(y, D[(long long)c * ldd + o]), rc);
        }
      }
  }
}

struct Args {
  const float2 *S, *TQ, *W, *D, *rot;
  float2* out;
  long long B;
  int C, pre, inv, ldw, ldd, m_out, jc;
};

template <int KC, int NI>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int MT = 8 * NI;
  const long long smem = smem_bytes(KC, MT, a.jc);
  if (smem > kMaxSmem || a.inv % KC != 0) return (int)cudaErrorInvalidValue;
  auto kern = fastddc_inv_kernel<KC, NI>;
  static long long opted = 48 * 1024;      // this instance's opt-in so far
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const int gx = (a.C + kCB - 1) / kCB;
  const long long gy = (a.B + kBT - 1) / kBT;
  const int gz = (a.m_out + MT - 1) / MT;
  if (gy > 65535 || gz > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  kern<<<grid, kThreads, (size_t)smem, stream>>>(
      a.S, a.TQ, a.W, a.D, a.rot, a.out, a.B, a.C, a.pre, a.inv, a.ldw,
      a.ldd, a.m_out, a.jc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (C, B, m_out) from S (B, pre*inv), TQ (C, pre, inv), W (inv, ldw),
// D (C, ldd), rot (C, B); all complex64, contiguous, S and TQ 16-byte
// aligned.  Tiles from
// fastddc_cuda.plan_tiles: bin chunk kc (16 or 32, dividing inv), column
// tile mt (8 * {1, 2, 4, 7}), fold stage jc (dividing pre).  Returns a
// cudaError_t.
int csdr_fastddc_inv(const void* S, const void* TQ, const void* W,
                     const void* D, const void* rot, void* out, long long B,
                     int C, int pre, int inv, int ldw, int ldd, int m_out,
                     int kc, int mt, int jc, void* stream) {
  if (B < 0 || C < 1 || pre < 1 || inv < 1 || m_out < 1 || m_out > ldw ||
      m_out > ldd || jc < 1 || pre % jc != 0 ||
      ((reinterpret_cast<uintptr_t>(S) | reinterpret_cast<uintptr_t>(TQ)) &
       15) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args a{(const float2*)S, (const float2*)TQ, (const float2*)W,
               (const float2*)D, (const float2*)rot, (float2*)out,
               B, C, pre, inv, ldw, ldd, m_out, jc};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kc * 1000 + mt) {
    case 32008: return launch<32, 1>(a, st);
    case 32016: return launch<32, 2>(a, st);
    case 32032: return launch<32, 4>(a, st);
    case 32056: return launch<32, 7>(a, st);
    case 16008: return launch<16, 1>(a, st);
    case 16016: return launch<16, 2>(a, st);
    case 16032: return launch<16, 4>(a, st);
    case 16056: return launch<16, 7>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory of one block at tiles (kc, mt, jc)
int csdr_fastddc_inv_smem_bytes(int kc, int mt, int jc) {
  return (int)smem_bytes(kc, mt, jc);
}

}  // extern "C"
