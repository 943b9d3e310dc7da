// Decimating FIR over a carried stream, optionally NCO-mixed on load.
//
// Replaces the TPU kernels in csdr_tpu/kernels/fir_pallas.py:
//   _fir_vmem_shift_kernel (MIX = true: NCO shift fused into the FIR) and
//   _fir_vmem_kernel       (MIX = false: the plain decimating FIR),
// which share _vmem_core there as they share this template here.
//
// Computes, over the virtual stream v = [tail | x] (tail_len + n complex
// samples, indexed s = 0 .. tail_len + n - 1):
//   y[k] = sum_{t < T} m(s) * v[s] * h[t],   s = k*D + t,   k < kout
// with m(s) = exp(j*2*pi*(theta + rate*s)) when MIX, else 1.  The phase of
// sample s is frac(rate*s) in float64, plus theta, then an f32 sincospi:
// nothing is accumulated along the stream.  Each output is one f32 fmaf
// chain for its real part and one for its imaginary part, over t = 0, 1,
// .., T-1 in order: csdr_tpu's "HIGHEST" and "HIGH" (bf16x3) both run here
// as that chain, which is at least as accurate as either.
//
// The kernel reads the carried tail and the new chunk through two base
// pointers, so one launch gives every output of a chunk: there is no
// concatenation pass over the chunk and no head/body/tail split.
//
// What bounds it on an H100.  At the receivers' shapes (T/D <= 17) a launch
// moves ~8 B an input sample and does 2T/D FMA a sample, so device-memory
// bytes bound it (6.3 us at the WFM front end, 5.9 at D=50).  Fed from
// shared memory, each output-tap costs a lane 8 B of window and 4 B of tap
// broadcast, and shared memory delivers 128 B a clock an SM: that is the
// larger cost at every shape but T=81, ahead of the FMA.  A one-output-a-
// thread kernel also loads its window one sample at a time, with little in
// flight.
//
// Design.  A block owns tile = NT*R*S consecutive outputs: NT summing
// threads, each with S runs of R consecutive outputs (R, S and NT come
// from the host planner, fir_cuda.plan_tile, for the shape; the template
// covers R = 1, 2, 4 and S = 1, 2).  The block stages
//  - its input window phase-major: X[p][c] = v[s0 + c*D + p] for the D
//    phases p and tile + M - 1 columns c (M = ceil(T/D) tap rows), each
//    sample from tail or x by its index and zero past the stream's end.
//    K2 copies it with cp.async, every copy of a thread in flight at once.
//    K1 loads it in batches of kStageBatch samples a thread into registers
//    and mixes each sample once as it stores it, with kMixStagers times
//    the summing threads, since the mix costs more than the sum there;
//  - its taps as a table of R-vectors: H[u][p][r] = h[(u-r)*D + p].
// Output j = i*R + r of run g of thread i (g*NT*R on) at tap t = m*D + p
// reads X[p][j + m].  So at step (u, p) every output r of the run reads the
// one sample X[p][i*R + u] at tap row m = u - r: one 8-byte window load
// serves R outputs, and one R-vector of taps serves the S runs.  A lane
// then reads 8/R + 4/S bytes an output-tap instead of 12.  The steps run u
// outer, p inner, so each output still meets its taps in the order t = 0,
// 1, .., T-1: every output is bit for bit the sum of the one-output-a-
// thread kernel this replaced.  Column c of a row is stored at sub-row
// c % R, position c / R, so a warp's 32 lanes read 32 consecutive words;
// the row stride is odd, so the transposing stores of the staging spread
// over the banks.  Steps where an output has no tap (u < R-1, and the rows
// m >= M-1 where T is not a multiple of D) are guarded, so no output takes
// an FMA its one-chain sum does not.  Loads of kBatch steps are issued
// before their FMA.  The last tile is masked.

#include <cuda_runtime.h>

namespace {

constexpr size_t kMaxSmem = 232448;        // 227 KB opt-in limit on sm_90
constexpr int kMaxThreads = 512;
constexpr int kStageBatch = 8;             // K1: samples a thread loads at once
constexpr int kMixStagers = 2;             // K1: staging threads a summing one

struct Layout {
  long long M, U, L, RS;                   // tap rows, steps, sub-row, stride
  size_t bytes;
};

Layout layout(long long T, long long D, long long tile, long long R) {
  Layout g;
  g.M = (T + D - 1) / D;
  g.U = g.M + R - 1;
  g.L = (tile + g.M - 1 + R - 1) / R;
  g.RS = (R * g.L) | 1;
  // the taps rounded up to 16 bytes, so the window's float2s stay aligned
  g.bytes = (size_t)((g.U * D * R + 3) & ~3LL) * sizeof(float) +
            (size_t)(D * g.RS) * sizeof(float2);
  return g;
}

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(d), "l"(src) : "memory");
}

// sample s (as a double: exact below 2^53) mixed by exp(j*2*pi*(theta +
// rate*s)), the phase frac(rate*s) + theta in float64
__device__ __forceinline__ float2 mix(float2 v, double s, double rate,
                                      double theta) {
  double c = rate * s;
  c -= floor(c);
  c += theta;
  c -= floor(c);
  if (c >= 0.5) c -= 1.0;  // [-0.5, 0.5): the f32 argument stays small
  float sn, cs;
  sincospif(2.0f * (float)c, &sn, &cs);
  return make_float2(v.x * cs - v.y * sn, v.x * sn + v.y * cs);
}

template <int R>
__device__ __forceinline__ void load_taps(const float* hp, float (&h)[R]) {
  if constexpr (R == 1) {
    h[0] = hp[0];
  } else if constexpr (R == 2) {
    const float2 a = *reinterpret_cast<const float2*>(hp);
    h[0] = a.x; h[1] = a.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(hp);
    h[0] = a.x; h[1] = a.y; h[2] = a.z; h[3] = a.w;
  }
}

// Steps (u, p), p = 0 .. D-1, of one u: output r of group g of the
// thread takes sample v = X[p][column + g*nt] times tap h[(u-r)*D + p]
// into its two chains; the S groups share the taps.  The samples and taps
// of kBatch steps are loaded before their FMA.  GUARD skips the FMA of an
// output whose tap t = t0 + p - r*D does not exist (t < 0 or t >= T).
template <int R, int S, bool GUARD>
__device__ __forceinline__ void sum_steps(float (&ar)[S][R],
                                          float (&ai)[S][R],
                                          const float2* wu, int nt,
                                          const float* hp, int D, int RS,
                                          int t0, int T) {
  constexpr int kBatch = R * S >= 8 ? 5 : 10;   // registers: v and h
  int p = 0;
  for (; p + kBatch <= D; p += kBatch) {
    float2 v[kBatch][S];
    float h[kBatch][R];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
#pragma unroll
      for (int g = 0; g < S; ++g) v[k][g] = wu[(p + k) * RS + g * nt];
      load_taps<R>(hp + (p + k) * R, h[k]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!GUARD || (unsigned)(t0 + p + k - r * D) < (unsigned)T) {
#pragma unroll
          for (int g = 0; g < S; ++g) {
            ar[g][r] = fmaf(v[k][g].x, h[k][r], ar[g][r]);
            ai[g][r] = fmaf(v[k][g].y, h[k][r], ai[g][r]);
          }
        }
      }
    }
  }
  for (; p < D; ++p) {
    float2 v[S];
#pragma unroll
    for (int g = 0; g < S; ++g) v[g] = wu[p * RS + g * nt];
    float h[R];
    load_taps<R>(hp + p * R, h);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!GUARD || (unsigned)(t0 + p - r * D) < (unsigned)T) {
#pragma unroll
        for (int g = 0; g < S; ++g) {
          ar[g][r] = fmaf(v[g].x, h[r], ar[g][r]);
          ai[g][r] = fmaf(v[g].y, h[r], ai[g][r]);
        }
      }
    }
  }
}

template <bool MIX, int R, int S>
__global__ void __launch_bounds__(kMaxThreads)
fir_decimate_kernel(const float2* __restrict__ tail, long long tail_len,
                    const float2* __restrict__ x, long long n,
                    const float* __restrict__ taps, int T, int D,
                    long long kout, float2* __restrict__ y,
                    double rate, double theta,
                    const float* __restrict__ theta_dev, int M, int L,
                    int RS) {
  extern __shared__ float4 smem4[];
  // the pointer form: theta as a float32 on the card, widened as the host
  // widens the by-value form's
  if constexpr (MIX) {
    if (theta_dev != nullptr) theta = (double)__ldg(theta_dev);
  }
  const int U = M + R - 1;
  float* hu = reinterpret_cast<float*>(smem4);    // U*D*R taps, then D rows
  float2* w = reinterpret_cast<float2*>(hu + ((U * D * R + 3) & ~3));

  // K1 stages (and mixes) its window with kMixStagers times the threads
  // that sum it
  const int nst = blockDim.x, tid = threadIdx.x;
  const int nt = MIX ? nst / kMixStagers : nst;
  const int tile = nt * R * S;
  const long long k0 = (long long)blockIdx.x * tile;
  const long long s0 = k0 * D;
  const long long total = tail_len + n;
  const int win = (tile + M - 1) * D;

  // the window: sample i = c*D + p of the tile goes to row p, sub-row
  // c % R, position c / R; zero past the stream's end.  Where the whole
  // window lies in x (every tile but the first), a sample is read without
  // the tail test.
  {
    const bool in_x = s0 >= tail_len && s0 + win <= total;
    const float2* xw = x + (s0 - tail_len);
    const unsigned dc = nst / D, dp = nst - (nst / D) * D;
    unsigned c = tid / D, p = tid - (tid / D) * D;
    if constexpr (!MIX) {
      // cp.async: every copy of the thread in flight at once
      for (int i = tid; i < win; i += nst) {
        float2* dst = w + p * RS + (c % R) * L + c / R;
        const long long s = s0 + i;
        if (in_x) cp_async8(dst, xw + i);
        else if (s < total)
          cp_async8(dst, s < tail_len ? tail + s : x + (s - tail_len));
        else *dst = make_float2(0.f, 0.f);
        c += dc; p += dp;
        if (p >= D) { p -= D; ++c; }
      }
    } else {
      // kStageBatch loads in flight, then each sample mixed as it is
      // stored, so one warp's mixing runs while other warps' loads fly;
      // the sample index goes to the phase as an exact double, stepped
      const double dnt = (double)nst;
      for (int i0 = tid; i0 < win; i0 += kStageBatch * nst) {
        float2 v[kStageBatch];
#pragma unroll
        for (int b = 0; b < kStageBatch; ++b) {
          const int i = i0 + b * nst;
          const long long s = s0 + i;
          v[b] = make_float2(0.f, 0.f);
          if (i < win) {
            if (in_x) v[b] = xw[i];
            else if (s < total)
              v[b] = s < tail_len ? tail[s] : x[s - tail_len];
          }
        }
        double sd = (double)(s0 + i0);
#pragma unroll
        for (int b = 0; b < kStageBatch; ++b, sd += dnt) {
          const int i = i0 + b * nst;
          if (i < win)
            w[p * RS + (c % R) * L + c / R] =
                in_x || s0 + i < total ? mix(v[b], sd, rate, theta) : v[b];
          c += dc; p += dp;
          if (p >= D) { p -= D; ++c; }
        }
      }
    }
  }
  // the taps: H[u][p][r] = h[(u-r)*D + p], 0 where that tap does not exist
  for (int i = tid; i < U * D * R; i += nst) {
    const int r = i % R, up = i / R;
    const int u = up / D, p = up - u * D;
    const int t = (u - r) * D + p;
    hu[i] = (u >= r && t < T) ? taps[t] : 0.f;
  }
  if constexpr (!MIX) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (tid >= nt) return;

  float ar[S][R], ai[S][R];
#pragma unroll
  for (int g = 0; g < S; ++g)
#pragma unroll
    for (int r = 0; r < R; ++r) ar[g][r] = ai[g][r] = 0.f;
  const float2* wt = w + tid;
  for (int u = 0; u < U; ++u) {
    // column tid*R + u, and g*nt*R on for group g
    const float2* wu = wt + (u % R) * L + u / R;
    const float* hp = hu + u * D * R;
    // every output of the thread has a tap of a full row at steps
    // R-1 <= u <= M-2; elsewhere the taps are guarded
    if (u >= R - 1 && u <= M - 2)
      sum_steps<R, S, false>(ar, ai, wu, nt, hp, D, RS, 0, T);
    else
      sum_steps<R, S, true>(ar, ai, wu, nt, hp, D, RS, u * D, T);
  }
#pragma unroll
  for (int g = 0; g < S; ++g)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long k = k0 + (long long)(g * nt + tid) * R + r;
      if (k < kout) y[k] = make_float2(ar[g][r], ai[g][r]);
    }
}

template <bool MIX, int R, int S>
int launch_r(const void* tail, long long tail_len, const void* x, long long n,
             const void* taps, int T, int D, long long kout, void* y,
             double rate, double theta, const float* theta_dev, int tile,
             const Layout& g, cudaStream_t stream) {
  auto kern = fir_decimate_kernel<MIX, R, S>;
  if (g.bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (kout + tile - 1) / tile;
  kern<<<(unsigned)blocks, tile / (R * S) * (MIX ? kMixStagers : 1), g.bytes,
         stream>>>(
      (const float2*)tail, tail_len, (const float2*)x, n, (const float*)taps,
      T, D, kout, (float2*)y, rate, theta, theta_dev, (int)g.M, (int)g.L,
      (int)g.RS);
  return (int)cudaGetLastError();
}

bool valid_tile(int tile, int R, int S, bool mix) {
  if (R != 1 && R != 2 && R != 4) return false;
  if (S != 1 && S != 2) return false;
  if (tile < R * S || tile % (R * S)) return false;
  const int nt = tile / (R * S);
  return nt >= 32 && nt % 32 == 0 &&
         nt * (mix ? kMixStagers : 1) <= kMaxThreads;
}

template <bool MIX>
int launch(const void* tail, long long tail_len, const void* x, long long n,
           const void* taps, int T, int D, long long kout, void* y,
           double rate, double theta, const float* theta_dev, int tile,
           int R, int S, void* stream) {
  if (T < 1 || D < 1 || tail_len < 0 || n < 0 || kout < 0 ||
      !valid_tile(tile, R, S, MIX))
    return (int)cudaErrorInvalidValue;
  if (kout == 0) return 0;
  if ((kout - 1) * D + T > tail_len + n) return (int)cudaErrorInvalidValue;
  const Layout g = layout(T, D, tile, R);
  if (g.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rs = R * 10 + S;
#define CSDR_FIR_CASE(R_, S_)                                              \
  case R_ * 10 + S_:                                                       \
    return launch_r<MIX, R_, S_>(tail, tail_len, x, n, taps, T, D, kout, y, \
                                 rate, theta, theta_dev, tile, g, s);
  switch (rs) {
    CSDR_FIR_CASE(1, 1) CSDR_FIR_CASE(2, 1) CSDR_FIR_CASE(4, 1)
    CSDR_FIR_CASE(1, 2) CSDR_FIR_CASE(2, 2) CSDR_FIR_CASE(4, 2)
  }
#undef CSDR_FIR_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// y[k] = sum_t [tail|x][k*D + t] * taps[t], k < kout, one block for each
// `tile` outputs, `groups` (S) groups of `per_thread` (R) consecutive
// outputs a thread.  Returns a cudaError_t.
int csdr_fir_decimate(const void* tail, long long tail_len, const void* x,
                      long long n, const void* taps, int T, int D,
                      long long kout, void* y, int tile, int per_thread,
                      int groups, void* stream) {
  return launch<false>(tail, tail_len, x, n, taps, T, D, kout, y, 0.0, 0.0,
                       nullptr, tile, per_thread, groups, stream);
}

// As csdr_fir_decimate, with [tail|x][s] mixed by exp(j*2*pi*(theta +
// rate*s)) first; rate and theta in cycles.
int csdr_shift_fir_decimate(const void* tail, long long tail_len,
                            const void* x, long long n, const void* taps,
                            int T, int D, long long kout, void* y,
                            double rate, double theta, int tile,
                            int per_thread, int groups, void* stream) {
  return launch<true>(tail, tail_len, x, n, taps, T, D, kout, y, rate, theta,
                      nullptr, tile, per_thread, groups, stream);
}

// As csdr_shift_fir_decimate, with theta read on the card from the float32
// at `theta` (widened to double as the by-value form's caller widens it):
// the form a captured step launches, its phase filled in before each
// replay.
int csdr_shift_fir_decimate_dev(const void* tail, long long tail_len,
                                const void* x, long long n, const void* taps,
                                int T, int D, long long kout, void* y,
                                double rate, const void* theta, int tile,
                                int per_thread, int groups, void* stream) {
  if (theta == nullptr) return (int)cudaErrorInvalidValue;
  return launch<true>(tail, tail_len, x, n, taps, T, D, kout, y, rate, 0.0,
                      (const float*)theta, tile, per_thread, groups, stream);
}

// Shared memory of one block of `tile` outputs, in runs of `per_thread`
// (R), at (T, D); -1 for a tile the kernel does not take, and a size above
// the opt-in limit for a shape it refuses.
int csdr_fir_decimate_smem_bytes(int T, int D, int tile, int per_thread) {
  const int r = per_thread;
  if (T < 1 || D < 1 || (r != 1 && r != 2 && r != 4) || tile < r ||
      tile % r)
    return -1;
  const size_t b = layout(T, D, tile, per_thread).bytes;
  return b > 0x7fffffff ? 0x7fffffff : (int)b;
}

const char* csdr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
