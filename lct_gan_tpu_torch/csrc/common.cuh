// CUDA-core device code shared by the FTF-block forward and backward and
// the MHSA kernels (ftf.cu, ftf_bwd.cu, mhsa.cu): the forward's precise
// (all-f32) mode and every stage of the backward. The forward's bf16 mode
// runs the tensor-core kernels of tc.cuh instead.
//
// Widths: the library is built for one kernel width C = LCT_C (16, 32,
// 64, 128, 256 or 512; -DLCT_C=<C>, ops/_build.py; 64 when unset): the
// channels a row holds in every kernel. The model's true bottleneck width
// c_true <= C arrives at run time with each launch, and so do the heads
// and the score scale. The Python wrappers pick C from the true width, the
// head count and the group count (ops/padding.py::kernel_width) and pad to
// it: each
// GRU group and each attention head is widened with zero channels to a
// power of two, which is exact (a zero channel adds 0 to every product, a
// zero-weight GRU unit stays 0), and every LayerNorm divides by c_true, the
// true channel count (the `inv_c` argument, 1 / c_true), so the zeros leave
// its mean and variance as they are. Heads of hd = c_true / num_heads
// channels run at the padded width head_width(hd) with the score scale the
// wrapper computes, the f32 rounding of 1 / sqrt(hd) (the JAX package's).
// The kernels are templated on a padded head width and take the true one at
// run time: attention on the head width (8 for any hd <= 8, else 16 .. C),
// the GRU on its slot width (16: groups of 16 or, packed block-diagonally,
// narrower; dense slots of C, or of 64 at C = 128, or of 64, 128 or C at
// C = 256, or of 64, 128, 256 or C at C = 512: wider groups packed); the
// Python wrappers check the widths before a launch. The wider rows of C =
// 256 take kernels of their own, each under `C > 128`, so that every
// instance at C <= 128 is the one it was; C = 512's, each under `C > 256`,
// leave every instance at C <= 256 as it was. C = 512 serves the forward
// only (ftf_bwd.cu is not built there).
//
// Rounding: `round != 0` is the bf16 mode (the backward's). Every GEMM
// operand is rounded to bf16 (round-to-nearest-even) exactly where the TPU
// kernels round it, and products accumulate in f32 -- a bf16 x bf16 product
// is exact in f32, so this reproduces the TPU's bf16 MXU arithmetic up to
// the order of the f32 sums. `round == 0` is the all-f32 `precise` mode.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace lct {

#ifndef LCT_C
#define LCT_C 64
#endif

// The smallest power of two >= v (v >= 1).
__host__ __device__ constexpr int pow2_ceil(int v) {
  return v <= 1 ? 1 : 2 * pow2_ceil((v + 1) / 2);
}

constexpr int C = LCT_C;  // channels the kernels run at (the kernel width)
constexpr int ROWS = 32;  // rows per block in the row-GEMM kernels
static_assert(C == 16 || C == 32 || C == 64 || C == 128 || C == 256 ||
                  C == 512,
              "LCT_C");

// The width a head of hd true channels runs at (the wrappers pad it there).
__host__ __device__ constexpr int head_width(int hd) { return pow2_ceil(hd); }

// The padded head width a kernel instance is built for: 8 for any hd <= 8
// (the true width at run time), else hd itself.
__host__ __device__ constexpr int head_pad(int hd) { return hd <= 8 ? 8 : hd; }

// The slot width of the GRU kernels for `slots` slots (C / 16, 1, at
// C >= 128 also C / 64: slots of 64, at C >= 256 also C / 128: slots of
// 128, at C = 512 also 2: slots of 256).
inline int gru_slot(int slots) { return C / slots; }

// The units a block of a CUDA-core GRU walk over dense slots of SW units
// takes (ftf.cu's gru_dense_kernel, ftf_bwd.cu's bptt_dense_kernel): all C,
// or at C >= 256 one slot of 128 (or 256) a block, or at C = 512 four
// slots of 64 (256 units: the W_hh of all eight, 393 KB, would pass the
// shared memory of a block).
template <int SW>
__host__ __device__ constexpr int dense_units() {
  return C > 256 && SW == 64 ? 256 : C > 128 && SW >= 128 ? SW : C;
}

// c_true channels (at most C) in num_heads heads, whose padded heads fit
// C; the GRU weights come in C / 16 slots of 16, 1 of C, at C >= 128 C / 64
// of 64, at C >= 256 C / 128 of 128, at C = 512 2 of 256.
inline bool widths_ok(int c_true, int num_heads, int slots) {
  return c_true > 0 && c_true <= C && num_heads > 0 &&
         c_true % num_heads == 0 &&
         num_heads * head_width(c_true / num_heads) <= C &&
         (slots == C / 16 || slots == 1 || (C > 64 && slots == C / 64) ||
          (C > 128 && slots == C / 128) || (C > 256 && slots == C / 256));
}

// Channels of a C-wide row a lane of a warp holds (lane + 32 i; lanes past
// C hold zeros).
constexpr int CPL = (C + 31) / 32;

__host__ __device__ constexpr bool lane_holds(int lane, int i) {
  return C % 32 == 0 || lane + 32 * i < C;
}

__device__ __forceinline__ float rnd(float v, int round) {
  return round ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of one row that a warp holds, CPL values a lane (lane_holds;
// the rest 0): fast-variance form max(0, E[x^2] - mu^2) over the true
// channels (inv_c = 1 / their count), eps 1e-6; s and b are the lane's
// scale and bias (0 on a padded channel, which so stays 0).
__device__ __forceinline__ void ln_row(float (&v)[CPL], const float (&s)[CPL],
                                       const float (&b)[CPL], float inv_c) {
  float s1, s2;
  if constexpr (CPL == 2) {
    s1 = v[0] + v[1];
    s2 = v[0] * v[0] + v[1] * v[1];
  } else {
    s1 = v[0];
    s2 = v[0] * v[0];
#pragma unroll
    for (int i = 1; i < CPL; ++i) {
      s1 += v[i];
      s2 += v[i] * v[i];
    }
  }
  const float mu = warp_sum(s1) * inv_c;
  const float ms = warp_sum(s2) * inv_c;
  const float rs = rsqrtf(fmaxf(ms - mu * mu, 0.f) + 1e-6f);
#pragma unroll
  for (int i = 0; i < CPL; ++i) v[i] = (v[i] - mu) * rs * s[i] + b[i];
}

// Output columns a row-GEMM block takes at most at C >= 256 (2 blocks of
// 768 threads for the 6C = 1,536 columns of two directions' GRU input
// projection at C = 256, 4 at C = 512: a block has at most 1,024 threads).
constexpr int PROJ_COLS = 768;

// Rows a row-GEMM block (proj_kernel) takes: ROWS, at C = 512 16 (a tile of
// 32 rows of 512 floats would pass the 48 KB of static shared memory).
constexpr int PROJ_ROWS = C > 256 ? 16 : ROWS;

// Threads of a row-GEMM block of M output columns: whole warps (the
// LayerNorm above takes a warp a row), at C >= 256 at most PROJ_COLS.
inline unsigned row_threads(int M) {
  const unsigned t = (unsigned)((M + 31) / 32 * 32);
  return C > 128 && t > (unsigned)PROJ_COLS ? (unsigned)PROJ_COLS : t;
}

// The grid of a row GEMM over `rblocks` tiles of PROJ_ROWS rows and M
// output columns: blockIdx.y picks the columns at C >= 256 (row_threads).
inline dim3 row_grid(unsigned rblocks, int M) {
  return dim3(rblocks, (unsigned)((M + row_threads(M) - 1) / row_threads(M)));
}

// C = 128's row GEMMs run up to 6C threads a block, C >= 256's PROJ_COLS:
// the register budget must allow it.
#if LCT_C > 128
#define LCT_PROJ_BOUNDS __launch_bounds__(PROJ_COLS, 1)
#elif LCT_C > 64
#define LCT_PROJ_BOUNDS __launch_bounds__(6 * C, 1)
#else
#define LCT_PROJ_BOUNDS
#endif

// out[r, c] = sum_k in[r, koff(c) + k] * W(k, c) + bias[c] over PROJ_ROWS
// rows per block, one thread per output column c (blockDim.x: M rounded up
// to whole warps, row_threads; at C >= 256 column blockIdx.y * blockDim.x +
// the thread, each column block taking the tile's LayerNorm itself).
//
// in = x (+ (add0 + add1)), optionally LayerNorm'ed (ln_s != nullptr;
// fast-variance form max(0, E[x^2] - mu^2) over 1 / inv_c true channels,
// eps 1e-6), then rounded.
// GROUPED: the grouped GRU input projection over slots of GW channels.
// Column c = d*3C + g*3GW + j reads the GW inputs of slot g and W = w_ih
// [D, C/GW, GW, 3GW] (the groups packed into slots, ops/gru.py::
// pack_gru_slots); otherwise W is dense [C, M].
//
// Bound: a tile of 32 rows lives in shared memory and each thread keeps its
// 32 partial sums in registers; a weight is read once per tile (L1-resident,
// the weights are at most 48 KB at C = 64) and each product reads one shared value
// that the whole warp shares (a broadcast). CUDA-core f32 FMAs: all-f32
// arithmetic has no tensor-core product (TF32 would break precise mode's
// 1e-3 contract); tc.cuh's qkv_tc_kernel is the bf16 forward's version.
template <bool GROUPED, int GW = 16>
__global__ void LCT_PROJ_BOUNDS proj_kernel(const float* __restrict__ x,
                            const float* __restrict__ add0,
                            const float* __restrict__ add1,
                            const float* __restrict__ ln_s,
                            const float* __restrict__ ln_b,
                            const float* __restrict__ W,
                            const float* __restrict__ bias,
                            float* __restrict__ out, long long rows, int M,
                            int round, float inv_c) {
  __shared__ float tile[PROJ_ROWS][C];
  const long long row0 = (long long)blockIdx.x * PROJ_ROWS;
  const int tid = threadIdx.x;
  for (int i = tid; i < PROJ_ROWS * C; i += blockDim.x) {
    const int r = i / C, k = i % C;
    const long long row = row0 + r;
    float v = 0.f;
    if (row < rows) {
      const size_t o = (size_t)row * C + k;
      v = x[o];
      if (add0) v += add1 ? (add0[o] + add1[o]) : add0[o];
    }
    tile[r][k] = v;
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  for (int r = warp; r < PROJ_ROWS; r += nwarps) {
    float v[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      v[i] = lane_holds(lane, i) ? tile[r][lane + 32 * i] : 0.f;
    if (ln_s) {
      float ls[CPL], lb[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        ls[i] = lane_holds(lane, i) ? ln_s[lane + 32 * i] : 0.f;
        lb[i] = lane_holds(lane, i) ? ln_b[lane + 32 * i] : 0.f;
      }
      ln_row(v, ls, lb, inv_c);
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (lane_holds(lane, i)) tile[r][lane + 32 * i] = rnd(v[i], round);
  }
  __syncthreads();

#if LCT_C > 128
  const int c = tid + (int)(blockIdx.y * blockDim.x);
#else
  const int c = tid;
#endif
  if (c >= M) return;
  constexpr int K = GROUPED ? GW : C;
  int koff = 0, wstride = M;
  const float* wp = W + c;
  if (GROUPED) {
    const int d = c / (3 * C), g = (c % (3 * C)) / (3 * GW), j = c % (3 * GW);
    koff = g * GW;
    wp = W + (size_t)(d * (C / GW) + g) * GW * (3 * GW) + j;
    wstride = 3 * GW;
  }
  float acc[PROJ_ROWS];
#pragma unroll
  for (int r = 0; r < PROJ_ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float w = rnd(__ldg(wp + (size_t)k * wstride), round);
#pragma unroll
    for (int r = 0; r < PROJ_ROWS; ++r)
      acc[r] = fmaf(tile[r][koff + k], w, acc[r]);
  }
  const float bc = bias[c];
#pragma unroll
  for (int r = 0; r < PROJ_ROWS; ++r) {
    const long long row = row0 + r;
    if (row < rows) out[(size_t)row * M + c] = acc[r] + bc;
  }
}

// Multi-head self-attention core over qkv [N*L, 3C] -> ctx [N*L, C] (ctx not
// yet rounded: its consumer rounds it as a GEMM operand), C / hd heads of
// hd channels, scores scaled by `scale` (1 / sqrt of the true head width,
// from the wrapper).
//
// One block per (sequence, head), one query row per thread. For heads of
// at most 16 channels, K and V of that head (rounded, HDP floats a key,
// zero past hd) and the per-key bias sit in dynamic shared memory (33
// floats per key at HDP = 16: 85 KB at L = 644); wider heads would not fit
// (129 floats per key at hd = 64), so their K and V rows are read from
// device memory where they lie: every lane of a warp reads the same key
// row, one cached transaction. Scores are q.k / sqrt(hd) + key_bias[k];
// `lookback >= 0` keeps only keys in the inclusive band [q - lookback, q].
// The softmax subtracts the exact row max (a first pass over the keys), so
// the probabilities round to bf16 at the same values as on the TPU:
//   MODE 0 (FTF kernel):  p = exp(s - m) rounded, ctx = (p @ v) / (sum p + 1e-20)
//   MODE 1 (MHSA kernel): p = exp(s - m) / sum, rounded, ctx = p @ v
//
// Bound: O(L^2 * hd) FMAs per head on CUDA cores, with K/V reads that the
// whole block shares (broadcast). Recomputing the scores in each pass costs
// 2-3x the score FLOPs but no memory traffic. The bf16 forward's version is
// tc.cuh's attn_tc_kernel (scores and context on tensor cores).
template <int MODE, int HDP>
__global__ void attn_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ key_bias,
                            float* __restrict__ ctx, int L, int lookback,
                            int round, int hd_rt, float scale) {
  constexpr bool STAGE = HDP <= 16;
  extern __shared__ float sm[];
  float* Ks = sm;                // [L][HDP]
  float* Vs = sm + L * HDP;      // [L][HDP]
  float* kb = sm + 2 * L * HDP;  // [L]
  const int hd = HDP >= 16 ? HDP : hd_rt;
  const int nh = C / hd;
  const long long n = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const float* base = qkv + (size_t)n * L * (3 * C);
  if (STAGE) {
    for (int i = threadIdx.x; i < L * HDP; i += blockDim.x) {
      const int t = i / HDP, d = i % HDP;
      if (HDP == 8 && d >= hd) {
        Ks[i] = Vs[i] = 0.f;
        continue;
      }
      Ks[i] = rnd(base[(size_t)t * 3 * C + C + h * hd + d], round);
      Vs[i] = rnd(base[(size_t)t * 3 * C + 2 * C + h * hd + d], round);
    }
    for (int t = threadIdx.x; t < L; t += blockDim.x)
      kb[t] = key_bias ? key_bias[(size_t)n * L + t] : 0.f;
    __syncthreads();
  }
  // Key k's row of K (or V: + C), its stride, and its bias.
  auto krow = [&](int k) {
    return STAGE ? Ks + k * HDP : base + (size_t)k * 3 * C + C + h * hd;
  };
  auto kval = [&](float v) { return STAGE ? v : rnd(v, round); };
  auto kbias = [&](int k) {
    return STAGE ? kb[k] : (key_bias ? key_bias[(size_t)n * L + k] : 0.f);
  };
  const int voff = STAGE ? L * HDP : C;  // V's row from K's

  for (int q = threadIdx.x; q < L; q += blockDim.x) {
    float qv[HDP];
#pragma unroll
    for (int d = 0; d < HDP; ++d)
      qv[d] = HDP == 8 && d >= hd
                  ? 0.f
                  : rnd(base[(size_t)q * 3 * C + h * hd + d], round);
    int k0 = 0, k1 = L - 1;
    if (lookback >= 0) {
      k0 = max(0, q - lookback);
      k1 = q;
    }
    auto score = [&](int k) {
      const float* kr = krow(k);
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HDP; ++d) s = fmaf(qv[d], kval(kr[d]), s);
      return s * scale + kbias(k);
    };
    float m = -INFINITY;
    for (int k = k0; k <= k1; ++k) m = fmaxf(m, score(k));
    float acc[HDP];
#pragma unroll
    for (int d = 0; d < HDP; ++d) acc[d] = 0.f;
    float den = 0.f;
    if (MODE == 0) {
      for (int k = k0; k <= k1; ++k) {
        const float p = expf(score(k) - m);
        den += p;
        const float pr = rnd(p, round);
        const float* vr = krow(k) + voff;
#pragma unroll
        for (int d = 0; d < HDP; ++d) acc[d] = fmaf(pr, kval(vr[d]), acc[d]);
      }
      den += 1e-20f;
    } else {
      for (int k = k0; k <= k1; ++k) den += expf(score(k) - m);
      for (int k = k0; k <= k1; ++k) {
        const float pr = rnd(expf(score(k) - m) / den, round);
        const float* vr = krow(k) + voff;
#pragma unroll
        for (int d = 0; d < HDP; ++d) acc[d] = fmaf(pr, kval(vr[d]), acc[d]);
      }
      den = 1.f;
    }
    float* o = ctx + ((size_t)n * L + q) * C + h * hd;
#pragma unroll
    for (int d = 0; d < HDP; ++d)
      if (HDP != 8 || d < hd) o[d] = acc[d] / den;
  }
}

// attn_kernel for heads of 128 to 512 channels at C >= 256, where a
// thread's q and context (2 HDP floats) would not fit in registers: one
// warp a query row, lane l holding channels l + 32 i (HDP / 32 a lane), a
// score one warp sum. The same function and passes as attn_kernel (MODE 0:
// max, then p, den and the context; MODE 1: max, den, then the context);
// K and V rows are read where they lie, each a coalesced row of the warp.
// Block: (sequence, head), WARP_ROWS warps walking its query rows. Bound:
// the L^2 hd score and context FMAs on CUDA cores, as attn_kernel.
constexpr int WARP_ROWS = 8;

template <int MODE, int HDP>
__global__ void __launch_bounds__(32 * WARP_ROWS)
    attn_warp_kernel(const float* __restrict__ qkv,
                     const float* __restrict__ key_bias,
                     float* __restrict__ ctx, int L, int lookback, int round,
                     float scale) {
  constexpr int PL = HDP / 32;  // channels a lane
  constexpr int nh = C / HDP;
  const long long n = blockIdx.x / nh;
  const int h = blockIdx.x % nh, lane = threadIdx.x & 31;
  const float* base = qkv + (size_t)n * L * (3 * C) + h * HDP + lane;
  const float* kb = key_bias ? key_bias + (size_t)n * L : nullptr;
  for (int q = threadIdx.x >> 5; q < L; q += WARP_ROWS) {
    float qv[PL];
#pragma unroll
    for (int i = 0; i < PL; ++i)
      qv[i] = rnd(base[(size_t)q * 3 * C + 32 * i], round);
    int k0 = 0, k1 = L - 1;
    if (lookback >= 0) {
      k0 = max(0, q - lookback);
      k1 = q;
    }
    auto score = [&](int k) {
      const float* kr = base + (size_t)k * 3 * C + C;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) s = fmaf(qv[i], rnd(kr[32 * i], round), s);
      return warp_sum(s) * scale + (kb ? kb[k] : 0.f);
    };
    float m = -INFINITY;
    for (int k = k0; k <= k1; ++k) m = fmaxf(m, score(k));
    float acc[PL];
#pragma unroll
    for (int i = 0; i < PL; ++i) acc[i] = 0.f;
    float den = 0.f;
    auto accumulate = [&](int k, float pr) {
      const float* vr = base + (size_t)k * 3 * C + 2 * C;
#pragma unroll
      for (int i = 0; i < PL; ++i)
        acc[i] = fmaf(pr, rnd(vr[32 * i], round), acc[i]);
    };
    if (MODE == 0) {
      for (int k = k0; k <= k1; ++k) {
        const float p = expf(score(k) - m);
        den += p;
        accumulate(k, rnd(p, round));
      }
      den += 1e-20f;
    } else {
      for (int k = k0; k <= k1; ++k) den += expf(score(k) - m);
      for (int k = k0; k <= k1; ++k)
        accumulate(k, rnd(expf(score(k) - m) / den, round));
      den = 1.f;
    }
    float* o = ctx + ((size_t)n * L + q) * C + h * HDP + lane;
#pragma unroll
    for (int i = 0; i < PL; ++i) o[32 * i] = acc[i] / den;
  }
}

template <int MODE, int HDP>
cudaError_t launch_attn_hd(const float* qkv, const float* key_bias,
                           float* ctx, long long N, int L, int lookback,
                           int round, int hd, float scale, cudaStream_t st) {
  if constexpr (C > 128 && HDP >= 128) {
    attn_warp_kernel<MODE, HDP><<<(unsigned)(N * (C / HDP)), 32 * WARP_ROWS,
                                  0, st>>>(qkv, key_bias, ctx, L, lookback,
                                           round, scale);
    return cudaGetLastError();
  } else {
    const size_t smem =
        HDP <= 16 ? (size_t)(2 * HDP + 1) * L * sizeof(float) : 0;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          attn_kernel<MODE, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
    }
    int threads = ((L + 31) / 32) * 32;
    if (threads > 256) threads = 256;
    attn_kernel<MODE, HDP><<<(unsigned)(N * (C / hd)), threads, smem, st>>>(
        qkv, key_bias, ctx, L, lookback, round, hd, scale);
    return cudaGetLastError();
  }
}

// Launch attn_kernel<MODE, head_pad(hd)> for N sequences of length L and
// heads of hd channels (scores scaled by `scale`).
// Instances exist for the padded widths up to C.
template <int MODE>
cudaError_t launch_attn(const float* qkv, const float* key_bias, float* ctx,
                        long long N, int L, int lookback, int round, int hd,
                        float scale, cudaStream_t st) {
  switch (head_pad(hd)) {
    case 8:
      return launch_attn_hd<MODE, 8>(qkv, key_bias, ctx, N, L, lookback,
                                     round, hd, scale, st);
    case 16:
      return launch_attn_hd<MODE, 16>(qkv, key_bias, ctx, N, L, lookback,
                                      round, hd, scale, st);
    case 32:
      if constexpr (C >= 32)
        return launch_attn_hd<MODE, 32>(qkv, key_bias, ctx, N, L, lookback,
                                        round, hd, scale, st);
      break;
    case 64:
      if constexpr (C >= 64)
        return launch_attn_hd<MODE, 64>(qkv, key_bias, ctx, N, L, lookback,
                                        round, hd, scale, st);
      break;
    case 128:
      if constexpr (C >= 128)
        return launch_attn_hd<MODE, 128>(qkv, key_bias, ctx, N, L, lookback,
                                         round, hd, scale, st);
      break;
    case 256:
      if constexpr (C >= 256)
        return launch_attn_hd<MODE, 256>(qkv, key_bias, ctx, N, L, lookback,
                                         round, hd, scale, st);
      break;
    case 512:
      if constexpr (C >= 512)
        return launch_attn_hd<MODE, 512>(qkv, key_bias, ctx, N, L, lookback,
                                         round, hd, scale, st);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace lct

// The name of a CUDA error code returned by an entry point of this library.
extern "C" const char* lct_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
