// CUDA-core device code shared by the FTF-block forward and backward and
// the MHSA kernels (ftf.cu, ftf_bwd.cu, mhsa.cu): the forward's precise
// (all-f32) mode and every stage of the backward. The forward's bf16 mode
// runs the tensor-core kernels of tc.cuh instead.
//
// Widths are those of the LCT generator's bottleneck: C = 64 channels,
// 4 attention heads of 16, 4 GRU groups of hidden size 16. The Python
// wrappers check them before a launch.
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

constexpr int C = 64;     // channels = attention embed dim
constexpr int NH = 4;     // attention heads
constexpr int HD = 16;    // head dim
constexpr int G = 4;      // GRU groups
constexpr int H = 16;     // GRU hidden size per group
constexpr int ROWS = 32;  // rows per block in the row-GEMM kernels

__device__ __forceinline__ float rnd(float v, int round) {
  return round ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[r, c] = sum_k in[r, koff(c) + k] * W(k, c) + bias[c] over ROWS rows
// per block, one thread per output column c (blockDim.x == M).
//
// in = x (+ (add0 + add1)), optionally LayerNorm'ed (ln_s != nullptr;
// fast-variance form max(0, E[x^2] - mu^2), eps 1e-6), then rounded.
// GROUPED: the grouped GRU input projection. Column c = d*192 + g*48 + j
// reads the 16 inputs of group g and W = w_ih [D, G, 16, 48]; otherwise W
// is dense [64, M].
//
// Bound: a tile of 32 rows lives in shared memory and each thread keeps its
// 32 partial sums in registers; a weight is read once per tile (L1-resident,
// the weights are at most 48 KB) and each product reads one shared value
// that the whole warp shares (a broadcast). CUDA-core f32 FMAs: all-f32
// arithmetic has no tensor-core product (TF32 would break precise mode's
// 1e-3 contract); tc.cuh's qkv_tc_kernel is the bf16 forward's version.
template <bool GROUPED>
__global__ void proj_kernel(const float* __restrict__ x,
                            const float* __restrict__ add0,
                            const float* __restrict__ add1,
                            const float* __restrict__ ln_s,
                            const float* __restrict__ ln_b,
                            const float* __restrict__ W,
                            const float* __restrict__ bias,
                            float* __restrict__ out, long long rows, int M,
                            int round) {
  __shared__ float tile[ROWS][C];
  const long long row0 = (long long)blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  for (int i = tid; i < ROWS * C; i += blockDim.x) {
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
  for (int r = warp; r < ROWS; r += nwarps) {
    float a = tile[r][lane], b = tile[r][lane + 32];
    if (ln_s) {
      const float mu = warp_sum(a + b) * (1.f / C);
      const float ms = warp_sum(a * a + b * b) * (1.f / C);
      const float rs = rsqrtf(fmaxf(ms - mu * mu, 0.f) + 1e-6f);
      a = (a - mu) * rs * ln_s[lane] + ln_b[lane];
      b = (b - mu) * rs * ln_s[lane + 32] + ln_b[lane + 32];
    }
    tile[r][lane] = rnd(a, round);
    tile[r][lane + 32] = rnd(b, round);
  }
  __syncthreads();

  const int c = tid;
  if (c >= M) return;
  constexpr int K = GROUPED ? H : C;
  int koff = 0, wstride = M;
  const float* wp = W + c;
  if (GROUPED) {
    const int d = c / (3 * C), g = (c % (3 * C)) / (3 * H), j = c % (3 * H);
    koff = g * H;
    wp = W + (size_t)(d * G + g) * H * (3 * H) + j;
    wstride = 3 * H;
  }
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float w = rnd(__ldg(wp + (size_t)k * wstride), round);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(tile[r][koff + k], w, acc[r]);
  }
  const float bc = bias[c];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = row0 + r;
    if (row < rows) out[(size_t)row * M + c] = acc[r] + bc;
  }
}

// Multi-head self-attention core over qkv [N*L, 3C] -> ctx [N*L, C] (ctx not
// yet rounded: its consumer rounds it as a GEMM operand).
//
// One block per (sequence, head); K and V of that head (rounded) and the
// per-key bias sit in dynamic shared memory (33 floats per key: 85 KB at
// L = 644), one query row per thread. Scores are q.k * 1/4 + key_bias[k];
// `lookback >= 0` keeps only keys in the inclusive band [q - lookback, q].
// The softmax subtracts the exact row max (a first pass over the keys), so
// the probabilities round to bf16 at the same values as on the TPU:
//   MODE 0 (FTF kernel):  p = exp(s - m) rounded, ctx = (p @ v) / (sum p + 1e-20)
//   MODE 1 (MHSA kernel): p = exp(s - m) / sum, rounded, ctx = p @ v
//
// Bound: O(L^2 * 16) FMAs per head on CUDA cores, with K/V reads that the
// whole block shares (broadcast). Recomputing the scores in each pass costs
// 2-3x the score FLOPs but no memory traffic. The bf16 forward's version is
// tc.cuh's attn_tc_kernel (scores and context on tensor cores).
template <int MODE>
__global__ void attn_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ key_bias,
                            float* __restrict__ ctx, int L, int lookback,
                            int round) {
  extern __shared__ float sm[];
  float* Ks = sm;                // [L][HD]
  float* Vs = sm + L * HD;       // [L][HD]
  float* kb = sm + 2 * L * HD;   // [L]
  const long long n = blockIdx.x / NH;
  const int h = blockIdx.x % NH;
  const float* base = qkv + (size_t)n * L * (3 * C);
  for (int i = threadIdx.x; i < L * HD; i += blockDim.x) {
    const int t = i / HD, d = i % HD;
    Ks[i] = rnd(base[(size_t)t * 3 * C + C + h * HD + d], round);
    Vs[i] = rnd(base[(size_t)t * 3 * C + 2 * C + h * HD + d], round);
  }
  for (int t = threadIdx.x; t < L; t += blockDim.x)
    kb[t] = key_bias ? key_bias[(size_t)n * L + t] : 0.f;
  __syncthreads();

  for (int q = threadIdx.x; q < L; q += blockDim.x) {
    float qv[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d)
      qv[d] = rnd(base[(size_t)q * 3 * C + h * HD + d], round);
    int k0 = 0, k1 = L - 1;
    if (lookback >= 0) {
      k0 = max(0, q - lookback);
      k1 = q;
    }
    auto score = [&](int k) {
      const float* kr = Ks + k * HD;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) s = fmaf(qv[d], kr[d], s);
      return s * 0.25f + kb[k];
    };
    float m = -INFINITY;
    for (int k = k0; k <= k1; ++k) m = fmaxf(m, score(k));
    float acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.f;
    float den = 0.f;
    if (MODE == 0) {
      for (int k = k0; k <= k1; ++k) {
        const float p = expf(score(k) - m);
        den += p;
        const float pr = rnd(p, round);
        const float* vr = Vs + k * HD;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(pr, vr[d], acc[d]);
      }
      den += 1e-20f;
    } else {
      for (int k = k0; k <= k1; ++k) den += expf(score(k) - m);
      for (int k = k0; k <= k1; ++k) {
        const float pr = rnd(expf(score(k) - m) / den, round);
        const float* vr = Vs + k * HD;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(pr, vr[d], acc[d]);
      }
      den = 1.f;
    }
    float* o = ctx + ((size_t)n * L + q) * C + h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = acc[d] / den;
  }
}

// Launch attn_kernel<MODE> for N sequences of length L.
template <int MODE>
cudaError_t launch_attn(const float* qkv, const float* key_bias, float* ctx,
                        long long N, int L, int lookback, int round,
                        cudaStream_t st) {
  const size_t smem = (size_t)(2 * HD + 1) * L * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  int threads = ((L + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  attn_kernel<MODE><<<(unsigned)(N * NH), threads, smem, st>>>(
      qkv, key_bias, ctx, L, lookback, round);
  return cudaGetLastError();
}

}  // namespace lct

// The name of a CUDA error code returned by an entry point of this library.
extern "C" const char* lct_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
