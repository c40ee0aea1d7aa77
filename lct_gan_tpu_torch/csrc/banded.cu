// Banded-causal multi-head self-attention for Hopper (sm_90a): the function
// of the TPU kernel `lct_gan_tpu/ops/banded_attention.py::_banded_kernel`
// over x [N, S, 64] with no upper bound on S, as three kernels in a row:
//
//   1. proj_kernel<false>  qkv = x @ in_w + in_b                -> qkv [N*S, 192]
//   2. banded_attn_kernel  4-head softmax attention over each query's band
//                          [q - W, q] ∩ [0, S), plus key_bias   -> ctx [N*S, 64]
//   3. proj_kernel<false>  out = ctx @ out_w + out_b              -> out [N*S, 64]
//
// with the TPU kernel's bf16 rounding points (x, in_w; q, k, v; the
// normalised p; ctx, out_w) and f32 accumulation (see common.cuh); `precise`
// is all f32. Out-of-band keys are skipped (the JAX reference's -inf fill);
// a row whose whole band carries key_bias -1e30 scores -1e30 on every key
// (-1e30 + s == -1e30 in f32) and comes out uniform over its band.
//
// Bound on the H100: at the banded time block of the 196,608-sample bucket
// (N = 20*33 sequences of S = 772, W = 64) the function moves ~261 MB (x in,
// out back; ~78 us at 3.35 TB/s) and does ~25 GFLOP of useful products, 82%
// of them in the qkv and output projections (~25 us at 989 TFLOP/s bf16):
// it is bound by bytes. This simple design round-trips qkv and ctx through
// device memory (~4x the bytes of x and out) and runs the products on CUDA
// cores in f32. The TPU tiling (104-128-row tiles that re-project the
// previous tile for the MXU) does not carry over: one block takes one
// (sequence, head, tile of BT = 128 query rows), stages the K/V rows its
// queries can reach, [t0 - W, t0 + BT), in shared memory, and scores each
// query only against those, so the work is O(S * W) for any S. A warp walks
// the union of its 32 rows' bands in step (W + 32 keys), so every K/V read
// from shared memory is a broadcast; each row keeps its own keys by a test.

#include <limits.h>

#include "common.cuh"

namespace lct {

constexpr int BT = 128;   // query rows per block, one per thread
constexpr int BKC = 256;  // key rows staged in shared memory at a time

// One pass over the staged keys [c0, c1) that the warp's rows can reach,
// [wk0, wk1]: PASS 0 takes the row max, PASS 1 the softmax denominator,
// PASS 2 accumulates the context with p = exp(s - m) / den (rounded).
template <int PASS>
__device__ __forceinline__ void band_pass(const float* Ks, const float* Vs,
                                          const float* kb, int c0, int c1,
                                          int wk0, int wk1, int q, int W,
                                          bool live, const float (&qv)[HD],
                                          float& m, float& den,
                                          float (&acc)[HD], int round) {
  const int a = max(c0, wk0), b = min(c1 - 1, wk1);
  for (int k = a; k <= b; ++k) {
    const float4* kr = reinterpret_cast<const float4*>(Ks + (k - c0) * HD);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) {
      const float4 kk = kr[i];
      s = fmaf(qv[4 * i], kk.x, s);
      s = fmaf(qv[4 * i + 1], kk.y, s);
      s = fmaf(qv[4 * i + 2], kk.z, s);
      s = fmaf(qv[4 * i + 3], kk.w, s);
    }
    s = s * 0.25f + kb[k - c0];
    if (!(live && k >= q - W && k <= q)) continue;
    if (PASS == 0) {
      m = fmaxf(m, s);
    } else if (PASS == 1) {
      den += expf(s - m);
    } else {
      const float p = rnd(expf(s - m) / den, round);
      const float4* vr = reinterpret_cast<const float4*>(Vs + (k - c0) * HD);
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) {
        const float4 vv = vr[i];
        acc[4 * i] = fmaf(p, vv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
      }
    }
  }
}

// qkv [N*S, 3C] -> ctx [N*S, C] (ctx not yet rounded: the output
// projection rounds it as a GEMM operand). Block b covers sequence n, head
// h and query rows [t0, t0 + BT) with b = (n * NH + h) * ntiles + t0 / BT.
// The keys the tile can reach, [max(0, t0 - W), min(S, t0 + BT)), are
// staged BKC rows at a time: with W <= BKC - BT (W <= 128) they fit at once
// and are loaded once; a wider band reloads each chunk in each of the three
// passes, so shared memory stays 33 KB for any W.
__global__ void __launch_bounds__(BT)
    banded_attn_kernel(const float* __restrict__ qkv,
                       const float* __restrict__ key_bias,
                       float* __restrict__ ctx, int S, int W, int ntiles,
                       int round) {
  __shared__ __align__(16) float Ks[BKC * HD];
  __shared__ __align__(16) float Vs[BKC * HD];
  __shared__ float kb[BKC];
  const int tid = threadIdx.x;
  const int tile = (int)(blockIdx.x % (unsigned)ntiles);
  const long long seq_head = blockIdx.x / (unsigned)ntiles;
  const long long n = seq_head / NH;
  const int h = (int)(seq_head % NH);
  const float* base = qkv + (size_t)n * S * (3 * C);
  const int t0 = tile * BT;
  const int q = t0 + tid;
  const bool live = q < S;
  const int kbeg = max(0, t0 - W), kend = min(S, t0 + BT);
  const int warp0 = t0 + (tid & ~31);
  const int wk0 = max(0, warp0 - W), wk1 = min(S - 1, warp0 + 31);

  float qv[HD];
  if (live) {
    const float4* qp =
        reinterpret_cast<const float4*>(base + (size_t)q * 3 * C + h * HD);
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) {
      const float4 t = qp[i];
      qv[4 * i] = rnd(t.x, round);
      qv[4 * i + 1] = rnd(t.y, round);
      qv[4 * i + 2] = rnd(t.z, round);
      qv[4 * i + 3] = rnd(t.w, round);
    }
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qv[d] = 0.f;
  }

  float m = -INFINITY, den = 0.f, acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  const int nchunks = (kend - kbeg + BKC - 1) / BKC;
  for (int pass = 0; pass < 3; ++pass) {
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = kbeg + c * BKC, c1 = min(kend, c0 + BKC);
      if (nchunks > 1 || pass == 0) {
        __syncthreads();  // the previous chunk's readers are done
        for (int i = tid; i < (c1 - c0) * (HD / 4); i += BT) {
          const int r = i / (HD / 4), part = i % (HD / 4);
          const float* row = base + (size_t)(c0 + r) * 3 * C + h * HD + 4 * part;
          const float4 kk = *reinterpret_cast<const float4*>(row + C);
          const float4 vv = *reinterpret_cast<const float4*>(row + 2 * C);
          float* kd = Ks + r * HD + 4 * part;
          float* vd = Vs + r * HD + 4 * part;
          kd[0] = rnd(kk.x, round); kd[1] = rnd(kk.y, round);
          kd[2] = rnd(kk.z, round); kd[3] = rnd(kk.w, round);
          vd[0] = rnd(vv.x, round); vd[1] = rnd(vv.y, round);
          vd[2] = rnd(vv.z, round); vd[3] = rnd(vv.w, round);
        }
        for (int r = tid; r < c1 - c0; r += BT)
          kb[r] = key_bias ? key_bias[(size_t)n * S + c0 + r] : 0.f;
        __syncthreads();
      }
      if (pass == 0)
        band_pass<0>(Ks, Vs, kb, c0, c1, wk0, wk1, q, W, live, qv, m, den,
                     acc, round);
      else if (pass == 1)
        band_pass<1>(Ks, Vs, kb, c0, c1, wk0, wk1, q, W, live, qv, m, den,
                     acc, round);
      else
        band_pass<2>(Ks, Vs, kb, c0, c1, wk0, wk1, q, W, live, qv, m, den,
                     acc, round);
    }
  }
  if (!live) return;
  float4* o = reinterpret_cast<float4*>(ctx + ((size_t)n * S + q) * C + h * HD);
#pragma unroll
  for (int i = 0; i < HD / 4; ++i)
    o[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                       acc[4 * i + 3]);
}

}  // namespace lct

// x, out: [N, S, 64]; in_w: [64, 192]; out_w: [64, 64]; key_bias: [N, S] or
// null; lookback >= 0. Scratch: qkv [N*S, 192], ctx [N*S, 64]. Returns a
// cudaError_t.
extern "C" int lct_banded_forward(const float* x, const float* in_w,
                                  const float* in_b, const float* out_w,
                                  const float* out_b, const float* key_bias,
                                  float* qkv, float* ctx, float* out,
                                  long long N, int S, int lookback,
                                  int precise, int device, void* stream) {
  using namespace lct;
  if (lookback < 0 || N < 0 || S < 0) return (int)cudaErrorInvalidValue;
  const long long rows = N * S;
  if (rows == 0) return 0;
  const int ntiles = (S + BT - 1) / BT;
  const long long ablocks = N * NH * ntiles;
  const long long rblocks = (rows + ROWS - 1) / ROWS;
  if (ablocks > INT_MAX || rblocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const int round = precise ? 0 : 1;

  proj_kernel<false><<<(unsigned)rblocks, 3 * C, 0, st>>>(
      x, nullptr, nullptr, nullptr, nullptr, in_w, in_b, qkv, rows, 3 * C,
      round);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  banded_attn_kernel<<<(unsigned)ablocks, BT, 0, st>>>(qkv, key_bias, ctx, S,
                                                       lookback, ntiles, round);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  proj_kernel<false><<<(unsigned)rblocks, C, 0, st>>>(
      ctx, nullptr, nullptr, nullptr, nullptr, out_w, out_b, out, rows, C,
      round);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return 0;
}
