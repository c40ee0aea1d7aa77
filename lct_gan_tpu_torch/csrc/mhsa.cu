// Fused multi-head self-attention for Hopper (sm_90a): the function of the
// TPU kernel `lct_gan_tpu/ops/attention.py::_mhsa_kernel` over x [N, L, 64]
// (L <= 1024), as three kernels in a row:
//
//   1. proj_kernel<false> qkv = x @ in_w + in_b            -> qkv [N*L, 192]
//   2. attn_kernel<1>     4-head softmax attention, band, key bias -> ctx
//   3. proj_kernel<false> out = ctx @ out_w + out_b          -> out [N*L, 64]
//
// with the TPU kernel's bf16 rounding points (x, in_w; q, k, v; the
// normalised p; ctx, out_w), f32 accumulation (see common.cuh).
//
// Bound on the H100: at the time block of a 163,840-sample bucket (N = 25*33
// sequences of L = 644) the function moves ~272 MB (~81 us at 3.35 TB/s)
// and does ~100 GFLOP of products, 88% of them in the L x L scores and
// context (~101 us at 989 TFLOP/s bf16): it is bound by operations. This
// simple design runs them on CUDA cores in f32, one query row per thread
// with K/V of a head in shared memory, and round-trips qkv and ctx through
// device memory; tensor-core tiles (wgmma) are later work.

#include "common.cuh"

// x, out: [N, L, 64]; in_w: [64, 192]; out_w: [64, 64]; key_bias: [N, L] or
// null; lookback < 0 means no band. Scratch: qkv [N*L, 192], ctx [N*L, 64].
// Returns a cudaError_t.
extern "C" int lct_mhsa_forward(const float* x, const float* in_w,
                                const float* in_b, const float* out_w,
                                const float* out_b, const float* key_bias,
                                float* qkv, float* ctx, float* out,
                                long long N, int L, int lookback, int precise,
                                int device, void* stream) {
  using namespace lct;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const int round = precise ? 0 : 1;
  const long long rows = N * L;
  const unsigned rblocks = (unsigned)((rows + ROWS - 1) / ROWS);

  proj_kernel<false><<<rblocks, 3 * C, 0, st>>>(
      x, nullptr, nullptr, nullptr, nullptr, in_w, in_b, qkv, rows, 3 * C,
      round);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  e = launch_attn<1>(qkv, key_bias, ctx, N, L, lookback, round, st);
  if (e != cudaSuccess) return (int)e;
  proj_kernel<false><<<rblocks, C, 0, st>>>(
      ctx, nullptr, nullptr, nullptr, nullptr, out_w, out_b, out, rows, C,
      round);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return 0;
}
