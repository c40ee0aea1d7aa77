// Fused multi-head self-attention for Hopper (sm_90a): the function of the
// TPU kernel `lct_gan_tpu/ops/attention.py::_mhsa_kernel` over x [N, L, C]
// (L <= 1024), with the TPU kernel's bf16 rounding points (x, in_w; q, k,
// v; the normalised p; ctx, out_w) and f32 accumulation. Two designs, one
// per mode:
//
// bf16 (lct_mhsa_forward_bf16), tensor cores (tc.cuh):
//   1. qkv_tc_kernel       qkv = bf16(x @ in_w + in_b) -> qkv bf16 [N*L, 3C]
//   2. attn_tc_kernel<1>   C/hd-head softmax attention, band, key bias, and
//                          out = ctx @ out_w + out_b  -> out [N*L, C]
//   At C = 256 and 512: qkv_panel_kernel, then attn_head_kernel<1> -> ctx
//   bf16 [N*L, C] and epi_kernel<1> -> out (the split epilogue, tc.cuh).
// precise (lct_mhsa_forward_f32), all f32 on CUDA cores (common.cuh):
//   proj_kernel -> qkv f32, attn_kernel<1> -> ctx f32, proj_kernel -> out.
//
// Any true width c_true <= C in any num_heads dividing it (heads of hd =
// c_true / num_heads channels, run at head_width(hd); the kernels' head
// widths: tc.cuh, common.cuh), the score scale from the caller.
//
// Bound on the H100 at C = 64: at the time block of a 163,840-sample bucket
// (N = 25*33 sequences of L = 644) the function moves ~272 MB (~81 us at 3.35 TB/s)
// and does ~100 GFLOP of products, 88% of them in the L x L scores and
// context (~101 us at 989 TFLOP/s bf16): it is bound by operations. With
// head_dim 16 the tensor cores are not what sets the pace of the bf16
// design: the contract rounds the normalised p, which needs the exact row
// max and sum first, so every in-band pair takes two exps (one per pass
// over the keys), and the special-function unit (~4.15 T exp/s measured by
// ops/probe.py) gives a floor of ~0.66 ms at L = 644 (0.53 ms at L = 516). q, k, v cross device
// memory once, as bf16; the context never does.

#include "tc.cuh"

// x, out: [N, L, C]; in_w: [C, 3C]; out_w: [C, C]; key_bias: [N, L] or
// null; lookback < 0 means no band; c_true true channels (the rest of each
// row zero) in num_heads heads, scale their score scale (the f32 rounding
// of 1 / sqrt(c_true / num_heads)). Scratch: qkv bf16 [N*L, 3C], at C >=
// 256 ctx bf16 [N*L, C] (else null). Returns a cudaError_t.
extern "C" int lct_mhsa_forward_bf16(const float* x, const float* in_w,
                                     const float* in_b, const float* out_w,
                                     const float* out_b,
                                     const float* key_bias, void* qkv,
                                     void* ctx, float* out, long long N, int L,
                                     int lookback, int c_true, int num_heads,
                                     float scale, int device, void* stream) {
  using namespace lct;
  if (!widths_ok(c_true, num_heads, 1) || (C > 128) != (ctx != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  __nv_bfloat16* q = static_cast<__nv_bfloat16*>(qkv);
  e = tc::launch_qkv({x, nullptr, nullptr, nullptr, nullptr, in_w, in_b, q,
                      nullptr, nullptr, N * L},
                     st);
  if (e != cudaSuccess) return (int)e;
  tc::AttnArgs a = {};
  a.qkv = q;
  a.key_bias = key_bias;
  a.out_w = out_w;
  a.out_b = out_b;
  a.out = out;
  a.N = N;
  a.L = L;
  a.lookback = lookback;
  a.hd = head_width(c_true / num_heads);
  a.scale2 = tc::qk_scale2(scale);
  return (int)tc::launch_attn_tc<1>(a, st, static_cast<__nv_bfloat16*>(ctx));
}

// The same function in all-f32 arithmetic (precise mode), arguments as
// lct_mhsa_forward_bf16's. Scratch: qkv [N*L, 3C], ctx [N*L, C], f32.
extern "C" int lct_mhsa_forward_f32(const float* x, const float* in_w,
                                    const float* in_b, const float* out_w,
                                    const float* out_b, const float* key_bias,
                                    float* qkv, float* ctx, float* out,
                                    long long N, int L, int lookback,
                                    int c_true, int num_heads, float scale,
                                    int device, void* stream) {
  using namespace lct;
  if (!widths_ok(c_true, num_heads, 1)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = N * L;
  const unsigned rblocks = (unsigned)((rows + PROJ_ROWS - 1) / PROJ_ROWS);

  proj_kernel<false><<<row_grid(rblocks, 3 * C), row_threads(3 * C), 0, st>>>(
      x, nullptr, nullptr, nullptr, nullptr, in_w, in_b, qkv, rows, 3 * C,
      /*round=*/0, /*inv_c=*/0.f);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  e = launch_attn<1>(qkv, key_bias, ctx, N, L, lookback, /*round=*/0,
                     head_width(c_true / num_heads), scale, st);
  if (e != cudaSuccess) return (int)e;
  proj_kernel<false><<<row_grid(rblocks, C), row_threads(C), 0, st>>>(
      ctx, nullptr, nullptr, nullptr, nullptr, out_w, out_b, out, rows, C,
      /*round=*/0, /*inv_c=*/0.f);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return 0;
}
