// Tensor-core kernels of the bf16 mode, shared by ftf.cu, mhsa.cu and
// banded.cu (whose fused kernel, and ftf_bwd.cu's, are built from the
// fragment helpers here).
//
// Every product runs as `mma.sync.aligned.m16n8k16` on bf16 operands with
// f32 accumulation. The contract already rounds every GEMM operand to bf16
// (common.cuh), and a bf16 x bf16 product is exact in f32, so this is the
// arithmetic of the CUDA-core kernels up to the order of the f32 sums.
// Precise (all-f32) mode keeps the CUDA-core kernels of common.cuh: tensor
// cores have no f32 product.
//
// Fragment layouts (PTX ISA, m16n8k16, g = lane / 4, t = lane % 4):
//   A 16x16: a[0] (row g, cols 2t, 2t+1), a[1] (row g+8), a[2] (row g,
//            cols 8+2t, 9+2t), a[3] (row g+8, cols 8+2t, 9+2t)
//   B 16x8:  b[0] (rows 2t, 2t+1, col g), b[1] (rows 8+2t, 9+2t, col g)
//   C 16x8:  c[0], c[1] (row g, cols 2t, 2t+1), c[2], c[3] (row g+8)
// So the C fragments of two neighbouring n8 tiles, rounded and packed, are
// the A fragment of the next product over those 16 columns: probabilities,
// contexts and GRU hidden states pass from one product to the next in
// registers.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace lct {
namespace tc {

constexpr int LDS = C + 8;        // bf16 row stride of a C-column tile
constexpr int LDW = 3 * C + 8;    // bf16 row stride of in_w [C][3C]
// log2 of C / 8: the 16-byte pieces of a bf16 row of C channels.
constexpr int PIECES_LOG2 =
    C == 16 ? 1 : C == 32 ? 2 : C == 64 ? 3 : C == 128 ? 4 : C == 256 ? 5 : 6;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two f32 values rounded to bf16 (nearest-even) and packed, `lo` in the low
// half: the register layout of two neighbouring fragment columns.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += A B on bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// A fragment of rows 0..15, cols 0..15 of a row-major bf16 tile.
__device__ __forceinline__ void load_a(uint32_t a[4],
                                       const __nv_bfloat16* base, int ld,
                                       int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  ldsm_x4(a, base + ((mi & 1) * 8 + rr) * ld + (mi >> 1) * 8);
}

// B fragments of two n8 tiles (b[0..1]: n 0..7, b[2..3]: n 8..15) over
// k 0..15 from a row-major [n][k] tile (K of the scores q k^T).
__device__ __forceinline__ void load_b_nk(uint32_t b[4],
                                          const __nv_bfloat16* base, int ld,
                                          int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  ldsm_x4(b, base + ((mi >> 1) * 8 + rr) * ld + (mi & 1) * 8);
}

// The same from a row-major [k][n] tile (V, and every weight matrix).
__device__ __forceinline__ void load_b_kn(uint32_t b[4],
                                          const __nv_bfloat16* base, int ld,
                                          int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  ldsm_x4_t(b, base + ((mi & 1) * 8 + rr) * ld + (mi >> 1) * 8);
}

// 16-byte (or, for the key bias, 4-byte) asynchronous copy global ->
// shared; `valid == false` writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N_PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_PENDING) : "memory");
}

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// dst[r * ld + c] = bf16(src[r * cols + c]) for a [rows][cols] f32 matrix,
// by the whole block.
__device__ __forceinline__ void stage_weight(__nv_bfloat16* dst, int ld,
                                             const float* __restrict__ src,
                                             int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
    dst[(i / cols) * ld + i % cols] = __float2bfloat16_rn(__ldg(src + i));
}

// Blocks of a persistent grid: as many as fit on the card at once, at most
// `items`.
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, size_t smem,
                            long long items, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (unsigned)(g < items ? g : (items > 0 ? items : 1));
  return cudaSuccess;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The GRU kernels on tensor cores (ftf.cu's gru_tc_kernel, ftf_bwd.cu's
// bptt_tc_kernel) take 16 sequences per block, the rows of one m16 tile.
constexpr int GS = 16;

// The gates from one ex2 and one reciprocal each on the special-function
// unit: a few f32 ulps from expf / tanhf, far below the bf16 rounding of h
// that the next step's product takes.
__device__ __forceinline__ float sigmoid_sfu(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}

__device__ __forceinline__ float tanh_sfu(float v) {
  return fmaf(-2.f, __fdividef(1.f, 1.f + __expf(2.f * v)), 1.f);
}

// One direction and slot's GRU weights as a warp of the GRU kernels holds
// them: the B fragments of W_ih and W_hh [16][48] (k = input unit, n = gate
// column; n8 tiles 0-1 r, 2-3 z, 4-5 n) and the biases of this lane's units
// 8 jh + 2t + e, r and z summed, n apart. The weights are slots of 16
// units, [D, C/16, 16, 48] (groups of 16, or narrower groups packed
// block-diagonally by ops/gru.py::pack_gru_slots); dg = direction * (C/16) +
// slot.
struct GruFrags {
  uint32_t bi[6][2], bh[6][2];
  float brz[2][2][2], bxn[2][2], bhn[2][2];
};

__device__ __forceinline__ void load_gru_frags(GruFrags& f,
                                               const float* w_ih,
                                               const float* w_hh,
                                               const float* b_ih,
                                               const float* b_hh, int dg,
                                               int lane) {
  constexpr int H = 16;
  const int g = lane >> 2, t = lane & 3;
  const float* wi = w_ih + (size_t)dg * H * (3 * H);
  const float* wh = w_hh + (size_t)dg * H * (3 * H);
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
    const int col = nt * 8 + g;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = 2 * t + 8 * k;
      f.bi[nt][k] = pack_bf16(wi[r * 3 * H + col], wi[(r + 1) * 3 * H + col]);
      f.bh[nt][k] = pack_bf16(wh[r * 3 * H + col], wh[(r + 1) * 3 * H + col]);
    }
  }
#pragma unroll
  for (int jh = 0; jh < 2; ++jh)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = dg * 3 * H + 8 * jh + 2 * t + e;
#pragma unroll
      for (int q = 0; q < 2; ++q)
        f.brz[q][jh][e] = b_ih[o + q * H] + b_hh[o + q * H];
      f.bxn[jh][e] = b_ih[o + 2 * H];
      f.bhn[jh][e] = b_hh[o + 2 * H];
    }
}

// The same for a dense slot of W = 16 KS units (one group of W, or narrower
// ones packed block-diagonally; W = C, or 64 at C = 128), [D, C / W, W,
// 3W], dg = direction * (C / W) + slot: a warp holds its 16 units 16 u ..
// 16 u + 15 of each gate, over the KS 16-input k-steps of W_ih and W_hh
// (bi[nt][kk]). Built for W <= 64 (96 fragment registers at 64).
template <int KS>
struct GruFragsDense {
  uint32_t bi[6][KS][2], bh[6][KS][2];
  float brz[2][2][2], bxn[2][2], bhn[2][2];
};

template <int KS>
__device__ __forceinline__ void load_gru_frags(GruFragsDense<KS>& f,
                                               const float* w_ih,
                                               const float* w_hh,
                                               const float* b_ih,
                                               const float* b_hh, int dg,
                                               int u, int lane) {
  constexpr int W = 16 * KS;
  const int g = lane >> 2, t = lane & 3;
  const float* wi = w_ih + (size_t)dg * W * (3 * W);
  const float* wh = w_hh + (size_t)dg * W * (3 * W);
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
    const int col = (nt >> 1) * W + 16 * u + (nt & 1) * 8 + g;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = kk * 16 + 2 * t + 8 * k;
        f.bi[nt][kk][k] =
            pack_bf16(wi[r * 3 * W + col], wi[(r + 1) * 3 * W + col]);
        f.bh[nt][kk][k] =
            pack_bf16(wh[r * 3 * W + col], wh[(r + 1) * 3 * W + col]);
      }
  }
#pragma unroll
  for (int jh = 0; jh < 2; ++jh)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = dg * 3 * W + 16 * u + 8 * jh + 2 * t + e;
#pragma unroll
      for (int q = 0; q < 2; ++q)
        f.brz[q][jh][e] = b_ih[o + q * W] + b_hh[o + q * W];
      f.bxn[jh][e] = b_ih[o + 2 * W];
      f.bhn[jh][e] = b_hh[o + 2 * W];
    }
}

// The fragments of a GRU kernel built for KS k-steps a slot: slots of 16
// (KS = 1) or dense slots of 16 KS (C, or 64 at C = 128).
template <int KS>
struct GruFragsOf {
  using type = GruFragsDense<KS>;
};
template <>
struct GruFragsOf<1> {
  using type = GruFrags;
};

// acc = A @ w[:, 0:16] for a 16-row tile A of C columns, given as the A
// fragments of its C / 16 16-column k-steps, and w a bf16 [C][ld] tile in
// shared memory: the C fragments of two n8 tiles (columns 0-7, 8-15).
__device__ __forceinline__ void product_16cols(float (&acc)[2][4],
                                               const uint32_t (&af)[C / 16][4],
                                               const __nv_bfloat16* w,
                                               int ld, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t wb[4];
    load_b_kn(wb, w + kk * 16 * ld, ld, lane);
    mma(acc[0], af[kk], wb[0], wb[1]);
    mma(acc[1], af[kk], wb[2], wb[3]);
  }
}

// acc = ctx @ out_w for 16 rows: ctx as the A fragments of its C / 16
// 16-channel k-steps, out_w staged bf16 [C][LDS]; the C fragments of the
// C / 8 n8 tiles of the C output columns.
__device__ __forceinline__ void out_projection(float (&acc)[C / 8][4],
                                               const uint32_t (&ca)[C / 16][4],
                                               const __nv_bfloat16* wo,
                                               int lane) {
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
    for (int np = 0; np < C / 16; ++np) {
      uint32_t wf[4];
      load_b_kn(wf, wo + kk * 16 * LDS + np * 16, LDS, lane);
      mma(acc[2 * np], ca[kk], wf[0], wf[1]);
      mma(acc[2 * np + 1], ca[kk], wf[2], wf[3]);
    }
}

// Heads narrower than a fragment (hd <= 8, the attention kernels' padded
// width 8) are exact through zero masks, since entries off a head's block
// contribute nothing: head h's scores take the A fragment of its 16-channel
// k-step with every column outside [h hd, h hd + hd) zeroed (q_mask), and
// its context takes the B fragment of V's n8 tile with the other heads'
// columns zeroed (v_mask; a lane holds column g of the tile).
__device__ __forceinline__ void q_mask(uint32_t (&a)[4], int h, int hd,
                                       int lane) {
  const int lo = (h * hd) & 15, hi = lo + hd, t = lane & 3;
  auto pair = [&](int c) {
    return (c >= lo && c < hi ? 0xFFFFu : 0u) |
           (c + 1 >= lo && c + 1 < hi ? 0xFFFF0000u : 0u);
  };
  const uint32_t m0 = pair(2 * t), m1 = pair(8 + 2 * t);
  a[0] &= m0;
  a[1] &= m0;
  a[2] &= m1;
  a[3] &= m1;
}

__device__ __forceinline__ uint32_t v_mask(int h, int hd, int lane) {
  const int c = (((h * hd) >> 3) << 3) + (lane >> 2);
  return c >= h * hd && c < h * hd + hd ? 0xFFFFFFFFu : 0u;
}

// ---------------------------------------------------------------------------
// qkv = bf16(bf16(in) @ bf16(in_w) + in_b) over rows of C channels, stored
// bf16 [rows, 3C]: the contract rounds q, k and v, so this halves their
// bytes and changes no value.
//   in = x (+ (add0 + add1)), LayerNorm'ed when ln_s != nullptr with
//   proj_kernel's arithmetic over 1 / inv_c true channels (common.cuh;
//   ftf_bwd.cu's ln_kernel computes the same values). For the FTF block it
//   also writes what the attention kernel's epilogue needs: s = in before
//   the LayerNorm (f32) and bf16(add0 + add1), the Linear's rounded g.
// Persistent blocks of 4 warps, in_w staged once per block; each warp owns
// 16 rows of a 64-row tile (no block barrier inside the tile loop). Bound
// by bytes: x (and the hiddens) in, q, k, v out. At C = 128 in_w (98 KB as
// bf16) passes the 48 KB of static shared memory: dynamic there.
constexpr int PROJ_THREADS = 128;
constexpr size_t QKV_SMEM =
    sizeof(__nv_bfloat16) * (C * LDW + 64 * LDS);

struct ProjArgs {
  const float* x;
  const float* add0;
  const float* add1;
  const float* ln_s;
  const float* ln_b;
  const float* w;     // [C, 3C] f32
  const float* bias;  // [3C]
  __nv_bfloat16* out; // [rows, 3C]
  float* s_out;           // or null: in before the LayerNorm, f32 [rows, C]
  __nv_bfloat16* g_out;   // or null: bf16(add0 + add1) [rows, C]
  long long rows;
  float inv_c;            // 1 / the true channel count (the LayerNorm's)
};

// The LayerNorm's scale and bias of the CPL channels a lane holds (1 and 0
// without a LayerNorm; 0 and 0 past C).
__device__ __forceinline__ void ln_params(const ProjArgs& a, int lane,
                                          float (&ls)[CPL], float (&lb)[CPL]) {
#pragma unroll
  for (int i = 0; i < CPL; ++i)
    ls[i] = a.ln_s ? (lane_holds(lane, i) ? a.ln_s[lane + 32 * i] : 0.f)
                   : 1.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i)
    lb[i] = a.ln_s ? (lane_holds(lane, i) ? a.ln_b[lane + 32 * i] : 0.f)
                   : 0.f;
}

// A warp's 16 rows from row0 of in = x (+ (add0 + add1)), LayerNorm'ed when
// ln_s != nullptr and rounded to bf16 into its A tile aw [16][LDS], RB rows
// at a time (every load of a batch issued before the first row's
// LayerNorm; UNROLL batches unrolled); with `store` it also writes s and
// bf16(g) (ProjArgs). Every C but 64 (whose qkv_tc_kernel keeps its own
// two-channels-a-lane statements).
template <int RB, int UNROLL>
__device__ __forceinline__ void stage_rows(const ProjArgs& a, long long row0,
                                           __nv_bfloat16* aw,
                                           const float (&ls)[CPL],
                                           const float (&lb)[CPL], int lane,
                                           bool store) {
#pragma unroll (UNROLL)
  for (int r8 = 0; r8 < 16; r8 += RB) {
    float v[RB][CPL], gv[RB][CPL];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const long long row = row0 + r8 + r;
#pragma unroll
      for (int i = 0; i < CPL; ++i) v[r][i] = gv[r][i] = 0.f;
      if (row < a.rows) {
        const size_t o = (size_t)row * C + lane;
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          if (lane_holds(lane, i)) v[r][i] = a.x[o + 32 * i];
        if (a.add0) {
#pragma unroll
          for (int i = 0; i < CPL; ++i)
            if (lane_holds(lane, i))
              gv[r][i] = a.add1 ? (a.add0[o + 32 * i] + a.add1[o + 32 * i])
                                : a.add0[o + 32 * i];
#pragma unroll
          for (int i = 0; i < CPL; ++i) v[r][i] += gv[r][i];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const long long row = row0 + r8 + r;
      if (store && row < a.rows) {
        const size_t o = (size_t)row * C + lane;
        if (a.s_out) {
#pragma unroll
          for (int i = 0; i < CPL; ++i)
            if (lane_holds(lane, i)) a.s_out[o + 32 * i] = v[r][i];
        }
        if (a.g_out) {
#pragma unroll
          for (int i = 0; i < CPL; ++i)
            if (lane_holds(lane, i))
              a.g_out[o + 32 * i] = __float2bfloat16_rn(gv[r][i]);
        }
      }
      if (a.ln_s) ln_row(v[r], ls, lb, a.inv_c);
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        if (lane_holds(lane, i))
          aw[(r8 + r) * LDS + lane + 32 * i] = __float2bfloat16_rn(v[r][i]);
    }
  }
}

#if LCT_C <= 128
__global__ void __launch_bounds__(PROJ_THREADS)
    qkv_tc_kernel(ProjArgs a) {
#if LCT_C > 64
  extern __shared__ __align__(16) unsigned char qkv_smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(qkv_smem);
  __nv_bfloat16* as = ws + C * LDW;
#else
  __shared__ __align__(16) __nv_bfloat16 ws[C * LDW];
  __shared__ __align__(16) __nv_bfloat16 as[64 * LDS];
#endif
  stage_weight(ws, LDW, a.w, C, 3 * C);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* aw = as + warp * 16 * LDS;
#if LCT_C == 64
  // C = 64: two channels a lane (lane, lane + 32), the statements its
  // instances were built and timed with.
  const float ls0 = a.ln_s ? a.ln_s[lane] : 1.f;
  const float ls1 = a.ln_s ? a.ln_s[lane + 32] : 1.f;
  const float lb0 = a.ln_s ? a.ln_b[lane] : 0.f;
  const float lb1 = a.ln_s ? a.ln_b[lane + 32] : 0.f;
  const long long tiles = (a.rows + 63) / 64;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * 64 + warp * 16;
    // 8 rows at a time: every load of a batch is issued before the first
    // row's LayerNorm.
#pragma unroll
    for (int r8 = 0; r8 < 16; r8 += 8) {
      float va[8], vb[8], ga[8], gb[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const long long row = row0 + r8 + r;
        va[r] = vb[r] = ga[r] = gb[r] = 0.f;
        if (row < a.rows) {
          const size_t o = (size_t)row * C;
          va[r] = a.x[o + lane];
          vb[r] = a.x[o + lane + 32];
          if (a.add0) {
            ga[r] = a.add1 ? (a.add0[o + lane] + a.add1[o + lane])
                           : a.add0[o + lane];
            gb[r] = a.add1 ? (a.add0[o + lane + 32] + a.add1[o + lane + 32])
                           : a.add0[o + lane + 32];
            va[r] += ga[r];
            vb[r] += gb[r];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float p = va[r], q = vb[r];
        const long long row = row0 + r8 + r;
        if (row < a.rows) {
          const size_t o = (size_t)row * C;
          if (a.s_out) {
            a.s_out[o + lane] = p;
            a.s_out[o + lane + 32] = q;
          }
          if (a.g_out) {
            a.g_out[o + lane] = __float2bfloat16_rn(ga[r]);
            a.g_out[o + lane + 32] = __float2bfloat16_rn(gb[r]);
          }
        }
        if (a.ln_s) {
          const float mu = warp_sum(p + q) * a.inv_c;
          const float ms = warp_sum(p * p + q * q) * a.inv_c;
          const float rs = rsqrtf(fmaxf(ms - mu * mu, 0.f) + 1e-6f);
          p = (p - mu) * rs * ls0 + lb0;
          q = (q - mu) * rs * ls1 + lb1;
        }
        aw[(r8 + r) * LDS + lane] = __float2bfloat16_rn(p);
        aw[(r8 + r) * LDS + lane + 32] = __float2bfloat16_rn(q);
      }
    }
#else
  // Any other C: CPL channels a lane (lane + 32 i), the same steps.
  float ls[CPL], lb[CPL];
  ln_params(a, lane, ls, lb);
  const long long tiles = (a.rows + 63) / 64;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * 64 + warp * 16;
    stage_rows<8, 2>(a, row0, aw, ls, lb, lane, true);
#endif
    __syncwarp();
    uint32_t af[C / 16][4];
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      load_a(af[kk], aw + kk * 16, LDS, lane);
#pragma unroll 2
    for (int np = 0; np < 3 * C / 16; ++np) {
      float acc[2][4];
      product_16cols(acc, af, ws + np * 16, LDW, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = np * 16 + j * 8 + 2 * t;
        const float b0 = __ldg(a.bias + col), b1 = __ldg(a.bias + col + 1);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const long long row = row0 + g + 8 * rr;
          if (row < a.rows)
            *reinterpret_cast<uint32_t*>(a.out + (size_t)row * (3 * C) +
                                         col) =
                pack_bf16(acc[j][2 * rr] + b0, acc[j][2 * rr + 1] + b1);
        }
      }
    }
    __syncwarp();
  }
}

inline cudaError_t launch_qkv(const ProjArgs& a, cudaStream_t st) {
  unsigned grid = 1;
  constexpr size_t smem = LCT_C > 64 ? QKV_SMEM : 0;
  cudaError_t e = allow_smem(qkv_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  e = persistent_grid(qkv_tc_kernel, PROJ_THREADS, smem, (a.rows + 63) / 64,
                      &grid);
  if (e != cudaSuccess) return e;
  qkv_tc_kernel<<<grid, PROJ_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}
#else
// C = 256: in_w [C, 3C] is 393 KB as bf16, past the 227 KB of shared memory
// a block may hold, so qkv_panel_kernel stages it in three panels of PNW =
// C output columns (q, k, v: 135 KB each) and takes its rows through each
// panel in turn, each time with qkv_tc_kernel's LayerNorm and rounding
// (stage_rows, 4 rows at a time: CPL = 8 channels a lane); s and bf16(g)
// are written in the first panel. C = 512 (in_w 1.5 MB as bf16): twelve
// panels of PNW = 128 columns (139 KB each), rows 2 at a time (CPL = 16),
// and the A fragments of a row tile read from shared memory for each
// product (all 32 k-steps' would take 128 registers a lane). Bound by
// bytes, as qkv_tc_kernel: x (and the hiddens) are read once per panel.
constexpr int PNW = C > 256 ? 128 : C;  // output columns a panel
constexpr int LDP = PNW + 8;            // bf16 row stride of a panel
constexpr size_t PANEL_SMEM = sizeof(__nv_bfloat16) * (C * LDP + 64 * LDS);

__global__ void __launch_bounds__(PROJ_THREADS)
    qkv_panel_kernel(ProjArgs a) {
  extern __shared__ __align__(16) unsigned char qkv_smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(qkv_smem);  // [C][LDP]
  __nv_bfloat16* as = ws + C * LDP;                                 // [64][LDS]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* aw = as + warp * 16 * LDS;
  float ls[CPL], lb[CPL];
  ln_params(a, lane, ls, lb);
  const long long tiles = (a.rows + 63) / 64;
  for (int p = 0; p < 3 * C / PNW; ++p) {
    __syncthreads();  // the previous panel's products are done
    for (int i = threadIdx.x; i < C * PNW; i += blockDim.x)
      ws[(i / PNW) * LDP + i % PNW] = __float2bfloat16_rn(
          __ldg(a.w + (size_t)(i / PNW) * (3 * C) + p * PNW + i % PNW));
    __syncthreads();
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long row0 = tile * 64 + warp * 16;
#if LCT_C > 256
      stage_rows<2, 1>(a, row0, aw, ls, lb, lane, p == 0);
      __syncwarp();
#pragma unroll 1
      for (int np = 0; np < PNW / 16; ++np) {
        float acc[2][4] = {};
#pragma unroll 4
        for (int kk = 0; kk < C / 16; ++kk) {
          uint32_t af[4], wb[4];
          load_a(af, aw + kk * 16, LDS, lane);
          load_b_kn(wb, ws + kk * 16 * LDP + np * 16, LDP, lane);
          mma(acc[0], af, wb[0], wb[1]);
          mma(acc[1], af, wb[2], wb[3]);
        }
#else
      stage_rows<4, 1>(a, row0, aw, ls, lb, lane, p == 0);
      __syncwarp();
      uint32_t af[C / 16][4];
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        load_a(af[kk], aw + kk * 16, LDS, lane);
#pragma unroll 2
      for (int np = 0; np < C / 16; ++np) {
        float acc[2][4];
        product_16cols(acc, af, ws + np * 16, LDS, lane);
#endif
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = p * PNW + np * 16 + j * 8 + 2 * t;
          const float b0 = __ldg(a.bias + col), b1 = __ldg(a.bias + col + 1);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const long long row = row0 + g + 8 * rr;
            if (row < a.rows)
              *reinterpret_cast<uint32_t*>(a.out + (size_t)row * (3 * C) +
                                           col) =
                  pack_bf16(acc[j][2 * rr] + b0, acc[j][2 * rr + 1] + b1);
          }
        }
      }
      __syncwarp();
    }
  }
}

inline cudaError_t launch_qkv(const ProjArgs& a, cudaStream_t st) {
  unsigned grid = 1;
  cudaError_t e = allow_smem(qkv_panel_kernel, PANEL_SMEM);
  if (e != cudaSuccess) return e;
  e = persistent_grid(qkv_panel_kernel, PROJ_THREADS, PANEL_SMEM,
                      (a.rows + 63) / 64, &grid);
  if (e != cudaSuccess) return e;
  qkv_panel_kernel<<<grid, PROJ_THREADS, PANEL_SMEM, st>>>(a);
  return cudaGetLastError();
}
#endif

// ---------------------------------------------------------------------------
// Multi-head attention (C / hd heads of hd channels) over bf16 qkv [N*L,
// 3C] with the output projection (and, for the FTF block, the Linear,
// LeakyReLU and residual) in the epilogue.
//
// Work item: one (sequence, tile of 64 or 128 query rows); a persistent grid
// walks them, the weights staged in shared memory once per block. Each warp
// owns 16 query rows and all heads, so it holds the whole C-channel
// context of its rows for the epilogue's products. K and V stream through
// two shared-memory tiles of 64 keys (cp.async, double-buffered; a range of
// at most two tiles is loaded once and kept), so any L <= 1024 fits in a
// fixed 74 KB (FTF) or, for MHSA, 56 KB (64-row items) or 64 KB (128-row
// items; attn_smem below; at C = 64); the next item's Q and first tile load
// under the current item's epilogue. Scores q k^T are one m16n8k16 step per
// 8 keys and 16 head channels; P @ V is one step per 16 keys and 8 head
// channels, P taken from the score accumulators in registers. The kernel
// is built per padded head width HDP: 16 .. C (hd = HDP, every head's
// state in registers through one walk over the keys), or 8 for any hd <= 8
// (the true width at run time): a head then takes one masked fragment of
// its 16-channel k-step (q_mask) and its n8 tile of V (v_mask), and the
// C / hd heads go through the keys in rounds of four (two at C = 16), each
// round walking the keys as the heads of a wider instance do, with its
// heads' row max and sum in registers (the context of all C channels stays in registers
// across the rounds; a resident item's keys load once). Key chunks of 16
// outside a warp's band are skipped. A tile whose four chunks all lie
// inside the band and below L (every tile but the edges) runs a
// straight-line path with no mask.
//
// The contract needs the exact row max m before p is rounded, so the keys
// are walked twice when they span more than one tile:
//   MODE 1 (MHSA):  pass A: m and l = sum exp(s - m) online;
//                   pass B: p = bf16(exp(s - m) / l), ctx = p @ v.
//                   Two exps per pair.
//   MODE 0 (FTF):   pass A: m only (no exp);
//                   pass B: p = exp(s - m), den = sum p, ctx = (bf16(p) @ v)
//                   / (den + 1e-20). One exp per pair.
// Keys that fit one tile (the frequency blocks, L = 33) take one walk: the
// max is exact after it, and MODE 1 keeps its exps in registers.
// Scores are s = (q . k) / sqrt(hd) + key_bias; `lookback >= 0` keeps the
// inclusive band [q - lookback, q]. They are formed in log2 units,
// s log2(e) = fma(q . k, log2(e) / sqrt(hd), key_bias log2(e)), so each exp
// is one ex2 of a difference (FlashAttention's trick; the same function up
// to f32 rounding).
//
// Bound: with head_dim 16 the tensor cores are not what sets the pace. MHSA
// is bound by its exps on the special-function unit (two per pair; ~4.15 T/s
// on the H100 by ops/probe.py: 0.53 ms at L = 516, N = 1,023); the FTF
// block's attention by its bytes (q, k, v, s, bf16(g) in, out out: ~1 KB
// per row).
constexpr int AT = 64;  // keys per tile
// Query rows per work item (ROWS, 16 per warp) and the blocks per SM the
// register budget is set for (MIN_BLOCKS: more resident warps for a few
// spills). `python -m lct_gan_tpu_torch.tune_attention` builds variants with
// -D overrides of these macros and times them on the card (PERF.md): FTF
// items of 64 rows (its sequences are short) at 3 blocks; MHSA items of 128
// rows (each K/V tile serves twice the rows per load and per barrier) at 2.
// At C = 128 the context and the epilogue's tiles double: one block an SM,
// the whole register file's share a thread.
#ifndef LCT_FTF_ATTN_ROWS
#define LCT_FTF_ATTN_ROWS 64
#endif
#ifndef LCT_FTF_ATTN_MIN_BLOCKS
#define LCT_FTF_ATTN_MIN_BLOCKS 3
#endif
#ifndef LCT_MHSA_ATTN_ROWS
#define LCT_MHSA_ATTN_ROWS 128
#endif
#ifndef LCT_MHSA_ATTN_MIN_BLOCKS
#define LCT_MHSA_ATTN_MIN_BLOCKS 2
#endif
template <int MODE>
struct AttnShape {
  static constexpr int ROWS =
      MODE == 1 ? LCT_MHSA_ATTN_ROWS : LCT_FTF_ATTN_ROWS;
  static constexpr int THREADS = 2 * ROWS;
  static constexpr int MIN_BLOCKS =
      C > 64 ? 1
             : MODE == 1 ? LCT_MHSA_ATTN_MIN_BLOCKS : LCT_FTF_ATTN_MIN_BLOCKS;
  // 16 rows a warp; at least AT threads (load_kv's key-bias copy).
  static_assert(ROWS % 16 == 0 && 2 * ROWS >= AT && ROWS <= 512, "ROWS");
};
// The score scale in log2 units, from the wrapper's scale (the f32
// rounding of 1 / sqrt of the true head width), taken on the host.
inline float qk_scale2(float scale) { return scale * LOG2E; }

// A key tile: K rows of LD bf16, V rows of LDV (LD but for a head of 512,
// whose context a call takes in parts), the key bias.
template <int LD, int LDV = LD>
struct KVTileOf {
  __nv_bfloat16 k[AT * LD];
  __nv_bfloat16 v[AT * LDV];
  float kb[AT];
};
using KVTile = KVTileOf<LDS>;

struct AttnArgs {
  const __nv_bfloat16* qkv;  // [N*L, 3C]
  const float* key_bias;     // [N, L] or null
  const float* out_w;        // [C, C]
  const float* out_b;        // [C]
  float* out;                // [N*L, C]
  long long N;
  int L;
  int lookback;
  // MODE 0 only: out = s + LeakyReLU(comb),
  // comb = [bf16(g) @ lin_w[:C]] + bf16(a) @ lin_w[lin_in - C:] + lin_b
  const float* s;            // [N*L, C] f32: x + g
  const __nv_bfloat16* g;    // [N*L, C] bf16(g), lin_in == 2C only
  const float* lin_w;  // [lin_in, C]
  const float* lin_b;  // [C]
  int lin_in;
  int hd;  // head width the kernels run: a power of two
  float scale2;  // the score scale in log2 units (qk_scale2)
};

template <int MODE>
constexpr size_t attn_smem() {
  return 2 * sizeof(KVTile) +
         sizeof(__nv_bfloat16) * LDS *
             (AttnShape<MODE>::ROWS + C + (MODE == 0 ? 2 * C : 0));
}

// One work item: sequence n, query rows [q0, q0 + ROWS), key tiles
// [kt0, kt0 + nkt) (those some query of the item needs).
struct Item {
  long long n;
  int q0, kt0, nkt;
  bool resident;  // nkt <= 2: loaded once, kept for both passes
};

template <int QR>
__device__ __forceinline__ Item item_at(long long item, int L, int lb) {
  const int nqt = (L + QR - 1) / QR;
  Item it;
  it.n = item / nqt;
  it.q0 = (int)(item % nqt) * QR;
  int klo = 0, khi = L;
  if (lb >= 0) {
    klo = max(0, it.q0 - lb);
    khi = min(L, it.q0 + QR);
  }
  it.kt0 = klo / AT;
  it.nkt = (khi + AT - 1) / AT - it.kt0;
  it.resident = it.nkt <= 2;
  return it;
}

// An item's Q rows into qs, rows of LD bf16: 2^PL2 16-byte pieces a row
// from column col0 of the q section (all C channels, or one head's).
template <int QR, int THREADS, int PL2 = PIECES_LOG2, int LD = LDS>
__device__ __forceinline__ void load_q(const AttnArgs& a, const Item& it,
                                       __nv_bfloat16* qs, int tid,
                                       int col0 = 0) {
  const __nv_bfloat16* base = a.qkv + (size_t)it.n * a.L * (3 * C) + col0;
  for (int c = tid; c < QR << PL2; c += THREADS) {
    const int r = c >> PL2, part = c & ((1 << PL2) - 1);
    const bool ok = it.q0 + r < a.L;
    cp_async16(qs + r * LD + part * 8,
               base + (size_t)(ok ? it.q0 + r : 0) * (3 * C) + part * 8, ok);
  }
}

// Load number s of an item: key tile s % nkt into its buffer; V only for
// pass B (or when the tiles stay resident for both passes). The same
// columns as load_q, of the k and v sections; with PL2V != PL2 (a head of
// 512 in parts) V's 2^PL2V pieces a row from column vcol0 of the v
// section instead.
template <int THREADS, int PL2 = PIECES_LOG2, int LD = LDS, int PL2V = PL2,
          int LDV = LD>
__device__ __forceinline__ void load_kv(const AttnArgs& a, const Item& it,
                                        KVTileOf<LD, LDV>* kv, int s, int tid,
                                        int col0 = 0, int vcol0 = 0) {
  const int i = s % it.nkt;
  KVTileOf<LD, LDV>& b = kv[it.resident ? i : (s & 1)];
  const bool with_v = it.resident || s >= it.nkt;
  const int kbase = (it.kt0 + i) * AT;
  const __nv_bfloat16* base = a.qkv + (size_t)it.n * a.L * (3 * C) + col0;
  if constexpr (PL2V == PL2 && LDV == LD) {
    for (int c = tid; c < AT << PL2; c += THREADS) {
      const int r = c >> PL2, part = c & ((1 << PL2) - 1);
      const bool ok = kbase + r < a.L;
      const __nv_bfloat16* src =
          base + (size_t)(ok ? kbase + r : 0) * (3 * C) + C + part * 8;
      cp_async16(b.k + r * LD + part * 8, src, ok);
      if (with_v) cp_async16(b.v + r * LD + part * 8, src + C, ok);
    }
  } else {
    for (int c = tid; c < AT << PL2; c += THREADS) {
      const int r = c >> PL2, part = c & ((1 << PL2) - 1);
      const bool ok = kbase + r < a.L;
      cp_async16(b.k + r * LD + part * 8,
                 base + (size_t)(ok ? kbase + r : 0) * (3 * C) + C + part * 8,
                 ok);
    }
    if (with_v) {
      const __nv_bfloat16* vbase =
          a.qkv + (size_t)it.n * a.L * (3 * C) + 2 * C + vcol0;
      for (int c = tid; c < AT << PL2V; c += THREADS) {
        const int r = c >> PL2V, part = c & ((1 << PL2V) - 1);
        const bool ok = kbase + r < a.L;
        cp_async16(b.v + r * LDV + part * 8,
                   vbase + (size_t)(ok ? kbase + r : 0) * (3 * C) + part * 8,
                   ok);
      }
    }
  }
  if (tid < AT) {
    const bool ok = a.key_bias != nullptr && kbase + tid < a.L;
    cp_async4(b.kb + tid,
              ok ? a.key_bias + (size_t)it.n * a.L + kbase + tid : a.out_b,
              ok);
  }
}

// Passes of attn_tile: the first walk (row max, and for MODE 1 the sum),
// the second (p and P @ V), or both at once when the item's keys fit one
// tile (the max is then exact after the tile, and MODE 1 keeps its exps).
constexpr int PASS_A = 0, PASS_B = 1, PASS_AB = 2;

// The heads of a padded head width HDP as attn_tile takes them: KS
// 16-channel k-steps of a head's scores, NHW heads whose row max and sum a
// warp keeps through one round over the keys (all of them for HDP >= 16).
template <int HDP>
struct HeadShape {
  static constexpr int KS = HDP >= 16 ? HDP / 16 : 1;
  static constexpr int NHW = HDP >= 16 ? C / HDP : C >= 32 ? 4 : C / 8;
};

// How attn_tile sees its tiles. attn_tc_kernel (HEAD false): rows of LDS
// bf16 holding all C channels, NHW heads a call, the context o over all C
// channels (C / 8 n8 tiles). attn_head_kernel (HEAD true): rows of LD bf16
// holding one head's KW channels (a head of at most 8: the 16-channel
// k-step that holds it), one head a call, o over VW of those channels in V
// rows of LDV: all KW, but a head of 512 in parts of VW = 128 (its whole
// context, 256 floats a lane, would pass the register file), each call
// scoring over all 512 channels.
template <int HDP, bool HEAD>
struct TileShape {
  static constexpr int KW = HDP >= 16 ? HDP : 16;
  static constexpr int LD = HEAD ? KW + 8 : LDS;
  static constexpr int NHW = HEAD ? 1 : HeadShape<HDP>::NHW;
  static constexpr int VW = HEAD && KW > 256 ? 128 : KW;
  static constexpr int LDV = HEAD ? VW + 8 : LDS;
  static constexpr int NO = HEAD ? VW / 8 : C / 8;
};

// A score fragment (key chunk kc, n8 half j) in log2 units: scale2 times
// q.k plus the key bias, -inf for keys past L or outside the band unless
// the chunk is `full`.
template <bool FULL>
__device__ __forceinline__ void bias_mask(float (&sj)[4], const float* kb_t,
                                          unsigned full, int kc, int j,
                                          int kbase, int L, int lb,
                                          const int (&rg)[2], int t,
                                          float scale2) {
  // key bias of this lane's two score columns, in log2 units
  const float2 kb = *reinterpret_cast<const float2*>(
      kb_t + kc * 16 + j * 8 + 2 * t);
  const float kb0 = kb.x * LOG2E, kb1 = kb.y * LOG2E;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = fmaf(sj[e], scale2, (e & 1) ? kb1 : kb0);
    if (!FULL && !((full >> kc) & 1u)) {
      const int key = kbase + kc * 16 + j * 8 + 2 * t + (e & 1);
      const int row = rg[e >> 1];
      const bool ok = key < L && (lb < 0 || (key <= row && key >= row - lb));
      v = ok ? v : -INFINITY;
    }
    sj[e] = v;
  }
}

// One key tile for one warp's 16 query rows (Q at qw in shared memory),
// heads h0 .. h0 + NHW - 1 (h0 = 0 but for HDP = 8 or HEAD). m, l are the
// warp's running row max and sum of those heads, o its context (C-fragment
// layout, n8 tile nt = channels 8 nt .. of the tile's rows); only they
// live across tiles, Q fragments and key bias are re-read from shared
// memory. FULL: all four 16-key chunks are needed and need no mask
// (`need`, `full`: per-chunk bits). scale2: the score scale in log2 units
// (AttnArgs). HEAD streams the scores over the head's k-steps (up to 16),
// one Q and one K fragment at a time.
template <int MODE, int PASS, bool FULL, int HDP, bool HEAD = false,
          typename KV>
__device__ __forceinline__ void attn_tile(
    const KV& b, const __nv_bfloat16* qw, unsigned need, unsigned full,
    int kbase, int L, int lb, const int (&rg)[2],
    float (&m)[TileShape<HDP, HEAD>::NHW][2],
    float (&l)[TileShape<HDP, HEAD>::NHW][2],
    float (&o)[TileShape<HDP, HEAD>::NO][4], int lane, int h0, int hd,
    float scale2) {
  constexpr int KS = HeadShape<HDP>::KS, NHW = TileShape<HDP, HEAD>::NHW;
  constexpr int LD = TileShape<HDP, HEAD>::LD, NO = TileShape<HDP, HEAD>::NO;
  // V's row stride and the k-steps of the context a call takes (KS but for
  // a head of 512, whose call takes a part of VW channels).
  constexpr int LDV = TileShape<HDP, HEAD>::LDV;
  constexpr int VS = HEAD ? TileShape<HDP, HEAD>::VW / 16 : KS;
  const int t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < NHW; ++hh) {
    const int h = h0 + hh;
    // The head's first channel in the rows (HDP >= 16), or its 16-channel
    // k-step's.
    const int col0 = HEAD ? 0 : HDP >= 16 ? hh * HDP : ((h * hd) & ~15);
    float sc[4][2][4];
    if constexpr (HEAD) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[kc][j][e] = 0.f;
      if constexpr (KS > 16) {
        // A head of 512: its 32 k-steps unrolled by 2 (fully unrolled,
        // ptxas took ~16 s on each instance of the head kernel).
#pragma unroll 2
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t qa[4];
          load_a(qa, qw + ks * 16, LD, lane);
          if (HDP == 8) q_mask(qa, h, hd, lane);
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            if (!FULL && !((need >> kc) & 1u)) continue;
            uint32_t kf[4];
            load_b_nk(kf, b.k + kc * 16 * LD + ks * 16, LD, lane);
            mma(sc[kc][0], qa, kf[0], kf[1]);
            mma(sc[kc][1], qa, kf[2], kf[3]);
          }
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t qa[4];
          load_a(qa, qw + ks * 16, LD, lane);
          if (HDP == 8) q_mask(qa, h, hd, lane);
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            if (!FULL && !((need >> kc) & 1u)) continue;
            uint32_t kf[4];
            load_b_nk(kf, b.k + kc * 16 * LD + ks * 16, LD, lane);
            mma(sc[kc][0], qa, kf[0], kf[1]);
            mma(sc[kc][1], qa, kf[2], kf[3]);
          }
        }
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        if (!FULL && !((need >> kc) & 1u)) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          bias_mask<FULL>(sc[kc][j], b.kb, full, kc, j, kbase, L, lb, rg, t,
                          scale2);
      }
    } else {
      uint32_t qa[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        load_a(qa[ks], qw + col0 + ks * 16, LD, lane);
      if (HDP == 8) q_mask(qa[0], h, hd, lane);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        if (!FULL && !((need >> kc) & 1u)) continue;
        uint32_t kf[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          load_b_nk(kf[ks], b.k + kc * 16 * LD + col0 + ks * 16, LD, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float* sj = sc[kc][j];
          sj[0] = sj[1] = sj[2] = sj[3] = 0.f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            mma(sj, qa[ks], kf[ks][2 * j], kf[ks][2 * j + 1]);
          bias_mask<FULL>(sc[kc][j], b.kb, full, kc, j, kbase, L, lb, rg, t,
                          scale2);
        }
      }
    }
    if (PASS != PASS_B) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        if (!FULL && !((need >> kc) & 1u)) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[kc][j][e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mnew = fmaxf(m[hh][r], quad_max(mx[r]));
        const float mb = mnew == -INFINITY ? 0.f : mnew;
        if (MODE == 1) {
          // PASS_AB: the exps stay in sc for the P @ V below.
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            if (!FULL && !((need >> kc) & 1u)) continue;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float e0 = ex2(sc[kc][j][2 * r] - mb);
              const float e1 = ex2(sc[kc][j][2 * r + 1] - mb);
              if (PASS == PASS_AB) {
                sc[kc][j][2 * r] = e0;
                sc[kc][j][2 * r + 1] = e1;
              }
              part[kc] += e0 + e1;
            }
          }
          const float sum = (part[0] + part[1]) + (part[2] + part[3]);
          if (PASS == PASS_A) {
            l[hh][r] = fmaf(l[hh][r], ex2(m[hh][r] - mb), sum);
          } else {
            const float tot = quad_sum(sum);
            l[hh][r] = tot > 0.f ? 1.f / tot : 0.f;
          }
        }
        m[hh][r] = PASS == PASS_A ? mnew : mb;
      }
    }
    if (PASS != PASS_A) {
      // m is the row max (0 for a row with no key), and for MODE 1 l is
      // 1 / sum (set between the passes, or above).
      float part[4][2] = {};
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        if (!FULL && !((need >> kc) & 1u)) continue;
        float p[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pe;
            if (MODE == 1) {
              pe = (PASS == PASS_AB ? sc[kc][j][e]
                                    : ex2(sc[kc][j][e] - m[hh][e >> 1])) *
                   l[hh][e >> 1];
            } else {
              pe = ex2(sc[kc][j][e] - m[hh][e >> 1]);
              part[kc][e >> 1] += pe;
            }
            p[j][e] = pe;
          }
        const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                                pack_bf16(p[0][2], p[0][3]),
                                pack_bf16(p[1][0], p[1][1]),
                                pack_bf16(p[1][2], p[1][3])};
        uint32_t vf[4];
        if (HDP >= 16) {
#pragma unroll
          for (int ks = 0; ks < VS; ++ks) {
            load_b_kn(vf, b.v + kc * 16 * LDV + col0 + ks * 16, LDV, lane);
            const int nt = col0 / 8 + 2 * ks;
            mma(o[nt], pa, vf[0], vf[1]);
            mma(o[nt + 1], pa, vf[2], vf[3]);
          }
        } else {
          // The head's n8 tile of V, the other heads' columns zeroed (its
          // index in o: of the C channels, or of the k-step for HEAD).
          load_b_kn(vf, b.v + kc * 16 * LD + col0, LD, lane);
          const int nt = (h * hd) >> 3, no = HEAD ? nt & 1 : nt;
          const uint32_t vm = v_mask(h, hd, lane);
          const uint32_t v0 = ((nt & 1) ? vf[2] : vf[0]) & vm;
          const uint32_t v1 = ((nt & 1) ? vf[3] : vf[1]) & vm;
#pragma unroll
          for (int q = 0; q < NO; ++q)
            if (q == no) mma(o[q], pa, v0, v1);
        }
      }
      if (MODE == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          l[hh][r] += (part[0][r] + part[1][r]) + (part[2][r] + part[3][r]);
      }
    }
  }
}

template <int MODE, int HDP>
__global__ void __launch_bounds__(AttnShape<MODE>::THREADS,
                                  AttnShape<MODE>::MIN_BLOCKS)
    attn_tc_kernel(AttnArgs a) {
  constexpr int QR = AttnShape<MODE>::ROWS;
  constexpr int THREADS = AttnShape<MODE>::THREADS;
  constexpr int NHW = HeadShape<HDP>::NHW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KVTile* kv = reinterpret_cast<KVTile*>(smem_raw);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(kv + 2);
  __nv_bfloat16* wo = qs + QR * LDS;  // out_w [C][LDS]
  __nv_bfloat16* wl = wo + C * LDS;   // MODE 0: lin_w [lin_in][LDS]
  stage_weight(wo, LDS, a.out_w, C, C);
  if (MODE == 0) stage_weight(wl, LDS, a.lin_w, a.lin_in, C);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = a.L, lb = a.lookback;
  const long long items = a.N * ((L + QR - 1) / QR);
  // Rounds of NHW heads an item takes (one but for HDP = 8).
  const int hd = HDP >= 16 ? HDP : a.hd;
  const int rounds = HDP >= 16 ? 1 : C / hd / NHW;

  long long item = blockIdx.x;
  if (item < items) {
    const Item first = item_at<QR>(item, L, lb);
    load_q<QR, THREADS>(a, first, qs, tid);
    load_kv<THREADS>(a, first, kv, 0, tid);
    cp_async_commit();
  }
  for (; item < items; item += gridDim.x) {
    const Item it = item_at<QR>(item, L, lb);
    const int nload = it.resident ? it.nkt : rounds * 2 * it.nkt;
    const int r0 = it.q0 + warp * 16;  // this warp's first query row
    const bool active = r0 < L;
    const int rg[2] = {r0 + g, r0 + g + 8};
    // Keys this warp's rows need.
    const int need_lo = lb >= 0 ? r0 - lb : 0;
    const int need_hi = lb >= 0 ? min(r0 + 15, L - 1) : L - 1;

    float m[NHW][2], l[NHW][2], o[C / 8][4];
#pragma unroll
    for (int h = 0; h < NHW; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[h][r] = -INFINITY;
        l[h][r] = 0.f;
      }
    // MODE 0, HDP = 8: a round's heads' context divided by den + 1e-20
    // (for HDP >= 16 the epilogue divides).
    auto end_round = [&](int h0) {
#pragma unroll
      for (int hh = 0; hh < NHW; ++hh) {
        const int c0 = (h0 + hh) * hd;
        float den[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) den[r] = quad_sum(l[hh][r]) + 1e-20f;
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = nt * 8 + 2 * t + (e & 1);
            if (col >= c0 && col < c0 + hd) o[nt][e] /= den[e >> 1];
          }
      }
    };
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

    // One walk when the keys fit one tile, else two (see attn_tile); a
    // round of heads is one walk or two.
    const int nsteps = it.nkt == 1 ? 1 : 2 * it.nkt;
    for (int S = 0; S < rounds * nsteps; ++S) {
      const int s = rounds == 1 ? S : S % nsteps;  // the step in its round
      const int h0 = rounds == 1 ? 0 : S / nsteps * NHW;
      if (S + 1 < nload) {
        load_kv<THREADS>(a, it, kv, rounds == 1 ? S + 1 : (S + 1) % nsteps,
                         tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        if (HDP == 8 && s == 0 && S > 0) {  // a new round of heads
          if (MODE == 0) end_round(h0 - NHW);
#pragma unroll
          for (int h = 0; h < NHW; ++h)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              m[h][r] = -INFINITY;
              l[h][r] = 0.f;
            }
        }
        if (s == it.nkt) {  // between the passes
#pragma unroll
          for (int h = 0; h < NHW; ++h)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              if (m[h][r] == -INFINITY) m[h][r] = 0.f;
              if (MODE == 1) {
                const float tot = quad_sum(l[h][r]);
                l[h][r] = tot > 0.f ? 1.f / tot : 0.f;
              }
            }
        }
        const KVTile& b = kv[it.resident ? (s % it.nkt) : (s & 1)];
        const int kbase = (it.kt0 + s % it.nkt) * AT;
        unsigned need = 0u, full = 0u;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const int ks = kbase + kc * 16, ke = ks + 15;
          if (ke >= need_lo && ks <= need_hi) need |= 1u << kc;
          if (ke < L && (lb < 0 || (ke <= r0 && ks >= r0 + 15 - lb)))
            full |= 1u << kc;
        }
        const __nv_bfloat16* qw = qs + warp * 16 * LDS;
        const bool fast = need == 0xFu && full == 0xFu;
#define LCT_ATTN_TILE(PASS)                                                  \
  (fast ? attn_tile<MODE, PASS, true, HDP>(b, qw, need, full, kbase, L, lb,  \
                                           rg, m, l, o, lane, h0, hd,        \
                                           a.scale2)                         \
        : attn_tile<MODE, PASS, false, HDP>(b, qw, need, full, kbase, L, lb, \
                                            rg, m, l, o, lane, h0, hd,       \
                                            a.scale2))
        if (it.nkt == 1)
          LCT_ATTN_TILE(PASS_AB);
        else if (s >= it.nkt)
          LCT_ATTN_TILE(PASS_B);
        else
          LCT_ATTN_TILE(PASS_A);
#undef LCT_ATTN_TILE
      }
      __syncthreads();  // the buffer is free for the load two steps on
    }
    if (HDP == 8 && MODE == 0 && active) end_round((rounds - 1) * NHW);
    // Q and K/V are free: the next item's first loads run under this
    // item's epilogue.
    if (item + gridDim.x < items) {
      const Item nx = item_at<QR>(item + gridDim.x, L, lb);
      load_q<QR, THREADS>(a, nx, qs, tid);
      load_kv<THREADS>(a, nx, kv, 0, tid);
      cp_async_commit();
    }
    if (!active) continue;

    const size_t rowbase = (size_t)it.n * L;
    // MODE 0: s and bf16(g) at this lane's output elements (row rg[r],
    // column nt * 8 + 2t), all loads issued before the products; bf16(g)
    // is loaded as the A fragments of [g @ lin_w[:C]] (k-step kk holds
    // columns kk * 16 + j * 8 + 2t).
    float2 sv[C / 8][2];
    uint32_t gf[C / 16][4];
    if (MODE == 0) {
#pragma unroll
      for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const size_t off =
              (rowbase + min(rg[r], L - 1)) * C + nt * 8 + 2 * t;
          sv[nt][r] = __ldg(reinterpret_cast<const float2*>(a.s + off));
          if (a.g != nullptr)
            gf[nt >> 1][2 * (nt & 1) + r] =
                __ldg(reinterpret_cast<const unsigned*>(a.g + off));
        }
    }
    // ctx (MODE 0: divided by den + 1e-20, here for HDP >= 16) as the A
    // fragments of the output projection's C / 16 16-channel k-steps.
    uint32_t ca[C / 16][4];
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      const bool div = MODE == 0 && HDP >= 16;
      float den[2] = {1.f, 1.f};
      if (div) {
        const int hh = HDP >= 16 ? kk * 16 / HDP : 0;  // the k-step's head
#pragma unroll
        for (int r = 0; r < 2; ++r) den[r] = quad_sum(l[hh][r]) + 1e-20f;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* oj = o[2 * kk + j];
        if (div) {
          ca[kk][2 * j] = pack_bf16(oj[0] / den[0], oj[1] / den[0]);
          ca[kk][2 * j + 1] = pack_bf16(oj[2] / den[1], oj[3] / den[1]);
        } else {
          ca[kk][2 * j] = pack_bf16(oj[0], oj[1]);
          ca[kk][2 * j + 1] = pack_bf16(oj[2], oj[3]);
        }
      }
    }
    float acc[C / 8][4];
    out_projection(acc, ca, wo, lane);
    if (MODE == 1) {
#pragma unroll
      for (int nt = 0; nt < C / 8; ++nt) {
        const int col = nt * 8 + 2 * t;
        const float b0 = __ldg(a.out_b + col), b1 = __ldg(a.out_b + col + 1);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rg[r] < L)
            *reinterpret_cast<float2*>(a.out + (rowbase + rg[r]) * C + col) =
                make_float2(acc[nt][2 * r] + b0, acc[nt][2 * r + 1] + b1);
      }
      continue;
    }
    // a = ctx @ out_w + out_b, rounded: the A fragments of the Linear.
    uint32_t aa[C / 16][4];
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = 2 * kk + j, col = nt * 8 + 2 * t;
        const float b0 = __ldg(a.out_b + col), b1 = __ldg(a.out_b + col + 1);
        aa[kk][2 * j] = pack_bf16(acc[nt][0] + b0, acc[nt][1] + b1);
        aa[kk][2 * j + 1] = pack_bf16(acc[nt][2] + b0, acc[nt][3] + b1);
      }
    float cb[C / 8][4] = {};
    const __nv_bfloat16* wla = wl;
    if (a.lin_in == 2 * C) {
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
        for (int np = 0; np < C / 16; ++np) {
          uint32_t wf[4];
          load_b_kn(wf, wl + kk * 16 * LDS + np * 16, LDS, lane);
          mma(cb[2 * np], gf[kk], wf[0], wf[1]);
          mma(cb[2 * np + 1], gf[kk], wf[2], wf[3]);
        }
      wla = wl + C * LDS;
    }
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        uint32_t wf[4];
        load_b_kn(wf, wla + kk * 16 * LDS + np * 16, LDS, lane);
        mma(cb[2 * np], aa[kk], wf[0], wf[1]);
        mma(cb[2 * np + 1], aa[kk], wf[2], wf[3]);
      }
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float b0 = __ldg(a.lin_b + col), b1 = __ldg(a.lin_b + col + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rg[r] >= L) continue;
        float c0 = cb[nt][2 * r] + b0, c1 = cb[nt][2 * r + 1] + b1;
        c0 = c0 >= 0.f ? c0 : 0.2f * c0;
        c1 = c1 >= 0.f ? c1 : 0.2f * c1;
        *reinterpret_cast<float2*>(a.out + (rowbase + rg[r]) * C + col) =
            make_float2(sv[nt][r].x + c0, sv[nt][r].y + c1);
      }
    }
  }
}

template <int MODE, int HDP>
cudaError_t launch_attn_tc_hd(const AttnArgs& a, cudaStream_t st) {
  constexpr size_t smem = attn_smem<MODE>();
  cudaError_t e = allow_smem(attn_tc_kernel<MODE, HDP>, smem);
  if (e != cudaSuccess) return e;
  unsigned grid = 1;
  constexpr int QR = AttnShape<MODE>::ROWS;
  constexpr int THREADS = AttnShape<MODE>::THREADS;
  e = persistent_grid(attn_tc_kernel<MODE, HDP>, THREADS, smem,
                      a.N * ((a.L + QR - 1) / QR), &grid);
  if (e != cudaSuccess) return e;
  attn_tc_kernel<MODE, HDP><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}


#if LCT_C > 128
// ---------------------------------------------------------------------------
// C = 256's and 512's attention, in two kernels (the split epilogue).
// attn_tc_kernel keeps a warp's whole C-channel context in registers and
// stages out_w and lin_w in shared memory; at C = 256 that is 128 context
// floats a lane and 405 KB of weights. So here:
//   attn_head_kernel<MODE, HDP>  the softmax attention of one head a work
//     item (sequence, 64 query rows, head), its scores streamed over the
//     head's 16-channel k-steps, writing the context rounded to bf16 (the
//     contract rounds it as the output projection's operand; MODE 0 after
//     the division by den + 1e-20) into ctx [N*L, C];
//   epi_kernel<MODE>  out = ctx @ out_w + out_b (MODE 1), or a = bf16(ctx @
//     out_w + out_b), comb = [bf16(g) @ lin_w[:C]] + a @ lin_w[lin_in - C:] +
//     lin_b, out = s + LeakyReLU(comb) (MODE 0), over tiles of 128 rows (64
//     at C = 512) with the weights streamed through shared memory in panels
//     of 64 output columns.
// The scores, the passes over the keys, the band, the key bias and the
// rounding points are attn_tc_kernel's (attn_tile). Heads of hd <= 8 take
// the 16-channel k-step that holds them with the other heads' q columns
// zeroed (q_mask) and write only their own context columns. Every padded
// head (the wrapper's zero heads) is computed too: its context is 0, which
// the epilogue reads. Bound: for narrow heads the exps, as attn_tc_kernel;
// ctx crosses device memory once each way (2 B a channel), which the fused
// design avoided. A head of 512 (C = 512) takes its context in NP = 4 parts
// of 128 channels, a work item each, every part scoring over all 512
// channels (4x the score products: slow and right), in items of 48 query
// rows, so that Q, two K tiles and two V parts fit (213 KB).
constexpr int HQR = 64;        // query rows an item
constexpr int HTHREADS = 128;  // 4 warps of 16 rows

// attn_tile's HEAD tiles: rows of LD bf16, 2^PL2 16-byte pieces a row (KW
// channels), two K/V tiles (V rows of LDV, 2^PL2V pieces: a part of VW
// channels, NP parts a head) and the item's QR Q rows, THREADS threads.
template <int HDP>
struct HeadTile {
  using TS = TileShape<HDP, true>;
  static constexpr int KW = TS::KW, LD = TS::LD;
  static constexpr int PL2 = KW == 16    ? 1
                             : KW == 32  ? 2
                             : KW == 64  ? 3
                             : KW == 128 ? 4
                             : KW == 256 ? 5
                                         : 6;
  static_assert(KW == 8 << PL2, "KW");
  static constexpr int VW = TS::VW, LDV = TS::LDV, NP = KW / VW;
  static constexpr int PL2V = PL2 - (NP == 1 ? 0 : 2);
  static_assert(VW == 8 << PL2V && (NP == 1 || NP == 4), "VW");
  static constexpr int QR = KW > 256 ? 48 : HQR;
  static constexpr int THREADS = KW > 256 ? 96 : HTHREADS;
  using KV = KVTileOf<LD, LDV>;
  static constexpr size_t SMEM =
      2 * sizeof(KV) + sizeof(__nv_bfloat16) * QR * LD;
};

template <int MODE, int HDP>
__global__ void __launch_bounds__(HeadTile<HDP>::THREADS)
    attn_head_kernel(AttnArgs a, __nv_bfloat16* __restrict__ ctx) {
  using HT = HeadTile<HDP>;
  using KV = typename HT::KV;
  constexpr int KW = HT::KW, LD = HT::LD, PL2 = HT::PL2;
  constexpr int QR = HT::QR, THREADS = HT::THREADS, NP = HT::NP;
  constexpr int PL2V = HT::PL2V, LDV = HT::LDV, NO = HT::VW / 8;
  extern __shared__ __align__(16) unsigned char head_smem[];
  KV* kv = reinterpret_cast<KV*>(head_smem);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(kv + 2);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = a.L, lb = a.lookback;
  const int hd = HDP >= 16 ? HDP : a.hd, nh = C / hd;
  const long long items = a.N * ((L + QR - 1) / QR) * nh * NP;
  // The head's first channel (HDP >= 16), or its 16-channel k-step's.
  auto col0_of = [&](int h) { return HDP >= 16 ? h * HDP : (h * hd) & ~15; };
  // An item: (query item, head, part): part the fastest (NP == 1: none).
  auto head_of = [&](long long i) { return (int)((i / NP) % nh); };
  auto part_of = [&](long long i) { return NP == 1 ? 0 : (int)(i % NP); };

  long long item = blockIdx.x;
  if (item < items) {
    const Item first = item_at<QR>(item / NP / nh, L, lb);
    const int c0 = col0_of(head_of(item));
    load_q<QR, THREADS, PL2, LD>(a, first, qs, tid, c0);
    load_kv<THREADS, PL2, LD, PL2V, LDV>(
        a, first, kv, 0, tid, c0, c0 + part_of(item) * HT::VW);
    cp_async_commit();
  }
  for (; item < items; item += gridDim.x) {
    const Item it = item_at<QR>(item / NP / nh, L, lb);
    const int h = head_of(item), col0 = col0_of(h);
    const int vcol0 = col0 + part_of(item) * HT::VW;
    const int nload = it.resident ? it.nkt : 2 * it.nkt;
    const int r0 = it.q0 + warp * 16;
    const bool active = r0 < L;
    const int rg[2] = {r0 + g, r0 + g + 8};
    const int need_lo = lb >= 0 ? r0 - lb : 0;
    const int need_hi = lb >= 0 ? min(r0 + 15, L - 1) : L - 1;
    float m[1][2] = {{-INFINITY, -INFINITY}}, l[1][2] = {{0.f, 0.f}};
    float o[NO][4];
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    const int nsteps = it.nkt == 1 ? 1 : 2 * it.nkt;
    for (int s = 0; s < nsteps; ++s) {
      if (s + 1 < nload) {
        load_kv<THREADS, PL2, LD, PL2V, LDV>(a, it, kv, s + 1, tid, col0,
                                             vcol0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        if (s == it.nkt) {  // between the passes
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (m[0][r] == -INFINITY) m[0][r] = 0.f;
            if (MODE == 1) {
              const float tot = quad_sum(l[0][r]);
              l[0][r] = tot > 0.f ? 1.f / tot : 0.f;
            }
          }
        }
        const KV& b = kv[it.resident ? (s % it.nkt) : (s & 1)];
        const int kbase = (it.kt0 + s % it.nkt) * AT;
        unsigned need = 0u, full = 0u;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const int ks = kbase + kc * 16, ke = ks + 15;
          if (ke >= need_lo && ks <= need_hi) need |= 1u << kc;
          if (ke < L && (lb < 0 || (ke <= r0 && ks >= r0 + 15 - lb)))
            full |= 1u << kc;
        }
        const __nv_bfloat16* qw = qs + warp * 16 * LD;
        const bool fast = need == 0xFu && full == 0xFu;
#define LCT_HEAD_TILE(PASS)                                                 \
  (fast ? attn_tile<MODE, PASS, true, HDP, true>(b, qw, need, full, kbase,  \
                                                 L, lb, rg, m, l, o, lane,  \
                                                 h, hd, a.scale2)           \
        : attn_tile<MODE, PASS, false, HDP, true>(b, qw, need, full, kbase, \
                                                  L, lb, rg, m, l, o, lane, \
                                                  h, hd, a.scale2))
        if (it.nkt == 1)
          LCT_HEAD_TILE(PASS_AB);
        else if (s >= it.nkt)
          LCT_HEAD_TILE(PASS_B);
        else
          LCT_HEAD_TILE(PASS_A);
#undef LCT_HEAD_TILE
      }
      __syncthreads();  // the buffer is free for the load two steps on
    }
    // Q and K/V are free: the next item's first loads run under this
    // item's stores.
    if (item + gridDim.x < items) {
      const long long nx = item + gridDim.x;
      const Item ni = item_at<QR>(nx / NP / nh, L, lb);
      const int c0 = col0_of(head_of(nx));
      load_q<QR, THREADS, PL2, LD>(a, ni, qs, tid, c0);
      load_kv<THREADS, PL2, LD, PL2V, LDV>(a, ni, kv, 0, tid, c0,
                                           c0 + part_of(nx) * HT::VW);
      cp_async_commit();
    }
    if (!active) continue;
    float den[2] = {1.f, 1.f};
    if (MODE == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) den[r] = quad_sum(l[0][r]) + 1e-20f;
    }
    const int lo = HDP >= 16 ? 0 : (h * hd) & 15;  // the head in the window
    const int hi = HDP >= 16 ? KW : lo + hd;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rg[r] >= L) continue;
        __nv_bfloat16* dst =
            ctx + ((size_t)it.n * L + rg[r]) * C + vcol0 + col;
        const float v0 = o[nt][2 * r] / den[r], v1 = o[nt][2 * r + 1] / den[r];
        if (HDP >= 16) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
        } else {
          if (col >= lo && col < hi) dst[0] = __float2bfloat16_rn(v0);
          if (col + 1 >= lo && col + 1 < hi) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int MODE, int HDP>
cudaError_t launch_attn_head(const AttnArgs& a, __nv_bfloat16* ctx,
                             cudaStream_t st) {
  using HT = HeadTile<HDP>;
  constexpr size_t smem = HT::SMEM;
  cudaError_t e = allow_smem(attn_head_kernel<MODE, HDP>, smem);
  if (e != cudaSuccess) return e;
  const int hd = HDP >= 16 ? HDP : a.hd;
  unsigned grid = 1;
  e = persistent_grid(attn_head_kernel<MODE, HDP>, HT::THREADS, smem,
                      a.N * ((a.L + HT::QR - 1) / HT::QR) * (C / hd) * HT::NP,
                      &grid);
  if (e != cudaSuccess) return e;
  attn_head_kernel<MODE, HDP><<<grid, HT::THREADS, smem, st>>>(a, ctx);
  return cudaGetLastError();
}

// Rows a tile (8 warps of 16; at C = 512 4, whose tile of a [64][LDS] and
// lin_w panel [2C][EPI_LDW] take 209 KB) and the block's threads.
constexpr int EPI_ROWS = C > 256 ? 64 : 128;
constexpr int EPI_THREADS = 2 * EPI_ROWS;
constexpr int EPI_LDW = 64 + 8;   // bf16 row stride of a weight panel

// Shared memory of epi_kernel<MODE>: for MODE 0 the tile's a [EPI_ROWS]
// [LDS] (the Linear's operand), then one weight panel [K][EPI_LDW], K the
// rows of out_w (C) or lin_w (up to 2C).
template <int MODE>
constexpr size_t epi_smem() {
  return sizeof(__nv_bfloat16) * ((MODE == 0 ? EPI_ROWS * LDS : 0) +
                                  (MODE == 0 ? 2 * C : C) * EPI_LDW);
}

// Columns [c0, c0 + 64) of w [K][C] f32 as bf16 [K][EPI_LDW], by the block.
__device__ __forceinline__ void stage_panel(__nv_bfloat16* wp,
                                            const float* __restrict__ w,
                                            int K, int c0) {
  for (int i = threadIdx.x; i < K * 16; i += blockDim.x) {
    const int r = i >> 4, q = i & 15;
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(w + (size_t)r * C + c0) + q);
    uint2 pk;
    pk.x = pack_bf16(v.x, v.y);
    pk.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(wp + r * EPI_LDW + 4 * q) = pk;
  }
}

// The A fragment of rows r0 .. r0 + 15, channels k0 .. k0 + 15 of a bf16
// [rows][C] matrix in device memory (rows past the end read the last).
__device__ __forceinline__ void load_a_rows(uint32_t a[4],
                                            const __nv_bfloat16* m,
                                            long long r0, long long rows,
                                            int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const long long ra = r0 + g < rows ? r0 + g : rows - 1;
  const long long rb = r0 + g + 8 < rows ? r0 + g + 8 : rows - 1;
  const unsigned* pa =
      reinterpret_cast<const unsigned*>(m + (size_t)ra * C + k0 + 2 * t);
  const unsigned* pb =
      reinterpret_cast<const unsigned*>(m + (size_t)rb * C + k0 + 2 * t);
  a[0] = __ldg(pa);
  a[1] = __ldg(pb);
  a[2] = __ldg(pa + 4);
  a[3] = __ldg(pb + 4);
}

template <int MODE>
__global__ void __launch_bounds__(EPI_THREADS, 1)
    epi_kernel(AttnArgs a, const __nv_bfloat16* __restrict__ ctx) {
  extern __shared__ __align__(16) unsigned char epi_smem_raw[];
  __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(epi_smem_raw);
  __nv_bfloat16* wp = at + (MODE == 0 ? EPI_ROWS * LDS : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long rows = a.N * a.L;
  const long long tiles = (rows + EPI_ROWS - 1) / EPI_ROWS;
  __nv_bfloat16* aw = at + warp * 16 * LDS;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * EPI_ROWS + warp * 16;
    for (int p = 0; p < C / 64; ++p) {
      __syncthreads();  // the previous panel's readers are done
      stage_panel(wp, a.out_w, C, 64 * p);
      __syncthreads();
      float acc[8][4] = {};
#pragma unroll 4
      for (int kk = 0; kk < C / 16; ++kk) {
        uint32_t af[4];
        load_a_rows(af, ctx, r0, rows, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t wf[4];
          load_b_kn(wf, wp + kk * 16 * EPI_LDW + np * 16, EPI_LDW, lane);
          mma(acc[2 * np], af, wf[0], wf[1]);
          mma(acc[2 * np + 1], af, wf[2], wf[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = 64 * p + nt * 8 + 2 * t;
        const float b0 = __ldg(a.out_b + col), b1 = __ldg(a.out_b + col + 1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float v0 = acc[nt][2 * r] + b0, v1 = acc[nt][2 * r + 1] + b1;
          if (MODE == 1) {
            const long long row = r0 + g + 8 * r;
            if (row < rows)
              *reinterpret_cast<float2*>(a.out + (size_t)row * C + col) =
                  make_float2(v0, v1);
          } else {
            *reinterpret_cast<uint32_t*>(aw + (g + 8 * r) * LDS + col) =
                pack_bf16(v0, v1);
          }
        }
      }
    }
    if (MODE == 1) continue;
    for (int p = 0; p < C / 64; ++p) {
      __syncthreads();  // a is whole; the previous panel's readers are done
      stage_panel(wp, a.lin_w, a.lin_in, 64 * p);
      __syncthreads();
      float acc[8][4] = {};
      const __nv_bfloat16* wa = wp;
      if (a.lin_in == 2 * C) {
#pragma unroll 4
        for (int kk = 0; kk < C / 16; ++kk) {
          uint32_t af[4];
          load_a_rows(af, a.g, r0, rows, kk * 16, lane);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t wf[4];
            load_b_kn(wf, wp + kk * 16 * EPI_LDW + np * 16, EPI_LDW, lane);
            mma(acc[2 * np], af, wf[0], wf[1]);
            mma(acc[2 * np + 1], af, wf[2], wf[3]);
          }
        }
        wa = wp + C * EPI_LDW;
      }
#pragma unroll 4
      for (int kk = 0; kk < C / 16; ++kk) {
        uint32_t af[4];
        load_a(af, aw + kk * 16, LDS, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t wf[4];
          load_b_kn(wf, wa + kk * 16 * EPI_LDW + np * 16, EPI_LDW, lane);
          mma(acc[2 * np], af, wf[0], wf[1]);
          mma(acc[2 * np + 1], af, wf[2], wf[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = 64 * p + nt * 8 + 2 * t;
        const float b0 = __ldg(a.lin_b + col), b1 = __ldg(a.lin_b + col + 1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = r0 + g + 8 * r;
          if (row >= rows) continue;
          float c0 = acc[nt][2 * r] + b0, c1 = acc[nt][2 * r + 1] + b1;
          c0 = c0 >= 0.f ? c0 : 0.2f * c0;
          c1 = c1 >= 0.f ? c1 : 0.2f * c1;
          const float2 sv =
              __ldg(reinterpret_cast<const float2*>(a.s + (size_t)row * C + col));
          *reinterpret_cast<float2*>(a.out + (size_t)row * C + col) =
              make_float2(sv.x + c0, sv.y + c1);
        }
      }
    }
  }
}

template <int MODE>
cudaError_t launch_epi(const AttnArgs& a, const __nv_bfloat16* ctx,
                       cudaStream_t st) {
  constexpr size_t smem = epi_smem<MODE>();
  cudaError_t e = allow_smem(epi_kernel<MODE>, smem);
  if (e != cudaSuccess) return e;
  unsigned grid = 1;
  e = persistent_grid(epi_kernel<MODE>, EPI_THREADS, smem,
                      (a.N * a.L + EPI_ROWS - 1) / EPI_ROWS, &grid);
  if (e != cudaSuccess) return e;
  epi_kernel<MODE><<<grid, EPI_THREADS, smem, st>>>(a, ctx);
  return cudaGetLastError();
}
#endif

// attn_tc_kernel<MODE, head_pad(a.hd)>: instances for the padded widths
// up to C. At C >= 256 attn_head_kernel<MODE, head_pad(a.hd)> into ctx bf16
// [N*L, C] (scratch), then epi_kernel<MODE>; ctx is unused below.
template <int MODE>
cudaError_t launch_attn_tc(const AttnArgs& a, cudaStream_t st,
                           __nv_bfloat16* ctx = nullptr) {
#if LCT_C > 128
  if (ctx == nullptr) return cudaErrorInvalidValue;
  if (a.N * a.L == 0) return cudaSuccess;
  cudaError_t e = cudaErrorInvalidValue;
  switch (head_pad(a.hd)) {
    case 8: e = launch_attn_head<MODE, 8>(a, ctx, st); break;
    case 16: e = launch_attn_head<MODE, 16>(a, ctx, st); break;
    case 32: e = launch_attn_head<MODE, 32>(a, ctx, st); break;
    case 64: e = launch_attn_head<MODE, 64>(a, ctx, st); break;
    case 128: e = launch_attn_head<MODE, 128>(a, ctx, st); break;
    case 256: e = launch_attn_head<MODE, 256>(a, ctx, st); break;
#if LCT_C > 256
    case 512: e = launch_attn_head<MODE, 512>(a, ctx, st); break;
#endif
  }
  if (e != cudaSuccess) return e;
  return launch_epi<MODE>(a, ctx, st);
#else
  (void)ctx;
  switch (head_pad(a.hd)) {
    case 8: return launch_attn_tc_hd<MODE, 8>(a, st);
    case 16: return launch_attn_tc_hd<MODE, 16>(a, st);
    case 32:
      if constexpr (C >= 32) return launch_attn_tc_hd<MODE, 32>(a, st);
      break;
    case 64:
      if constexpr (C >= 64) return launch_attn_tc_hd<MODE, 64>(a, st);
      break;
    case 128:
      if constexpr (C >= 128) return launch_attn_tc_hd<MODE, 128>(a, st);
      break;
  }
  return cudaErrorInvalidValue;
#endif
}

}  // namespace tc
}  // namespace lct
