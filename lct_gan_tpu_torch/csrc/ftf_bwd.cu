// FTF block backward for Hopper (sm_90a): the whole function of the TPU
// kernel `lct_gan_tpu/ops/ftf_bwd.py::_ftf_bwd_kernel`. Inputs: x, dout
// [N*L, C], the forward's per-direction hiddens hid [D, N*L, C] (unrounded
// f32) and the block's parameters, the GRU's in slots. Outputs: dx and the
// 14 parameter gradients, f32, the GRU's in the slot layout [D, C/W, W, 3W]
// / [D, C/W, 3W]. Two designs, one per mode. C is the library's kernel
// width (common.cuh: -DLCT_C=<C>, 64 when unset); a true width c_true < C
// runs on operands the wrapper pads, ops/padding.py.
//
// Bound on the H100: at the training shapes (B=64 x 2 s; freq N=8,256 L=33,
// time N=2,112 L=129: 272,448 rows each) and C = 64 the function reads x,
// dout and hid and writes dx (1.0-1.3 KB per row), 279-349 MB or 83-104 us
// at 3.35 TB/s, and does 47-71 GFLOP of useful products (47-71 us at the
// 989 TFLOP/s bf16 rate): in bf16 it is bound by bytes. Both scale with C.
//
// bf16 (lct_ftf_backward_bf16), every product on tensor cores (tc.cuh's
// mma.sync m16n8k16 fragments), nine launches (ten at one head of 128):
//   1. qkv_tc_kernel       LN2 and qkv recomputed; s = x + g, bf16(g)
//   2. attn_fwd_tc_kernel  the context (bf16) and the softmax's (m, 1/l)
//   3. comb_bwd_tc_kernel  out-proj, Linear, LeakyReLU backward -> dcomb, da,
//                          dctx (bf16), dg_lin
//   4. attn_bwd_tc_kernel  softmax VJP -> dqkv (bf16)
//   5. dn2_tc_kernel       dn2 = dqkv in_w^T, LN2 backward -> ds; bf16 n2, n1
//   6. bptt_tc_kernel      GRU projections, gate factors, BPTT -> bf16 dxp,
//                          dhp, h_prev
//   7. dn1_tc_kernel       dn1 = dxp W_ih^T, LN1 backward -> dx
//   8. wgrad_tc_kernel     the 5 weight gradients as A^T B over row chunks
//   9. reduce_tc_kernel    every partial sum, in block order
// What holds a simple design back, and what this one does about it:
//   * Intermediates in device memory. Only values the contract rounds to
//     bf16 cross a kernel boundary as bf16 (qkv, ctx, a, dcomb, da, dctx,
//     dqkv, n1, n2, h_prev, dxp, dhp); f32 crosses only where the contract
//     keeps f32 (s, ds, dg_lin, the softmax statistics). ~3.8 KB per row at
//     D = 2 and C = 64, against ~13 KB.
//   * Products on CUDA cores. Every product, the weight gradients included,
//     is mma.sync on bf16 operands with f32 accumulation: the contract's
//     arithmetic up to the order of the f32 sums. Weights are staged in
//     shared memory once per persistent block; row-tile kernels give each of
//     4 warps 16 whole rows, so the row-wise LayerNorm backward needs no
//     block barrier.
//   * Bias and LayerNorm-scale gradients are column sums of unrounded f32
//     values: each producing kernel keeps them in f32 registers and writes
//     one partial row per block.
//   * The attention: one (sequence, head) per block, its rows resident in
//     shared memory; key chunks outside the band skipped. p is recomputed
//     from the stored (m, 1/l), the rowsum sum(dp p) taken exactly in a
//     first walk, then dq by query tiles and dk, dv by key tiles (keys as
//     the M rows), so no sum crosses a work item. A head of 128 channels
//     would not fit resident: it streams 64-row blocks (attn_*_wide_kernel).
//   * The recurrence stays a sequential walk, latency-bound: the gate
//     factors are computed in the walk itself on tensor cores (as in
//     ftf.cu's gru_tc_kernel), dhp passes to the carry product in registers,
//     and each step's loads are issued one step ahead. A dense slot of 128
//     units (one group of 128, or of 65-127 padded) runs on CUDA cores with the
//     same rounding points (bptt_simt_kernel), as ftf.cu's forward does.
//
// Kernel width 256 (-DLCT_C=256; every path below under LCT_C > 128, so
// no instance at C <= 128 changes). in_w, out_w + lin_w and a direction's
// W_ih are 393-405 KB as bf16, past the 227 KB of shared memory a block
// may hold, and a warp's C-column rows would take 128-256 registers, so
// stages 3, 5 and 7 are kernels of their own that stream the weights in
// panels of 64 output channels through tiles of 64 or 128 rows
// (comb_panel_kernel; dn_panel_kernel<W, DN2> for the qkv projection and
// LN2 backward and, per slot width W, the input projection and LN1
// backward); the attention's heads of 128 and 256 stream their rows
// (attn_*_wide_kernel<HW>, a head of 256 as two 128-channel halves); the
// GRU's slots of 16 take a direction a block (bptt_tc_kernel<1>), of 64 a
// slot a block (bptt_tc_kernel<4>), of 128 a slot a block on CUDA cores
// (bptt_simt_kernel), and one slot of 256 is two kernels: gate_tc_kernel
// forms every step's gate factors on tensor cores at once, then
// bptt_cluster_kernel walks the carry with a cluster of 8 blocks, W_hh in
// registers, dhp through distributed shared memory (ftf.cu's
// gru_cluster_kernel's design); wgrad_tc_kernel stages 32-row tiles and
// takes its up to 98 product pieces in launches of 32. In precise mode the
// same slot of 256 takes bptt_cluster_kernel<false> over gate_kernel's
// factors, a slot of 128 bptt_dense_kernel a slot a block, heads of 128
// and 256 attn_bwd_warp_kernel (a warp a row), and the static-shared row
// kernels fewer rows a block.
//
// Kernel width 512 (-DLCT_C=512; every path new there under LCT_C > 256,
// or a constant that equals the old one below 512, so no instance at C <=
// 256 changes). A row of C channels is 1 KB as bf16 and W_hh of one
// direction's slot of 512 is 3 MB as f32, so: comb_panel_kernel takes
// tiles of 32 rows (2 warps: its tile pair and a lin_w panel fill 215 KB);
// dn_panel_kernel tiles of 32 rows, and a slot of 512 streams its 1,536
// k-columns in two halves; the heads of 512 stream key and query blocks of
// 32 rows (Wide<HW>::SB) beside their 64-row items, a head in four
// 128-channel output parts; wgrad_tc_kernel stages 16-row tiles and
// splits a product of more than 48 units a 16-row tile by columns too
// (WgProd::ldo), the grouped one by 16 slots (WG_ALLP counts every piece
// of every slot width: 416 at most); the GRU's slots of 16 take half a
// direction's slots a block (BPTT_PARTS, grid z), of 64 and 128 a slot a
// block as at 256, of 256 gate_tc_kernel (32-unit panels of one slot) and
// bptt_cluster_kernel with the slot in grid z (BC_SW), and one slot of 512
// the step-synchronous walk: gate_tc_kernel (or precise gate_kernel<512>)
// forms every step's factors, then bptt_step_kernel takes one launch a
// step, a block 64 sequences x 32 units of the carry product dhp_t @
// W_hh^T over all 3C columns (f32 FMAs, W_hh from L2), the carry in two
// [D, N, C] f32 buffers. Precise mode: comb_bwd_kernel and dn2_kernel 8
// rows a block, wgrad_kernel 2, attn_bwd_warp_kernel<512>, the precise
// GRU's slots of 64 four a block (dense_units), the cluster and step
// kernels over gate_kernel<256 / 512>.
//
// precise (lct_ftf_backward_f32), all f32 on CUDA cores (common.cuh), the
// simple design of one kernel per stage:
//   1. ln_kernel + proj_kernel<false>  recompute s = x + sum_d hid, LN2, qkv
//   2. attn_kernel<1>                  recompute the context (normalised p)
//   3. comb_bwd_kernel                 out-proj, Linear, LeakyReLU backward
//                                      -> dcomb, da, dg_lin, dctx
//   4. attn_bwd_kernel                 softmax VJP ds = p (dp - rowsum(dp p))
//                                      -> dq, dk, dv
//   5. dn2_kernel + ln_bwd_kernel      qkv-projection and LN2 backward
//   6. ln_kernel + proj_kernel<true>   recompute LN1 (bit-equal to the
//                                      forward's operand) and xp
//   7. gate_kernel                     hp from the shifted hiddens, the gate
//                                      factors K1..K5 for every step at once
//   8. bptt_kernel (bptt_dense_kernel  dh_{t-1} = dh_t z_t + (dh_t K123_t) W_hh^T
//      for dense slots)
//   9. dn1_kernel + ln_bwd_kernel      input-projection and LN1 backward -> dx
//  10. wgrad_kernel + reduce_kernel    every parameter gradient: per-chunk
//                                      partial sums over rows, then the chunks
//                                      summed in a fixed order
// It round-trips ~20 f32 intermediates per row through device memory and
// walks the recurrence with one thread per hidden unit.
//
// Rounding (common.cuh): every GEMM operand is rounded to bf16 exactly where
// the TPU kernel rounds it (its `cd` casts), products accumulate in f32;
// `precise` keeps everything f32. The f32 design's hp and xp recomputes
// sum in the order of the f32 forward (gru_kernel, proj_kernel), so in
// precise mode the backward sees the forward's own gate values. The bf16
// forward (ftf.cu's gru_tc_kernel) and backward (bptt_tc_kernel) sum on
// tensor cores and take sigmoid and tanh from the special-function unit's
// exp and reciprocal: the recomputed gates agree with the forward's to f32
// noise, not bit for bit, and so does the qkv the backward recomputes.
// Both sides of a gradient see the same saved hiddens, so this moves no
// gradient beyond that noise.
//
// Determinism: no atomics. Every sum over rows is taken by blocks over
// fixed rows (chunks, persistent tiles, or 16 sequences) and the blocks'
// partial rows are added in index order. The result is the same from run
// to run for the same shapes on the same card.
//
// Widths: any true width c_true <= C in any num_heads and any GRU group
// count the wrapper padded to C, as the forward kernels (ftf.cu). The
// attention kernels are built per padded head width HDP (common.cuh's
// head_pad: 8 for any hd <= 8, else 16 .. C) and take the true width at run
// time; their score scale (1 / sqrt of the true head width) comes from the
// caller. The GRU kernels are built per slot width W (ops/gru.py::
// gru_slot): 16 (C / 16 slots: groups of 16, or narrower ones packed
// block-diagonally), C (one dense slot, C <= 64), at C = 128 64 (two
// dense slots) and 128 (one), at C = 256 64 (four), 128 (two) and 256
// (one). The caller packs the GRU weights into slots
// (ops/gru.py::pack_gru_slots) and takes the slot-layout gradients apart
// again (ops/gru.py::unpack_gru_slot_grads): the entries off a slot's
// blocks are zero in the forward, so the gradients on the blocks are the
// grouped ones. Heads narrower than a k16 step take their 16-channel k-step
// and n8 tile masked to their channels (tc.cuh's q_mask and v_mask), as the
// TPU kernel's zero blocks do. Every LayerNorm, forward and backward,
// divides by the true channel count c_true (inv_c = 1 / c_true): the padded
// channels hold zeros in x, dout, hid and every weight, so they add nothing
// to a true channel's value or gradient (ops/padding.py), and the wrapper
// drops their dx and gradients.

#include <type_traits>

#include "tc.cuh"

#if LCT_C > 128  // bptt_cluster_kernel
#include <cooperative_groups.h>
#endif

namespace lct {

// Launches of the dense-slot GRU walks by this library, counted on the host
// where each launch succeeds (read by lct_ftf_backward_walk_launches): 0
// bptt_cluster_kernel (slots of 256), 1 bptt_step_kernel (a slot of 512,
// one a step).
static long long walk_launches[2] = {0, 0};

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

// LayerNorm rows of in = x (+ add0 (+ add1)), one warp per row: y, xhat and
// rstd (the arithmetic of proj_kernel's LayerNorm, so y is bit-equal to the
// operand the forward rounded), over 1 / inv_c true channels.
__global__ void ln_kernel(const float* __restrict__ x,
                          const float* __restrict__ add0,
                          const float* __restrict__ add1,
                          const float* __restrict__ s,
                          const float* __restrict__ b, float* __restrict__ y,
                          float* __restrict__ xhat, float* __restrict__ rstd,
                          long long rows, float inv_c) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const size_t o = (size_t)row * C;
#if LCT_C == 64
  float a = x[o + lane], c = x[o + lane + 32];
  if (add0) {
    a += add1 ? (add0[o + lane] + add1[o + lane]) : add0[o + lane];
    c += add1 ? (add0[o + lane + 32] + add1[o + lane + 32])
              : add0[o + lane + 32];
  }
  const float mu = warp_sum(a + c) * inv_c;
  const float ms = warp_sum(a * a + c * c) * inv_c;
  const float rs = rsqrtf(fmaxf(ms - mu * mu, 0.f) + 1e-6f);
  const float ha = (a - mu) * rs, hc = (c - mu) * rs;
  y[o + lane] = ha * s[lane] + b[lane];
  y[o + lane + 32] = hc * s[lane + 32] + b[lane + 32];
  xhat[o + lane] = ha;
  xhat[o + lane + 32] = hc;
#else
  // CPL channels a lane (lane + 32 i), the sums over the true channels (a
  // padded one holds 0; its xhat is dropped with its gradient).
  float v[CPL];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const size_t k = o + lane + 32 * i;
    v[i] = 0.f;
    if (lane_holds(lane, i)) {
      v[i] = x[k];
      if (add0) v[i] += add1 ? (add0[k] + add1[k]) : add0[k];
    }
    s1 += v[i];
    s2 += v[i] * v[i];
  }
  const float mu = warp_sum(s1) * inv_c;
  const float ms = warp_sum(s2) * inv_c;
  const float rs = rsqrtf(fmaxf(ms - mu * mu, 0.f) + 1e-6f);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    if (!lane_holds(lane, i)) continue;
    const int c = lane + 32 * i;
    const float h = (v[i] - mu) * rs;
    y[o + c] = h * s[c] + b[c];
    xhat[o + c] = h;
  }
#endif
  if (lane == 0) rstd[row] = rs;
}

// out = base + LN backward of dy:  rstd (dxh - mean(dxh) - xhat mean(dxh
// xhat)), dxh = dy * scale, the means over 1 / inv_c true channels; out2 =
// out + extra when out2 is given. One warp per row.
__global__ void ln_bwd_kernel(const float* __restrict__ dy,
                              const float* __restrict__ xhat,
                              const float* __restrict__ rstd,
                              const float* __restrict__ scale,
                              const float* __restrict__ base,
                              const float* __restrict__ extra,
                              float* __restrict__ out,
                              float* __restrict__ out2, long long rows,
                              float inv_c) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t o = (size_t)row * C;
#if LCT_C == 64
  const float da = dy[o + lane] * scale[lane];
  const float dc = dy[o + lane + 32] * scale[lane + 32];
  const float xa = xhat[o + lane], xc = xhat[o + lane + 32];
  const float m1 = warp_sum(da + dc) * inv_c;
  const float m2 = warp_sum(da * xa + dc * xc) * inv_c;
  const float rs = rstd[row];
  const float oa = base[o + lane] + rs * (da - m1 - xa * m2);
  const float oc = base[o + lane + 32] + rs * (dc - m1 - xc * m2);
  out[o + lane] = oa;
  out[o + lane + 32] = oc;
  if (out2) {
    out2[o + lane] = oa + extra[o + lane];
    out2[o + lane + 32] = oc + extra[o + lane + 32];
  }
#else
  // CPL channels a lane; means over the true channels (a padded channel's
  // scale is 0, so its dxh adds nothing).
  float dv[CPL], xv[CPL];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    dv[i] = lane_holds(lane, i) ? dy[o + c] * scale[c] : 0.f;
    xv[i] = lane_holds(lane, i) ? xhat[o + c] : 0.f;
    s1 += dv[i];
    s2 += dv[i] * xv[i];
  }
  const float m1 = warp_sum(s1) * inv_c;
  const float m2 = warp_sum(s2) * inv_c;
  const float rs = rstd[row];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    if (!lane_holds(lane, i)) continue;
    const int c = lane + 32 * i;
    const float ov = base[o + c] + rs * (dv[i] - m1 - xv[i] * m2);
    out[o + c] = ov;
    if (out2) out2[o + c] = ov + extra[o + c];
  }
#endif
}

// The combine layer's backward over COMB_ROWS rows per block, one thread
// per channel c (blockDim.x == C):
//   a     = ctx @ out_w + out_b                      (recomputed)
//   comb  = [g @ lin_w[:C]] + a @ lin_w[C or 0:] + lin_b
//   dcomb = dout * (comb >= 0 ? 1 : 0.2)
//   dga   = dcomb @ lin_w^T  -> dg_lin = dga[:, :C] (frequency block), da
//   dctx  = da @ out_w^T
// Writes ga = [g | a] (the Linear's gradient operands), dcomb and da
// (their column sums are the bias gradients), dg_lin, dctx.
// Rows a block: its three [rows][C] f32 tiles fill the 48 KB of static
// shared memory at C = 128, so C = 256 takes 16 and C = 512 8.
constexpr int COMB_ROWS = C > 256 ? 8 : C > 128 ? 16 : ROWS;

__global__ void comb_bwd_kernel(const float* __restrict__ hid, int D,
                                const float* __restrict__ ctx,
                                const float* __restrict__ dout,
                                const float* __restrict__ out_w,
                                const float* __restrict__ out_b,
                                const float* __restrict__ lin_w,
                                const float* __restrict__ lin_b, int lin_in,
                                float* __restrict__ ga,
                                float* __restrict__ dcomb,
                                float* __restrict__ da,
                                float* __restrict__ dglin,
                                float* __restrict__ dctx, long long rows) {
  __shared__ float t0[COMB_ROWS][C];  // ctx, then dcomb
  __shared__ float t1[COMB_ROWS][C];  // a, then da
  __shared__ float t2[COMB_ROWS][C];  // g (frequency block)
  const long long row0 = (long long)blockIdx.x * COMB_ROWS;
  const int c = threadIdx.x;
  const bool freq = lin_in == 2 * C;
#pragma unroll
  for (int r = 0; r < COMB_ROWS; ++r) {
    const long long row = row0 + r;
    float g = 0.f, cv = 0.f;
    if (row < rows) {
      const size_t o = (size_t)row * C + c;
      g = hid[o];
      if (D == 2) g += hid[(size_t)rows * C + o];
      cv = ctx[o];
    }
    t2[r][c] = g;
    t0[r][c] = cv;
  }
  __syncthreads();

  float acc[COMB_ROWS];
#pragma unroll
  for (int r = 0; r < COMB_ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < C; ++k) {
    const float w = __ldg(out_w + k * C + c);
#pragma unroll
    for (int r = 0; r < COMB_ROWS; ++r) acc[r] = fmaf(t0[r][k], w, acc[r]);
  }
  const float ob = out_b[c];
#pragma unroll
  for (int r = 0; r < COMB_ROWS; ++r) {
    const float a = acc[r] + ob;
    t1[r][c] = a;
    const long long row = row0 + r;
    if (row < rows) {
      if (freq) {
        ga[(size_t)row * 2 * C + c] = t2[r][c];
        ga[(size_t)row * 2 * C + C + c] = a;
      } else {
        ga[(size_t)row * C + c] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < COMB_ROWS; ++r) acc[r] = 0.f;
  const float* lw_a = lin_w;
  if (freq) {
#pragma unroll 4
    for (int k = 0; k < C; ++k) {
      const float w = __ldg(lin_w + k * C + c);
#pragma unroll
      for (int r = 0; r < COMB_ROWS; ++r) acc[r] = fmaf(t2[r][k], w, acc[r]);
    }
    lw_a = lin_w + C * C;
  }
#pragma unroll 4
  for (int k = 0; k < C; ++k) {
    const float w = __ldg(lw_a + k * C + c);
#pragma unroll
    for (int r = 0; r < COMB_ROWS; ++r) acc[r] = fmaf(t1[r][k], w, acc[r]);
  }
  const float lb = lin_b[c];
  __syncthreads();  // every thread is done reading t0 (ctx)
#pragma unroll
  for (int r = 0; r < COMB_ROWS; ++r) {
    const long long row = row0 + r;
    float dc = 0.f;
    if (row < rows) {
      const size_t o = (size_t)row * C + c;
      const float comb = acc[r] + lb;
      dc = dout[o] * (comb >= 0.f ? 1.f : 0.2f);
      dcomb[o] = dc;
    }
    t0[r][c] = dc;
  }
  __syncthreads();

  // dga[m] = sum_j dcomb[j] lin_w[m, j]: thread c computes m = c (the da
  // column of the time block, the dg_lin column of the frequency block)
  // and, for the frequency block, m = C + c (its da column).
  float acc2[COMB_ROWS];
#pragma unroll
  for (int r = 0; r < COMB_ROWS; ++r) acc[r] = acc2[r] = 0.f;
#pragma unroll 4
  for (int j = 0; j < C; ++j) {
    const float w = __ldg(lin_w + c * C + j);
#pragma unroll
    for (int r = 0; r < COMB_ROWS; ++r) acc[r] = fmaf(t0[r][j], w, acc[r]);
  }
  if (freq) {
#pragma unroll 4
    for (int j = 0; j < C; ++j) {
      const float w = __ldg(lin_w + (C + c) * C + j);
#pragma unroll
      for (int r = 0; r < COMB_ROWS; ++r) acc2[r] = fmaf(t0[r][j], w, acc2[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < COMB_ROWS; ++r) {
    const long long row = row0 + r;
    const float dav = freq ? acc2[r] : acc[r];
    if (row < rows) {
      const size_t o = (size_t)row * C + c;
      da[o] = dav;
      if (freq) dglin[o] = acc[r];
    }
    t1[r][c] = dav;
  }
  __syncthreads();

  // dctx[c] = sum_k da[k] out_w[c, k]
#pragma unroll
  for (int r = 0; r < COMB_ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < C; ++k) {
    const float w = __ldg(out_w + c * C + k);
#pragma unroll
    for (int r = 0; r < COMB_ROWS; ++r) acc[r] = fmaf(t1[r][k], w, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < COMB_ROWS; ++r) {
    const long long row = row0 + r;
    if (row < rows) dctx[(size_t)row * C + c] = acc[r];
  }
}

// The attention core's backward. One block per (sequence, head), heads of
// hd = C / nh channels (the kernels' padded head width; the score scale
// `scale` is 1 / sqrt of the true head width); the kernel is built per
// padded head width HDP (8 for any hd <= 8, else hd). For heads of at most
// 16 channels, Q, K, V and
// dctx of that head (rounded, HDP floats a position, zero past hd) sit in
// dynamic shared memory, 4 HDP + 3 floats per position (137 KB at HDP =
// 16, L = 512); wider heads would not fit, so their rows are read from
// device memory where they lie (as common.cuh's attn_kernel does), and
// only the per-query statistics are staged.
//   pass A, one thread per query q: the row max m_q and sum den_q, the
//     normalised p (rounded), dp = dctx_q . v_k, rowsum_q = sum_k dp p, and
//     dq = sum_k round(p (dp - rowsum_q)) k_k / sqrt(hd);
//   pass B, one thread per key k: dk = sum_q round(ds) q_q / sqrt(hd) and
//     dv = sum_q p dctx_q over the queries whose band holds k, recomputing
//     p and dp from the stored m, den and rowsum (bit-equal to pass A's).
// Keys outside a query's band are never visited (p = 0 there).
//
// It keeps a run-time `round` (the bf16 rounding points; its only caller,
// precise mode, passes 0) that the other kernels of this mode dropped: nvcc
// allocates this kernel's registers around it, and without it gave 80,
// 125, 220 registers at HDP = 8, 16, 32 (74, 116, 168 with it) and spilled
// 1,684 bytes at HDP = 64 (204 with it); pinned at the former counts, it
// spilled 12-356 bytes.
template <int HDP>
__global__ void attn_bwd_kernel(const float* __restrict__ qkv,
                                const float* __restrict__ dctx,
                                float* __restrict__ dqkv, int L, int lookback,
                                int round, int hd_rt, float scale) {
  constexpr bool STAGE = HDP <= 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = sm + L * HDP;
  float* Vs = sm + 2 * L * HDP;
  float* Ds = sm + 3 * L * HDP;
  float* mq = sm + (STAGE ? 4 * L * HDP : 0);
  float* dq_den = mq + L;
  float* rsum = dq_den + L;
  const int hd = HDP >= 16 ? HDP : hd_rt;
  const int nh = C / hd;
  const long long n = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const float* base = qkv + (size_t)n * L * (3 * C);
  const float* dbase = dctx + (size_t)n * L * C;
  if (STAGE) {
    for (int i = threadIdx.x; i < L * HDP; i += blockDim.x) {
      const int t = i / HDP, d = i % HDP;
      if (HDP == 8 && d >= hd) {
        Qs[i] = Ks[i] = Vs[i] = Ds[i] = 0.f;
        continue;
      }
      Qs[i] = rnd(base[(size_t)t * 3 * C + h * hd + d], round);
      Ks[i] = rnd(base[(size_t)t * 3 * C + C + h * hd + d], round);
      Vs[i] = rnd(base[(size_t)t * 3 * C + 2 * C + h * hd + d], round);
      Ds[i] = rnd(dbase[(size_t)t * C + h * hd + d], round);
    }
    __syncthreads();
  }
  // Position t's row of Q (K: + C, V: + 2C) and of dctx, staged or where
  // it lies; val rounds what is read from device memory.
  auto qrow = [&](int t) {
    return STAGE ? Qs + t * HDP : base + (size_t)t * 3 * C + h * hd;
  };
  auto krow = [&](int t) {
    return STAGE ? Ks + t * HDP : base + (size_t)t * 3 * C + C + h * hd;
  };
  auto vrow = [&](int t) {
    return STAGE ? Vs + t * HDP : base + (size_t)t * 3 * C + 2 * C + h * hd;
  };
  auto drow = [&](int t) {
    return STAGE ? Ds + t * HDP : dbase + (size_t)t * C + h * hd;
  };
  auto val = [&](float v) { return STAGE ? v : rnd(v, round); };

  auto score = [&](int q, int k) {
    const float* qr = qrow(q);
    const float* kr = krow(k);
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HDP; ++d) s = fmaf(val(qr[d]), val(kr[d]), s);
    return s * scale;
  };
  auto dprod = [&](int q, int k) {
    const float* dr = drow(q);
    const float* vr = vrow(k);
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HDP; ++d) s = fmaf(val(dr[d]), val(vr[d]), s);
    return s;
  };

  for (int q = threadIdx.x; q < L; q += blockDim.x) {
    int k0 = 0, k1 = L - 1;
    if (lookback >= 0) {
      k0 = max(0, q - lookback);
      k1 = q;
    }
    float m = -INFINITY;
    for (int k = k0; k <= k1; ++k) m = fmaxf(m, score(q, k));
    float den = 0.f;
    for (int k = k0; k <= k1; ++k) den += expf(score(q, k) - m);
    float rs = 0.f;
    for (int k = k0; k <= k1; ++k) {
      const float p = rnd(expf(score(q, k) - m) / den, round);
      rs = fmaf(dprod(q, k), p, rs);
    }
    float acc[HDP];
#pragma unroll
    for (int d = 0; d < HDP; ++d) acc[d] = 0.f;
    for (int k = k0; k <= k1; ++k) {
      const float p = rnd(expf(score(q, k) - m) / den, round);
      const float ds = rnd(p * (dprod(q, k) - rs), round);
      const float* kr = krow(k);
#pragma unroll
      for (int d = 0; d < HDP; ++d) acc[d] = fmaf(ds, val(kr[d]), acc[d]);
    }
    float* o = dqkv + ((size_t)n * L + q) * 3 * C + h * hd;
#pragma unroll
    for (int d = 0; d < HDP; ++d)
      if (HDP != 8 || d < hd) o[d] = rnd(acc[d] * scale, round);
    mq[q] = m;
    dq_den[q] = den;
    rsum[q] = rs;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    int q0 = 0, q1 = L - 1;
    if (lookback >= 0) {
      q0 = k;
      q1 = min(L - 1, k + lookback);
    }
    float dk[HDP], dv[HDP];
#pragma unroll
    for (int d = 0; d < HDP; ++d) dk[d] = dv[d] = 0.f;
    for (int q = q0; q <= q1; ++q) {
      const float p = rnd(expf(score(q, k) - mq[q]) / dq_den[q], round);
      const float ds = rnd(p * (dprod(q, k) - rsum[q]), round);
      const float* qr = qrow(q);
      const float* dr = drow(q);
#pragma unroll
      for (int d = 0; d < HDP; ++d) {
        dk[d] = fmaf(ds, val(qr[d]), dk[d]);
        dv[d] = fmaf(p, val(dr[d]), dv[d]);
      }
    }
    float* o = dqkv + ((size_t)n * L + k) * 3 * C + h * hd;
#pragma unroll
    for (int d = 0; d < HDP; ++d) {
      if (HDP == 8 && d >= hd) continue;
      o[C + d] = rnd(dk[d] * scale, round);
      o[2 * C + d] = rnd(dv[d], round);
    }
  }
}

#if LCT_C > 128
// attn_bwd_kernel for heads of 128 to 512 channels at C >= 256, where a
// thread's q, dq, dk and dv (4 HDP floats) would not fit in registers: as
// common.cuh's attn_warp_kernel, a warp takes one row, lane l holding
// channels l + 32 i (HDP / 32 a lane), each dot product one warp sum. The
// same passes as attn_bwd_kernel (precise mode: nothing rounded):
//   pass A, a warp a query: m, den, rowsum = sum_k dp p, dq;
//   pass B, a warp a key: dk, dv over the queries whose band holds it, p and
//     dp recomputed from the stored m, den and rowsum.
// Q, K, V and dctx rows are read where they lie, each a coalesced row of
// the warp. Block: (sequence, head), WARP_ROWS warps; 3 L floats of shared
// memory. Bound: the L^2 hd FMAs on CUDA cores and their warp sums.
template <int HDP>
__global__ void __launch_bounds__(32 * WARP_ROWS)
    attn_bwd_warp_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ dctx,
                         float* __restrict__ dqkv, int L, int lookback,
                         float scale) {
  constexpr int PL = HDP / 32;  // channels a lane
  constexpr int nh = C / HDP;
  extern __shared__ float sm[];
  float* mq = sm;           // [L] row max
  float* dq_den = sm + L;   // [L] sum of exps
  float* rsum = sm + 2 * L; // [L] sum_k dp p
  const long long n = blockIdx.x / nh;
  const int h = blockIdx.x % nh, lane = threadIdx.x & 31;
  const int wq = threadIdx.x >> 5;
  const size_t off = (size_t)h * HDP + lane;
  const float* base = qkv + (size_t)n * L * (3 * C) + off;
  const float* dbase = dctx + (size_t)n * L * C + off;
  float* obase = dqkv + (size_t)n * L * (3 * C) + off;
  auto load = [&](float (&v)[PL], const float* row) {
#pragma unroll
    for (int i = 0; i < PL; ++i) v[i] = row[32 * i];
  };
  auto dot = [&](const float (&v)[PL], const float* row) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i) s = fmaf(v[i], row[32 * i], s);
    return warp_sum(s);
  };

  for (int q = wq; q < L; q += WARP_ROWS) {
    float qv[PL], ov[PL];
    load(qv, base + (size_t)q * 3 * C);
    load(ov, dbase + (size_t)q * C);
    int k0 = 0, k1 = L - 1;
    if (lookback >= 0) {
      k0 = max(0, q - lookback);
      k1 = q;
    }
    auto score = [&](int k) {
      return dot(qv, base + (size_t)k * 3 * C + C) * scale;
    };
    float m = -INFINITY;
    for (int k = k0; k <= k1; ++k) m = fmaxf(m, score(k));
    float den = 0.f;
    for (int k = k0; k <= k1; ++k) den += expf(score(k) - m);
    float rs = 0.f;
    for (int k = k0; k <= k1; ++k)
      rs = fmaf(dot(ov, base + (size_t)k * 3 * C + 2 * C),
                expf(score(k) - m) / den, rs);
    float acc[PL];
#pragma unroll
    for (int i = 0; i < PL; ++i) acc[i] = 0.f;
    for (int k = k0; k <= k1; ++k) {
      const float p = expf(score(k) - m) / den;
      const float ds = p * (dot(ov, base + (size_t)k * 3 * C + 2 * C) - rs);
      const float* kr = base + (size_t)k * 3 * C + C;
#pragma unroll
      for (int i = 0; i < PL; ++i) acc[i] = fmaf(ds, kr[32 * i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < PL; ++i)
      obase[(size_t)q * 3 * C + 32 * i] = acc[i] * scale;
    if (lane == 0) {
      mq[q] = m;
      dq_den[q] = den;
      rsum[q] = rs;
    }
  }
  __syncthreads();

  for (int k = wq; k < L; k += WARP_ROWS) {
    float kv[PL], vv[PL];
    load(kv, base + (size_t)k * 3 * C + C);
    load(vv, base + (size_t)k * 3 * C + 2 * C);
    int q0 = 0, q1 = L - 1;
    if (lookback >= 0) {
      q0 = k;
      q1 = min(L - 1, k + lookback);
    }
    float dk[PL], dv[PL];
#pragma unroll
    for (int i = 0; i < PL; ++i) dk[i] = dv[i] = 0.f;
    for (int q = q0; q <= q1; ++q) {
      const float* qr = base + (size_t)q * 3 * C;
      const float* dr = dbase + (size_t)q * C;
      const float p = expf(dot(kv, qr) * scale - mq[q]) / dq_den[q];
      const float ds = p * (dot(vv, dr) - rsum[q]);
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        dk[i] = fmaf(ds, qr[32 * i], dk[i]);
        dv[i] = fmaf(p, dr[32 * i], dv[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      obase[(size_t)k * 3 * C + C + 32 * i] = dk[i] * scale;
      obase[(size_t)k * 3 * C + 2 * C + 32 * i] = dv[i];
    }
  }
}
#endif

template <int HDP>
cudaError_t launch_attn_bwd_hd(const float* qkv, const float* dctx,
                               float* dqkv, long long N, int L, int lookback,
                               int hd, float scale, cudaStream_t st) {
#if LCT_C > 128
  if constexpr (HDP >= 128) {
    const size_t smem = (size_t)3 * L * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          attn_bwd_warp_kernel<HDP>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    attn_bwd_warp_kernel<HDP><<<(unsigned)(N * (C / HDP)), 32 * WARP_ROWS,
                                smem, st>>>(qkv, dctx, dqkv, L, lookback,
                                            scale);
    return cudaGetLastError();
  } else
#endif
  {
    const size_t smem =
        (size_t)((HDP <= 16 ? 4 * HDP : 0) + 3) * L * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          attn_bwd_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
    }
    int threads = ((L + 31) / 32) * 32;
    if (threads > 256) threads = 256;
    attn_bwd_kernel<HDP><<<(unsigned)(N * (C / hd)), threads, smem, st>>>(
        qkv, dctx, dqkv, L, lookback, /*round=*/0, hd, scale);
    return cudaGetLastError();
  }
}

// attn_bwd_kernel<head_pad(hd)> for N sequences of length L: instances for
// the padded widths up to C.
inline cudaError_t launch_attn_bwd(const float* qkv, const float* dctx,
                                   float* dqkv, long long N, int L,
                                   int lookback, int hd, float scale,
                                   cudaStream_t st) {
  switch (head_pad(hd)) {
    case 8:
      return launch_attn_bwd_hd<8>(qkv, dctx, dqkv, N, L, lookback, hd,
                                   scale, st);
    case 16:
      return launch_attn_bwd_hd<16>(qkv, dctx, dqkv, N, L, lookback, hd,
                                    scale, st);
#if LCT_C > 16  // C >= 32
    case 32:
      return launch_attn_bwd_hd<32>(qkv, dctx, dqkv, N, L, lookback, hd,
                                    scale, st);
#endif
#if LCT_C > 32  // C >= 64
    case 64:
      return launch_attn_bwd_hd<64>(qkv, dctx, dqkv, N, L, lookback, hd,
                                    scale, st);
#endif
#if LCT_C > 64  // C >= 128
    case 128:
      return launch_attn_bwd_hd<128>(qkv, dctx, dqkv, N, L, lookback, hd,
                                     scale, st);
#endif
#if LCT_C > 128  // C >= 256
    case 256:
      return launch_attn_bwd_hd<256>(qkv, dctx, dqkv, N, L, lookback, hd,
                                     scale, st);
#endif
#if LCT_C > 256  // C = 512
    case 512:
      return launch_attn_bwd_hd<512>(qkv, dctx, dqkv, N, L, lookback, hd,
                                     scale, st);
#endif
  }
  return cudaErrorInvalidValue;
}

// dn2 = dqkv @ in_w^T over DN2_ROWS rows per block, one thread per channel
// c (its [rows][3C] f32 tile within the 48 KB of static shared memory: 16
// rows at C = 256, 8 at C = 512).
constexpr int DN2_ROWS = C > 256 ? 8 : C > 128 ? 16 : ROWS;

__global__ void dn2_kernel(const float* __restrict__ dqkv,
                           const float* __restrict__ in_w,
                           float* __restrict__ dn2, long long rows) {
  __shared__ float tile[DN2_ROWS][3 * C];
  const long long row0 = (long long)blockIdx.x * DN2_ROWS;
  const int c = threadIdx.x;
  for (int i = c; i < DN2_ROWS * 3 * C; i += blockDim.x) {
    const int r = i / (3 * C), m = i % (3 * C);
    const long long row = row0 + r;
    tile[r][m] = row < rows ? dqkv[(size_t)row * 3 * C + m] : 0.f;
  }
  __syncthreads();
  float acc[DN2_ROWS];
#pragma unroll
  for (int r = 0; r < DN2_ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int m = 0; m < 3 * C; ++m) {
    const float w = __ldg(in_w + c * 3 * C + m);
#pragma unroll
    for (int r = 0; r < DN2_ROWS; ++r) acc[r] = fmaf(tile[r][m], w, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < DN2_ROWS; ++r) {
    const long long row = row0 + r;
    if (row < rows) dn2[(size_t)row * C + c] = acc[r];
  }
}

// The GRU's gate factors for every (row, direction, unit) at once, over
// slots of W units (16, 64 or C). One thread per (row, d, c = g*W + j).
// hp_{t} = h_{t-1} @ W_hh + b_hh from the saved hiddens shifted by one step
// (h_{t-1} for the forward direction, h_{t+1} for the backward one, 0 at
// the sequence's start), computed as the f32 forward's gru_kernel computes
// it: same order of sums (the bf16 forward's gates differ by f32 noise).
// Writes
//   K[d, row, 0..4, c] = (K1, K2, K3, K4, K5)
//     K1 = P hp_n r (1 - r), K2 = (h_prev - n) z (1 - z), K3 = P r,
//     K4 = P, K5 = z,  with P = (1 - z)(1 - n^2)
// and hpv[d, row, c] = h_prev, the operand of dW_hh.
template <int W>
__global__ void gate_kernel(const float* __restrict__ xp,
                            const float* __restrict__ hid,
                            const float* __restrict__ w_hh,
                            const float* __restrict__ b_hh,
                            float* __restrict__ K, float* __restrict__ hpv,
                            long long N, int L, int D) {
  constexpr int S = C / W;  // slots
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long NL = N * L;
  if (tid >= NL * D * C) return;
  const int c = tid % C;
  const int d = (tid / C) % D;
  const long long row = tid / ((long long)C * D);
  const int g = c / W, j = c % W;
  const int t = row % L;
  const bool has_prev = d ? (t < L - 1) : (t > 0);
  const long long prow = d ? row + 1 : row - 1;
  const float* hp_row =
      has_prev ? hid + ((size_t)d * NL + prow) * C + g * W : nullptr;

  const float* wp = w_hh + (size_t)(d * S + g) * W * (3 * W);
  float ar = 0.f, az = 0.f, an = 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float hi = has_prev ? hp_row[i] : 0.f;
    ar = fmaf(hi, wp[i * 3 * W + j], ar);
    az = fmaf(hi, wp[i * 3 * W + W + j], az);
    an = fmaf(hi, wp[i * 3 * W + 2 * W + j], an);
  }
  const float* bp = b_hh + (d * S + g) * 3 * W;
  const float* xr = xp + (size_t)row * D * 3 * C + d * 3 * C + g * 3 * W;
  const float r = sigmoidf_(xr[j] + (ar + bp[j]));
  const float z = sigmoidf_(xr[W + j] + (az + bp[W + j]));
  const float hpn = an + bp[2 * W + j];
  const float nn = tanhf(xr[2 * W + j] + r * hpn);
  const float hprev = has_prev ? hp_row[j] : 0.f;
  const float P = (1.f - z) * (1.f - nn * nn);
  float* kp = K + ((size_t)d * NL + row) * 5 * C + c;
  kp[0] = P * hpn * r * (1.f - r);
  kp[C] = (hprev - nn) * z * (1.f - z);
  kp[2 * C] = P * r;
  kp[3 * C] = P;
  kp[4 * C] = z;
  hpv[((size_t)d * NL + row) * C + c] = hprev;
}

// BPTT through the saved gate factors over slots of 16 units. One thread
// per (sequence, direction, slot, unit j), as in gru_kernel: a slot's 16
// units are 16 lanes of one warp that trade the dhp values by shuffles. The
// forward direction walks t descending, the backward direction ascending:
//   dh  = carry + dg[t]
//   dhp = (dh K1, dh K2, dh K3),  dxp = (dh K1, dh K2, dh K4)  (written out)
//   carry = dh K5 + sum_{gate, k} dhp[gate, k] W_hh[g, j, gate*H + k]
__global__ void bptt_kernel(const float* __restrict__ K,
                            const float* __restrict__ dg,
                            const float* __restrict__ w_hh,
                            float* __restrict__ dxp, float* __restrict__ dhp,
                            long long N, int L, int D) {
  constexpr int H = 16, G = C / H;  // slots of 16 units
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // For C >= 32 the total is a multiple of 32 and blocks are too, so a warp
  // is either wholly in range or wholly out: the shuffles below see all 32
  // lanes. At C = 16 a warp may hang over the end: its lanes past it run
  // sequence 0 and store nothing.
  const long long total = N * D * G * H;
  const bool live = C % 32 == 0 || tid < total;
  if (C % 32 == 0 ? tid >= total : (tid & ~31LL) >= total) return;
  const int j = tid % H;
  const int g = (tid / H) % G;
  const int d = (tid / (G * H)) % D;
  const long long n = live ? tid / ((long long)G * H * D) : 0;
  const long long NL = N * L;
  const int c = g * H + j;

  const float* wp = w_hh + ((size_t)(d * G + g) * H + j) * (3 * H);
  float wr[H], wz[H], wn[H];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    wr[k] = wp[k];
    wz[k] = wp[H + k];
    wn[k] = wp[2 * H + k];
  }
  const size_t xstride = (size_t)D * 3 * C;
  float carry = 0.f;
  for (int s = 0; s < L; ++s) {
    const int t = d ? s : L - 1 - s;
    const long long row = n * L + t;
    const float* kp = K + ((size_t)d * NL + row) * 5 * C + c;
    const float dh = carry + dg[(size_t)row * C + c];
    const float er = dh * kp[0], ez = dh * kp[C], en = dh * kp[2 * C];
    const size_t o = (size_t)row * xstride + d * 3 * C + g * 3 * H + j;
    if (live) {
      dxp[o] = er;
      dxp[o + H] = ez;
      dxp[o + 2 * H] = dh * kp[3 * C];
      dhp[o] = er;
      dhp[o + H] = ez;
      dhp[o + 2 * H] = en;
    }
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      acc = fmaf(__shfl_sync(0xffffffffu, er, k, H), wr[k], acc);
      acc = fmaf(__shfl_sync(0xffffffffu, ez, k, H), wz[k], acc);
      acc = fmaf(__shfl_sync(0xffffffffu, en, k, H), wn[k], acc);
    }
    carry = dh * kp[4 * C] + acc;
  }
}

// The same walk over dense slots of SW units: one slot of C (groups of 32
// or 64 at C = 64, one group of C), at C = 128 two of 64, at C = 256 four
// of 64 or two of 128. A block takes one direction and DS sequences, one
// thread per (sequence, unit u = slot sl, unit j of it) of its UW units, as
// gru_dense_kernel: all C, or at C = 256 one slot of 128 (blockIdx.z), whose
// W_hh alone fills 192 KB. W_hh of those units sits transposed in shared
// memory (wt[sl][gate*SW + k][j], read by consecutive units: no bank
// conflict; 192 KB at SW = C = 128), and each step's dhp is traded through
// a double buffer of shared memory, one barrier a step. A slot of 256 is
// bptt_cluster_kernel's. Bound: latency. Like attn_bwd_kernel it keeps its
// run-time `round` (precise mode passes 0): without it nvcc gave it one
// register more than the 31 of C = 64's instance.
constexpr int DS = 4;  // sequences per block of bptt_dense_kernel

template <int SW>
inline size_t bptt_dense_smem() {
  constexpr int UW = dense_units<SW>();
  return (size_t)(3 * UW * SW + 2 * DS * 3 * UW) * sizeof(float);
}

template <int SW>
__global__ void __launch_bounds__(DS * dense_units<SW>())
    bptt_dense_kernel(const float* __restrict__ K,
                      const float* __restrict__ dg,
                      const float* __restrict__ w_hh,
                      float* __restrict__ dxp, float* __restrict__ dhp,
                      long long N, int L, int D, int round) {
  constexpr bool ONE = SW == C;  // one slot
  constexpr int UW = dense_units<SW>();
  extern __shared__ float bsm[];
  float* wt = bsm;                // [UW / SW][3 SW][SW]
  float* es = bsm + 3 * UW * SW;  // dhp [2][DS][3 UW], slot-major
  // u0: the block's first unit; uu the thread's among the block's, u in all
  const int u0 = UW == C ? 0 : (int)blockIdx.z * UW;
  const int d = blockIdx.y, uu = threadIdx.x % UW, sq = threadIdx.x / UW;
  const int u = u0 + uu;
  const int j = ONE ? u : u % SW;
  const int eo = ONE ? 0 : uu / SW * 3 * SW;  // the slot's first dhp column
  const long long n = (long long)blockIdx.x * DS + sq;
  const bool live = n < N;
  const float* wp = w_hh + (size_t)d * C * (3 * SW) + (size_t)u0 * 3 * SW;
  for (int i = threadIdx.x; i < UW * 3 * SW; i += blockDim.x) {
    if (ONE) {
      wt[(i % (3 * C)) * C + i / (3 * C)] = rnd(wp[i], round);
    } else {  // i = (slot unit r) * 3SW + o
      const int r = i / (3 * SW), o = i % (3 * SW);
      wt[(r / SW * 3 * SW + o) * SW + r % SW] = rnd(wp[i], round);
    }
  }
  __syncthreads();
  const long long NL = N * L;
  const size_t xstride = (size_t)D * 3 * C;
  const float* ws = wt + (size_t)eo * SW;  // the slot's transposed W_hh
  float carry = 0.f;
  for (int s = 0; s < L; ++s) {
    const int t = d ? s : L - 1 - s;
    const long long row = n * L + t;
    const float* kp = K + ((size_t)d * NL + row) * 5 * C + u;
    float dh = 0.f, er = 0.f, ez = 0.f, en = 0.f;
    if (live) {
      dh = carry + dg[(size_t)row * C + u];
      er = dh * kp[0];
      ez = dh * kp[C];
      en = dh * kp[2 * C];
      const size_t o = (size_t)row * xstride + d * 3 * C + u0 * 3 + eo + j;
      dxp[o] = er;
      dxp[o + SW] = ez;
      dxp[o + 2 * SW] = dh * kp[3 * C];
      dhp[o] = er;
      dhp[o + SW] = ez;
      dhp[o + 2 * SW] = en;
    }
    float* eb = es + (s & 1) * DS * 3 * UW + sq * 3 * UW + eo;
    eb[j] = rnd(er, round);
    eb[SW + j] = rnd(ez, round);
    eb[2 * SW + j] = rnd(en, round);
    __syncthreads();
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < SW; ++k) {
      acc = fmaf(eb[k], ws[k * SW + j], acc);
      acc = fmaf(eb[SW + k], ws[(SW + k) * SW + j], acc);
      acc = fmaf(eb[2 * SW + k], ws[(2 * SW + k) * SW + j], acc);
    }
    if (live) carry = dh * kp[4 * C] + acc;
  }
}

template <int SW>
cudaError_t launch_bptt_dense(const float* K, const float* dg,
                              const float* w_hh, float* dxp, float* dhp,
                              long long N, int L, int D, cudaStream_t st) {
  constexpr int UW = dense_units<SW>();
  const size_t smem = bptt_dense_smem<SW>();
  cudaError_t e = cudaFuncSetAttribute(
      bptt_dense_kernel<SW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  bptt_dense_kernel<SW><<<dim3((unsigned)((N + DS - 1) / DS), (unsigned)D,
                               (unsigned)(C / UW)),
                          DS * UW, smem, st>>>(K, dg, w_hh, dxp, dhp, N, L,
                                               D, /*round=*/0);
  return cudaGetLastError();
}

#if LCT_C > 128
// ---------------------------------------------------------------------------
// BPTT through one dense GRU slot of BC_SW = 256 units (a group of 256, or
// of 129-255 padded; at C = 512 each of two such slots, blockIdx.z), both
// modes: W_hh of one direction's slot is 256 x 768 = 768 KB as
// f32, more than the 227 KB of shared memory a block may hold, so, as
// ftf.cu's gru_cluster_kernel walks the forward, a cluster of BC_CL = 8
// blocks on neighbouring SMs walks the steps together, in the order
// opposite to the forward's (descending for direction 0). Block `rank` owns
// the slot's units [32 rank, 32 rank + 32); thread (unit u, k-part kq)
// keeps row u of the slot's W_hh (rounded to bf16 with ROUND), entries o =
// 4 kq + 32 i + e (i < 24, e < 4: 96 floats), for the carry
//   dh_t = carry + dg_t, dhp = (dh K1, dh K2, dh K3), dxp = (dh K1, dh K2,
//   dh K4), carry = dh K5 + dhp @ W_hh^T  (ROUND: bf16(dhp), bf16(W_hh))
// over the per-step gate factors K1..K5 [D, N*L, 5C] that an earlier pass
// computed for every step at once (precise: gate_kernel<C>; bf16:
// gate_tc_kernel, on tensor cores), so only the carry stays on the
// sequential chain. Each step a block writes its units' dhp into every
// block's double-buffered exchange through distributed shared memory (lane
// kq into block kq), the cluster crosses one barrier (release / acquire),
// and every thread sums its 96 products, the unit's 8 lanes added by xor
// shuffles. A cluster takes BC_DS sequences and one direction (blockIdx.y).
// A step's loads (its gate factors and dg) do not depend on the carry, so
// they are issued one step ahead. Writes dxp and dhp (f32, or bf16 with
// ROUND) and with ROUND the column sums of the unrounded dxp and dhp
// (db_ih, db_hh), one partial row per cluster. Bound: latency, one cluster
// barrier and a 12-deep FMA chain of 8 lanes a step.
constexpr int BC_CL = 8;   // blocks of a cluster
constexpr int BC_DS = 4;   // sequences of a cluster
constexpr int BC_SW = 256;  // units a slot (C / BC_SW slots: blockIdx.z)
static_assert(BC_DS == DS, "the bf16 partial rows count DS sequences a row");

// The arguments of the walks over one dense slot's gate factors (the
// cluster walk, and at C = 512 the step walk).
struct ClusterArgs {
  const float* K;      // [D, N*L, 5C]: K1, K2, K3, K4 = P, K5 = z
  const float* dg;     // [N*L, C]: ds (+ dg_lin), or ds
  const float* dglin;  // [N*L, C], added to dg, or null
  const float* w_hh;   // slots [D, C/SW, SW, 3SW]
  float* dxp;          // precise: [N*L, D*3C] f32 out
  float* dhp;
  __nv_bfloat16* dxp_b;  // ROUND: [N*L, D*3C] bf16 out
  __nv_bfloat16* dhp_b;
  float* part;         // ROUND: [sequence groups, 2*D*3C] out
  long long N;
  int L;
  int D;
};

template <bool ROUND>
__global__ void __cluster_dims__(BC_CL, 1, 1) __launch_bounds__(256, 1)
    bptt_cluster_kernel(ClusterArgs a) {
  namespace cg = cooperative_groups;
  constexpr int SW = BC_SW;
  constexpr int UPC = SW / BC_CL;  // units a block: 32
  constexpr int KQ = 256 / UPC;    // lanes a unit: 8
  constexpr int KO = 3 * SW / KQ;  // W_hh entries a lane: 96
  static_assert(UPC == 32 && KQ == BC_CL && KO % 4 == 0, "cluster BPTT");
  __shared__ __align__(16) float es[2][BC_DS][3 * SW];  // dhp (ROUND: rounded)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.y, kq = threadIdx.x % KQ;
  const int sl = SW == C ? 0 : (int)blockIdx.z;  // the slot
  const int u = rank * UPC + threadIdx.x / KQ;   // the unit in the slot
  const int uc = sl * SW + u;                    // its channel
  const long long n0 = (long long)(blockIdx.x / BC_CL) * BC_DS;
  const int L = a.L;
  const float* wp =
      a.w_hh + ((size_t)(d * (C / SW) + sl) * SW + u) * 3 * SW + 4 * kq;
  float w[KO];
#pragma unroll
  for (int i = 0; i < KO / 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(wp + 32 * i);
    w[4 * i] = rnd(v.x, ROUND);
    w[4 * i + 1] = rnd(v.y, ROUND);
    w[4 * i + 2] = rnd(v.z, ROUND);
    w[4 * i + 3] = rnd(v.w, ROUND);
  }
  const size_t NL = (size_t)a.N * L, ldx = (size_t)a.D * 3 * C;
  float carry[BC_DS];
#pragma unroll
  for (int q = 0; q < BC_DS; ++q) carry[q] = 0.f;
  float sr = 0.f, sz = 0.f, sxn = 0.f, shn = 0.f;
  // Step s's gate factors and dg of the cluster's sequences (0 past N).
  auto load = [&](int s, float (&k)[BC_DS][5], float (&g)[BC_DS]) {
    const int t = d ? s : L - 1 - s;
#pragma unroll
    for (int q = 0; q < BC_DS; ++q) {
      const long long n = n0 + q;
#pragma unroll
      for (int f = 0; f < 5; ++f) k[q][f] = 0.f;
      g[q] = 0.f;
      if (n < a.N) {
        const size_t row = (size_t)n * L + t;
        const float* kp = a.K + ((size_t)d * NL + row) * 5 * C + uc;
#pragma unroll
        for (int f = 0; f < 5; ++f) k[q][f] = kp[f * C];
        g[q] = a.dg[row * C + uc];
        if (a.dglin) g[q] += a.dglin[row * C + uc];
      }
    }
  };
  float kc[BC_DS][5], gc[BC_DS];
  load(0, kc, gc);
  cluster.sync();  // every block of the cluster runs before a remote write
  for (int s = 0; s < L; ++s) {
    const int t = d ? s : L - 1 - s;
    float kn[BC_DS][5], gn[BC_DS];
    if (s + 1 < L) load(s + 1, kn, gn);
    float dh[BC_DS], z[BC_DS];
    float* nb = cluster.map_shared_rank(&es[s & 1][0][0], kq);
#pragma unroll
    for (int q = 0; q < BC_DS; ++q) {
      const long long n = n0 + q;
      const float(&k)[5] = kc[q];
      const size_t row = (size_t)n * L + t;
      dh[q] = carry[q] + gc[q];
      z[q] = k[4];
      const float er = dh[q] * k[0], ez = dh[q] * k[1], en = dh[q] * k[2];
      const float ex = dh[q] * k[3];
      nb[q * 3 * SW + u] = rnd(er, ROUND);
      nb[q * 3 * SW + SW + u] = rnd(ez, ROUND);
      nb[q * 3 * SW + 2 * SW + u] = rnd(en, ROUND);
      if (kq == 0 && n < a.N) {
        const size_t o = row * ldx + (size_t)d * 3 * C + sl * 3 * SW + u;
        if constexpr (ROUND) {
          a.dhp_b[o] = __float2bfloat16_rn(er);
          a.dhp_b[o + SW] = __float2bfloat16_rn(ez);
          a.dhp_b[o + 2 * SW] = __float2bfloat16_rn(en);
          a.dxp_b[o] = __float2bfloat16_rn(er);
          a.dxp_b[o + SW] = __float2bfloat16_rn(ez);
          a.dxp_b[o + 2 * SW] = __float2bfloat16_rn(ex);
          sr += er;
          sz += ez;
          sxn += ex;
          shn += en;
        } else {
          a.dhp[o] = er;
          a.dhp[o + SW] = ez;
          a.dhp[o + 2 * SW] = en;
          a.dxp[o] = er;
          a.dxp[o + SW] = ez;
          a.dxp[o + 2 * SW] = ex;
        }
      }
    }
    cluster.sync();  // every block's dhp of step s is in every buffer
    const float* eb = &es[s & 1][0][0] + 4 * kq;
#pragma unroll
    for (int q = 0; q < BC_DS; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < KO / 4; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(eb + q * 3 * SW + 32 * i);
        acc = fmaf(v.x, w[4 * i], acc);
        acc = fmaf(v.y, w[4 * i + 1], acc);
        acc = fmaf(v.z, w[4 * i + 2], acc);
        acc = fmaf(v.w, w[4 * i + 3], acc);
      }
#pragma unroll
      for (int o = 1; o < KQ; o <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      carry[q] = dh[q] * z[q] + acc;
    }
    if (s + 1 < L) {
#pragma unroll
      for (int q = 0; q < BC_DS; ++q) {
#pragma unroll
        for (int f = 0; f < 5; ++f) kc[q][f] = kn[q][f];
        gc[q] = gn[q];
      }
    }
  }
  if constexpr (ROUND) {
    if (kq == 0) {
      float* out = a.part + (size_t)(blockIdx.x / BC_CL) * 2 * ldx +
                   (size_t)d * 3 * C + sl * 3 * SW + u;
      out[0] = sr;  // db_ih: r, z, n
      out[SW] = sz;
      out[2 * SW] = sxn;
      out[ldx] = sr;  // db_hh: r, z, n
      out[ldx + SW] = sz;
      out[ldx + 2 * SW] = shn;
    }
  }
}

// Refuses the launch unless the card can hold a cluster of BC_CL blocks of
// the kernel (its compile-time cluster size) at once.
template <bool ROUND>
cudaError_t launch_bptt_cluster(const ClusterArgs& a, cudaStream_t st) {
  const dim3 grid((unsigned)((a.N + BC_DS - 1) / BC_DS * BC_CL),
                  (unsigned)a.D, (unsigned)(C / BC_SW));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  int clusters = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(
      &clusters, bptt_cluster_kernel<ROUND>, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  bptt_cluster_kernel<ROUND><<<grid, 256, 0, st>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++walk_launches[0];
  return e;
}
#endif

#if LCT_C > 256
// ---------------------------------------------------------------------------
// BPTT through one dense GRU slot of C = 512 units (a group of 512, or of
// 257-511 padded), both modes: the step-synchronous walk, the backward of
// ftf.cu's gru_step_kernel. One direction's W_hh is 512 x 1,536 = 3 MB as
// f32: a cluster of 8 blocks would hold 192 floats a thread, and the
// cluster walk's one cluster a 4 sequences would run each step in ~1,000
// waves at the frequency block's 8,256 sequences. So the per-step gate
// factors K1..K5 [D, N*L, 5C] come first, for every step at once
// (gate_tc_kernel on tensor cores, or precise gate_kernel<512>), and then
// each step is one launch over all sequences and both directions, a tiled
// product in the backward's order (t descending for direction 0):
//   dh_t  = carry_t + dg_t                       (carry_0 = 0)
//   dhp_t = (dh K1, dh K2, dh K3)                over all 3C columns
//   carry_{t-1} = dh K5 + dhp_t @ W_hh^T         (ROUND: bf16 operands)
// A block takes BS_R = 64 sequences and BS_U = 32 units j of the carry:
// it forms its sequences' dhp in k-chunks of BS_K = 32 of the 3C columns
// as it stages them (dh recomputed from the carry and dg; each dhp entry,
// and W_hh, rounded to bf16 with ROUND), stages W_hh[j][o] of its units
// for the chunk beside them (W_hh stays in L2: 3 MB a direction), and
// each thread keeps 4 sequences x 2 units of f32 sums (f32 FMAs on CUDA cores, as gru_step_kernel: bf16
// operands make each product exact in f32, the tensor cores' arithmetic up
// to the order of the sums). Its epilogue writes carry_{t-1} of its units
// and their dxp = (dh K1, dh K2, dh K4) and dhp columns (f32, or bf16 with
// ROUND); the carry ping-pongs between two [D, N, C] f32 buffers. With
// ROUND the column sums of the unrounded dxp and dhp (db_ih, db_hh) are
// taken over the block's sequences in a fixed order and added to the
// block's own partial row (one a BS_R sequences) step after step: no
// atomics. Bound: the carry product, 2 N D L x 3C x C FLOP (0.86 TFLOP at
// the frequency block's B = 64 x 2 s shape) on the f32 pipes.
constexpr int BS_R = 64;  // sequences a block
constexpr int BS_U = 32;  // units a block
constexpr int BS_K = 32;  // dhp columns a k-chunk

template <bool ROUND>
__global__ void __launch_bounds__(256)
    bptt_step_kernel(ClusterArgs a, const float* __restrict__ carry_in,
                     float* __restrict__ carry_out, int s) {
  __shared__ __align__(16) float esm[BS_K][BS_R + 4];  // dhp [col][seq]
  __shared__ __align__(16) float wsm[BS_K][BS_U + 2];  // W_hh [col][unit]
  __shared__ float red[16][4][BS_U];  // column sums [ty][quantity][unit]
  const int d = blockIdx.z, L = a.L;
  const int t = d ? s : L - 1 - s;
  const long long N = a.N, n0 = (long long)blockIdx.x * BS_R;
  const int u0 = blockIdx.y * BS_U;
  // Thread (ty, tx): sequences n0 + 4 ty + r (r < 4), units u0 + 2 tx + e.
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t NL = (size_t)N * L, ldx = (size_t)a.D * 3 * C;
  const float* cin = carry_in + (size_t)d * N * C;
  const float* Kd = a.K + (size_t)d * NL * 5 * C;
  // dh of sequence n (< N) at channel u in this step.
  auto dh_at = [&](long long n, int u) {
    const size_t row = (size_t)n * L + t;
    float g = a.dg[row * C + u];
    if (a.dglin) g += a.dglin[row * C + u];
    return (s > 0 ? cin[(size_t)n * C + u] : 0.f) + g;
  };
  float acc[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int o0 = 0; o0 < 3 * C; o0 += BS_K) {
    const int q = o0 / C;  // the chunk's gate: K1, K2 or K3
    for (int i = threadIdx.x; i < BS_R * BS_K; i += blockDim.x) {
      const int r = i / BS_K, k = i % BS_K, u = o0 % C + k;
      const long long n = n0 + r;
      float v = 0.f;
      if (n < N)
        v = dh_at(n, u) * Kd[((size_t)n * L + t) * 5 * C + q * C + u];
      esm[k][r] = rnd(v, ROUND);
    }
    for (int i = threadIdx.x; i < BS_K * BS_U; i += blockDim.x) {
      const int c = i / BS_K, k = i % BS_K;
      wsm[k][c] = rnd(a.w_hh[((size_t)d * C + u0 + c) * 3 * C + o0 + k],
                      ROUND);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BS_K; ++k) {
      const float4 ev = *reinterpret_cast<const float4*>(&esm[k][4 * ty]);
      const float2 w = *reinterpret_cast<const float2*>(&wsm[k][2 * tx]);
      const float er[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(er[r], w.x, acc[r][0]);
        acc[r][1] = fmaf(er[r], w.y, acc[r][1]);
      }
    }
    __syncthreads();
  }
  float cs[4][2] = {};  // sr, sz, sxn, shn of the thread's two units
  float* cout = carry_out + (size_t)d * N * C;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long n = n0 + 4 * ty + r;
    if (n >= N) continue;
    const size_t row = (size_t)n * L + t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int u = u0 + 2 * tx + e;
      const float dh = dh_at(n, u);
      const float* kp = Kd + row * 5 * C + u;
      const float er = dh * kp[0], ez = dh * kp[C], en = dh * kp[2 * C];
      const float ex = dh * kp[3 * C];
      cout[(size_t)n * C + u] = dh * kp[4 * C] + acc[r][e];
      const size_t o = row * ldx + (size_t)d * 3 * C + u;
      if constexpr (ROUND) {
        a.dhp_b[o] = __float2bfloat16_rn(er);
        a.dhp_b[o + C] = __float2bfloat16_rn(ez);
        a.dhp_b[o + 2 * C] = __float2bfloat16_rn(en);
        a.dxp_b[o] = __float2bfloat16_rn(er);
        a.dxp_b[o + C] = __float2bfloat16_rn(ez);
        a.dxp_b[o + 2 * C] = __float2bfloat16_rn(ex);
        cs[0][e] += er;
        cs[1][e] += ez;
        cs[2][e] += ex;
        cs[3][e] += en;
      } else {
        a.dhp[o] = er;
        a.dhp[o + C] = ez;
        a.dhp[o + 2 * C] = en;
        a.dxp[o] = er;
        a.dxp[o + C] = ez;
        a.dxp[o + 2 * C] = ex;
      }
    }
  }
  if constexpr (ROUND) {
    // The block's sums over its sequences, ty in order, added to its row.
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < 2; ++e) red[ty][f][2 * tx + e] = cs[f][e];
    __syncthreads();
    if (threadIdx.x < 4 * BS_U) {
      const int f = threadIdx.x / BS_U, j = threadIdx.x % BS_U;
      float v = red[0][f][j];
      for (int y = 1; y < 16; ++y) v += red[y][f][j];
      float* out = a.part + (size_t)blockIdx.x * 2 * ldx + (size_t)d * 3 * C +
                   u0 + j;
      // f: r -> db_ih and db_hh r, z -> both z, xn -> db_ih n, hn -> db_hh n
      const int o1 = f == 0 ? 0 : f == 1 ? C : f == 2 ? 2 * C : -1;
      const int o2 = f == 0 ? (int)ldx : f == 1 ? (int)ldx + C
                   : f == 3 ? (int)ldx + 2 * C : -1;
      if (o1 >= 0) out[o1] = s > 0 ? out[o1] + v : v;
      if (o2 >= 0) out[o2] = s > 0 ? out[o2] + v : v;
    }
  }
}

// L launches of bptt_step_kernel<ROUND>, one a step; carry: 2 x [D, N, C]
// f32 scratch.
template <bool ROUND>
cudaError_t launch_bptt_steps(const ClusterArgs& a, float* carry,
                              cudaStream_t st) {
  if (a.N == 0) return cudaSuccess;
  const dim3 grid((unsigned)((a.N + BS_R - 1) / BS_R), C / BS_U,
                  (unsigned)a.D);
  const size_t nc = (size_t)a.D * a.N * C;
  for (int s = 0; s < a.L; ++s) {
    bptt_step_kernel<ROUND><<<grid, 256, 0, st>>>(
        a, carry + (s & 1) * nc, carry + ((s + 1) & 1) * nc, s);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ++walk_launches[1];
  }
  return cudaSuccess;
}
#endif

// BPTT over `slots` slots (C / 16 of 16 units, one of C, at C = 128 two of
// 64, at C = 256 four of 64 or two of 128, at C = 512 also two of 256);
// carry: the step walk's scratch (one slot of 512).
inline cudaError_t launch_bptt(const float* K, const float* dg,
                               const float* w_hh, float* dxp, float* dhp,
                               long long N, int L, int D, int slots,
                               float* carry, cudaStream_t st) {
  if (gru_slot(slots) == 16) {
    const long long bthreads = N * D * C;
    bptt_kernel<<<(unsigned)((bthreads + 255) / 256), 256, 0, st>>>(
        K, dg, w_hh, dxp, dhp, N, L, D);
    return cudaGetLastError();
  }
#if LCT_C > 64
  if (gru_slot(slots) == 64)
    return launch_bptt_dense<64>(K, dg, w_hh, dxp, dhp, N, L, D, st);
#endif
#if LCT_C > 128
  if (gru_slot(slots) == 128)
    return launch_bptt_dense<128>(K, dg, w_hh, dxp, dhp, N, L, D, st);
  ClusterArgs ca = {K, dg, nullptr, w_hh, dxp, dhp, nullptr, nullptr,
                    nullptr, N, L, D};
#if LCT_C > 256
  if (gru_slot(slots) == C) return launch_bptt_steps<false>(ca, carry, st);
#endif
  return launch_bptt_cluster<false>(ca, st);
#else
  return launch_bptt_dense<C>(K, dg, w_hh, dxp, dhp, N, L, D, st);
#endif
}

// dn1[row, g*W + i] = sum_d sum_m dxp[row, d, g, m] W_ih[d, g, i, m] over
// slots of W units. One thread per (row, channel).
template <int W>
__global__ void dn1_kernel(const float* __restrict__ dxp,
                           const float* __restrict__ w_ih,
                           float* __restrict__ dn1, long long rows, int D) {
  constexpr int S = C / W;  // slots
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= rows * C) return;
  const int c = tid % C;
  const long long row = tid / C;
  const int g = c / W, i = c % W;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) {
    const float* e = dxp + (size_t)row * D * 3 * C + d * 3 * C + g * 3 * W;
    const float* w = w_ih + ((size_t)(d * S + g) * W + i) * 3 * W;
#pragma unroll 8
    for (int m = 0; m < 3 * W; ++m) acc = fmaf(e[m], __ldg(w + m), acc);
  }
  dn1[(size_t)row * C + c] = acc;
}

// Parameter gradients: out[o] = sum over rows of A(row, ac(o)) * B(row,
// bc(o)), where (ac, bc) follows the mode:
//   WG_DENSE    o = i * J + j                   -> (i, j)        A^T B
//   WG_GROUPED  o = ((d*G + g)*H + i)*3H + m     -> (d*adir? + g*H + i,
//                                                   d*3C + g*3H + m)
//               (GRU slots of H = 16 units, G = C / 16 a direction; a
//               dense slot is WG_DENSE per direction and slot)
//   WG_DIAG     o = c                           -> (c, c)        sum A*B
//   WG_COLSUM   o = c                           -> (-, c)        sum B
// Each block sums a fixed chunk of rows into its own partial row; no atomics.
// A and B sub-tiles of WG_TR rows are staged in shared memory (at most 2C
// and 6C columns); each thread owns up to WG_MAXK outputs, so one launch
// writes at most WG_OUT of them (Wgrad::dense splits a larger product).
enum { WG_DENSE = 0, WG_GROUPED = 1, WG_DIAG = 2, WG_COLSUM = 3 };
constexpr int WG_THREADS = 256;
// Rows of the staged pair, within 48 KB of static shared memory.
constexpr int WG_TR = C > 256 ? 2 : C > 128 ? 4 : C > 64 ? 8 : 16;
constexpr int WG_MAXK = 48;  // 256 * 48 = 12,288 = C = 64's largest (in_w) grad
constexpr int WG_OUT = WG_THREADS * WG_MAXK;
constexpr int WG_MAX_BLOCKS = 264;
constexpr int WG_ACOLS = 2 * C;
constexpr int WG_BCOLS = 6 * C;

__global__ void __launch_bounds__(WG_THREADS)
    wgrad_kernel(const float* __restrict__ A, int lda, long long adir,
                 const float* __restrict__ B, int ldb, int mode, int J,
                 int nout, int acols, int bcols, long long rows,
                 long long chunk_rows, float* __restrict__ partial) {
  __shared__ float As[WG_TR][WG_ACOLS];
  __shared__ float Bs[WG_TR][WG_BCOLS];
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min(rows, r0 + chunk_rows);
  const int tid = threadIdx.x;
  float acc[WG_MAXK];
#pragma unroll
  for (int k = 0; k < WG_MAXK; ++k) acc[k] = 0.f;

  for (long long rt = r0; rt < r1; rt += WG_TR) {
    for (int i = tid; i < WG_TR * acols; i += WG_THREADS) {
      const int rr = i / acols, col = i % acols;
      const long long row = rt + rr;
      float v = 0.f;
      if (row < r1)
        v = adir ? A[(col / C) * adir + row * lda + col % C]
                 : A[row * lda + col];
      As[rr][col] = v;
    }
    for (int i = tid; i < WG_TR * bcols; i += WG_THREADS) {
      const int rr = i / bcols, col = i % bcols;
      const long long row = rt + rr;
      Bs[rr][col] = row < r1 ? B[row * ldb + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WG_MAXK; ++k) {
      const int o = tid + k * WG_THREADS;
      if (o < nout) {
        int ac = 0, bc = o;
        if (mode == WG_DENSE) {
          ac = o / J;
          bc = o % J;
        } else if (mode == WG_GROUPED) {
          constexpr int H = 16, G = C / H;
          const int m = o % (3 * H), i = (o / (3 * H)) % H;
          const int g = (o / (3 * H * H)) % G, d = o / (3 * H * H * G);
          ac = (adir ? d * C : 0) + g * H + i;
          bc = d * 3 * C + g * 3 * H + m;
        } else if (mode == WG_DIAG) {
          ac = o;
        }
        float s = acc[k];
        if (mode == WG_COLSUM) {
#pragma unroll
          for (int rr = 0; rr < WG_TR; ++rr) s += Bs[rr][bc];
        } else {
#pragma unroll
          for (int rr = 0; rr < WG_TR; ++rr) s = fmaf(As[rr][ac], Bs[rr][bc], s);
        }
        acc[k] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < WG_MAXK; ++k) {
    const int o = tid + k * WG_THREADS;
    if (o < nout) partial[(size_t)blockIdx.x * nout + o] = acc[k];
  }
}

// out[o] = sum_b partial[b, o], b in index order.
__global__ void reduce_kernel(const float* __restrict__ partial, int nblocks,
                              int nout, float* __restrict__ out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= nout) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partial[(size_t)b * nout + o];
  out[o] = s;
}

struct Wgrad {
  float* partial;
  long long rows;
  cudaStream_t st;

  // A: nullptr for WG_COLSUM. adir: element offset between directions of A
  // (WG_GROUPED with A = [D, rows, C]), else 0. nout <= WG_OUT.
  cudaError_t operator()(int mode, const float* A, int lda, long long adir,
                         const float* B, int ldb, int J, int nout, int acols,
                         int bcols, float* out) const {
    long long nchunks = (rows + WG_TR - 1) / WG_TR;
    if (nchunks > WG_MAX_BLOCKS) nchunks = WG_MAX_BLOCKS;
    long long chunk = (rows + nchunks - 1) / nchunks;
    chunk = (chunk + WG_TR - 1) / WG_TR * WG_TR;
    const int nblocks = (int)((rows + chunk - 1) / chunk);
    wgrad_kernel<<<nblocks, WG_THREADS, 0, st>>>(
        A, lda, adir, B, ldb, mode, J, nout, acols, bcols, rows, chunk,
        partial);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    reduce_kernel<<<(nout + 255) / 256, 256, 0, st>>>(partial, nblocks, nout,
                                                       out);
    return cudaGetLastError();
  }

  // WG_DENSE over A's `acols` columns and B's J: out [acols, J], in
  // launches of whole rows of at most WG_OUT outputs (one at C = 64).
  cudaError_t dense(const float* A, int lda, const float* B, int ldb, int J,
                    int acols, float* out) const {
    const int step = WG_OUT / J;
    for (int i0 = 0; i0 < acols; i0 += step) {
      const int n = acols - i0 < step ? acols - i0 : step;
      cudaError_t e = (*this)(WG_DENSE, A + i0, lda, 0, B, ldb, J, n * J, n,
                              J, out + (size_t)i0 * J);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

// Scratch layout (floats), rows = N * L.
struct Scratch {
  float *n2, *xh2, *rs2, *qkv, *ctx, *ga, *dcomb, *da, *dglin, *dctx, *dqkv,
      *dn2, *ds, *dgt, *n1, *xh1, *rs1, *xp, *K, *hpv, *dxp, *dhp, *dn1,
      *partial, *carry;
  long long total;

  Scratch(float* base, long long N, int L, int D) {
    const long long rows = N * L;
    long long off = 0;
    auto take = [&](long long n) {
      float* p = base ? base + off : nullptr;
      off += (n + 31) / 32 * 32;
      return p;
    };
    const long long rc = rows * C;
    n2 = take(rc); xh2 = take(rc); rs2 = take(rows);
    qkv = take(rows * 3 * C); ctx = take(rc); ga = take(rows * 2 * C);
    dcomb = take(rc); da = take(rc); dglin = take(rc); dctx = take(rc);
    dqkv = take(rows * 3 * C); dn2 = take(rc); ds = take(rc); dgt = take(rc);
    n1 = take(rc); xh1 = take(rc); rs1 = take(rows);
    xp = take(rows * D * 3 * C); K = take((long long)D * rows * 5 * C);
    hpv = take((long long)D * rc); dxp = take(rows * D * 3 * C);
    dhp = take(rows * D * 3 * C); dn1 = take(rc);
    partial = take((long long)WG_MAX_BLOCKS * WG_MAXK * WG_THREADS);
    // The step walk's carry (C = 512: one slot of 512), 2 x [D, N, C].
    carry = C > 256 ? take(2 * (long long)D * N * C) : nullptr;
    total = off;
  }
};

// ===========================================================================
// bf16 mode on tensor cores (lct_ftf_backward_bf16).
// ===========================================================================
namespace tc {

constexpr int RT = 4 * 32;          // threads of the row-tile kernels
constexpr int MAX_ROW_BLOCKS = 1024;  // cap of a row-tile kernel's grid
constexpr int WG_BLOCKS = 528;        // cap of wgrad_tc_kernel's grid
constexpr int WG_UNITS = 12;          // 16x16 output units per warp, at most
constexpr int WG_LDA = C + 8, WG_LDB = 3 * C + 8;
// Rows of a staged tile pair of wgrad_tc_kernel: 64, at C = 256 32 (two
// stages of 64 rows would take 266 KB), at C = 512 16.
constexpr int WG_ROWS = C > 256 ? 16 : C > 128 ? 32 : 64;
constexpr int WG_STAGE = WG_ROWS * (WG_LDA + WG_LDB);  // bf16 per tile pair
// Products a wgrad_tc_kernel launch takes (C = 128 splits its larger
// products into pieces of at most 4 WG_UNITS units; C = 256's pieces, up
// to 98 of them, go in several launches of at most WG_MAXP).
constexpr int WG_MAXP = C > 64 ? 32 : 8;
// Pieces in all. C = 512's, for a frequency block (two Linear products)
// in 16-row pieces: the Linear 2 x 32, out_w 32, in_w 2 x 32 (its 96
// units a 16-row tile in two column parts), and the GRU's ih and hh of
// both directions: slots of 16 8 (16 slots a piece), of 64 32, of 128 64,
// of 256 128, one of 512 256 (two column parts): 416 at most.
constexpr int WG_ALLP = C > 256 ? 416 : C > 128 ? 4 * WG_MAXP : WG_MAXP;
// Column sums a thread of wgrad_tc_kernel takes (3C columns at most).
constexpr int WG_CS = (3 * C + RT - 1) / RT;
// log2 of the warps of a direction in bptt_tc_kernel (C / 16).
constexpr int WPD_LOG2 = PIECES_LOG2 - 1;

// A fragment of rows r0..r0+15, cols col..col+15 of a row-major bf16 array
// in device memory; rows at or past `rows` read as zero.
__device__ __forceinline__ void ldg_a(uint32_t a[4],
                                      const __nv_bfloat16* __restrict__ p,
                                      int ld, long long r0, long long rows,
                                      int col, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const long long ra = r0 + g, rb = ra + 8;
  const unsigned* pa =
      reinterpret_cast<const unsigned*>(p + (size_t)ra * ld + col + 2 * t);
  const unsigned* pb =
      reinterpret_cast<const unsigned*>(p + (size_t)rb * ld + col + 2 * t);
  a[0] = ra < rows ? __ldg(pa) : 0u;
  a[1] = rb < rows ? __ldg(pb) : 0u;
  a[2] = ra < rows ? __ldg(pa + 4) : 0u;
  a[3] = rb < rows ? __ldg(pb + 4) : 0u;
}

// A fragment of the transpose of a row-major [k][m] bf16 tile in shared
// memory: A(m, k) = tile[k][m], m and k 0..15 from `base`.
__device__ __forceinline__ void load_at(uint32_t a[4],
                                        const __nv_bfloat16* base, int ld,
                                        int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  ldsm_x4_t(a, base + ((mi >> 1) * 8 + rr) * ld + (mi & 1) * 8);
}

// The lane's f32 values of a C-column row-major array at the C-fragment
// positions of C / 8 n8 tiles: v[nt][r] = (row r0 + g + 8r, cols nt*8 + 2t,
// +1).
__device__ __forceinline__ void ldg_c(float2 (&v)[C / 8][2],
                                      const float* __restrict__ p,
                                      long long r0, long long rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = r0 + g + 8 * r;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt)
      v[nt][r] = row < rows ? __ldg(reinterpret_cast<const float2*>(
                                  p + (size_t)row * C + nt * 8 + 2 * t))
                            : make_float2(0.f, 0.f);
  }
}

// Stores two values of one row as a bf16 pair (row < rows only).
__device__ __forceinline__ void st_pair(__nv_bfloat16* p, long long row,
                                        long long rows, int ld, int col,
                                        uint32_t v) {
  if (row < rows)
    *reinterpret_cast<uint32_t*>(p + (size_t)row * ld + col) = v;
}

// Column sums of C columns held in C-fragment layout by the 4 warps of a
// block (cs[nt][e]: column nt*8 + 2t + e, summed over the lane's rows),
// added in a fixed order (lanes, then warps) and written to out[0..C-1].
__device__ __forceinline__ void block_colsum(float (&cs)[C / 8][2],
                                             float* red, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[nt][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[warp * C + nt * 8 + 2 * lane + e] = v;
    }
  __syncthreads();
  if (threadIdx.x < C) {
    const int c = threadIdx.x;
    out[c] = ((red[c] + red[C + c]) + red[2 * C + c]) + red[3 * C + c];
  }
  __syncthreads();
}

// Row-tile kernels: persistent blocks of 4 warps over tiles of 64 rows, each
// warp owning 16 whole rows (row-wise LayerNorm needs no block barrier);
// weights staged in shared memory as bf16 once per block. Each block writes
// its column sums (bias and LayerNorm-scale gradients, in f32) as one
// partial row; reduce_tc_kernel adds the rows in block order.

// ---------------------------------------------------------------------------
// Combine layer backward on tensor cores, per 16 rows:
//   a = bf16(ctx) @ bf16(out_w) + out_b        (stored rounded: dlin_w operand)
//   comb = [bf16(g) @ bf16(lin_w[:C])] + bf16(a) @ bf16(lin_w[C or 0:]) + lin_b
//   dcomb = dout * (comb >= 0 ? 1 : 0.2)       (stored rounded)
//   dga = bf16(dcomb) @ bf16(lin_w)^T -> dg_lin (frequency block, f32), da
//   dctx = bf16(da) @ bf16(out_w)^T            (stored rounded)
// Column sums: dcomb (dlin_b), da (dout_b). lin_w and out_w serve both
// directions from one staged copy: [k][n] loads forward, [n][k] backward.
// At C = 128 the weights (104 KB as bf16) pass the 48 KB of static shared
// memory: dynamic there.
struct CombArgs {
  const __nv_bfloat16* ctx;  // [rows, C]
  const __nv_bfloat16* gb;   // [rows, C] bf16(g), lin_in == 2C only
  const float* dout;         // [rows, C]
  const float* out_w;
  const float* out_b;
  const float* lin_w;        // [lin_in, C]
  const float* lin_b;
  int lin_in;
  __nv_bfloat16* ab;         // [rows, C] out: bf16(a)
  __nv_bfloat16* dcomb;      // [rows, C] out
  __nv_bfloat16* da;         // [rows, C] out
  __nv_bfloat16* dctx;       // [rows, C] out
  float* dglin;              // [rows, C] out, lin_in == 2C only
  float* part;               // [grid, 2C] out: dlin_b, dout_b partials
  long long rows;
};

#if LCT_C <= 128  // C = 256: comb_panel_kernel
constexpr size_t COMB_SMEM =
    LCT_C > 64 ? sizeof(__nv_bfloat16) * 3 * C * LDS : 0;

__global__ void __launch_bounds__(RT) comb_bwd_tc_kernel(CombArgs a) {
#if LCT_C > 64
  extern __shared__ __align__(16) unsigned char comb_smem[];
  __nv_bfloat16* wo = reinterpret_cast<__nv_bfloat16*>(comb_smem);
  __nv_bfloat16* wl = wo + C * LDS;
#else
  __shared__ __align__(16) __nv_bfloat16 wo[C * LDS];
  __shared__ __align__(16) __nv_bfloat16 wl[2 * C * LDS];
#endif
  __shared__ float red[4 * C];
  stage_weight(wo, LDS, a.out_w, C, C);
  stage_weight(wl, LDS, a.lin_w, a.lin_in, C);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool freq = a.lin_in == 2 * C;
  const long long rows = a.rows;
  float cs_dc[C / 8][2] = {}, cs_da[C / 8][2] = {};
  const long long tiles = (rows + 63) / 64;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * 64 + warp * 16;
    if (r0 >= rows) continue;
    uint32_t ca[C / 16][4];
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) ldg_a(ca[kk], a.ctx, C, r0, rows, kk * 16, lane);
    float acc[C / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        uint32_t wf[4];
        load_b_kn(wf, wo + kk * 16 * LDS + np * 16, LDS, lane);
        mma(acc[2 * np], ca[kk], wf[0], wf[1]);
        mma(acc[2 * np + 1], ca[kk], wf[2], wf[3]);
      }
    uint32_t aa[C / 16][4];
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float b0 = __ldg(a.out_b + col), b1 = __ldg(a.out_b + col + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t v =
            pack_bf16(acc[nt][2 * r] + b0, acc[nt][2 * r + 1] + b1);
        aa[nt >> 1][2 * (nt & 1) + r] = v;
        st_pair(a.ab, r0 + g + 8 * r, rows, C, col, v);
      }
    }
    float cb[C / 8][4] = {};
    const __nv_bfloat16* wla = wl;
    if (freq) {
      uint32_t gf[C / 16][4];
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        ldg_a(gf[kk], a.gb, C, r0, rows, kk * 16, lane);
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
    // dcomb, rounded: the A fragments of dga.
    uint32_t dc[C / 16][4];
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float b0 = __ldg(a.lin_b + col), b1 = __ldg(a.lin_b + col + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = r0 + g + 8 * r;
        const float2 dv =
            row < rows ? __ldg(reinterpret_cast<const float2*>(
                             a.dout + (size_t)row * C + col))
                       : make_float2(0.f, 0.f);
        const float d0 = dv.x * (cb[nt][2 * r] + b0 >= 0.f ? 1.f : 0.2f);
        const float d1 = dv.y * (cb[nt][2 * r + 1] + b1 >= 0.f ? 1.f : 0.2f);
        cs_dc[nt][0] += d0;
        cs_dc[nt][1] += d1;
        const uint32_t v = pack_bf16(d0, d1);
        dc[nt >> 1][2 * (nt & 1) + r] = v;
        st_pair(a.dcomb, row, rows, C, col, v);
      }
    }
    // dga = dcomb @ lin_w^T: B(k = j, n = m) = lin_w[m][j], a [n][k] load.
    // Frequency block: columns 0..C-1 are dg_lin, C..2C-1 da.
    if (freq) {
      float gl[C / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
        for (int np = 0; np < C / 16; ++np) {
          uint32_t wf[4];
          load_b_nk(wf, wl + np * 16 * LDS + kk * 16, LDS, lane);
          mma(gl[2 * np], dc[kk], wf[0], wf[1]);
          mma(gl[2 * np + 1], dc[kk], wf[2], wf[3]);
        }
#pragma unroll
      for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = r0 + g + 8 * r;
          if (row < rows)
            *reinterpret_cast<float2*>(a.dglin + (size_t)row * C + nt * 8 +
                                       2 * t) =
                make_float2(gl[nt][2 * r], gl[nt][2 * r + 1]);
        }
    }
    const __nv_bfloat16* wld = freq ? wl + C * LDS : wl;
    float dd[C / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        uint32_t wf[4];
        load_b_nk(wf, wld + np * 16 * LDS + kk * 16, LDS, lane);
        mma(dd[2 * np], dc[kk], wf[0], wf[1]);
        mma(dd[2 * np + 1], dc[kk], wf[2], wf[3]);
      }
    uint32_t dr[C / 16][4];
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        cs_da[nt][0] += dd[nt][2 * r];
        cs_da[nt][1] += dd[nt][2 * r + 1];
        const uint32_t v = pack_bf16(dd[nt][2 * r], dd[nt][2 * r + 1]);
        dr[nt >> 1][2 * (nt & 1) + r] = v;
        st_pair(a.da, r0 + g + 8 * r, rows, C, nt * 8 + 2 * t, v);
      }
    // dctx = da @ out_w^T: B(k = c', n = c) = out_w[c][c'].
    float dx[C / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        uint32_t wf[4];
        load_b_nk(wf, wo + np * 16 * LDS + kk * 16, LDS, lane);
        mma(dx[2 * np], dr[kk], wf[0], wf[1]);
        mma(dx[2 * np + 1], dr[kk], wf[2], wf[3]);
      }
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        st_pair(a.dctx, r0 + g + 8 * r, rows, C, nt * 8 + 2 * t,
                pack_bf16(dx[nt][2 * r], dx[nt][2 * r + 1]));
  }
  float* out = a.part + (size_t)blockIdx.x * 2 * C;
  block_colsum(cs_dc, red, out);
  block_colsum(cs_da, red, out + C);
}
#endif

// ---------------------------------------------------------------------------
// The qkv projection and LN2 backward, per 16 rows:
//   dn2 = dqkv @ bf16(in_w)^T                   (3C / 16 k-steps of 16)
//   xh2 = (s - mu) rstd from s = x + g          (LN2 recomputed, f32)
//   ds = dout + rstd (dxh - mean(dxh) - xh2 mean(dxh xh2)),  dxh = dn2 ln2_s
// Writes ds (f32), bf16(n2) = bf16(xh2 ln2_s + ln2_b), the din_w operand,
// and bf16(n1) = bf16(LN1(x)), the GRU stage's input operand (row-wise, so
// it costs the recurrence nothing). Column sums: dn2 xh2 (dln2_s), dn2
// (dln2_b).
struct Dn2Args {
  const __nv_bfloat16* dqkv;  // [rows, 3C]
  const float* s;             // [rows, C]
  const float* dout;
  const float* x;
  const float* in_w;          // [C, 3C]
  const float* ln_s;
  const float* ln_b;
  const float* ln1_s;
  const float* ln1_b;
  __nv_bfloat16* n2;          // [rows, C] out
  __nv_bfloat16* n1;          // [rows, C] out
  float* ds;                  // [rows, C] out
  float* part;                // [grid, 2C] out: dln2_s, dln2_b partials
  long long rows;
  float inv_c;                // 1 / the true channel count
};

// LayerNorm statistics of the two rows a lane holds (C-fragment layout),
// proj_kernel's fast-variance arithmetic: max(E[x^2] - mu^2, 0), eps 1e-6,
// over the 1 / inv_c true channels (a padded one holds 0).
__device__ __forceinline__ void ln_stats(float2 (&v)[C / 8][2], float mu[2],
                                         float rs[2], float inv_c) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      s += v[nt][r].x + v[nt][r].y;
      q += v[nt][r].x * v[nt][r].x + v[nt][r].y * v[nt][r].y;
    }
    mu[r] = quad_sum(s) * inv_c;
    const float ms = quad_sum(q) * inv_c;
    rs[r] = rsqrtf(fmaxf(ms - mu[r] * mu[r], 0.f) + 1e-6f);
  }
}

// LayerNorm backward of the lane's two rows: returns in d the values
// rstd (dxh - mean(dxh) - xh mean(dxh xh)), dxh = dy * scale, the means
// over the 1 / inv_c true channels (a padded channel's scale is 0), and
// adds dy * xh, dy to the column sums.
__device__ __forceinline__ void ln_bwd_rows(float (&dy)[C / 8][4],
                                            float2 (&v)[C / 8][2],
                                            const float mu[2],
                                            const float rs[2],
                                            const float* __restrict__ scale,
                                            float (&cs_s)[C / 8][2],
                                            float (&cs_b)[C / 8][2], int t,
                                            float inv_c) {
  float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    const float s0 = __ldg(scale + col), s1 = __ldg(scale + col + 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x0 = (v[nt][r].x - mu[r]) * rs[r];
      const float x1 = (v[nt][r].y - mu[r]) * rs[r];
      const float y0 = dy[nt][2 * r], y1 = dy[nt][2 * r + 1];
      cs_s[nt][0] += y0 * x0;
      cs_s[nt][1] += y1 * x1;
      cs_b[nt][0] += y0;
      cs_b[nt][1] += y1;
      m1[r] += y0 * s0 + y1 * s1;
      m2[r] += y0 * s0 * x0 + y1 * s1 * x1;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m1[r] = quad_sum(m1[r]) * inv_c;
    m2[r] = quad_sum(m2[r]) * inv_c;
  }
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    const float s0 = __ldg(scale + col), s1 = __ldg(scale + col + 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x0 = (v[nt][r].x - mu[r]) * rs[r];
      const float x1 = (v[nt][r].y - mu[r]) * rs[r];
      dy[nt][2 * r] = rs[r] * (dy[nt][2 * r] * s0 - m1[r] - x0 * m2[r]);
      dy[nt][2 * r + 1] =
          rs[r] * (dy[nt][2 * r + 1] * s1 - m1[r] - x1 * m2[r]);
    }
  }
}

#if LCT_C <= 128  // C = 256: dn_panel_kernel
constexpr size_t DN2_SMEM = LCT_C > 64 ? sizeof(__nv_bfloat16) * C * LDW : 0;

__global__ void __launch_bounds__(RT) dn2_tc_kernel(Dn2Args a) {
#if LCT_C > 64
  extern __shared__ __align__(16) unsigned char dn2_smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(dn2_smem);
#else
  __shared__ __align__(16) __nv_bfloat16 ws[C * LDW];
#endif
  __shared__ float red[4 * C];
  stage_weight(ws, LDW, a.in_w, C, 3 * C);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long rows = a.rows;
  float cs_s[C / 8][2] = {}, cs_b[C / 8][2] = {};
  const long long tiles = (rows + 63) / 64;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * 64 + warp * 16;
    if (r0 >= rows) continue;
    float acc[C / 8][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < 3 * C / 16; ++kk) {
      uint32_t af[4];
      ldg_a(af, a.dqkv, 3 * C, r0, rows, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        uint32_t wf[4];
        load_b_nk(wf, ws + np * 16 * LDW + kk * 16, LDW, lane);
        mma(acc[2 * np], af, wf[0], wf[1]);
        mma(acc[2 * np + 1], af, wf[2], wf[3]);
      }
    }
    float2 sv[C / 8][2];
    ldg_c(sv, a.s, r0, rows, lane);
    float mu[2], rs[2];
    ln_stats(sv, mu, rs, a.inv_c);
    ln_bwd_rows(acc, sv, mu, rs, a.ln_s, cs_s, cs_b, t, a.inv_c);
#if LCT_C == 64
    float2 dv[C / 8][2];
    ldg_c(dv, a.dout, r0, rows, lane);
#endif
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float s0 = __ldg(a.ln_s + col), s1 = __ldg(a.ln_s + col + 1);
      const float b0 = __ldg(a.ln_b + col), b1 = __ldg(a.ln_b + col + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = r0 + g + 8 * r;
        if (row >= rows) continue;
#if LCT_C == 64
        const float2 d2 = dv[nt][r];
#else
        // Loaded where it is used: C / 8 float2 pairs fewer live registers.
        const float2 d2 = __ldg(
            reinterpret_cast<const float2*>(a.dout + (size_t)row * C + col));
#endif
        *reinterpret_cast<float2*>(a.ds + (size_t)row * C + col) =
            make_float2(d2.x + acc[nt][2 * r], d2.y + acc[nt][2 * r + 1]);
        const float x0 = (sv[nt][r].x - mu[r]) * rs[r];
        const float x1 = (sv[nt][r].y - mu[r]) * rs[r];
        *reinterpret_cast<uint32_t*>(a.n2 + (size_t)row * C + col) =
            pack_bf16(x0 * s0 + b0, x1 * s1 + b1);
      }
    }
    ldg_c(sv, a.x, r0, rows, lane);
    ln_stats(sv, mu, rs, a.inv_c);
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float s0 = __ldg(a.ln1_s + col), s1 = __ldg(a.ln1_s + col + 1);
      const float b0 = __ldg(a.ln1_b + col), b1 = __ldg(a.ln1_b + col + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        st_pair(a.n1, r0 + g + 8 * r, rows, C, col,
                pack_bf16((sv[nt][r].x - mu[r]) * rs[r] * s0 + b0,
                          (sv[nt][r].y - mu[r]) * rs[r] * s1 + b1));
    }
  }
  float* out = a.part + (size_t)blockIdx.x * 2 * C;
  block_colsum(cs_s, red, out);
  block_colsum(cs_b, red, out + C);
}
#endif

// ---------------------------------------------------------------------------
// The input projection and LN1 backward, per 16 rows, over GRU slots of W
// = 16 KS units (KS = 1: C / 16 slots of 16; else dense slots of W: one of
// C, or at C = 128 two of 64 (KS = 4) or one of 128 (KS = 8)):
//   dn1[:, g*W + i] = sum_d bf16(dxp[:, d, g, :]) @ bf16(W_ih[d, g])^T
//   dx = ds + rstd (dxh - mean(dxh) - xh1 mean(dxh xh1)), dxh = dn1 ln1_s
// LN1 recomputed from x. Column sums: dn1 xh1 (dln1_s), dn1 (dln1_b).
// W_ih is staged as bf16 [D*C][3W + 8]: static shared memory for KS = 1
// (14 KB at C = 64), dynamic for dense slots (51 KB at C = 64, up to 196
// KB at KS = 8; dn1_smem).
struct Dn1Args {
  const __nv_bfloat16* dxp;  // [rows, D*3C]
  const float* x;
  const float* ds;
  const float* w_ih;         // slots [D, C/W, W, 3W]
  const float* ln_s;
  float* dx;                 // [rows, C] out
  float* part;               // [grid, 2C] out: dln1_s, dln1_b partials
  long long rows;
  int D;
  float inv_c;               // 1 / the true channel count
};

template <int KS>
__host__ __device__ constexpr int dn1_ldi() { return 3 * 16 * KS + 8; }

template <int KS>
inline size_t dn1_smem() {
  return KS == 1 ? 0 : (size_t)2 * C * dn1_ldi<KS>() * sizeof(__nv_bfloat16);
}

template <int KS>
__global__ void __launch_bounds__(RT) dn1_tc_kernel(Dn1Args a) {
  constexpr int W = 16 * KS, S = C / W, LDI = dn1_ldi<KS>();
  __nv_bfloat16* wi;
  if constexpr (KS == 1) {
    __shared__ __align__(16) __nv_bfloat16 wst[2 * C * LDI];
    wi = wst;
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    wi = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  }
  __shared__ float red[4 * C];
  const int D = a.D;
  stage_weight(wi, LDI, a.w_ih, D * C, 3 * W);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long rows = a.rows;
  float cs_s[C / 8][2] = {}, cs_b[C / 8][2] = {};
  const long long tiles = (rows + 63) / 64;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * 64 + warp * 16;
    if (r0 >= rows) continue;
    // n tile 2 (slot KS + np) + jh holds columns slot*W + np*16 + 8 jh ..
    // (dn1's layout).
    float acc[C / 8][4] = {};
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int sl = 0; sl < S; ++sl)
#pragma unroll
        for (int kk = 0; kk < 3 * KS; ++kk) {
          uint32_t af[4];
          ldg_a(af, a.dxp, D * 3 * C, r0, rows,
                d * 3 * C + sl * 3 * W + kk * 16, lane);
#pragma unroll
          for (int np = 0; np < KS; ++np) {
            // B(k = m, n = i) = W_ih[d, slot][i][m], a [n][k] load.
            uint32_t wf[4];
            load_b_nk(wf, wi + ((d * S + sl) * W + np * 16) * LDI + kk * 16,
                      LDI, lane);
            mma(acc[2 * (sl * KS + np)], af, wf[0], wf[1]);
            mma(acc[2 * (sl * KS + np) + 1], af, wf[2], wf[3]);
          }
        }
    float2 xv[C / 8][2];
    ldg_c(xv, a.x, r0, rows, lane);
    float mu[2], rs[2];
    ln_stats(xv, mu, rs, a.inv_c);
    ln_bwd_rows(acc, xv, mu, rs, a.ln_s, cs_s, cs_b, t, a.inv_c);
#if LCT_C == 64
    float2 dv[C / 8][2];
    ldg_c(dv, a.ds, r0, rows, lane);
#endif
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = r0 + g + 8 * r;
#if LCT_C == 64
        if (row < rows)
          *reinterpret_cast<float2*>(a.dx + (size_t)row * C + nt * 8 + 2 * t) =
              make_float2(dv[nt][r].x + acc[nt][2 * r],
                          dv[nt][r].y + acc[nt][2 * r + 1]);
#else
        // ds loaded where it is used, as in dn2_tc_kernel.
        if (row < rows) {
          float2* o = reinterpret_cast<float2*>(a.dx + (size_t)row * C +
                                                nt * 8 + 2 * t);
          const float2 d2 = __ldg(reinterpret_cast<const float2*>(
              a.ds + (size_t)row * C + nt * 8 + 2 * t));
          *o = make_float2(d2.x + acc[nt][2 * r], d2.y + acc[nt][2 * r + 1]);
        }
#endif
      }
  }
  float* out = a.part + (size_t)blockIdx.x * 2 * C;
  block_colsum(cs_s, red, out);
  block_colsum(cs_b, red, out + C);
}

#if LCT_C > 128
// ---------------------------------------------------------------------------
// C = 256's combine-layer backward: comb_bwd_tc_kernel's function, outputs
// and rounding points. out_w and lin_w are 405 KB as bf16, and a warp's
// C-column rows would hold 128 accumulators a product, so, as tc.cuh's
// epi_kernel serves the forward, a block takes tiles of 128 rows (8 warps
// of 16) and streams the weights through shared memory in panels of 64
// output columns, keeping the tile's bf16(a), later bf16(da), and
// bf16(dcomb) in shared memory as the next products' A operands:
//   a     = bf16(ctx) @ out_w + out_b            panels of out_w's columns
//   dcomb = dout * (comb >= 0 ? 1 : 0.2)          panels of lin_w's columns
//   dga   = bf16(dcomb) @ lin_w^T -> dg_lin, da   panels of lin_w's rows
//   dctx  = bf16(da) @ out_w^T                    panels of out_w's rows
// The bias gradients are column sums of the unrounded dcomb and da: a
// panel's over the lanes, then the warps in order, into the block's row in
// shared memory. Bound: the weights' staging, 0.75-1 MB of bf16 a tile
// from L2. C = 512 takes tiles of 32 rows (2 warps): two tiles of 64 rows
// and a lin_w panel [2C][EPI_LDW] would take 281 KB.
constexpr int CB_ROWS = C > 256 ? 32 : 128;  // rows a tile: warps of 16
constexpr int CB_THREADS = 2 * CB_ROWS;
constexpr size_t CB_SMEM =
    sizeof(__nv_bfloat16) * (2 * CB_ROWS * LDS + 2 * C * EPI_LDW) +
    sizeof(float) * (8 * 64 + 2 * C);

// Rows [m0, m0 + 64) of w [*, C] f32 as bf16 [64][LDS], by the block: the
// [n][k] operand of a product with w's transpose.
__device__ __forceinline__ void stage_row_panel(__nv_bfloat16* wp,
                                                const float* __restrict__ w,
                                                int m0) {
  for (int i = threadIdx.x; i < 64 * (C / 4); i += blockDim.x) {
    const int r = i / (C / 4), q = i % (C / 4);
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(w + (size_t)(m0 + r) * C) + q);
    uint2 pk;
    pk.x = pack_bf16(v.x, v.y);
    pk.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(wp + r * LDS + 4 * q) = pk;
  }
}

// sums[c0 + c] += the column sums of a panel's 64 columns over the block's
// rows (v: each warp's 16 rows in C-fragment layout, n8 tile nt = columns
// 8 nt ..): the lanes' two rows, the warp's 8 row groups by shuffles, then
// the warps in order through red [warps][64]. Called by the whole block.
__device__ __forceinline__ void panel_colsum(const float (&v)[8][4],
                                             float* red, float* sums,
                                             int c0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = v[nt][e] + v[nt][2 + e];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (lane < 4) red[warp * 64 + nt * 8 + 2 * lane + e] = x;
    }
  __syncthreads();
  if (threadIdx.x < 64) {
    float x = red[threadIdx.x];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) x += red[w * 64 + threadIdx.x];
    sums[c0 + threadIdx.x] += x;
  }
  __syncthreads();
}

// acc = A @ B over the C channels of A: A the warp's 16 rows of a staged
// bf16 tile (row stride LDS) at aw, B a staged [n][k] panel of 64 rows (n)
// at wp: acc's 8 n8 tiles are the panel's 64 columns.
__device__ __forceinline__ void tile_product_nk(float (&acc)[8][4],
                                                const __nv_bfloat16* aw,
                                                const __nv_bfloat16* wp,
                                                int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t af[4];
    load_a(af, aw + kk * 16, LDS, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t wf[4];
      load_b_nk(wf, wp + np * 16 * LDS + kk * 16, LDS, lane);
      mma(acc[2 * np], af, wf[0], wf[1]);
      mma(acc[2 * np + 1], af, wf[2], wf[3]);
    }
  }
}

// acc += A @ B[:, panel]: A the warp's 16 rows of a bf16 [rows][C] array in
// device memory (ldg_a: rows past the end zero), B a staged [k][n] panel of
// C rows at wp (stage_panel's layout).
__device__ __forceinline__ void rows_product_kn(float (&acc)[8][4],
                                                const __nv_bfloat16* m,
                                                long long r0, long long rows,
                                                const __nv_bfloat16* wp,
                                                int lane) {
#pragma unroll 4
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t af[4];
    ldg_a(af, m, C, r0, rows, kk * 16, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t wf[4];
      load_b_kn(wf, wp + kk * 16 * EPI_LDW + np * 16, EPI_LDW, lane);
      mma(acc[2 * np], af, wf[0], wf[1]);
      mma(acc[2 * np + 1], af, wf[2], wf[3]);
    }
  }
}

__global__ void __launch_bounds__(CB_THREADS, 1) comb_panel_kernel(CombArgs a) {
  extern __shared__ __align__(16) unsigned char comb_smem[];
  __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(comb_smem);
  __nv_bfloat16* dt = at + CB_ROWS * LDS;     // bf16(dcomb)
  __nv_bfloat16* wp = dt + CB_ROWS * LDS;     // a weight panel
  float* red = reinterpret_cast<float*>(wp + 2 * C * EPI_LDW);  // [8][64]
  float* sums = red + 8 * 64;  // [2][C]: dlin_b, dout_b
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) sums[i] = 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool freq = a.lin_in == 2 * C;
  const long long rows = a.rows;
  const long long tiles = (rows + CB_ROWS - 1) / CB_ROWS;
  __nv_bfloat16* aw = at + warp * 16 * LDS;
  __nv_bfloat16* dw = dt + warp * 16 * LDS;
  float acc[8][4];
  auto zero = [&]() {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  };
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // Every warp takes part in every barrier: rows past the end read as
    // zero and store nothing.
    const long long r0 = tile * CB_ROWS + warp * 16;
    // a = bf16(ctx) @ bf16(out_w) + out_b, stored rounded.
    for (int p = 0; p < C / 64; ++p) {
      __syncthreads();  // the previous panel's readers are done
      stage_panel(wp, a.out_w, C, 64 * p);
      __syncthreads();
      zero();
      rows_product_kn(acc, a.ctx, r0, rows, wp, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = 64 * p + nt * 8 + 2 * t;
        const float b0 = __ldg(a.out_b + col), b1 = __ldg(a.out_b + col + 1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t v =
              pack_bf16(acc[nt][2 * r] + b0, acc[nt][2 * r + 1] + b1);
          *reinterpret_cast<uint32_t*>(aw + (g + 8 * r) * LDS + col) = v;
          st_pair(a.ab, r0 + g + 8 * r, rows, C, col, v);
        }
      }
    }
    // comb = [bf16(g) @ bf16(lin_w[:C])] + bf16(a) @ bf16(lin_w[C or 0:])
    // + lin_b; dcomb = dout * slope, stored rounded.
    for (int p = 0; p < C / 64; ++p) {
      __syncthreads();
      stage_panel(wp, a.lin_w, a.lin_in, 64 * p);
      __syncthreads();
      zero();
      const __nv_bfloat16* wa = wp;
      if (freq) {
        rows_product_kn(acc, a.gb, r0, rows, wp, lane);
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
          const float2 dv =
              row < rows ? __ldg(reinterpret_cast<const float2*>(
                               a.dout + (size_t)row * C + col))
                         : make_float2(0.f, 0.f);
          const float d0 = dv.x * (acc[nt][2 * r] + b0 >= 0.f ? 1.f : 0.2f);
          const float d1 =
              dv.y * (acc[nt][2 * r + 1] + b1 >= 0.f ? 1.f : 0.2f);
          acc[nt][2 * r] = d0;
          acc[nt][2 * r + 1] = d1;
          const uint32_t v = pack_bf16(d0, d1);
          *reinterpret_cast<uint32_t*>(dw + (g + 8 * r) * LDS + col) = v;
          st_pair(a.dcomb, row, rows, C, col, v);
        }
      }
      panel_colsum(acc, red, sums, 64 * p);  // dlin_b
    }
    // dga = bf16(dcomb) @ bf16(lin_w)^T: the frequency block's first C
    // columns are dg_lin (f32), the rest (all, time block) da, stored
    // rounded over a's place.
    for (int p = 0; p < a.lin_in / 64; ++p) {
      __syncthreads();
      stage_row_panel(wp, a.lin_w, 64 * p);
      __syncthreads();
      tile_product_nk(acc, dw, wp, lane);
      const bool is_da = !freq || p >= C / 64;
      const int c0 = 64 * p - (freq && is_da ? C : 0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = c0 + nt * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = r0 + g + 8 * r;
          if (!is_da) {
            if (row < rows)
              *reinterpret_cast<float2*>(a.dglin + (size_t)row * C + col) =
                  make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
            continue;
          }
          const uint32_t v = pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(aw + (g + 8 * r) * LDS + col) = v;
          st_pair(a.da, row, rows, C, col, v);
        }
      }
      if (is_da) panel_colsum(acc, red, sums + C, c0);  // dout_b
    }
    // dctx = bf16(da) @ bf16(out_w)^T, stored rounded.
    for (int p = 0; p < C / 64; ++p) {
      __syncthreads();
      stage_row_panel(wp, a.out_w, 64 * p);
      __syncthreads();
      tile_product_nk(acc, aw, wp, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          st_pair(a.dctx, r0 + g + 8 * r, rows, C, 64 * p + nt * 8 + 2 * t,
                  pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]));
    }
  }
  __syncthreads();
  float* out = a.part + (size_t)blockIdx.x * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) out[i] = sums[i];
}

// ---------------------------------------------------------------------------
// C = 256's qkv-projection and LN2 backward (dn2_tc_kernel's function) and
// input-projection and LN1 backward (dn1_tc_kernel's): in_w and a
// direction's W_ih are 393 KB as bf16, and a warp's C-column accumulators
// and LayerNorm operands would take 256 registers. So a block takes tiles
// of 64 rows (4 warps of 16) and streams the weight's rows in panels of 64
// output channels ([64][3W + 8] bf16, a direction at a time), collecting
// the tile's f32 dn [64][C + 4] in shared memory; then each warp takes its
// 16 rows one at a time (lane l: channels l + 32 i) through the LayerNorm
// backward
//   out = base + rstd (dxh - mean(dxh) - xh mean(dxh xh)),  dxh = dn scale
// over the 1 / inv_c true channels (proj_kernel's fast-variance statistics
// of the LayerNorm's input v):
//   DN2: dn = dqkv @ bf16(in_w)^T (W = C, one "slot"), v = s, base = dout,
//        out = ds; also bf16(n2) = bf16(xh ln2_s + ln2_b) and bf16(n1) =
//        bf16(LN1(x)), the later stages' operands, as dn2_tc_kernel;
//   dn1: dn = sum_d bf16(dxp[:, d]) @ bf16(W_ih[d])^T over slots of W
//        units (block-diagonal), v = x, base = ds, out = dx.
// Column sums dn xh and dn (the LayerNorm scale and bias gradients): per
// lane, then the warps in order, one partial row per block. Bound: the
// weight panels' staging from L2 (0.8 MB a tile for dn2, 1.6 MB for a
// bidirectional slot of 256). C = 512 takes tiles of DN_ROWS = 32 rows (2
// warps; the dn tile [32][516] f32 is 66 KB), and a slot of 512 (and
// DN2's in_w) stages a panel's 3W = 1,536 k-columns in two halves
// (dn_kparts): a [64][1544] panel would take 198 KB.
struct DnArgs {
  const __nv_bfloat16* A;  // dqkv [rows, 3C] or dxp [rows, D*3C]
  const float* w;          // in_w [C][3C] or W_ih slots [D, C/W, W, 3W]
  const float* v;          // the LayerNorm's input: s or x
  const float* scale;      // its scale: ln2_s or ln1_s
  const float* base;       // dout or ds
  float* out;              // ds or dx
  const float* ln_b;       // DN2: ln2_b, and x, ln1_s, ln1_b for n1
  const float* x;
  const float* ln1_s;
  const float* ln1_b;
  __nv_bfloat16* n2;       // DN2: [rows, C] out
  __nv_bfloat16* n1;
  float* part;             // [grid, 2C] out: d scale, d bias partials
  long long rows;
  int D;
  float inv_c;             // 1 / the true channel count
};

constexpr int DN_LDT = C + 4;  // f32 row stride of the dn tile
constexpr int DN_ROWS = C > 256 ? 32 : 64;  // rows a tile: warps of 16
constexpr int DN_THREADS = 2 * DN_ROWS;

// Parts a panel's 3W k-columns are staged in.
__host__ __device__ constexpr int dn_kparts(int W) {
  return C > 256 && W > 256 ? 2 : 1;
}

template <int W>
inline size_t dn_panel_smem() {
  return sizeof(__nv_bfloat16) * 64 * (3 * W / dn_kparts(W) + 8) +
         sizeof(float) * (DN_ROWS * DN_LDT + DN_ROWS / 16 * 2 * C);
}

template <int W, bool DN2>
__global__ void __launch_bounds__(DN_THREADS, 1) dn_panel_kernel(DnArgs a) {
  constexpr int KW = 3 * W, KP = dn_kparts(W), KWP = KW / KP;
  constexpr int LDK = KWP + 8, S = C / W;
  extern __shared__ __align__(16) unsigned char dn_smem[];
  __nv_bfloat16* wst = reinterpret_cast<__nv_bfloat16*>(dn_smem);  // [64][LDK]
  float* dnt = reinterpret_cast<float*>(wst + 64 * LDK);  // [DN_ROWS][DN_LDT]
  float* red = dnt + DN_ROWS * DN_LDT;                    // [warps][2C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long rows = a.rows;
  const int D = DN2 ? 1 : a.D, lda = D * 3 * C;
  const long long tiles = (rows + DN_ROWS - 1) / DN_ROWS;
  float cs_s[CPL] = {}, cs_b[CPL] = {};
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // Every warp takes part in every barrier (rows past the end read as
    // zero and store nothing).
    const long long r0 = tile * DN_ROWS + warp * 16;
    for (int p = 0; p < C / 64; ++p) {
      const int c0 = 64 * p;
      float acc[8][4] = {};
      for (int dk = 0; dk < D * KP; ++dk) {
        const int d = dk / KP, kp = dk % KP;  // direction, k-part
        __syncthreads();  // the previous panel's readers are done
        // Row i: output channel c0 + i's weights over its slot's 3W inputs
        // (k-part kp of them).
        for (int i = threadIdx.x; i < 64 * (KWP / 4); i += blockDim.x) {
          const int r = i / (KWP / 4), q = i % (KWP / 4), c = c0 + r;
          const float4 v = __ldg(reinterpret_cast<const float4*>(
                                     a.w + ((size_t)(d * S + c / W) * W +
                                            c % W) * KW + kp * KWP) + q);
          uint2 pk;
          pk.x = pack_bf16(v.x, v.y);
          pk.y = pack_bf16(v.z, v.w);
          *reinterpret_cast<uint2*>(wst + r * LDK + 4 * q) = pk;
        }
        __syncthreads();
        if constexpr (W >= 64) {  // the panel lies in one slot
          const int colb = d * 3 * C + c0 / W * KW + kp * KWP;
#pragma unroll 4
          for (int kk = 0; kk < KWP / 16; ++kk) {
            uint32_t af[4];
            ldg_a(af, a.A, lda, r0, rows, colb + kk * 16, lane);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              uint32_t wf[4];
              load_b_nk(wf, wst + np * 16 * LDK + kk * 16, LDK, lane);
              mma(acc[2 * np], af, wf[0], wf[1]);
              mma(acc[2 * np + 1], af, wf[2], wf[3]);
            }
          }
        } else {  // slots of 16: each 16 channels its own slot
#pragma unroll
          for (int np = 0; np < 4; ++np)
#pragma unroll
            for (int kk = 0; kk < KW / 16; ++kk) {
              uint32_t af[4], wf[4];
              ldg_a(af, a.A, lda, r0, rows,
                    d * 3 * C + (c0 / W + np) * KW + kk * 16, lane);
              load_b_nk(wf, wst + np * 16 * LDK + kk * 16, LDK, lane);
              mma(acc[2 * np], af, wf[0], wf[1]);
              mma(acc[2 * np + 1], af, wf[2], wf[3]);
            }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(
              dnt + (warp * 16 + g + 8 * r) * DN_LDT + c0 + nt * 8 + 2 * t) =
              make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
    __syncwarp();  // the warp's own rows of dnt are whole
    for (int i = 0; i < 16; ++i) {
      const long long row = r0 + i;
      if (row >= rows) break;
      const float* dr = dnt + (warp * 16 + i) * DN_LDT + lane;
      const size_t o = (size_t)row * C + lane;
      float dn[CPL], xh[CPL], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        dn[k] = dr[32 * k];
        xh[k] = __ldg(a.v + o + 32 * k);
        s1 += xh[k];
        s2 += xh[k] * xh[k];
      }
      const float mu = warp_sum(s1) * a.inv_c;
      const float ms = warp_sum(s2) * a.inv_c;
      const float rs = rsqrtf(fmaxf(ms - mu * mu, 0.f) + 1e-6f);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        xh[k] = (xh[k] - mu) * rs;
        const float dxh = dn[k] * __ldg(a.scale + lane + 32 * k);
        m1 += dxh;
        m2 += dxh * xh[k];
        cs_s[k] += dn[k] * xh[k];
        cs_b[k] += dn[k];
      }
      m1 = warp_sum(m1) * a.inv_c;
      m2 = warp_sum(m2) * a.inv_c;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const float dxh = dn[k] * __ldg(a.scale + lane + 32 * k);
        a.out[o + 32 * k] =
            __ldg(a.base + o + 32 * k) + rs * (dxh - m1 - xh[k] * m2);
      }
      if constexpr (DN2) {
        float xv[CPL];
        s1 = s2 = 0.f;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = lane + 32 * k;
          a.n2[o + 32 * k] = __float2bfloat16_rn(
              xh[k] * __ldg(a.scale + c) + __ldg(a.ln_b + c));
          xv[k] = __ldg(a.x + o + 32 * k);
          s1 += xv[k];
          s2 += xv[k] * xv[k];
        }
        const float mu1 = warp_sum(s1) * a.inv_c;
        const float ms1 = warp_sum(s2) * a.inv_c;
        const float rs1 = rsqrtf(fmaxf(ms1 - mu1 * mu1, 0.f) + 1e-6f);
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = lane + 32 * k;
          a.n1[o + 32 * k] = __float2bfloat16_rn(
              (xv[k] - mu1) * rs1 * __ldg(a.ln1_s + c) + __ldg(a.ln1_b + c));
        }
      }
    }
  }
  // Column sums: the warps' rows in order.
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    red[warp * 2 * C + lane + 32 * k] = cs_s[k];
    red[warp * 2 * C + C + lane + 32 * k] = cs_b[k];
  }
  __syncthreads();
  float* out = a.part + (size_t)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
    float v = red[c];
#pragma unroll
    for (int w = 1; w < DN_ROWS / 16; ++w) v += red[w * 2 * C + c];
    out[c] = v;
  }
}

template <int W, bool DN2>
cudaError_t launch_dn_panel(const DnArgs& a, int grid, cudaStream_t st) {
  const size_t smem = dn_panel_smem<W>();
  cudaError_t e = allow_smem(dn_panel_kernel<W, DN2>, smem);
  if (e != cudaSuccess) return e;
  dn_panel_kernel<W, DN2><<<grid, DN_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// bf16 mode, the gate factors of one dense GRU slot of C = 256 units for
// every step at once, before bptt_cluster_kernel walks the carry: per row
// and direction
//   xp = bf16(n1) @ bf16(W_ih) + b_ih, hp = bf16(h_prev) @ bf16(W_hh) + b_hh
// on tensor cores, the gates as bptt_tc_kernel forms them (sigmoid and tanh
// on the special-function unit), then K1..K5 as gate_kernel writes them,
// and bf16(h_prev) (h_prev: the saved hidden one step back in the forward's
// order, 0 at the sequence's start). A block takes one direction
// (blockIdx.y) and GT_U = 64 units (blockIdx.z): their three gate columns
// of W_ih and W_hh staged as bf16 [C][GT_LD] (2 x 100 KB); persistent over
// tiles of 64 rows, each of 4 warps 16 rows, 16 units at a time. Scratch:
// K is [D, N*L, 5C] f32, 2.79 GB at the B = 64 x 2 s shapes (272,448 rows,
// D = 2), written once and read once by the walk: the price of taking the
// products off the recurrence's chain. At C = 512 a slot is of sw = 256
// (two slots) or 512 units (GateArgs::sw), and a block GT_U = 32 of its
// units (blockIdx.z: 32-unit panels over all C channels): the slot's sw
// input rows staged, 2 x 512 x 104 x 2 = 208 KB at sw = 512. K at the
// frequency block's B = 64 x 2 s shape: 5.58 GB.
constexpr int GT_U = C > 256 ? 32 : 64;
constexpr int GT_LD = 3 * GT_U + 8;
// Shared memory of a block over a slot of sw units.
inline size_t gate_tc_smem(int sw) {
  return (size_t)2 * sw * GT_LD * sizeof(__nv_bfloat16);
}
constexpr size_t GT_SMEM = (size_t)2 * C * GT_LD * sizeof(__nv_bfloat16);

struct GateArgs {
  const __nv_bfloat16* n1;  // [N*L, C] bf16(LN1(x))
  const float* hid;         // [D, N*L, C]
  const float* w_ih;        // slots [D, C/sw, sw, 3sw]
  const float* w_hh;
  const float* b_ih;        // [D, C/sw, 3sw]
  const float* b_hh;
  float* K;                 // [D, N*L, 5C] out
  __nv_bfloat16* hprev;     // [D, N*L, C] out
  long long N;
  int L;
#if LCT_C > 256
  int sw;                   // units a slot: 256 or 512
#endif
};

__global__ void __launch_bounds__(RT, 1) gate_tc_kernel(GateArgs a) {
  extern __shared__ __align__(16) unsigned char gate_smem[];
  __nv_bfloat16* wi = reinterpret_cast<__nv_bfloat16*>(gate_smem);
#if LCT_C > 256
  // A slot of sw units (256 or 512): the block's GT_U units from su0 in
  // slot sl, whose inputs are channels [k0, k0 + sw).
  const int sw = a.sw;
  __nv_bfloat16* wh = wi + sw * GT_LD;  // both [sw][GT_LD]
  const int d = blockIdx.y, u0 = blockIdx.z * GT_U;
  const int sl = u0 / sw, su0 = u0 % sw, k0 = sl * sw;
#else
  __nv_bfloat16* wh = wi + C * GT_LD;  // both [C][GT_LD]
  const int d = blockIdx.y, u0 = blockIdx.z * GT_U;
#endif
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = a.L;
  const long long rows = a.N * L;
#if LCT_C > 256
  const size_t slot = (size_t)d * (C / sw) + sl;
  // Column q GT_U + j of the staged tiles: gate q of unit su0 + j.
  for (int i = threadIdx.x; i < sw * 3 * GT_U; i += blockDim.x) {
    const int k = i / (3 * GT_U), c = i % (3 * GT_U);
    const size_t src =
        (slot * sw + k) * 3 * sw + (c / GT_U) * sw + su0 + c % GT_U;
#else
  // Column q GT_U + j of the staged tiles: gate q of unit u0 + j.
  for (int i = threadIdx.x; i < C * 3 * GT_U; i += blockDim.x) {
    const int k = i / (3 * GT_U), c = i % (3 * GT_U);
    const size_t src =
        ((size_t)d * C + k) * 3 * C + (c / GT_U) * C + u0 + c % GT_U;
#endif
    wi[k * GT_LD + c] = __float2bfloat16_rn(__ldg(a.w_ih + src));
    wh[k * GT_LD + c] = __float2bfloat16_rn(__ldg(a.w_hh + src));
  }
  __syncthreads();
  const float* hd = a.hid + (size_t)d * rows * C;
#if LCT_C > 256
  const float* bi = a.b_ih + slot * 3 * sw;
  const float* bh = a.b_hh + slot * 3 * sw;
#else
  const float* bi = a.b_ih + (size_t)d * 3 * C;
  const float* bh = a.b_hh + (size_t)d * 3 * C;
#endif
  const long long tiles = (rows + 63) / 64;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * 64 + warp * 16;
    if (r0 >= rows) continue;  // no barrier below
    // The lane's rows g, g + 8 and their h_prev rows.
    long long prow[2];
    bool hasp[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long long row = r0 + g + 8 * rr;
      const int tt = (int)(row % L);
      hasp[rr] = row < rows && (d ? tt < L - 1 : tt > 0);
      prow[rr] = d ? row + 1 : row - 1;
    }
    for (int sp = 0; sp < GT_U / 16; ++sp) {
#if LCT_C > 256
      const int ub = u0 + sp * 16;  // the 16 units' first (a channel)
      const int bb = su0 + sp * 16;  // the same in the slot
      float ar[2][4], az[2][4], xn[2][4], hn[2][4];
#pragma unroll
      for (int jh = 0; jh < 2; ++jh)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = bb + 8 * jh + 2 * t + (e & 1);
          ar[jh][e] = bi[u] + bh[u];
          az[jh][e] = bi[sw + u] + bh[sw + u];
          xn[jh][e] = bi[2 * sw + u];
          hn[jh][e] = bh[2 * sw + u];
        }
#pragma unroll 2
      for (int kk = 0; kk < sw / 16; ++kk) {
        uint32_t ax[4], ah[4];
        ldg_a(ax, a.n1, C, r0, rows, k0 + kk * 16, lane);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float2 h = make_float2(0.f, 0.f);
            if (hasp[rr])
              h = __ldg(reinterpret_cast<const float2*>(
                  hd + (size_t)prow[rr] * C + k0 + kk * 16 + 8 * hf +
                  2 * t));
            ah[2 * hf + rr] = pack_bf16(h.x, h.y);
          }
#else
      const int ub = u0 + sp * 16;  // the 16 units' first
      float ar[2][4], az[2][4], xn[2][4], hn[2][4];
#pragma unroll
      for (int jh = 0; jh < 2; ++jh)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = ub + 8 * jh + 2 * t + (e & 1);
          ar[jh][e] = bi[u] + bh[u];
          az[jh][e] = bi[C + u] + bh[C + u];
          xn[jh][e] = bi[2 * C + u];
          hn[jh][e] = bh[2 * C + u];
        }
#pragma unroll 2
      for (int kk = 0; kk < C / 16; ++kk) {
        uint32_t ax[4], ah[4];
        ldg_a(ax, a.n1, C, r0, rows, kk * 16, lane);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float2 h = make_float2(0.f, 0.f);
            if (hasp[rr])
              h = __ldg(reinterpret_cast<const float2*>(
                  hd + (size_t)prow[rr] * C + kk * 16 + 8 * hf + 2 * t));
            ah[2 * hf + rr] = pack_bf16(h.x, h.y);
          }
#endif
        const int col = sp * 16;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          uint32_t fi[4], fh[4];
          load_b_kn(fi, wi + kk * 16 * GT_LD + q * GT_U + col, GT_LD, lane);
          load_b_kn(fh, wh + kk * 16 * GT_LD + q * GT_U + col, GT_LD, lane);
          float (&xa)[2][4] = q == 0 ? ar : q == 1 ? az : xn;
          float (&ha)[2][4] = q == 0 ? ar : q == 1 ? az : hn;
          mma(xa[0], ax, fi[0], fi[1]);
          mma(xa[1], ax, fi[2], fi[3]);
          mma(ha[0], ah, fh[0], fh[1]);
          mma(ha[1], ah, fh[2], fh[3]);
        }
      }
#pragma unroll
      for (int jh = 0; jh < 2; ++jh)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const long long row = r0 + g + 8 * rr;
          if (row >= rows) continue;
          const int u = ub + 8 * jh + 2 * t;
          const float2 hv =
              hasp[rr] ? __ldg(reinterpret_cast<const float2*>(
                             hd + (size_t)prow[rr] * C + u))
                       : make_float2(0.f, 0.f);
          float k[5][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * rr + e;
            const float r = sigmoid_sfu(ar[jh][i]);
            const float z = sigmoid_sfu(az[jh][i]);
            const float nn = tanh_sfu(fmaf(r, hn[jh][i], xn[jh][i]));
            const float P = (1.f - z) * (1.f - nn * nn);
            k[0][e] = P * hn[jh][i] * r * (1.f - r);
            k[1][e] = ((e ? hv.y : hv.x) - nn) * z * (1.f - z);
            k[2][e] = P * r;
            k[3][e] = P;
            k[4][e] = z;
          }
          float* kp = a.K + ((size_t)d * rows + row) * 5 * C + u;
#pragma unroll
          for (int f = 0; f < 5; ++f)
            *reinterpret_cast<float2*>(kp + f * C) =
                make_float2(k[f][0], k[f][1]);
          *reinterpret_cast<uint32_t*>(a.hprev + ((size_t)d * rows + row) *
                                                     C + u) =
              pack_bf16(hv.x, hv.y);
        }
    }
  }
}

inline cudaError_t launch_gate_tc(const GateArgs& a, int D, cudaStream_t st) {
#if LCT_C > 256
  const size_t smem = gate_tc_smem(a.sw);
#else
  const size_t smem = GT_SMEM;
#endif
  cudaError_t e = allow_smem(gate_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (a.N * a.L + 63) / 64;
  const int per = D * (C / GT_U);  // blocks of one row range
  unsigned grid = 1;
  e = persistent_grid(gate_tc_kernel, RT, smem, tiles * per, &grid);
  if (e != cudaSuccess) return e;
  long long gx = ((long long)grid + per - 1) / per;
  if (gx > tiles) gx = tiles;
  if (gx < 1) gx = 1;
  gate_tc_kernel<<<dim3((unsigned)gx, (unsigned)D, (unsigned)(C / GT_U)), RT,
                   smem, st>>>(a);
  return cudaGetLastError();
}
#endif

// ---------------------------------------------------------------------------
// The GRU backward on tensor cores: the input and hidden projections, the
// gate factors and BPTT in one pass. A block takes 16 sequences; with P =
// C / 16 warps a direction, warp w runs direction w / P and the 16 units
// 16 (w % P) .. over them, walking the steps in the order opposite to the
// forward's (descending for direction 0). KS = 1: slots of 16 units, warp
// w's units are slot w % P.
// Per step, with the 16 sequences as the M rows of one m16n8k16 tile:
//   xp, hp   bf16(n1_t) @ bf16(W_ih), bf16(h_prev) @ bf16(W_hh)  12 products
//            (h_prev: the saved hidden one step back in the forward's order,
//            0 at the sequence's start), gates as gru_tc_kernel forms them
//   K1 = P hp_n r(1-r), K2 = (h_prev - n) z(1-z), K3 = P r, P = (1-z)(1-n^2)
//   dh  = carry + dg_t,  dg = ds (+ dg_lin)
//   dhp = (dh K1, dh K2, dh K3),  dxp = (dh K1, dh K2, dh P)
//   carry = dh z + bf16(dhp) @ bf16(W_hh)^T                        6 products
// dhp, rounded and packed, is the carry product's A fragment, so the chain
// stays in registers. The recurrence is latency-bound (one warp per
// direction and group of 16 sequences), so a step reads only what it needs
// (the n1 A fragment, bf16, written by dn2_tc_kernel; h_prev and dg at the
// C-fragment positions), and the next step's loads are issued before this
// step's arithmetic.
// KS > 1: dense slots of W = 16 KS units (gru_tc_kernel<KS>'s layout,
// GruFragsDense; one slot of C <= 64, or at C = 128 two of 64): the
// projections take the slot's W inputs as KS k-steps (6 KS + 6 KS products
// a step, h_prev's A fragments of the slot's units read from the saved
// hiddens), and the carry needs every unit's dhp of the slot: the warps of
// a direction trade their units' bf16 dhp through shared memory, one block
// barrier a step (double-buffered), and take W_hh^T's B fragments from a
// bf16 copy staged there (6 KS products a step). At KS = 4 the weights' 96
// fragment registers leave no room to load a step ahead: its loads are
// issued at the step's start; at C = 128 a block then takes one direction
// (blockIdx.y), as ftf.cu's gru_tc_kernel does.
// Writes bf16(h_prev), and bf16 dxp and dhp for the weight and input
// gradients; db_ih and db_hh are the column sums of the unrounded dxp and
// dhp, one partial row per block.
struct BpttArgs {
  const __nv_bfloat16* n1;  // [N*L, C] bf16(LN1(x))
  const float* w_ih;   // slots [D, C/W, W, 3W]
  const float* w_hh;
  const float* b_ih;   // [D, C/W, 3W]
  const float* b_hh;
  const float* hid;    // [D, N*L, C]
  const float* ds;     // [N*L, C]
  const float* dglin;  // [N*L, C] or null
  __nv_bfloat16* hprev;  // [D, N*L, C] out
  __nv_bfloat16* dxp;    // [N*L, D*3C] out
  __nv_bfloat16* dhp;    // [N*L, D*3C] out
  float* part;           // [grid, 2*D*3C] out: db_ih, db_hh partials
  long long N;
  int L;
  int D;
};

// One step's inputs for one warp: the n1 A fragments, h_prev and dg in
// the C-fragment layout [jh][e] (sequence g + 8 (e >> 1), unit 8 jh + 2t +
// (e & 1) of the warp's 16), and for KS > 1 h_prev's A fragments over the
// slot's W units.
template <int KS>
struct StepIn {
  uint32_t ax[KS][4];
  float hv[2][4];
  float dg[2][4];
  uint32_t ha[KS > 1 ? KS : 1][4];
};

// Whether bptt_tc_kernel<KS> takes one direction a block (dense slots at
// C = 128: 8 warps of 96 fragment registers each; every slot at C = 256,
// where both directions' 32 warps would pass 1,024 threads) rather than all
// of them, and whether it takes one dense slot of a direction (C = 256's
// slots of 64: the carry trades dhp within a slot only, so a block of 4
// warps holds that slot's W_hh, 25 KB, and its exchange, not all of C's).
__host__ __device__ constexpr bool bptt_split(int KS) {
  return C > 128 || (C > 64 && KS > 1);
}
__host__ __device__ constexpr bool bptt_slot_block(int KS) {
  return C > 128 && KS > 1;
}
// Blocks a direction's slots of 16 are split over (grid z): at C = 512 a
// direction's 32 warps would be 1,024 threads of at most 64 registers.
constexpr int BPTT_PARTS = C > 256 ? 2 : 1;
__host__ __device__ constexpr int bptt_threads(int KS) {
  return bptt_slot_block(KS) ? KS * 32
                             : (bptt_split(KS) ? 1 : 2) * (C / 16) * 32 /
                                   BPTT_PARTS;
}
// Row stride of bptt_tc_kernel<KS>'s staged W_hh and dhp exchange: LDW, or
// a slot's 3W + 8 where a block takes one slot.
__host__ __device__ constexpr int bptt_ld(int KS) {
  return bptt_slot_block(KS) ? 3 * 16 * KS + 8 : LDW;
}

// Shared memory of bptt_tc_kernel<KS > 1>: W_hh bf16 [Db][C][LDW] (rows:
// the slots' units, columns gate * W + input unit) and the dhp exchange
// [2][Db][GS][LDW] (columns slot * 3W + gate * W + unit), Db the directions
// a block takes; where a block takes one slot, that slot's alone, row
// stride bptt_ld(KS).
template <int KS>
inline size_t bptt_tc_smem(int Db) {
  return bptt_slot_block(KS)
             ? (size_t)(16 * KS + 2 * GS) * bptt_ld(KS) *
                   sizeof(__nv_bfloat16)
             : (size_t)Db * (C + 2 * GS) * LDW * sizeof(__nv_bfloat16);
}

template <int KS>
__global__ void __launch_bounds__(bptt_threads(KS),
                                  KS == 1 && C <= 64 ? 2 : 1)
    bptt_tc_kernel(BpttArgs a) {
  constexpr bool SPLIT = bptt_split(KS);
  constexpr bool SLOTB = bptt_slot_block(KS);  // a block: one dense slot
  constexpr int W = 16 * KS;       // slot width
  constexpr int SLOTS = C / W;     // KS > 1: dense slots a direction
  constexpr int LDH = bptt_ld(KS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // grp: the warp's 16 units; d its direction, dl that within the block
  const int d = SPLIT ? (int)blockIdx.y : warp >> WPD_LOG2;
  const int grp = SLOTB ? (int)blockIdx.z * KS + warp
                  : BPTT_PARTS > 1
                      ? (int)blockIdx.z * (C / 16 / BPTT_PARTS) + warp
                      : warp & ((1 << WPD_LOG2) - 1);
  const int dl = SPLIT ? 0 : d;
  const int L = a.L, D = a.D;
  const int Db = SPLIT ? 1 : D;  // directions in the block
  const long long n0 = (long long)blockIdx.x * GS;
  const size_t NL = (size_t)a.N * L;
  // KS > 1: the first unit of the warp's slot, its 16 units' place in it.
  const int slot0 = SLOTS == 1 ? 0 : (grp / KS) * W;
  const int u16 = 16 * (SLOTS == 1 ? grp : grp % KS);
  // The warp's units: channels 16 grp .., in the gate-major slot layout at
  // column slot * 3W + gate * W + u of a direction's 3C.
  const int scol = KS == 1 ? grp * 3 * W : slot0 * 3 + u16;

  typename GruFragsOf<KS>::type f;
  uint32_t bt[3][2][2];  // KS = 1: W_hh^T's B fragments for the carry
  __nv_bfloat16* whs = nullptr;  // KS > 1: W_hh staged, then the exchange
  __nv_bfloat16* ex = nullptr;
  if constexpr (KS == 1) {
    const int dg = d * (C / 16) + grp;
    load_gru_frags(f, a.w_ih, a.w_hh, a.b_ih, a.b_hh, dg, lane);
    // W_hh^T for the carry: B(k = o, n = j) = W_hh[j][o]; k-step q is gate q.
    const float* wh = a.w_hh + (size_t)dg * W * (3 * W);
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int jh = 0; jh < 2; ++jh)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int o = q * W + 2 * t + 8 * k, j = jh * 8 + g;
          bt[q][jh][k] = pack_bf16(wh[j * 3 * W + o], wh[j * 3 * W + o + 1]);
        }
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    whs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    if constexpr (SLOTB)
      ex = whs + (size_t)W * LDH;
    else
      ex = whs + (size_t)Db * C * LDW;
    load_gru_frags(f, a.w_ih, a.w_hh, a.b_ih, a.b_hh,
                   SLOTS == 1 ? d : d * SLOTS + grp / KS,
                   SLOTS == 1 ? grp : grp % KS, lane);
    if constexpr (SLOTB)
      stage_weight(whs, LDH, a.w_hh + ((size_t)d * C + slot0) * 3 * W, W,
                   3 * W);
    else
      stage_weight(whs, LDW, a.w_hh + (SPLIT ? (size_t)d * C * 3 * W : 0),
                   Db * C, 3 * W);
    __syncthreads();
  }
  const auto& bi = f.bi;
  const auto& bh = f.bh;
  const auto& brz = f.brz;
  const auto& bxn = f.bxn;
  const auto& bhn = f.bhn;

  // Step s of the walk is t = L-1-s (direction 0) or t = s (direction 1).
  auto load_step = [&](int s, StepIn<KS>& in) {
    const int tt = d ? s : L - 1 - s;
    const bool hasp = d ? tt < L - 1 : tt > 0;
    const int tp = d ? tt + 1 : tt - 1;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long long n = n0 + g + 8 * rr;
      const bool ok = n < a.N;
      const size_t row = (size_t)n * L + tt;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const unsigned* pa = reinterpret_cast<const unsigned*>(
            a.n1 + row * C + (KS == 1 ? grp * 16 : slot0 + kk * 16) + 2 * t);
        in.ax[kk][rr] = ok ? __ldg(pa) : 0u;
        in.ax[kk][2 + rr] = ok ? __ldg(pa + 4) : 0u;
      }
      const float* hrow = a.hid + ((size_t)d * NL + (size_t)n * L + tp) * C;
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        const int col = grp * 16 + 8 * jh + 2 * t;
        float2 h = make_float2(0.f, 0.f), dv = make_float2(0.f, 0.f);
        if (ok) {
          if (hasp) h = __ldg(reinterpret_cast<const float2*>(hrow + col));
          dv = __ldg(reinterpret_cast<const float2*>(a.ds + row * C + col));
          if (a.dglin) {
            const float2 e2 = __ldg(
                reinterpret_cast<const float2*>(a.dglin + row * C + col));
            dv.x += e2.x;
            dv.y += e2.y;
          }
        }
        in.hv[jh][2 * rr] = h.x;
        in.hv[jh][2 * rr + 1] = h.y;
        in.dg[jh][2 * rr] = dv.x;
        in.dg[jh][2 * rr + 1] = dv.y;
      }
      if constexpr (KS > 1) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int jh = 0; jh < 2; ++jh) {
            float2 h = make_float2(0.f, 0.f);
            if (ok && hasp)
              h = __ldg(reinterpret_cast<const float2*>(
                  hrow + slot0 + kk * 16 + 8 * jh + 2 * t));
            in.ha[kk][2 * jh + rr] = pack_bf16(h.x, h.y);
          }
      }
    }
  };

  float carry[2][4] = {};
  float sr[2][2] = {}, sz[2][2] = {}, sxn[2][2] = {}, shn[2][2] = {};
  const size_t ldx = (size_t)D * 3 * C;
  StepIn<KS> cur, nxt;
  if constexpr (KS == 1) load_step(0, cur);
  for (int s = 0; s < L; ++s) {
    if constexpr (KS == 1) {
      if (s + 1 < L) load_step(s + 1, nxt);
    } else {
      load_step(s, cur);
    }
    const int tt = d ? s : L - 1 - s;
    // bf16(h_prev) of the warp's own units: A fragment (KS = 1) and output.
    const uint32_t hown[4] = {pack_bf16(cur.hv[0][0], cur.hv[0][1]),
                              pack_bf16(cur.hv[0][2], cur.hv[0][3]),
                              pack_bf16(cur.hv[1][0], cur.hv[1][1]),
                              pack_bf16(cur.hv[1][2], cur.hv[1][3])};
    float ar[2][4], az[2][4], xn[2][4], hn[2][4];
#pragma unroll
    for (int jh = 0; jh < 2; ++jh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ar[jh][e] = brz[0][jh][e & 1];
        az[jh][e] = brz[1][jh][e & 1];
        xn[jh][e] = bxn[jh][e & 1];
        hn[jh][e] = bhn[jh][e & 1];
      }
    if constexpr (KS == 1) {
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        mma(ar[jh], cur.ax[0], bi[jh][0], bi[jh][1]);
        mma(az[jh], cur.ax[0], bi[2 + jh][0], bi[2 + jh][1]);
        mma(xn[jh], cur.ax[0], bi[4 + jh][0], bi[4 + jh][1]);
        mma(ar[jh], hown, bh[jh][0], bh[jh][1]);
        mma(az[jh], hown, bh[2 + jh][0], bh[2 + jh][1]);
        mma(hn[jh], hown, bh[4 + jh][0], bh[4 + jh][1]);
      }
    } else {
#pragma unroll
      for (int jh = 0; jh < 2; ++jh)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          mma(ar[jh], cur.ax[kk], bi[jh][kk][0], bi[jh][kk][1]);
          mma(az[jh], cur.ax[kk], bi[2 + jh][kk][0], bi[2 + jh][kk][1]);
          mma(xn[jh], cur.ax[kk], bi[4 + jh][kk][0], bi[4 + jh][kk][1]);
          mma(ar[jh], cur.ha[kk], bh[jh][kk][0], bh[jh][kk][1]);
          mma(az[jh], cur.ha[kk], bh[2 + jh][kk][0], bh[2 + jh][kk][1]);
          mma(hn[jh], cur.ha[kk], bh[4 + jh][kk][0], bh[4 + jh][kk][1]);
        }
    }
    float er[2][4], ez[2][4], en[2][4], exv[2][4];
#pragma unroll
    for (int jh = 0; jh < 2; ++jh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float r = sigmoid_sfu(ar[jh][e]);
        const float z = sigmoid_sfu(az[jh][e]);
        const float nn = tanh_sfu(fmaf(r, hn[jh][e], xn[jh][e]));
        const float P = (1.f - z) * (1.f - nn * nn);
        const float dh = carry[jh][e] + cur.dg[jh][e];
        er[jh][e] = dh * (P * hn[jh][e] * r * (1.f - r));
        ez[jh][e] = dh * ((cur.hv[jh][e] - nn) * z * (1.f - z));
        en[jh][e] = dh * (P * r);
        exv[jh][e] = dh * P;
        carry[jh][e] = dh * z;
        sr[jh][e & 1] += er[jh][e];
        sz[jh][e & 1] += ez[jh][e];
        sxn[jh][e & 1] += exv[jh][e];
        shn[jh][e & 1] += en[jh][e];
      }
    uint32_t pr[4], pz[4], pn[4], px[4];
#pragma unroll
    for (int jh = 0; jh < 2; ++jh)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = 2 * jh + rr;
        pr[i] = pack_bf16(er[jh][2 * rr], er[jh][2 * rr + 1]);
        pz[i] = pack_bf16(ez[jh][2 * rr], ez[jh][2 * rr + 1]);
        pn[i] = pack_bf16(en[jh][2 * rr], en[jh][2 * rr + 1]);
        px[i] = pack_bf16(exv[jh][2 * rr], exv[jh][2 * rr + 1]);
      }
    if constexpr (KS == 1) {
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        mma(carry[jh], pr, bt[0][jh][0], bt[0][jh][1]);
        mma(carry[jh], pz, bt[1][jh][0], bt[1][jh][1]);
        mma(carry[jh], pn, bt[2][jh][0], bt[2][jh][1]);
      }
    } else {
      // This warp's units' dhp into the step's buffer (row: sequence,
      // column slot * 3W + gate * W + unit), then all the slot's W units'
      // as A fragments.
      // SLOTB: the block's slot alone, columns gate * W + unit.
      __nv_bfloat16* hb = ex + ((size_t)(s & 1) * Db + dl) * GS * LDH;
#pragma unroll
      for (int jh = 0; jh < 2; ++jh)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 2 * jh + rr;
          uint32_t* dst = reinterpret_cast<uint32_t*>(
              hb + (g + 8 * rr) * LDH + (SLOTB ? u16 : scol) + 8 * jh +
              2 * t);
          dst[0] = pr[i];
          dst[W / 2] = pz[i];
          dst[W] = pn[i];
        }
      __syncthreads();
      const __nv_bfloat16* wd =
          whs + (size_t)(SLOTB ? u16 : dl * C + 16 * grp) * LDH;
      const __nv_bfloat16* hs = hb + (SLOTB ? 0 : slot0 * 3);
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t af[4], wf[4];
          load_a(af, hs + q * W + kk * 16, LDH, lane);
          // B(k = o, n = j) = W_hh[slot][j][q*W + o], a [n][k] load.
          load_b_nk(wf, wd + q * W + kk * 16, LDH, lane);
          mma(carry[0], af, wf[0], wf[1]);
          mma(carry[1], af, wf[2], wf[3]);
        }
    }
#pragma unroll
    for (int jh = 0; jh < 2; ++jh)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const long long n = n0 + g + 8 * rr;
        if (n >= a.N) continue;
        const int i = 2 * jh + rr;
        const size_t row = (size_t)n * L + tt;
        *reinterpret_cast<uint32_t*>(
            a.hprev + ((size_t)d * NL + row) * C + grp * 16 + 8 * jh +
            2 * t) = hown[i];
        const size_t o = row * ldx + d * 3 * C + scol + 8 * jh + 2 * t;
        uint32_t* hp = reinterpret_cast<uint32_t*>(a.dhp + o);
        uint32_t* xp = reinterpret_cast<uint32_t*>(a.dxp + o);
        hp[0] = pr[i];
        hp[W / 2] = pz[i];
        hp[W] = pn[i];
        xp[0] = pr[i];
        xp[W / 2] = pz[i];
        xp[W] = px[i];
      }
    if constexpr (KS == 1) cur = nxt;
  }
  // Column sums over the block's 16 sequences and all steps.
  float* out = a.part + (size_t)blockIdx.x * 2 * ldx + d * 3 * C + scol;
#pragma unroll
  for (int jh = 0; jh < 2; ++jh)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v[4] = {sr[jh][e], sz[jh][e], sxn[jh][e], shn[jh][e]};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 4);
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 8);
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 16);
      }
      if (lane < 4) {
        const int u = 8 * jh + 2 * t + e;
        out[u] = v[0];              // db_ih: r, z, n
        out[W + u] = v[1];
        out[2 * W + u] = v[2];
        out[ldx + u] = v[0];        // db_hh: r, z, n
        out[ldx + W + u] = v[1];
        out[ldx + 2 * W + u] = v[3];
      }
    }
}

template <int KS>
cudaError_t launch_bptt_tc(const BpttArgs& a, cudaStream_t st) {
  constexpr bool SPLIT = bptt_split(KS);
  const int Db = SPLIT ? 1 : a.D;
  const size_t smem = KS == 1 ? 0 : bptt_tc_smem<KS>(Db);
  cudaError_t e = allow_smem(bptt_tc_kernel<KS>, smem);
  if (e != cudaSuccess) return e;
  bptt_tc_kernel<KS><<<dim3((unsigned)((a.N + GS - 1) / GS),
                            SPLIT ? (unsigned)a.D : 1u,
                            bptt_slot_block(KS) ? (unsigned)(C / (16 * KS))
                                                : (unsigned)BPTT_PARTS),
                       bptt_slot_block(KS)
                           ? KS * 32
                           : Db * (C / 16) * 32 / BPTT_PARTS,
                       smem, st>>>(a);
  return cudaGetLastError();
}

#if LCT_C > 64
// bf16 mode, one dense GRU slot of SW = 128 units (a group of 128, or of
// 65-127 padded; at C = 256 each of two such slots) on CUDA cores: on
// tensor cores a warp would hold 192 fragment registers (ftf.cu runs this
// slot's forward on CUDA cores too). bptt_tc_kernel's function, outputs and
// rounding points: a block takes one direction, one slot (blockIdx.z) and
// DS sequences, a thread one (sequence, unit j of the slot), walking the
// steps as bptt_tc_kernel does. The slot's W_ih and W_hh, rounded to bf16,
// sit in shared memory as [SW][SIMT_LD] (an odd word stride: the carry's
// reads of W_hh's row j by consecutive j fall in distinct banks); each step
// the block's bf16(n1_t) and bf16(h_prev) rows of the slot's inputs, then
// its bf16(dhp), are traded through shared memory, two barriers a step.
// Per step and thread: 3 x 128 products each for xp, hp and the carry,
// summed in the f32 order of proj_kernel and gate_kernel. Bound: latency
// (a sequential walk).
constexpr int SIMT_SW = C > 128 ? 128 : C;  // the slot's units
constexpr int SIMT_LD = 3 * SIMT_SW + 2;

inline size_t bptt_simt_smem() {
  return (size_t)2 * SIMT_SW * SIMT_LD * sizeof(__nv_bfloat16) +
         (size_t)DS * 5 * SIMT_SW * sizeof(float);
}

__global__ void __launch_bounds__(DS * SIMT_SW) bptt_simt_kernel(BpttArgs a) {
  constexpr int SW = SIMT_SW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* wis = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* whs = wis + SW * SIMT_LD;
  float* xs = reinterpret_cast<float*>(whs + SW * SIMT_LD);  // [DS][SW] n1
  float* hs = xs + DS * SW;                                  // [DS][SW] h_prev
  float* es = hs + DS * SW;                                  // [DS][3SW] dhp
  const int d = blockIdx.y, j = threadIdx.x % SW, sq = threadIdx.x / SW;
  const int u0 = SW == C ? 0 : (int)blockIdx.z * SW;  // the slot's first unit
  const int u = u0 + j;
  const long long n = (long long)blockIdx.x * DS + sq;
  const bool live = n < a.N;
  const int L = a.L, D = a.D;
  const size_t NL = (size_t)a.N * L, ldx = (size_t)D * 3 * C;
  stage_weight(wis, SIMT_LD, a.w_ih + ((size_t)d * C + u0) * 3 * SW, SW,
               3 * SW);
  stage_weight(whs, SIMT_LD, a.w_hh + ((size_t)d * C + u0) * 3 * SW, SW,
               3 * SW);
  const float* bi = a.b_ih + d * 3 * C + u0 * 3;
  const float* bh = a.b_hh + d * 3 * C + u0 * 3;
  const float bir = bi[j], biz = bi[SW + j], bin = bi[2 * SW + j];
  const float bhr = bh[j], bhz = bh[SW + j], bhn = bh[2 * SW + j];
  float* xr = xs + sq * SW;
  float* hr = hs + sq * SW;
  float* er_s = es + sq * 3 * SW;
  float carry = 0.f, sr = 0.f, sz = 0.f, sxn = 0.f, shn = 0.f;
  for (int s = 0; s < L; ++s) {
    const int tt = d ? s : L - 1 - s;
    const bool hasp = d ? tt < L - 1 : tt > 0;
    const size_t row = (size_t)(live ? n : 0) * L + tt;
    const size_t prow = (size_t)(live ? n : 0) * L + (d ? tt + 1 : tt - 1);
    float hp = 0.f, dg = 0.f;
    if (live) {
      xr[j] = __bfloat162float(a.n1[row * C + u]);
      if (hasp) hp = a.hid[((size_t)d * NL + prow) * C + u];
      dg = a.ds[row * C + u];
      if (a.dglin) dg += a.dglin[row * C + u];
    } else {
      xr[j] = 0.f;
    }
    hr[j] = rnd(hp, 1);
    __syncthreads();
    float xa = 0.f, xz = 0.f, xn = 0.f, ha = 0.f, hz = 0.f, hn = 0.f;
#pragma unroll 4
    for (int i = 0; i < SW; ++i) {
      const float xi = xr[i], hi = hr[i];
      const __nv_bfloat16* wi = wis + i * SIMT_LD + j;
      const __nv_bfloat16* wh = whs + i * SIMT_LD + j;
      xa = fmaf(xi, __bfloat162float(wi[0]), xa);
      xz = fmaf(xi, __bfloat162float(wi[SW]), xz);
      xn = fmaf(xi, __bfloat162float(wi[2 * SW]), xn);
      ha = fmaf(hi, __bfloat162float(wh[0]), ha);
      hz = fmaf(hi, __bfloat162float(wh[SW]), hz);
      hn = fmaf(hi, __bfloat162float(wh[2 * SW]), hn);
    }
    const float r = sigmoidf_((xa + bir) + (ha + bhr));
    const float z = sigmoidf_((xz + biz) + (hz + bhz));
    const float hpn = hn + bhn;
    const float nn = tanhf((xn + bin) + r * hpn);
    const float P = (1.f - z) * (1.f - nn * nn);
    const float dh = carry + dg;
    const float er = dh * (P * hpn * r * (1.f - r));
    const float ez = dh * ((hp - nn) * z * (1.f - z));
    const float en = dh * (P * r);
    const float ex = dh * P;
    if (live) {
      sr += er;
      sz += ez;
      sxn += ex;
      shn += en;
      a.hprev[((size_t)d * NL + row) * C + u] = __float2bfloat16_rn(hp);
      const size_t o = row * ldx + d * 3 * C + u0 * 3 + j;
      a.dhp[o] = __float2bfloat16_rn(er);
      a.dhp[o + SW] = __float2bfloat16_rn(ez);
      a.dhp[o + 2 * SW] = __float2bfloat16_rn(en);
      a.dxp[o] = __float2bfloat16_rn(er);
      a.dxp[o + SW] = __float2bfloat16_rn(ez);
      a.dxp[o + 2 * SW] = __float2bfloat16_rn(ex);
    }
    er_s[j] = rnd(er, 1);
    er_s[SW + j] = rnd(ez, 1);
    er_s[2 * SW + j] = rnd(en, 1);
    __syncthreads();
    float acc = 0.f;
    const __nv_bfloat16* wj = whs + j * SIMT_LD;
#pragma unroll 8
    for (int o = 0; o < 3 * SW; ++o)
      acc = fmaf(er_s[o], __bfloat162float(wj[o]), acc);
    carry = dh * z + acc;
  }
  // Column sums over the block's sequences, in sequence order.
  __syncthreads();
  float* red = xs;  // [4][DS][SW] over xs, hs, es
  red[(0 * DS + sq) * SW + j] = sr;
  red[(1 * DS + sq) * SW + j] = sz;
  red[(2 * DS + sq) * SW + j] = sxn;
  red[(3 * DS + sq) * SW + j] = shn;
  __syncthreads();
  if (sq != 0) return;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = red[(k * DS) * SW + j];
    for (int q = 1; q < DS; ++q) v[k] += red[(k * DS + q) * SW + j];
  }
  float* out = a.part + (size_t)blockIdx.x * 2 * ldx + d * 3 * C + u0 * 3;
  out[j] = v[0];              // db_ih: r, z, n
  out[SW + j] = v[1];
  out[2 * SW + j] = v[2];
  out[ldx + j] = v[0];        // db_hh: r, z, n
  out[ldx + SW + j] = v[1];
  out[ldx + 2 * SW + j] = v[3];
}

inline cudaError_t launch_bptt_simt(const BpttArgs& a, cudaStream_t st) {
  const size_t smem = bptt_simt_smem();
  cudaError_t e = allow_smem(bptt_simt_kernel, smem);
  if (e != cudaSuccess) return e;
  bptt_simt_kernel<<<dim3((unsigned)((a.N + DS - 1) / DS), (unsigned)a.D,
                          (unsigned)(C / SIMT_SW)),
                     DS * SIMT_SW, smem, st>>>(a);
  return cudaGetLastError();
}
#endif

// ---------------------------------------------------------------------------
// The attention core, recomputed and differentiated on tensor cores. A work
// item is one sequence and TW channels of q, k, v (and, backward, dctx):
// one head of hd = HDP channels (HDP = 16, 32 or 64), or for HDP = 8 the
// 16 / hd heads of a 16-channel k-step, taken in turn. Its rows sit in
// shared memory as bf16 [L][TW] tiles (the whole sequence: L <= 512), one
// block of up to 4 warps per item, each warp taking 16-row tiles in turn.
// A head's scores take its KS = TW / 16 k-steps (HDP = 8: its k-step with
// the other heads' channels zeroed, q_mask), its products over channels
// the head's n8 tiles (HDP = 8: the one holding it, v_mask): the masks
// make a narrow head exact, as the TPU kernel's zero blocks do. Scores are
// formed in log2 units, s log2(e) = (q . k) log2(e) / sqrt(hd), so each
// exp is one ex2; key chunks of 16 outside the band are skipped, partial
// chunks masked.
//
// attn_fwd_tc_kernel: per query tile and head, walk 1 takes the row max m
// and sum l online, walk 2 p = bf16(exp(s - m) / l) and ctx = p @ v.
// Writes bf16(ctx) and (m, 1/l) per row and head for the backward.
// attn_bwd_tc_kernel, with the stored (m, 1/l) giving p again:
//   query pass: walk 1 rowsum = sum_k p dp (dp = dctx . v, f32), walk 2
//     ds = bf16(p (dp - rowsum)), dq = ds @ k / sqrt(hd);
//   key pass (keys as the M rows): s^T = k q^T, p^T, dp^T = v dctx^T,
//     dv = p^T @ dctx, dk = ds^T @ q / sqrt(hd).
// No sum crosses an item, so nothing is atomic. Four [L][72] tiles of a
// 64-channel head would not fit at L = 512 (295 KB), so HDP = 64 keeps two
// resident at a time (SPLIT): K, V for the query pass, whose Q and dctx A
// fragments are read from device memory, then Q, dctx for the key pass,
// whose K and V fragments are. One [L][136] tile of a 128-channel head
// takes 139 KB at L = 512: HDP = 128 streams (attn_*_wide_kernel below).
struct HeadArgs {
  const __nv_bfloat16* qkv;   // [N*L, 3C]
  const __nv_bfloat16* dctx;  // [N*L, C] (backward)
  float* stats;               // [N*L, C/hd, 2]: m (log2 units), 1/l
  __nv_bfloat16* ctx;         // [N*L, C] out (forward)
  __nv_bfloat16* dqkv;        // [N*L, 3C] out (backward)
  int L;
  int lookback;
  int hd;                     // head width the kernels run: a power of two
  float scale;                // the score scale, 1 / sqrt(true head width)
  float scale2;               // the same in log2 units (qk_scale2)
  float* rsum;                // [N*L, C/hd] sum(dp p) (HDP = 128 only)
};

// A work item's shape for padded head width HDP: TW channels staged per
// row (row stride LD), KS 16-channel k-steps of a head's scores.
template <int HDP>
struct ItemShape {
  static constexpr int TW = HDP >= 16 ? HDP : 16;
  static constexpr int KS = TW / 16;
  static constexpr int LD = TW + 8;
  static constexpr bool SPLIT = HDP == 64;  // the backward's two phases
};

__host__ __device__ inline int head_lp(int L) { return (L + 15) / 16 * 16; }
inline int head_warps(int L) { return L > 48 ? 4 : (L + 15) / 16; }
// Heads a work item takes in turn.
__host__ __device__ inline int item_heads(int HDP, int hd) {
  return HDP >= 16 ? 1 : 16 / hd;
}
template <int HDP>
inline size_t attn_fwd_smem(int L) {
  return (size_t)3 * head_lp(L) * ItemShape<HDP>::LD * sizeof(__nv_bfloat16);
}
template <int HDP>
inline size_t attn_bwd_smem(int L, int hd) {
  using S = ItemShape<HDP>;
  return (size_t)(S::SPLIT ? 2 : 4) * head_lp(L) * S::LD *
             sizeof(__nv_bfloat16) +
         (size_t)3 * item_heads(HDP, hd) * head_lp(L) * sizeof(float);
}

// Rows [0, Lp) of TW channels of a [N*L, ld] bf16 array, from column
// `col`, into a [Lp][TW + 8] tile (rows >= L zero).
template <int TW>
__device__ __forceinline__ void load_head(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int ld, int col, int L, int Lp) {
  constexpr int P = TW / 8, LD = TW + 8;
  for (int i = threadIdx.x; i < P * Lp; i += blockDim.x) {
    const int r = i / P, part = i % P;
    const bool ok = r < L;
    cp_async16(dst + r * LD + part * 8,
               src + (size_t)(ok ? r : 0) * ld + col + part * 8, ok);
  }
}

// The A fragments of a 16-row tile over KS k-steps from a staged tile.
template <int KS>
__device__ __forceinline__ void load_a_ks(uint32_t (&a)[KS][4],
                                          const __nv_bfloat16* base, int ld,
                                          int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a(a[ks], base + ks * 16, ld, lane);
}

// The same from device memory (rows r0 .. of `rows`; past them zero).
template <int KS>
__device__ __forceinline__ void ldg_a_ks(uint32_t (&a)[KS][4],
                                         const __nv_bfloat16* p, int ld,
                                         long long r0, long long rows,
                                         int col, int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldg_a(a[ks], p, ld, r0, rows, col + ks * 16, lane);
}

// A head's copy of a tile's A fragments: for HDP = 8 its k-step masked to
// its channels, else the fragments as they are.
template <int HDP, int KS>
__device__ __forceinline__ void head_a(uint32_t (&dst)[KS][4],
                                       const uint32_t (&src)[KS][4], int h,
                                       int hd, int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[ks][i] = src[ks][i];
  if (HDP == 8) q_mask(dst[0], h, hd, lane);
}

// acc (n8 tiles over the item's TW channels) += A @ B, B the [k][n] tile at
// `b` (16 rows of TW channels, row stride LD): a 16-channel k-step of P @ V,
// dq = ds @ k, dv = p^T @ dctx or dk = ds^T @ q. For HDP = 8 only head h's
// n8 tile, its other heads' channels zeroed (v_mask).
template <int HDP>
__device__ __forceinline__ void head_product(
    float (&acc)[ItemShape<HDP>::TW / 8][4], const uint32_t (&pa)[4],
    const __nv_bfloat16* b, int h, int hd, int lane) {
  using S = ItemShape<HDP>;
  if constexpr (HDP >= 16) {
#pragma unroll
    for (int ks = 0; ks < S::KS; ++ks) {
      uint32_t bf[4];
      load_b_kn(bf, b + ks * 16, S::LD, lane);
      mma(acc[2 * ks], pa, bf[0], bf[1]);
      mma(acc[2 * ks + 1], pa, bf[2], bf[3]);
    }
  } else {
    uint32_t bf[4];
    load_b_kn(bf, b, S::LD, lane);
    const uint32_t vm = v_mask(h, hd, lane);
    if (((h * hd) & 15) >> 3) {
      mma(acc[1], pa, bf[2] & vm, bf[3] & vm);
    } else {
      mma(acc[0], pa, bf[0] & vm, bf[1] & vm);
    }
  }
}

// acc0 += A0 @ B0 and acc1 += A1 @ B1 (head_product twice), both B tiles
// loaded before the products: dv and dk of the key pass.
template <int HDP>
__device__ __forceinline__ void head_product2(
    float (&acc0)[ItemShape<HDP>::TW / 8][4], const uint32_t (&a0)[4],
    const __nv_bfloat16* b0, float (&acc1)[ItemShape<HDP>::TW / 8][4],
    const uint32_t (&a1)[4], const __nv_bfloat16* b1, int h, int hd,
    int lane) {
  using S = ItemShape<HDP>;
  if constexpr (HDP >= 16) {
#pragma unroll
    for (int ks = 0; ks < S::KS; ++ks) {
      uint32_t f0[4], f1[4];
      load_b_kn(f0, b0 + ks * 16, S::LD, lane);
      load_b_kn(f1, b1 + ks * 16, S::LD, lane);
      mma(acc0[2 * ks], a0, f0[0], f0[1]);
      mma(acc0[2 * ks + 1], a0, f0[2], f0[3]);
      mma(acc1[2 * ks], a1, f1[0], f1[1]);
      mma(acc1[2 * ks + 1], a1, f1[2], f1[3]);
    }
  } else {
    head_product<HDP>(acc0, a0, b0, h, hd, lane);
    head_product<HDP>(acc1, a1, b1, h, hd, lane);
  }
}

// Scores (log2 units) of the 16 rows of A fragments `qa` (the head's
// k-steps) against 16 keys at `kb` (a [key][TW] tile), masked to -inf:
// key >= L, or outside the band of the row. Element [j][e]: row rq[e >> 1],
// key k0 + 8j + 2t + (e & 1).
template <int KS, int LD>
__device__ __forceinline__ void scores16(float (&sc)[2][4],
                                         const uint32_t (&qa)[KS][4],
                                         const __nv_bfloat16* kb, int k0,
                                         const int rq[2], int L, int lb,
                                         float scale2, int lane) {
  const int t = lane & 3;
  uint32_t kf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_b_nk(kf[ks], kb + ks * 16, LD, lane);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      mma(sc[j], qa[ks], kf[ks][2 * j], kf[ks][2 * j + 1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * t + (e & 1), row = rq[e >> 1];
      const bool ok = key < L && (lb < 0 || (key <= row && key >= row - lb));
      sc[j][e] = ok ? sc[j][e] * scale2 : -INFINITY;
    }
  }
}

// First and last key chunk of 16 that query rows [q0, q0 + 15] need.
__device__ __forceinline__ void key_chunks(int q0, int L, int lb, int& kc0,
                                           int& kc1) {
  const int lo = lb >= 0 ? max(0, q0 - lb) : 0;
  const int hi = lb >= 0 ? min(L - 1, q0 + 15) : L - 1;
  kc0 = lo / 16;
  kc1 = hi / 16;
}

__device__ __forceinline__ void pack_a(uint32_t pa[4], const float p[2][4]) {
  pa[0] = pack_bf16(p[0][0], p[0][1]);
  pa[1] = pack_bf16(p[0][2], p[0][3]);
  pa[2] = pack_bf16(p[1][0], p[1][1]);
  pa[3] = pack_bf16(p[1][2], p[1][3]);
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The bf16 pairs of 16 rows' TW-channel outputs (C-fragment layout, n8
// tile j = channels 8j ..), times `scale`, at column `col` of rows rowbase
// + r0 .. of a [N*L, ld] array (rows >= L skipped).
template <int NT>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int ld,
                                           size_t rowbase, int r0, int L,
                                           int col, const float (&o)[NT][4],
                                           float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = r0 + g + 8 * r;
    if (q >= L) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<uint32_t*>(out + (rowbase + q) * ld + col + 8 * j +
                                   2 * t) =
          pack_bf16(o[j][2 * r] * scale, o[j][2 * r + 1] * scale);
  }
}

template <int HDP>
__global__ void attn_fwd_tc_kernel(HeadArgs a) {
  using S = ItemShape<HDP>;
  constexpr int TW = S::TW, KS = S::KS, LD = S::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = a.L, lb = a.lookback, Lp = head_lp(L);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + Lp * LD;
  __nv_bfloat16* Vs = Ks + Lp * LD;
  const int hd = HDP >= 16 ? HDP : a.hd;
  const int nh = C / hd, hpi = item_heads(HDP, hd);
  const float scale2 = a.scale2;
  const long long n = blockIdx.x / (C / TW);
  const int c0 = (blockIdx.x % (C / TW)) * TW;  // the item's first channel
  const size_t rowbase = (size_t)n * L;
  const __nv_bfloat16* src = a.qkv + rowbase * 3 * C;
  load_head<TW>(Qs, src, 3 * C, c0, L, Lp);
  load_head<TW>(Ks, src, 3 * C, C + c0, L, Lp);
  load_head<TW>(Vs, src, 3 * C, 2 * C + c0, L, Lp);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5, t = lane & 3;
  for (int q0 = warp * 16; q0 < Lp; q0 += nwarps * 16) {
    const int rq[2] = {q0 + (lane >> 2), q0 + (lane >> 2) + 8};
    uint32_t qt[KS][4];
    load_a_ks<KS>(qt, Qs + q0 * LD, LD, lane);
    int kc0, kc1;
    key_chunks(q0, L, lb, kc0, kc1);
    float o[TW / 8][4] = {};
    for (int hh = 0; hh < hpi; ++hh) {
      const int h = c0 / hd + hh;
      uint32_t qa[KS][4];
      head_a<HDP, KS>(qa, qt, h, hd, lane);
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      for (int kc = kc0; kc <= kc1; ++kc) {
        float sc[2][4];
        scores16<KS, LD>(sc, qa, Ks + kc * 16 * LD, kc * 16, rq, L, lb,
                         scale2, lane);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mx =
              quad_max(fmaxf(fmaxf(sc[0][2 * r], sc[0][2 * r + 1]),
                             fmaxf(sc[1][2 * r], sc[1][2 * r + 1])));
          const float mnew = fmaxf(m[r], mx);
          const float mb = mnew == -INFINITY ? 0.f : mnew;
          const float part =
              (ex2(sc[0][2 * r] - mb) + ex2(sc[0][2 * r + 1] - mb)) +
              (ex2(sc[1][2 * r] - mb) + ex2(sc[1][2 * r + 1] - mb));
          l[r] = fmaf(l[r], ex2(m[r] - mb), part);
          m[r] = mnew;
        }
      }
      float il[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (m[r] == -INFINITY) m[r] = 0.f;
        const float tot = quad_sum(l[r]);
        il[r] = tot > 0.f ? 1.f / tot : 0.f;
      }
      for (int kc = kc0; kc <= kc1; ++kc) {
        float sc[2][4];
        scores16<KS, LD>(sc, qa, Ks + kc * 16 * LD, kc * 16, rq, L, lb,
                         scale2, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[j][e] = ex2(sc[j][e] - m[e >> 1]) * il[e >> 1];
        uint32_t pa[4];
        pack_a(pa, sc);
        head_product<HDP>(o, pa, Vs + kc * 16 * LD, h, hd, lane);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rq[r] < L && t == 0)
          *reinterpret_cast<float2*>(a.stats +
                                     ((rowbase + rq[r]) * nh + h) * 2) =
              make_float2(m[r], il[r]);
    }
    store_rows<TW / 8>(a.ctx, C, rowbase, q0, L, c0, o, 1.f, lane);
  }
}

template <int HDP>
__global__ void attn_bwd_tc_kernel(HeadArgs a) {
  using S = ItemShape<HDP>;
  constexpr int TW = S::TW, KS = S::KS, LD = S::LD;
  constexpr bool SPLIT = S::SPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = a.L, lb = a.lookback, Lp = head_lp(L);
  const int hd = HDP >= 16 ? HDP : a.hd;
  const int nh = C / hd, hpi = item_heads(HDP, hd);
  const float scale2 = a.scale2;
  const float scale = a.scale;
  // Tiles [Lp][LD]: Q, K, V, dctx; SPLIT: K, V in the query pass, then Q,
  // dctx in their place for the key pass.
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + (SPLIT ? 0 : 1) * Lp * LD;
  __nv_bfloat16* Vs = Qs + (SPLIT ? 1 : 2) * Lp * LD;
  __nv_bfloat16* Os = Qs + (SPLIT ? 1 : 3) * Lp * LD;  // dctx
  float* ms = reinterpret_cast<float*>(Qs + (SPLIT ? 2 : 4) * Lp * LD);
  float* ils = ms + hpi * Lp;  // [hpi][Lp] each
  float* rss = ils + hpi * Lp;
  const long long n = blockIdx.x / (C / TW);
  const int c0 = (blockIdx.x % (C / TW)) * TW;  // the item's first channel
  const size_t rowbase = (size_t)n * L;
  const __nv_bfloat16* src = a.qkv + rowbase * 3 * C;
  const __nv_bfloat16* dsrc = a.dctx + rowbase * C;
  if (!SPLIT) load_head<TW>(Qs, src, 3 * C, c0, L, Lp);
  load_head<TW>(Ks, src, 3 * C, C + c0, L, Lp);
  load_head<TW>(Vs, src, 3 * C, 2 * C + c0, L, Lp);
  if (!SPLIT) load_head<TW>(Os, dsrc, C, c0, L, Lp);
  cp_async_commit();
  for (int hh = 0; hh < hpi; ++hh)
    for (int r = threadIdx.x; r < Lp; r += blockDim.x) {
      float2 st = make_float2(0.f, 0.f);
      if (r < L)
        st = *reinterpret_cast<const float2*>(
            a.stats + ((rowbase + r) * nh + c0 / hd + hh) * 2);
      ms[hh * Lp + r] = st.x;
      ils[hh * Lp + r] = st.y;
    }
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5, g = lane >> 2, t = lane & 3;

  // Query pass: rowsum, then dq.
  for (int q0 = warp * 16; q0 < Lp; q0 += nwarps * 16) {
    const int rq[2] = {q0 + g, q0 + g + 8};
    uint32_t qt[KS][4], ot[KS][4];
    if constexpr (SPLIT) {
      ldg_a_ks<KS>(qt, src, 3 * C, q0, L, c0, lane);
      ldg_a_ks<KS>(ot, dsrc, C, q0, L, c0, lane);
    } else {
      load_a_ks<KS>(qt, Qs + q0 * LD, LD, lane);
      load_a_ks<KS>(ot, Os + q0 * LD, LD, lane);
    }
    int kc0, kc1;
    key_chunks(q0, L, lb, kc0, kc1);
    float dq[TW / 8][4];  // zeroed before the first head's walk 2
    for (int hh = 0; hh < hpi; ++hh) {
      const int h = c0 / hd + hh;
      const float mr[2] = {ms[hh * Lp + rq[0]], ms[hh * Lp + rq[1]]};
      const float ir[2] = {ils[hh * Lp + rq[0]], ils[hh * Lp + rq[1]]};
      uint32_t qa[KS][4], oa[KS][4];
      head_a<HDP, KS>(qa, qt, h, hd, lane);
      head_a<HDP, KS>(oa, ot, h, hd, lane);
      // p and dp of one key chunk.
      auto chunk = [&](int kc, float (&p)[2][4], float (&dp)[2][4]) {
        scores16<KS, LD>(p, qa, Ks + kc * 16 * LD, kc * 16, rq, L, lb,
                         scale2, lane);
        uint32_t vf[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          load_b_nk(vf[ks], Vs + kc * 16 * LD + ks * 16, LD, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            mma(dp[j], oa[ks], vf[ks][2 * j], vf[ks][2 * j + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[j][e] = bf16r(ex2(p[j][e] - mr[e >> 1]) * ir[e >> 1]);
        }
      };
      float rs[2] = {0.f, 0.f};
      for (int kc = kc0; kc <= kc1; ++kc) {
        float p[2][4], dp[2][4];
        chunk(kc, p, dp);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rs[e >> 1] = fmaf(dp[j][e], p[j][e], rs[e >> 1]);
      }
      rs[0] = quad_sum(rs[0]);
      rs[1] = quad_sum(rs[1]);
      if (hh == 0) {
#pragma unroll
        for (int j = 0; j < TW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
      }
      for (int kc = kc0; kc <= kc1; ++kc) {
        float p[2][4], dp[2][4];
        chunk(kc, p, dp);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[j][e] = p[j][e] * (dp[j][e] - rs[e >> 1]);
        uint32_t sa[4];
        pack_a(sa, p);
        head_product<HDP>(dq, sa, Ks + kc * 16 * LD, h, hd, lane);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (t == 0) rss[hh * Lp + rq[r]] = rs[r];
    }
    store_rows<TW / 8>(a.dqkv, 3 * C, rowbase, q0, L, c0, dq, scale, lane);
  }
  __syncthreads();
  if constexpr (SPLIT) {  // K, V are done with: Q and dctx in their place
    load_head<TW>(Qs, src, 3 * C, c0, L, Lp);
    load_head<TW>(Os, dsrc, C, c0, L, Lp);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // Key pass: the keys as the M rows, dk and dv.
  for (int k0 = warp * 16; k0 < Lp; k0 += nwarps * 16) {
    uint32_t kt[KS][4], vt[KS][4];
    if constexpr (SPLIT) {
      ldg_a_ks<KS>(kt, src, 3 * C, k0, L, C + c0, lane);
      ldg_a_ks<KS>(vt, src, 3 * C, k0, L, 2 * C + c0, lane);
    } else {
      load_a_ks<KS>(kt, Ks + k0 * LD, LD, lane);
      load_a_ks<KS>(vt, Vs + k0 * LD, LD, lane);
    }
    const int kr[2] = {k0 + g, k0 + g + 8};
    const int qc0 = k0 / 16;
    const int qc1 =
        lb >= 0 ? min(L - 1, k0 + 15 + lb) / 16 : (L - 1) / 16;
    float dk[TW / 8][4] = {}, dv[TW / 8][4] = {};
    for (int hh = 0; hh < hpi; ++hh) {
      const int h = c0 / hd + hh;
      const float* mh = ms + hh * Lp;
      const float* ih = ils + hh * Lp;
      const float* rh = rss + hh * Lp;
      uint32_t ka[KS][4], va[KS][4];
      head_a<HDP, KS>(ka, kt, h, hd, lane);
      head_a<HDP, KS>(va, vt, h, hd, lane);
      for (int qc = lb >= 0 ? qc0 : 0; qc <= qc1; ++qc) {
        uint32_t qf[KS][4], of[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          load_b_nk(qf[ks], Qs + qc * 16 * LD + ks * 16, LD, lane);
          load_b_nk(of[ks], Os + qc * 16 * LD + ks * 16, LD, lane);
        }
        float p[2][4], ds[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float sj[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            mma(sj, ka[ks], qf[ks][2 * j], qf[ks][2 * j + 1]);
            mma(dp, va[ks], of[ks][2 * j], of[ks][2 * j + 1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = qc * 16 + 8 * j + 2 * t + (e & 1), key = kr[e >> 1];
            const bool ok = q < L && key < L &&
                            (lb < 0 || (key <= q && key >= q - lb));
            const float pe =
                ok ? bf16r(ex2(sj[e] * scale2 - mh[q]) * ih[q]) : 0.f;
            p[j][e] = pe;
            ds[j][e] = pe * (dp[e] - rh[q]);
          }
        }
        uint32_t pa[4], sa[4];
        pack_a(pa, p);
        pack_a(sa, ds);
        head_product2<HDP>(dv, pa, Os + qc * 16 * LD, dk, sa,
                           Qs + qc * 16 * LD, h, hd, lane);
      }
    }
    store_rows<TW / 8>(a.dqkv, 3 * C, rowbase, k0, L, C + c0, dk, scale,
                       lane);
    store_rows<TW / 8>(a.dqkv, 3 * C, rowbase, k0, L, 2 * C + c0, dv, 1.f,
                       lane);
  }
}

#if LCT_C > 64
// ---------------------------------------------------------------------------
// Heads of HW = 128 or (C = 256) 256 channels (a head of 128, or of 65-127
// padded; at C = 256 two heads of 128, or one of 256 or of 129-255 padded),
// whose rows would not fit resident: work items of 64 rows (4 warps of 16)
// of one head, the other side of the products streamed through shared
// memory in blocks of 64 rows ([64][HW + 8] bf16 tiles, cp.async), every
// fragment taken from the staged tiles, 16 channels at a time, so a warp
// holds only its outputs: 128 channels of them, so a head of 256 takes two
// items (halves) a 64 rows, each forming the same scores over all 256.
//   attn_fwd_wide_kernel  item = 64 queries; K blocks (walk 1: m, l), then
//                         K and V blocks (walk 2: ctx); writes ctx, (m, 1/l)
//   attn_dq_wide_kernel   item = 64 queries with their dctx; K, V blocks
//                         (walk 1: rowsum = sum p dp, walk 2: dq); writes
//                         dq and the rowsum (HeadArgs::rsum)
//   attn_dkv_wide_kernel  item = 64 keys with their V; Q and dctx blocks with
//                         their (m, 1/l, rowsum): dk, dv
// The arithmetic is attn_fwd_tc_kernel's and attn_bwd_tc_kernel's; blocks
// and chunks of 16 outside the band are skipped. Each streamed block is
// read once per item and walk: K and V of a sequence about L / 64 times
// (two walks), from L2. Only the first half of a head writes its softmax
// statistics and rowsums. A head of 512 (C = 512: one head, or of 257-511
// padded) takes four 128-channel output parts, and streams its blocks in
// 32 rows (SB) beside its items of 64: two [64][520] tiles and two
// streamed [32][520] ones take 200 KB.
constexpr int WB = 64;                       // rows of an item

template <int HW>
struct Wide {
  static constexpr int LD = HW + 8;          // row stride of a staged tile
  static constexpr int TILE = WB * LD;       // bf16 of an item's tile
  static constexpr int SB = HW > 256 ? 32 : WB;  // rows of a streamed block
  static constexpr int STILE = SB * LD;      // bf16 of a streamed tile
  static constexpr int NH = C / HW;          // heads
  static constexpr int HV = HW / 128;        // output parts of a head
};

// acc[j] (j: the two n8 tiles of 16 columns) = A @ B^T over the HW
// channels: A the warp's 16 rows of a staged tile, B 16 rows of another
// ([n][k] loads); rows of A and B at a and b.
template <int HW>
__device__ __forceinline__ void wide_dot16(float (&acc)[2][4],
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* b,
                                           int lane) {
  constexpr int LD = Wide<HW>::LD;
#pragma unroll
  for (int j = 0; j < 2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HW / 16; ++ks) {
    uint32_t af[4], bf[4];
    load_a(af, a + ks * 16, LD, lane);
    load_b_nk(bf, b + ks * 16, LD, lane);
    mma(acc[0], af, bf[0], bf[1]);
    mma(acc[1], af, bf[2], bf[3]);
  }
}

// out[16 n8 tiles] += P @ B: P the A fragment of 16 rows over 16 staged rows
// (k), B those rows' 128 channels ([k][n] loads) at b.
template <int HW>
__device__ __forceinline__ void wide_product(float (&out)[16][4],
                                             const uint32_t (&pa)[4],
                                             const __nv_bfloat16* b,
                                             int lane) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t bf[4];
    load_b_kn(bf, b + ks * 16, Wide<HW>::LD, lane);
    mma(out[2 * ks], pa, bf[0], bf[1]);
    mma(out[2 * ks + 1], pa, bf[2], bf[3]);
  }
}

// Rows [r0, r0 + R) of HW channels from column `col` of a [N*L, ld] bf16
// array of one sequence (`src` its row 0) into a staged tile, rows past L
// zero.
template <int HW, int R = WB>
__device__ __forceinline__ void load_wide(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int ld,
                                          int col, int r0, int L) {
  load_head<HW>(dst, src + (size_t)r0 * ld, ld, col, min(R, L - r0), R);
}

// Masks sc (scores of rows rq against 16 keys from k0, C-fragment layout)
// to -inf outside [0, L) and the band, in log2 units otherwise.
__device__ __forceinline__ void wide_mask(float (&sc)[2][4], int k0,
                                          const int (&rq)[2], int L, int lb,
                                          float scale2, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * t + (e & 1), row = rq[e >> 1];
      const bool ok = key < L && (lb < 0 || (key <= row && key >= row - lb));
      sc[j][e] = ok ? sc[j][e] * scale2 : -INFINITY;
    }
}

// The blocks of SB keys that queries [q0, q0 + 64) need.
template <int SB>
__device__ __forceinline__ void wide_key_blocks(int q0, int L, int lb,
                                                int& b0, int& b1) {
  b0 = (lb >= 0 ? max(0, q0 - lb) : 0) / SB;
  b1 = (lb >= 0 ? min(L - 1, q0 + WB - 1) : L - 1) / SB;
}

template <int HW>
__global__ void __launch_bounds__(128) attn_fwd_wide_kernel(HeadArgs a) {
  using S = Wide<HW>;
  constexpr int LD = S::LD, NH = S::NH, HV = S::HV, SB = S::SB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + S::TILE;
  __nv_bfloat16* Vs = Ks + S::STILE;
  const int L = a.L, lb = a.lookback, nqb = (L + WB - 1) / WB;
  const float scale2 = a.scale2;
  // item: (sequence, block of 64 queries, head h, part oh)
  const unsigned bx = blockIdx.x / (NH * HV);
  const int h = (int)(blockIdx.x / HV % NH), oh = (int)(blockIdx.x % HV);
  const long long n = bx / nqb;
  const int q0b = (int)(bx % nqb) * WB;
  const size_t rowbase = (size_t)n * L;
  const __nv_bfloat16* src = a.qkv + rowbase * 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = q0b + warp * 16;
  const bool active = r0 < L;
  const int rq[2] = {r0 + (lane >> 2), r0 + (lane >> 2) + 8};
  int kc0 = 0, kc1 = -1, b0, b1;
  if (active) key_chunks(r0, L, lb, kc0, kc1);
  wide_key_blocks<SB>(q0b, L, lb, b0, b1);
  load_wide<HW>(Qs, src, 3 * C, h * HW, q0b, L);
  const __nv_bfloat16* qw = Qs + warp * 16 * LD;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[16][4] = {};
  for (int walk = 0; walk < 2; ++walk) {
    if (walk == 1) {
      float il[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (m[r] == -INFINITY) m[r] = 0.f;
        const float tot = quad_sum(l[r]);
        il[r] = tot > 0.f ? 1.f / tot : 0.f;
      }
      l[0] = il[0];
      l[1] = il[1];
    }
    for (int kb = b0; kb <= b1; ++kb) {
      __syncthreads();  // the previous block's readers are done
      load_wide<HW, SB>(Ks, src, 3 * C, C + h * HW, kb * SB, L);
      if (walk == 1)
        load_wide<HW, SB>(Vs, src, 3 * C, 2 * C + h * HW, kb * SB, L);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (!active) continue;
      for (int c = 0; c < SB / 16; ++c) {
        const int kc = kb * (SB / 16) + c;
        if (kc < kc0 || kc > kc1) continue;
        float sc[2][4];
        wide_dot16<HW>(sc, qw, Ks + c * 16 * LD, lane);
        wide_mask(sc, kc * 16, rq, L, lb, scale2, lane);
        if (walk == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float mx =
                quad_max(fmaxf(fmaxf(sc[0][2 * r], sc[0][2 * r + 1]),
                               fmaxf(sc[1][2 * r], sc[1][2 * r + 1])));
            const float mnew = fmaxf(m[r], mx);
            const float mb = mnew == -INFINITY ? 0.f : mnew;
            const float part =
                (ex2(sc[0][2 * r] - mb) + ex2(sc[0][2 * r + 1] - mb)) +
                (ex2(sc[1][2 * r] - mb) + ex2(sc[1][2 * r + 1] - mb));
            l[r] = fmaf(l[r], ex2(m[r] - mb), part);
            m[r] = mnew;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[j][e] = ex2(sc[j][e] - m[e >> 1]) * l[e >> 1];
          uint32_t pa[4];
          pack_a(pa, sc);
          wide_product<HW>(o, pa, Vs + c * 16 * LD + oh * 128, lane);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (rq[r] < L && t == 0 && oh == 0)
      *reinterpret_cast<float2*>(a.stats +
                                 ((rowbase + rq[r]) * NH + h) * 2) =
          make_float2(m[r], l[r]);
  store_rows<16>(a.ctx, C, rowbase, r0, L, h * HW + oh * 128, o, 1.f, lane);
}

template <int HW>
__global__ void __launch_bounds__(128) attn_dq_wide_kernel(HeadArgs a) {
  using S = Wide<HW>;
  constexpr int LD = S::LD, NH = S::NH, HV = S::HV, SB = S::SB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + S::TILE;  // dctx
  __nv_bfloat16* Ks = Os + S::TILE;
  __nv_bfloat16* Vs = Ks + S::STILE;
  const int L = a.L, lb = a.lookback, nqb = (L + WB - 1) / WB;
  const float scale2 = a.scale2;
  const float scale = a.scale;
  const unsigned bx = blockIdx.x / (NH * HV);
  const int h = (int)(blockIdx.x / HV % NH), oh = (int)(blockIdx.x % HV);
  const long long n = bx / nqb;
  const int q0b = (int)(bx % nqb) * WB;
  const size_t rowbase = (size_t)n * L;
  const __nv_bfloat16* src = a.qkv + rowbase * 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = q0b + warp * 16;
  const bool active = r0 < L;
  const int rq[2] = {r0 + (lane >> 2), r0 + (lane >> 2) + 8};
  int kc0 = 0, kc1 = -1, b0, b1;
  if (active) key_chunks(r0, L, lb, kc0, kc1);
  wide_key_blocks<SB>(q0b, L, lb, b0, b1);
  load_wide<HW>(Qs, src, 3 * C, h * HW, q0b, L);
  load_wide<HW>(Os, a.dctx + rowbase * C, C, h * HW, q0b, L);
  float mr[2] = {0.f, 0.f}, ir[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (active && rq[r] < L) {
      const float2 st = *reinterpret_cast<const float2*>(
          a.stats + ((rowbase + rq[r]) * NH + h) * 2);
      mr[r] = st.x;
      ir[r] = st.y;
    }
  const __nv_bfloat16* qw = Qs + warp * 16 * LD;
  const __nv_bfloat16* ow = Os + warp * 16 * LD;

  float rs[2] = {0.f, 0.f};
  float dq[16][4] = {};
  for (int walk = 0; walk < 2; ++walk) {
    if (walk == 1) {
      rs[0] = quad_sum(rs[0]);
      rs[1] = quad_sum(rs[1]);
    }
    for (int kb = b0; kb <= b1; ++kb) {
      __syncthreads();
      load_wide<HW, SB>(Ks, src, 3 * C, C + h * HW, kb * SB, L);
      load_wide<HW, SB>(Vs, src, 3 * C, 2 * C + h * HW, kb * SB, L);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (!active) continue;
      for (int c = 0; c < SB / 16; ++c) {
        const int kc = kb * (SB / 16) + c;
        if (kc < kc0 || kc > kc1) continue;
        float p[2][4], dp[2][4];
        wide_dot16<HW>(p, qw, Ks + c * 16 * LD, lane);
        wide_mask(p, kc * 16, rq, L, lb, scale2, lane);
        wide_dot16<HW>(dp, ow, Vs + c * 16 * LD, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[j][e] = bf16r(ex2(p[j][e] - mr[e >> 1]) * ir[e >> 1]);
        if (walk == 0) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              rs[e >> 1] = fmaf(dp[j][e], p[j][e], rs[e >> 1]);
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[j][e] = p[j][e] * (dp[j][e] - rs[e >> 1]);
          uint32_t sa[4];
          pack_a(sa, p);
          wide_product<HW>(dq, sa, Ks + c * 16 * LD + oh * 128, lane);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (rq[r] < L && t == 0 && oh == 0)
      a.rsum[(rowbase + rq[r]) * NH + h] = rs[r];
  store_rows<16>(a.dqkv, 3 * C, rowbase, r0, L, h * HW + oh * 128, dq, scale,
                 lane);
}

template <int HW>
__global__ void __launch_bounds__(128) attn_dkv_wide_kernel(HeadArgs a) {
  using S = Wide<HW>;
  constexpr int LD = S::LD, NH = S::NH, HV = S::HV, SB = S::SB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + S::TILE;
  __nv_bfloat16* Qs = Vs + S::TILE;
  __nv_bfloat16* Os = Qs + S::STILE;  // dctx
  float* mq = reinterpret_cast<float*>(Os + S::STILE);  // [3][SB]: m, 1/l, rs
  const int L = a.L, lb = a.lookback, nkb = (L + WB - 1) / WB;
  const float scale2 = a.scale2;
  const float scale = a.scale;
  const unsigned bx = blockIdx.x / (NH * HV);
  const int h = (int)(blockIdx.x / HV % NH), oh = (int)(blockIdx.x % HV);
  const long long n = bx / nkb;
  const int k0b = (int)(bx % nkb) * WB;
  const size_t rowbase = (size_t)n * L;
  const __nv_bfloat16* src = a.qkv + rowbase * 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = k0b + warp * 16;
  const bool active = k0 < L;
  const int kr[2] = {k0 + g, k0 + g + 8};
  // The queries that see some key of the item, and of the warp's keys.
  const int b0 = lb >= 0 ? k0b / SB : 0;
  const int b1 = (lb >= 0 ? min(L - 1, k0b + WB - 1 + lb) : L - 1) / SB;
  const int qc0 = lb >= 0 ? k0 / 16 : 0;
  const int qc1 = (lb >= 0 ? min(L - 1, k0 + 15 + lb) : L - 1) / 16;
  load_wide<HW>(Ks, src, 3 * C, C + h * HW, k0b, L);
  load_wide<HW>(Vs, src, 3 * C, 2 * C + h * HW, k0b, L);
  const __nv_bfloat16* kw = Ks + warp * 16 * LD;
  const __nv_bfloat16* vw = Vs + warp * 16 * LD;

  float dk[16][4] = {}, dv[16][4] = {};
  for (int qb = b0; qb <= b1; ++qb) {
    __syncthreads();
    load_wide<HW, SB>(Qs, src, 3 * C, h * HW, qb * SB, L);
    load_wide<HW, SB>(Os, a.dctx + rowbase * C, C, h * HW, qb * SB, L);
    cp_async_commit();
    for (int i = threadIdx.x; i < SB; i += blockDim.x) {
      const int q = qb * SB + i;
      float2 st = make_float2(0.f, 0.f);
      float r = 0.f;
      if (q < L) {
        st = *reinterpret_cast<const float2*>(a.stats +
                                              ((rowbase + q) * NH + h) * 2);
        r = a.rsum[(rowbase + q) * NH + h];
      }
      mq[i] = st.x;
      mq[SB + i] = st.y;
      mq[2 * SB + i] = r;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < SB / 16; ++c) {
      const int qc = qb * (SB / 16) + c;
      if (qc < qc0 || qc > qc1) continue;
      // Keys as the M rows: s^T = k q^T, dp^T = v dctx^T.
      float sj[2][4], dp[2][4];
      wide_dot16<HW>(sj, kw, Qs + c * 16 * LD, lane);
      wide_dot16<HW>(dp, vw, Os + c * 16 * LD, lane);
      float p[2][4], ds[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = c * 16 + 8 * j + 2 * t + (e & 1);
          const int q = qb * SB + qi, key = kr[e >> 1];
          const bool ok =
              q < L && key < L && (lb < 0 || (key <= q && key >= q - lb));
          const float pe = ok ? bf16r(ex2(sj[j][e] * scale2 - mq[qi]) *
                                      mq[SB + qi])
                              : 0.f;
          p[j][e] = pe;
          ds[j][e] = pe * (dp[j][e] - mq[2 * SB + qi]);
        }
      uint32_t pa[4], sa[4];
      pack_a(pa, p);
      pack_a(sa, ds);
      wide_product<HW>(dv, pa, Os + c * 16 * LD + oh * 128, lane);
      wide_product<HW>(dk, sa, Qs + c * 16 * LD + oh * 128, lane);
    }
  }
  if (!active) return;
  store_rows<16>(a.dqkv, 3 * C, rowbase, k0, L, C + h * HW + oh * 128, dk,
                 scale, lane);
  store_rows<16>(a.dqkv, 3 * C, rowbase, k0, L, 2 * C + h * HW + oh * 128,
                 dv, 1.f, lane);
}

// A wide head's forward recompute, or its backward (two launches), for N
// sequences: one block per item (64 rows, head, half).
template <int HW>
inline cudaError_t launch_head_wide(const HeadArgs& a, long long N,
                                    bool backward, cudaStream_t st) {
  using S = Wide<HW>;
  const unsigned items =
      (unsigned)(N * ((a.L + WB - 1) / WB) * S::NH * S::HV);
  const size_t tile = (size_t)S::TILE * sizeof(__nv_bfloat16);
  const size_t stile = (size_t)S::STILE * sizeof(__nv_bfloat16);
  if (!backward) {
    const size_t smem = tile + 2 * stile;
    cudaError_t e = allow_smem(attn_fwd_wide_kernel<HW>, smem);
    if (e != cudaSuccess) return e;
    attn_fwd_wide_kernel<HW><<<items, 128, smem, st>>>(a);
    return cudaGetLastError();
  }
  cudaError_t e = allow_smem(attn_dq_wide_kernel<HW>, 2 * tile + 2 * stile);
  if (e != cudaSuccess) return e;
  attn_dq_wide_kernel<HW><<<items, 128, 2 * tile + 2 * stile, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t smem = 2 * tile + 2 * stile + 3 * S::SB * sizeof(float);
  if ((e = allow_smem(attn_dkv_wide_kernel<HW>, smem)) != cudaSuccess)
    return e;
  attn_dkv_wide_kernel<HW><<<items, 128, smem, st>>>(a);
  return cudaGetLastError();
}
#endif

// The attention's forward recompute, then later its backward, for N
// sequences: attn_*_tc_kernel<head_pad(hd)>, one block per work item.
template <int HDP>
cudaError_t launch_head_hd(const HeadArgs& a, long long N, bool backward,
                           cudaStream_t st) {
  const unsigned items = (unsigned)(N * (C / ItemShape<HDP>::TW));
  const int threads = 32 * head_warps(a.L);
  if (!backward) {
    const size_t smem = attn_fwd_smem<HDP>(a.L);
    cudaError_t e = allow_smem(attn_fwd_tc_kernel<HDP>, smem);
    if (e != cudaSuccess) return e;
    attn_fwd_tc_kernel<HDP><<<items, threads, smem, st>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = attn_bwd_smem<HDP>(a.L, a.hd);
  cudaError_t e = allow_smem(attn_bwd_tc_kernel<HDP>, smem);
  if (e != cudaSuccess) return e;
  attn_bwd_tc_kernel<HDP><<<items, threads, smem, st>>>(a);
  return cudaGetLastError();
}

inline cudaError_t launch_head(const HeadArgs& a, long long N, bool backward,
                               cudaStream_t st) {
  switch (head_pad(a.hd)) {
    case 8: return launch_head_hd<8>(a, N, backward, st);
    case 16: return launch_head_hd<16>(a, N, backward, st);
#if LCT_C > 16  // C >= 32
    case 32: return launch_head_hd<32>(a, N, backward, st);
#endif
#if LCT_C > 32  // C >= 64
    case 64: return launch_head_hd<64>(a, N, backward, st);
#endif
#if LCT_C > 64
    case 128: return launch_head_wide<128>(a, N, backward, st);
#endif
#if LCT_C > 128
    case 256: return launch_head_wide<256>(a, N, backward, st);
#endif
#if LCT_C > 256
    case 512: return launch_head_wide<512>(a, N, backward, st);
#endif
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Weight gradients on tensor cores: out[m, n] = sum over rows of A[row, m]
// B[row, n], A and B bf16 in device memory (the contract rounds both). Each
// block takes a fixed chunk of rows and, product after product, stages
// tiles of WG_ROWS rows of A and B in shared memory (cp.async,
// double-buffered);
// each warp keeps up to WG_UNITS 16x16 output units in f32 registers, their
// A^T fragments from ldmatrix.trans. A product's outputs go to the block's
// partial row; reduce_tc_kernel adds the rows in block order. `grouped`:
// only the C / 16 diagonal [16 x 48] blocks of a [C x 3C] product (the GRU
// weights in slots of 16, out[slot][i][m]; a dense slot is a dense
// product). `cs_off >= 0`: also the column sums of B. The caller splits a
// product of more than 4 WG_UNITS 16x16 units into pieces of whole rows,
// at C = 512 also of columns (a piece's output rows `ldo` apart), and the
// grouped one into pieces of 16 slots.
struct WgProd {
  const __nv_bfloat16* A;
  const __nv_bfloat16* B;
  int lda, ldb, acol, bcol;
  int M, N;      // multiples of 16; M <= C, N <= 3C
  int grouped;
  int out_off;   // first output in the partial row
  int cs_off;    // first column sum in the partial row, or -1
  int ldo;       // C = 512: the whole product's columns (N below 512)
};

struct WgArgs {
  WgProd p[WG_MAXP];
  int np;
  long long rows;
  long long chunk;  // rows per block, a multiple of 64
  int nout;         // floats per partial row
  float* part;      // [grid, nout]
};

__global__ void __launch_bounds__(RT) wgrad_tc_kernel(WgArgs a) {
  constexpr int H = 16, G = C / H;  // `grouped`: GRU slots of 16 units
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long r0 = (long long)blockIdx.x * a.chunk;
  const long long r1 = min(a.rows, r0 + a.chunk);
  const int ntiles = (int)((r1 - r0 + WG_ROWS - 1) / WG_ROWS);
  float* part = a.part + (size_t)blockIdx.x * a.nout;
  for (int pi = 0; pi < a.np; ++pi) {
    const WgProd P = a.p[pi];
    const int lda = P.M + 8, ldb = P.N + 8;
    const int nunits = P.grouped ? (C > 256 ? P.M / 16 : G) * 3
                                 : (P.M / 16) * (P.N / 16);
    auto stage = [&](int buf, long long rt) {
      __nv_bfloat16* As = sm + buf * WG_STAGE;
      __nv_bfloat16* Bs = As + WG_ROWS * lda;
      const int ma = P.M / 8, nb = P.N / 8;
      for (int i = tid; i < WG_ROWS * ma; i += RT) {
        const int r = i / ma, c8 = i % ma;
        const long long row = rt + r;
        const bool ok = row < r1;
        cp_async16(As + r * lda + c8 * 8,
                   P.A + (size_t)(ok ? row : r0) * P.lda + P.acol + c8 * 8, ok);
      }
      for (int i = tid; i < WG_ROWS * nb; i += RT) {
        const int r = i / nb, c8 = i % nb;
        const long long row = rt + r;
        const bool ok = row < r1;
        cp_async16(Bs + r * ldb + c8 * 8,
                   P.B + (size_t)(ok ? row : r0) * P.ldb + P.bcol + c8 * 8, ok);
      }
    };
    float acc[WG_UNITS][2][4];
#pragma unroll
    for (int u = 0; u < WG_UNITS; ++u)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;
    float cs[WG_CS] = {};
    stage(0, r0);
    cp_async_commit();
    for (int it = 0; it < ntiles; ++it) {
      if (it + 1 < ntiles) {
        stage((it + 1) & 1, r0 + (long long)(it + 1) * WG_ROWS);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* As = sm + (it & 1) * WG_STAGE;
      const __nv_bfloat16* Bs = As + WG_ROWS * lda;
#pragma unroll
      for (int ui = 0; ui < WG_UNITS; ++ui) {
        const int u = warp + 4 * ui;
        if (u >= nunits) break;
        int mt, nc;
        if (P.grouped) {
          mt = u / 3;
          nc = u;  // group mt's columns mt*48 + (u % 3)*16 = u*16
        } else {
          mt = u / (P.N / 16);
          nc = u % (P.N / 16);
        }
#pragma unroll
        for (int kk = 0; kk < WG_ROWS / 16; ++kk) {
          uint32_t af[4], bf[4];
          load_at(af, As + kk * 16 * lda + mt * 16, lda, lane);
          load_b_kn(bf, Bs + kk * 16 * ldb + nc * 16, ldb, lane);
          mma(acc[ui][0], af, bf[0], bf[1]);
          mma(acc[ui][1], af, bf[2], bf[3]);
        }
      }
      if (P.cs_off >= 0) {
#pragma unroll
        for (int k = 0; k < WG_CS; ++k) {
          const int c = tid + k * RT;
          if (c < P.N) {
            float s = 0.f;
            for (int r = 0; r < WG_ROWS; ++r)
              s += __bfloat162float(Bs[r * ldb + c]);
            cs[k] += s;
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int ui = 0; ui < WG_UNITS; ++ui) {
      const int u = warp + 4 * ui;
      if (u >= nunits) break;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
          int o;
          if (P.grouped) {
            // out[grp][i][m], m = (u % 3) * 16 + c
            o = (u / 3) * H * 3 * H + i * 3 * H + (u % 3) * 16 + c;
          } else {
            const int mt = u / (P.N / 16), nc = u % (P.N / 16);
            o = (mt * 16 + i) * (C > 256 ? P.ldo : P.N) + nc * 16 + c;
          }
          part[P.out_off + o] = acc[ui][j][e];
        }
    }
    if (P.cs_off >= 0) {
#pragma unroll
      for (int k = 0; k < WG_CS; ++k) {
        const int c = tid + k * RT;
        if (c < P.N) part[P.cs_off + c] = cs[k];
      }
    }
  }
}

// out[o] = sum_b part[b * ld + off + o], b in index order, for each of up to
// 16 segments (blockIdx.y).
struct RedSeg {
  const float* part;
  int nblocks, ld, off, n;
  float* out;
};
struct RedArgs {
  RedSeg s[16];
};

__global__ void reduce_tc_kernel(RedArgs a) {
  const RedSeg S = a.s[blockIdx.y];
  for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < S.n;
       o += gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int b = 0; b < S.nblocks; ++b) v += S.part[(size_t)b * S.ld + S.off + o];
    S.out[o] = v;
  }
}

// Sequences a block of the bf16 GRU stage takes: bptt_tc_kernel's GS, or
// the CUDA-core walk's DS for a dense slot of 128 (and the cluster walk's
// BC_DS = DS, a cluster, for one of 256), the step walk's BS_R for one of
// 512.
inline int bptt_seqs(int W) {
#if LCT_C > 256
  if (W == C) return BS_R;
#endif
  return W > 64 ? DS : GS;
}

// Device memory of one bf16-mode launch, in bytes from one base (each
// buffer 256-byte aligned). The front region holds qkv, s, the softmax
// statistics and dctx until the attention and LN2 backward are done; the
// GRU stage then writes dxp over it.
struct ScratchTC {
  __nv_bfloat16 *qkv, *gb, *ctx, *ab, *dcomb, *da, *dctx, *dqkv, *n2, *n1,
      *hprev, *dxp, *dhp;
  float *s, *stats, *dglin, *ds, *p_comb, *p_dn2, *p_bptt, *p_dn1, *p_wg,
      *rsum, *K, *carry;
  long long total;
  int grid_rows, grid_wg, nout;
  long long wg_chunk;

  // nh heads as the kernels run them (C / hd); GRU slots of W units.
  ScratchTC(unsigned char* base, long long N, int L, int D, int lin_in,
            int nh, int W, int grid_rows_, int grid_wg_) {
    const long long rows = N * L;
    grid_rows = grid_rows_;
    grid_wg = grid_wg_;
    wg_chunk = (rows + grid_wg - 1) / grid_wg;
    wg_chunk = (wg_chunk + 63) / 64 * 64;
    if (wg_chunk < 64) wg_chunk = 64;
    grid_wg = (int)((rows + wg_chunk - 1) / wg_chunk);
    if (grid_wg < 1) grid_wg = 1;
    nout = lin_in * C + C * C + C * 3 * C + 3 * C + 2 * D * C * 3 * W;
    long long off = 0;
    auto take = [&](long long bytes) {
      unsigned char* p = base ? base + off : nullptr;
      off += (bytes + 255) / 256 * 256;
      return p;
    };
    const long long b16 = 2, f32 = 4;
    // Front region: qkv, s, stats, dctx; later dxp.
    const long long front0 = off;
    qkv = (__nv_bfloat16*)take(rows * 3 * C * b16);
    s = (float*)take(rows * C * f32);
    stats = (float*)take(rows * nh * 2 * f32);
    dctx = (__nv_bfloat16*)take(rows * C * b16);
    const long long front1 = off;
    off = front0;
    dxp = (__nv_bfloat16*)take(rows * D * 3 * C * b16);
    if (off < front1) off = front1;
    gb = lin_in == 2 * C ? (__nv_bfloat16*)take(rows * C * b16) : nullptr;
    dglin = lin_in == 2 * C ? (float*)take(rows * C * f32) : nullptr;
    ctx = (__nv_bfloat16*)take(rows * C * b16);
    ab = (__nv_bfloat16*)take(rows * C * b16);
    dcomb = (__nv_bfloat16*)take(rows * C * b16);
    da = (__nv_bfloat16*)take(rows * C * b16);
    dqkv = (__nv_bfloat16*)take(rows * 3 * C * b16);
    n2 = (__nv_bfloat16*)take(rows * C * b16);
    ds = (float*)take(rows * C * f32);
    n1 = (__nv_bfloat16*)take(rows * C * b16);
    hprev = (__nv_bfloat16*)take(D * rows * C * b16);
    dhp = (__nv_bfloat16*)take(rows * D * 3 * C * b16);
    p_comb = (float*)take((long long)grid_rows * 2 * C * f32);
    p_dn2 = (float*)take((long long)grid_rows * 2 * C * f32);
    p_dn1 = (float*)take((long long)grid_rows * 2 * C * f32);
    p_bptt = (float*)take((N + bptt_seqs(W) - 1) / bptt_seqs(W) * 2 * D * 3 *
                          C * f32);
    p_wg = (float*)take((long long)grid_wg * nout * f32);
    // The wide heads' rowsums (attn_dq_wide_kernel) at C >= 128.
    rsum = C > 64 ? (float*)take(rows * nh * f32) : nullptr;
    // Slots of 256 or 512: the gate factors of every step (gate_tc_kernel).
    K = C > 128 && W >= 256 ? (float*)take(D * rows * 5 * C * f32) : nullptr;
    // One slot of 512: the step walk's carry, 2 x [D, N, C].
    carry = C > 256 && W == C ? (float*)take(2 * D * N * C * f32) : nullptr;
    total = off;
  }
};

// Grid sizes of the bf16 launch on the current device: the row-tile
// kernels' persistent grid and the weight-gradient grid (both capped, so
// the partial buffers are bounded).
inline cudaError_t tc_grids(long long rows, int* grid_rows, int* grid_wg) {
  const long long tiles = (rows + 63) / 64;
  unsigned gr = 1, gw = 1;
#if LCT_C > 128
  // The row-tile kernels of C = 256 (combine, dn2, dn1) each fill an SM's
  // shared memory: one grid of the combine layer's blocks for all three.
  cudaError_t e = allow_smem(comb_panel_kernel, CB_SMEM);
  if (e != cudaSuccess) return e;
  e = persistent_grid(comb_panel_kernel, CB_THREADS, CB_SMEM, tiles, &gr);
#else
  cudaError_t e = allow_smem(comb_bwd_tc_kernel, COMB_SMEM);
  if (e != cudaSuccess) return e;
  e = persistent_grid(comb_bwd_tc_kernel, RT, COMB_SMEM, tiles, &gr);
#endif
  if (e != cudaSuccess) return e;
  const size_t wsm = (size_t)2 * WG_STAGE * sizeof(__nv_bfloat16);
  if ((e = allow_smem(wgrad_tc_kernel, wsm)) != cudaSuccess) return e;
  e = persistent_grid(wgrad_tc_kernel, RT, wsm, tiles, &gw);
  if (e != cudaSuccess) return e;
  *grid_rows = gr < MAX_ROW_BLOCKS ? (int)gr : MAX_ROW_BLOCKS;
  *grid_wg = gw < WG_BLOCKS ? (int)gw : WG_BLOCKS;
  return cudaSuccess;
}

}  // namespace tc
}  // namespace lct

#define LCT_CHECK()                              \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)
#define LCT_TRY(expr)                            \
  do {                                           \
    cudaError_t e_ = (expr);                     \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// Launches of GRU walk `walk` (0 the cluster walk, 1 the step walk) this
// library has made, or -1 for another walk.
extern "C" long long lct_ftf_backward_walk_launches(int walk) {
  return walk == 0 || walk == 1 ? lct::walk_launches[walk] : -1;
}

// Floats of scratch `lct_ftf_backward_f32` needs for N sequences of length
// L (the same at every head and group count), or -1 for widths the kernels
// do not take.
extern "C" long long lct_ftf_backward_scratch_floats(long long N, int L,
                                                     int D, int c_true,
                                                     int num_heads,
                                                     int slots) {
  if (!lct::widths_ok(c_true, num_heads, slots)) return -1;
  return lct::Scratch(nullptr, N, L, D).total;
}

// x, dout, dx: [N, L, C]; hid: [D, N*L, C]; parameters as in
// lct_ftf_forward (ftf.cu), the GRU's in `slots` slots ([D, slots, W, 3W] /
// [D, slots, 3W], W = C / slots: slots = C / 16, 1, at C = 128 2, at C =
// 256 4 or 2), their
// gradients in the same shapes; c_true true channels (the LayerNorms'
// count; the rest of each row zero), num_heads dividing it (heads of
// c_true / num_heads true channels at head_width of it, common.cuh), scale
// their score scale (the f32 rounding of 1 / sqrt(c_true / num_heads));
// scratch: lct_ftf_backward_scratch_floats(N, L, D, c_true, num_heads,
// slots) floats. lookback < 0 means no band. All f32 (precise mode).
// Returns a cudaError_t.
extern "C" int lct_ftf_backward_f32(
    const float* x, const float* ln1_s, const float* ln1_b,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ln2_s, const float* ln2_b,
    const float* in_w, const float* in_b, const float* out_w,
    const float* out_b, const float* lin_w, const float* lin_b,
    const float* hid, const float* dout, float* dx, float* dln1_s,
    float* dln1_b, float* dw_ih, float* dw_hh, float* db_ih, float* db_hh,
    float* dln2_s, float* dln2_b, float* din_w, float* din_b, float* dout_w,
    float* dout_b, float* dlin_w, float* dlin_b, float* scratch, long long N,
    int L, int D, int lin_in, int lookback, int c_true, int num_heads,
    float scale, int slots, int device, void* stream) {
  using namespace lct;
  if (!widths_ok(c_true, num_heads, slots)) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  LCT_CHECK();
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = N * L;
  const int hd = head_width(c_true / num_heads);
  const float inv_c = 1.f / c_true;
  const int W = gru_slot(slots);
  Scratch s(scratch, N, L, D);
  const unsigned rblocks = (unsigned)((rows + PROJ_ROWS - 1) / PROJ_ROWS);
  const unsigned wblocks = (unsigned)((rows + 7) / 8);  // a warp per row
  const float* hid1 = D == 2 ? hid + (size_t)rows * C : nullptr;
  const bool freq = lin_in == 2 * C;

  // 1-2. recompute LN2, qkv and the attention context.
  ln_kernel<<<wblocks, 256, 0, st>>>(x, hid, hid1, ln2_s, ln2_b, s.n2, s.xh2,
                                     s.rs2, rows, inv_c);
  LCT_CHECK();
  proj_kernel<false><<<row_grid(rblocks, 3 * C), row_threads(3 * C), 0,
                       st>>>(x, hid, hid1, ln2_s, ln2_b, in_w, in_b, s.qkv,
                             rows, 3 * C, /*round=*/0, inv_c);
  LCT_CHECK();
  LCT_TRY(launch_attn<1>(s.qkv, nullptr, s.ctx, N, L, lookback, /*round=*/0,
                         hd, scale, st));

  // 3. combine layer and out-proj backward.
  comb_bwd_kernel<<<(unsigned)((rows + COMB_ROWS - 1) / COMB_ROWS), C, 0,
                    st>>>(hid, D, s.ctx, dout, out_w, out_b, lin_w, lin_b,
                          lin_in, s.ga, s.dcomb, s.da, s.dglin, s.dctx, rows);
  LCT_CHECK();

  // 4. attention core backward.
  LCT_TRY(launch_attn_bwd(s.qkv, s.dctx, s.dqkv, N, L, lookback, hd, scale,
                          st));

  // 5. qkv projection and LN2 backward: ds, and dg = ds (+ dg_lin).
  dn2_kernel<<<(unsigned)((rows + DN2_ROWS - 1) / DN2_ROWS), C, 0, st>>>(
      s.dqkv, in_w, s.dn2, rows);
  LCT_CHECK();
  ln_bwd_kernel<<<wblocks, 256, 0, st>>>(s.dn2, s.xh2, s.rs2, ln2_s, dout,
                                         freq ? s.dglin : nullptr, s.ds,
                                         freq ? s.dgt : nullptr, rows, inv_c);
  LCT_CHECK();
  const float* dg = freq ? s.dgt : s.ds;

  // 6-8. GRU: LN1 and xp, the gate factors, BPTT.
  ln_kernel<<<wblocks, 256, 0, st>>>(x, nullptr, nullptr, ln1_s, ln1_b, s.n1,
                                     s.xh1, s.rs1, rows, inv_c);
  LCT_CHECK();
  const long long gthreads = rows * D * C;
  const unsigned gblocks = (unsigned)((gthreads + 255) / 256);
  const unsigned pthreads = row_threads(D * 3 * C);
  const dim3 pgrid = row_grid(rblocks, D * 3 * C);
  // LN1's grouped input projection and the gate factors over slots of GW.
  auto gates = [&](auto gw) {
    constexpr int GW = decltype(gw)::value;
    proj_kernel<true, GW><<<pgrid, pthreads, 0, st>>>(
        x, nullptr, nullptr, ln1_s, ln1_b, w_ih, b_ih, s.xp, rows, D * 3 * C,
        /*round=*/0, inv_c);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    gate_kernel<GW><<<gblocks, 256, 0, st>>>(s.xp, hid, w_hh, b_hh, s.K,
                                             s.hpv, N, L, D);
    return cudaGetLastError();
  };
  if (W == 16) {
    LCT_TRY(gates(std::integral_constant<int, 16>{}));
#if LCT_C > 64
  } else if (W == 64) {
    LCT_TRY(gates(std::integral_constant<int, 64>{}));
#endif
#if LCT_C > 128
  } else if (W == 128) {
    LCT_TRY(gates(std::integral_constant<int, 128>{}));
#endif
#if LCT_C > 256
  } else if (W == 256) {
    LCT_TRY(gates(std::integral_constant<int, 256>{}));
#endif
  } else {
    LCT_TRY(gates(std::integral_constant<int, C>{}));
  }
  LCT_TRY(launch_bptt(s.K, dg, w_hh, s.dxp, s.dhp, N, L, D, slots, s.carry,
                      st));

  // 9. input projection and LN1 backward: dx.
  const unsigned cblocks = (unsigned)((rows * C + 255) / 256);
  if (W == 16) {
    dn1_kernel<16><<<cblocks, 256, 0, st>>>(s.dxp, w_ih, s.dn1, rows, D);
#if LCT_C > 64
  } else if (W == 64) {
    dn1_kernel<64><<<cblocks, 256, 0, st>>>(s.dxp, w_ih, s.dn1, rows, D);
#endif
#if LCT_C > 128
  } else if (W == 128) {
    dn1_kernel<128><<<cblocks, 256, 0, st>>>(s.dxp, w_ih, s.dn1, rows, D);
#endif
#if LCT_C > 256
  } else if (W == 256) {
    dn1_kernel<256><<<cblocks, 256, 0, st>>>(s.dxp, w_ih, s.dn1, rows, D);
#endif
  } else {
    dn1_kernel<C><<<cblocks, 256, 0, st>>>(s.dxp, w_ih, s.dn1, rows, D);
  }
  LCT_CHECK();
  ln_bwd_kernel<<<wblocks, 256, 0, st>>>(s.dn1, s.xh1, s.rs1, ln1_s, s.ds,
                                         nullptr, dx, nullptr, rows, inv_c);
  LCT_CHECK();

  // 10. parameter gradients.
  const Wgrad wg{s.partial, rows, st};
  const int D3C = D * 3 * C;
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, s.dcomb, C, 0, C, 0, C, dlin_b));
  LCT_TRY(wg.dense(s.ga, lin_in, s.dcomb, C, C, lin_in, dlin_w));
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, s.da, C, 0, C, 0, C, dout_b));
  LCT_TRY(wg.dense(s.ctx, C, s.da, C, C, C, dout_w));
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, s.dqkv, 3 * C, 0, 3 * C, 0, 3 * C,
             din_b));
  LCT_TRY(wg.dense(s.n2, C, s.dqkv, 3 * C, 3 * C, C, din_w));
  LCT_TRY(wg(WG_DIAG, s.dn2, C, 0, s.xh2, C, 0, C, C, C, dln2_s));
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, s.dn2, C, 0, C, 0, C, dln2_b));
  if (W == 16) {
#if LCT_C > 128
    // 2 x 12,288 outputs at C = 256, past one launch's WG_OUT: a direction
    // a launch; at C = 512 (24,576 a direction) 16 slots a launch.
    constexpr int GP = C > 256 ? 16 : C / 16;  // slots a launch
    for (int d = 0; d < D; ++d)
      for (int g0 = 0; g0 < C / 16; g0 += GP) {
        const size_t o = (size_t)d * C * 3 * W + (size_t)g0 * W * 3 * W;
        const int a0 = g0 * 16, b0 = d * 3 * C + g0 * 48;
        LCT_TRY(wg(WG_GROUPED, s.n1 + a0, C, 0, s.dxp + b0, D3C, 0,
                   GP * W * 3 * W, GP * 16, GP * 48, dw_ih + o));
        LCT_TRY(wg(WG_GROUPED, s.hpv + (size_t)d * rows * C + a0, C, 0,
                   s.dhp + b0, D3C, 0, GP * W * 3 * W, GP * 16, GP * 48,
                   dw_hh + o));
      }
#else
    LCT_TRY(wg(WG_GROUPED, s.n1, C, 0, s.dxp, D3C, 0, D * C * 3 * W, C, D3C,
               dw_ih));
    LCT_TRY(wg(WG_GROUPED, s.hpv, C, rows * C, s.dhp, D3C, 0, D * C * 3 * W,
               D * C, D3C, dw_hh));
#endif
  } else {
    // Dense slots: the products are dense [W x 3W] per direction and slot.
    for (int d = 0; d < D; ++d)
      for (int sl = 0; sl < C / W; ++sl) {
        const size_t o = (size_t)(d * (C / W) + sl) * W * 3 * W;
        const int col = d * 3 * C + sl * 3 * W;
        LCT_TRY(wg.dense(s.n1 + sl * W, C, s.dxp + col, D3C, 3 * W, W,
                         dw_ih + o));
        LCT_TRY(wg.dense(s.hpv + (size_t)d * rows * C + sl * W, C,
                         s.dhp + col, D3C, 3 * W, W, dw_hh + o));
      }
  }
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, s.dxp, D3C, 0, D3C, 0, D3C, db_ih));
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, s.dhp, D3C, 0, D3C, 0, D3C, db_hh));
  LCT_TRY(wg(WG_DIAG, s.dn1, C, 0, s.xh1, C, 0, C, C, C, dln1_s));
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, s.dn1, C, 0, C, 0, C, dln1_b));
  return 0;
}

// Bytes of scratch `lct_ftf_backward_bf16` needs for N sequences of length L
// at these widths on the current device (the softmax statistics grow with
// the head count, the GRU weights' partial sums with the slot width, the
// partial sums' rows follow the device's grid sizes), or -1 with a CUDA
// error or for widths the kernels do not take.
extern "C" long long lct_ftf_backward_bf16_scratch_bytes(long long N, int L,
                                                         int D, int lin_in,
                                                         int c_true,
                                                         int num_heads,
                                                         int slots) {
  if (!lct::widths_ok(c_true, num_heads, slots)) return -1;
  int gr = 1, gw = 1;
  if (lct::tc::tc_grids(N * L, &gr, &gw) != cudaSuccess) return -1;
  const int hd = lct::head_width(c_true / num_heads);
  return lct::tc::ScratchTC(nullptr, N, L, D, lin_in, lct::C / hd,
                            lct::gru_slot(slots), gr, gw)
      .total;
}

// The same function in bf16 mode on tensor cores: arguments as
// lct_ftf_backward_f32; scratch:
// lct_ftf_backward_bf16_scratch_bytes(N, L, D, lin_in, c_true, num_heads,
// slots) bytes, 256-byte aligned. Nine launches:
//   qkv_tc_kernel -> attn_fwd_tc_kernel -> comb_bwd_tc_kernel ->
//   attn_bwd_tc_kernel -> dn2_tc_kernel -> bptt_tc_kernel -> dn1_tc_kernel
//   (-> dx) -> wgrad_tc_kernel -> reduce_tc_kernel (-> the 14 parameter
//   gradients); a head of 128 channels takes attn_*_wide_kernel (one more
//   launch), a dense GRU slot of 128 bptt_simt_kernel. At C = 256
//   comb_panel_kernel, dn_panel_kernel (twice) and, for one slot of 256,
//   gate_tc_kernel + bptt_cluster_kernel take their stages, and
//   wgrad_tc_kernel runs in up to four launches.
extern "C" int lct_ftf_backward_bf16(
    const float* x, const float* ln1_s, const float* ln1_b,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ln2_s, const float* ln2_b,
    const float* in_w, const float* in_b, const float* out_w,
    const float* out_b, const float* lin_w, const float* lin_b,
    const float* hid, const float* dout, float* dx, float* dln1_s,
    float* dln1_b, float* dw_ih, float* dw_hh, float* db_ih, float* db_hh,
    float* dln2_s, float* dln2_b, float* din_w, float* din_b, float* dout_w,
    float* dout_b, float* dlin_w, float* dlin_b, void* scratch, long long N,
    int L, int D, int lin_in, int lookback, int c_true, int num_heads,
    float scale, int slots, int device, void* stream) {
  using namespace lct;
  using namespace lct::tc;
  if (!widths_ok(c_true, num_heads, slots)) return (int)cudaErrorInvalidValue;
  LCT_TRY(cudaSetDevice(device));
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = N * L;
  const bool freq = lin_in == 2 * C;
  const int W = gru_slot(slots);
  const int hd = head_width(c_true / num_heads);
  const float inv_c = 1.f / c_true;
  int gr = 1, gw = 1;
  LCT_TRY(tc_grids(rows, &gr, &gw));
  const ScratchTC s(static_cast<unsigned char*>(scratch), N, L, D, lin_in,
                    C / hd, W, gr, gw);
  const float* hid1 = D == 2 ? hid + (size_t)rows * C : nullptr;

  // LN2 and qkv recomputed; s = x + g and bf16(g) kept for later stages.
  LCT_TRY(launch_qkv({x, hid, hid1, ln2_s, ln2_b, in_w, in_b, s.qkv, s.s,
                      s.gb, rows, inv_c},
                     st));
  // The attention context and its softmax statistics.
  HeadArgs ha = {s.qkv, s.dctx, s.stats, s.ctx, s.dqkv, L, lookback,
                 hd, scale, qk_scale2(scale), s.rsum};
  LCT_TRY(launch_head(ha, N, /*backward=*/false, st));
  // Combine layer and out-projection backward.
  CombArgs ca = {s.ctx, s.gb, dout, out_w, out_b, lin_w, lin_b, lin_in,
                 s.ab, s.dcomb, s.da, s.dctx, s.dglin, s.p_comb, rows};
#if LCT_C > 128
  LCT_TRY(allow_smem(comb_panel_kernel, CB_SMEM));
  comb_panel_kernel<<<gr, CB_THREADS, CB_SMEM, st>>>(ca);
#else
  comb_bwd_tc_kernel<<<gr, RT, COMB_SMEM, st>>>(ca);
#endif
  LCT_CHECK();
  // Attention core backward.
  LCT_TRY(launch_head(ha, N, /*backward=*/true, st));
  // qkv projection and LN2 backward.
#if LCT_C > 128
  const DnArgs na = {s.dqkv, in_w, s.s, ln2_s, dout, s.ds, ln2_b, x, ln1_s,
                     ln1_b, s.n2, s.n1, s.p_dn2, rows, 1, inv_c};
  LCT_TRY((launch_dn_panel<C, true>(na, gr, st)));
#else
  Dn2Args na = {s.dqkv, s.s, dout, x, in_w, ln2_s, ln2_b, ln1_s, ln1_b,
                s.n2, s.n1, s.ds, s.p_dn2, rows, inv_c};
  LCT_TRY(allow_smem(dn2_tc_kernel, DN2_SMEM));
  dn2_tc_kernel<<<gr, RT, DN2_SMEM, st>>>(na);
  LCT_CHECK();
#endif
  // GRU: projections, gate factors and BPTT.
  BpttArgs ba = {s.n1, w_ih, w_hh, b_ih, b_hh, hid, s.ds,
                 freq ? s.dglin : nullptr, s.hprev, s.dxp, s.dhp, s.p_bptt,
                 N, L, D};
#if LCT_C > 128
  if (W == 16) {
    LCT_TRY(launch_bptt_tc<1>(ba, st));
  } else if (W == 64) {
    LCT_TRY(launch_bptt_tc<4>(ba, st));
  } else if (W == 128) {
    LCT_TRY(launch_bptt_simt(ba, st));
  } else {
    // Slots of 256: every step's gate factors on tensor cores, then the
    // carry's walk by clusters; one slot of 512: the step walk.
    GateArgs gt = {s.n1, hid, w_ih, w_hh, b_ih, b_hh, s.K, s.hprev, N, L};
#if LCT_C > 256
    gt.sw = W;
#endif
    LCT_TRY(launch_gate_tc(gt, D, st));
    const ClusterArgs cl = {s.K, s.ds, freq ? s.dglin : nullptr, w_hh,
                            nullptr, nullptr, s.dxp, s.dhp, s.p_bptt, N, L,
                            D};
#if LCT_C > 256
    if (W == C) {
      LCT_TRY(launch_bptt_steps<true>(cl, s.carry, st));
    } else
#endif
    LCT_TRY(launch_bptt_cluster<true>(cl, st));
  }
  // Input projection and LN1 backward: dx.
  const DnArgs da1 = {s.dxp, w_ih, x, ln1_s, s.ds, dx, nullptr, nullptr,
                      nullptr, nullptr, nullptr, nullptr, s.p_dn1, rows, D,
                      inv_c};
  switch (W) {
    case 16: LCT_TRY((launch_dn_panel<16, false>(da1, gr, st))); break;
    case 64: LCT_TRY((launch_dn_panel<64, false>(da1, gr, st))); break;
    case 128: LCT_TRY((launch_dn_panel<128, false>(da1, gr, st))); break;
#if LCT_C > 256
    case 256: LCT_TRY((launch_dn_panel<256, false>(da1, gr, st))); break;
#endif
    default: LCT_TRY((launch_dn_panel<C, false>(da1, gr, st))); break;
  }
#else
  if (W == 16) {
    LCT_TRY(launch_bptt_tc<1>(ba, st));
  } else {
#if LCT_C > 64
    LCT_TRY(W == 64 ? launch_bptt_tc<4>(ba, st) : launch_bptt_simt(ba, st));
#else
    LCT_TRY(launch_bptt_tc<C / 16>(ba, st));
#endif
  }
  // Input projection and LN1 backward: dx.
  Dn1Args da1 = {s.dxp, x, s.ds, w_ih, ln1_s, dx, s.p_dn1, rows, D, inv_c};
  auto dn1 = [&](auto ks) {
    constexpr int KS = decltype(ks)::value;
    cudaError_t e = allow_smem(dn1_tc_kernel<KS>, dn1_smem<KS>());
    if (e != cudaSuccess) return e;
    dn1_tc_kernel<KS><<<gr, RT, dn1_smem<KS>(), st>>>(da1);
    return cudaGetLastError();
  };
  if (W == 16) {
    dn1_tc_kernel<1><<<gr, RT, 0, st>>>(da1);
    LCT_CHECK();
  } else if (W == C) {
    LCT_TRY(dn1(std::integral_constant<int, C / 16>{}));
  } else {
#if LCT_C > 64
    LCT_TRY(dn1(std::integral_constant<int, 4>{}));
#endif
  }
#endif

  // Weight gradients, then every partial sum reduced in block order. The
  // GRU's: slots of 16 as the diagonal blocks of a grouped product, dense
  // slots as dense ones.
  const int DG = D * C * 3 * W;  // GRU weight gradient floats
  const int o_lin = 0, o_out = lin_in * C, o_in = o_out + C * C;
  const int o_inb = o_in + C * 3 * C, o_ih = o_inb + 3 * C;
  const int o_hh = o_ih + DG;
  WgProd pieces[WG_ALLP];
  int np = 0;
  // A product, in pieces of whole rows of at most 4 WG_UNITS units each
  // (one piece at C = 64); at C = 512 a 16-row tile of more units in
  // column parts of 4 WG_UNITS units, and the grouped one in pieces of 16
  // slots (16 x 16 rows, 16 x 48 columns).
  auto prod = [&](const __nv_bfloat16* A, int lda, int acol, int M,
                  const __nv_bfloat16* B, int ldb, int bcol, int Nn,
                  int grouped, int out_off, int cs_off) {
    if (grouped) {
      const int gm = C > 256 ? 256 : M;  // rows (16 a slot) of a piece
      for (int m0 = 0; m0 < M; m0 += gm, ++np)
        if (np < WG_ALLP)
          pieces[np] = {A, B, lda, ldb, acol + m0, bcol + 3 * m0, gm,
                        3 * gm, grouped, out_off + m0 * 48, -1, 3 * gm};
      return;
    }
    const int cw = Nn < 64 * WG_UNITS ? Nn : 64 * WG_UNITS;  // part columns
    const int mstep = 16 * (4 * WG_UNITS / (cw / 16));
    for (int c0 = 0; c0 < Nn; c0 += cw)
      for (int m0 = 0; m0 < M; m0 += mstep, ++np)
        if (np < WG_ALLP)
          pieces[np] = {A, B, lda, ldb, acol + m0, bcol + c0,
                        M - m0 < mstep ? M - m0 : mstep, cw, grouped,
                        out_off + m0 * Nn + c0,
                        m0 == 0 && cs_off >= 0 ? cs_off + c0 : -1, Nn};
  };
  if (freq) prod(s.gb, C, 0, C, s.dcomb, C, 0, C, 0, o_lin, -1);
  prod(s.ab, C, 0, C, s.dcomb, C, 0, C, 0, o_lin + (freq ? C * C : 0), -1);
  prod(s.ctx, C, 0, C, s.da, C, 0, C, 0, o_out, -1);
  prod(s.n2, C, 0, C, s.dqkv, 3 * C, 0, 3 * C, 0, o_in, o_inb);
  const int grouped = W == 16 ? 1 : 0;
  const int SL = grouped ? 1 : C / W;  // products a direction, ih or hh
  const int PM = grouped ? C : W;      // their rows
  for (int d = 0; d < D; ++d)
    for (int sl = 0; sl < SL; ++sl) {
      const int off = d * C * 3 * W + sl * W * 3 * W;
      prod(s.n1, C, sl * W, PM, s.dxp, D * 3 * C, d * 3 * C + sl * 3 * W,
           grouped ? 3 * C : 3 * W, grouped, o_ih + off, -1);
      prod(s.hprev + (size_t)d * rows * C, C, sl * W, PM, s.dhp, D * 3 * C,
           d * 3 * C + sl * 3 * W, grouped ? 3 * C : 3 * W, grouped,
           o_hh + off, -1);
    }
  if (np > WG_ALLP) return (int)cudaErrorInvalidValue;
  const size_t wsm = (size_t)2 * WG_STAGE * sizeof(__nv_bfloat16);
  LCT_TRY(allow_smem(wgrad_tc_kernel, wsm));
  // At most WG_MAXP pieces a launch (one launch below C = 256): each writes
  // its own pieces' outputs of the partial rows.
  for (int p0 = 0; p0 < np; p0 += WG_MAXP) {
    WgArgs wa = {};
    wa.np = np - p0 < WG_MAXP ? np - p0 : WG_MAXP;
    for (int i = 0; i < wa.np; ++i) wa.p[i] = pieces[p0 + i];
    wa.rows = rows;
    wa.chunk = s.wg_chunk;
    wa.nout = s.nout;
    wa.part = s.p_wg;
    wgrad_tc_kernel<<<s.grid_wg, RT, wsm, st>>>(wa);
    LCT_CHECK();
  }

  const int nb = (int)((N + bptt_seqs(W) - 1) / bptt_seqs(W));
  const int ldb2 = 2 * D * 3 * C;
  const int D3C = D * 3 * C;
  RedArgs ra = {{
      {s.p_dn1, gr, 2 * C, 0, C, dln1_s},
      {s.p_dn1, gr, 2 * C, C, C, dln1_b},
      {s.p_wg, s.grid_wg, s.nout, o_ih, DG, dw_ih},
      {s.p_wg, s.grid_wg, s.nout, o_hh, DG, dw_hh},
      {s.p_bptt, nb, ldb2, 0, D3C, db_ih},
      {s.p_bptt, nb, ldb2, D3C, D3C, db_hh},
      {s.p_dn2, gr, 2 * C, 0, C, dln2_s},
      {s.p_dn2, gr, 2 * C, C, C, dln2_b},
      {s.p_wg, s.grid_wg, s.nout, o_in, C * 3 * C, din_w},
      {s.p_wg, s.grid_wg, s.nout, o_inb, 3 * C, din_b},
      {s.p_wg, s.grid_wg, s.nout, o_out, C * C, dout_w},
      {s.p_comb, gr, 2 * C, C, C, dout_b},
      {s.p_wg, s.grid_wg, s.nout, o_lin, lin_in * C, dlin_w},
      {s.p_comb, gr, 2 * C, 0, C, dlin_b},
  }};
  reduce_tc_kernel<<<dim3(16, 14), 256, 0, st>>>(ra);
  LCT_CHECK();
  return 0;
}
