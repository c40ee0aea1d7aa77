// FTF block backward for Hopper (sm_90a): the whole function of the TPU
// kernel `lct_gan_tpu/ops/ftf_bwd.py::_ftf_bwd_kernel`, as a row of simple
// kernels. Inputs: x, dout [N*L, 64], the forward's per-direction hiddens
// hid [D, N*L, 64] (unrounded f32) and the block's parameters. Outputs: dx
// and the 14 parameter gradients, f32, GRU gradients in the grouped
// [D, G, H, 3H] / [D, G, 3H] layout.
//
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
//   8. bptt_kernel                     dh_{t-1} = dh_t z_t + (dh_t K123_t) W_hh^T
//   9. dn1_kernel + ln_bwd_kernel      input-projection and LN1 backward -> dx
//  10. wgrad_kernel + reduce_kernel    every parameter gradient: per-chunk
//                                      partial sums over rows, then the chunks
//                                      summed in a fixed order
//
// Rounding (common.cuh): every GEMM operand is rounded to bf16 exactly where
// the TPU kernel rounds it (its `cd` casts), products accumulate in f32;
// `precise` keeps everything f32. The hp and xp recomputes round h_{t-1},
// n1 and the weights where the forward does and sum in the order of the
// f32 forward (gru_kernel, proj_kernel), so in precise mode the backward
// sees the forward's own gate values. The bf16 forward (ftf.cu's
// gru_tc_kernel) sums on tensor cores in another order and takes its
// sigmoid and tanh from the special-function unit's exp and reciprocal:
// there the gates agree to f32 noise, not bit for bit, and so does the qkv
// the backward recomputes. Both sides of a gradient see the same saved
// hiddens, so this moves no gradient beyond that noise.
//
// Determinism: no atomics. A parameter gradient is a sum over all N*L rows;
// wgrad_kernel gives each block a fixed chunk of rows and writes its partial
// sums, and reduce_kernel adds the chunks in index order. The result is the
// same from run to run for the same shapes.
//
// Bound on the H100: at the training shapes (B=64 x 2 s; freq N=8,256 L=33,
// time N=2,112 L=129: 272,448 rows each) the function reads x, dout and hid
// and writes dx (1.0-1.3 KB per row), 279-349 MB or 83-104 us at 3.35 TB/s,
// and does 47-71 GFLOP of useful products (47-71 us at the 989 TFLOP/s bf16
// rate): in bf16 it is bound by bytes. This simple design is far from that: it
// round-trips ~20 intermediates of 64-384 floats per row through device
// memory (~13 KB per row), runs every product on CUDA cores in f32, and
// walks the recurrence with one thread per hidden unit. Keeping a tile of
// sequences resident across the stages and moving the products to wgmma is
// later work.

#include "common.cuh"

namespace lct {

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

// LayerNorm rows of in = x (+ add0 (+ add1)), one warp per row: y, xhat and
// rstd (the arithmetic of proj_kernel's LayerNorm, so y is bit-equal to the
// operand the forward rounded).
__global__ void ln_kernel(const float* __restrict__ x,
                          const float* __restrict__ add0,
                          const float* __restrict__ add1,
                          const float* __restrict__ s,
                          const float* __restrict__ b, float* __restrict__ y,
                          float* __restrict__ xhat, float* __restrict__ rstd,
                          long long rows) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const size_t o = (size_t)row * C;
  float a = x[o + lane], c = x[o + lane + 32];
  if (add0) {
    a += add1 ? (add0[o + lane] + add1[o + lane]) : add0[o + lane];
    c += add1 ? (add0[o + lane + 32] + add1[o + lane + 32])
              : add0[o + lane + 32];
  }
  const float mu = warp_sum(a + c) * (1.f / C);
  const float ms = warp_sum(a * a + c * c) * (1.f / C);
  const float rs = rsqrtf(fmaxf(ms - mu * mu, 0.f) + 1e-6f);
  const float ha = (a - mu) * rs, hc = (c - mu) * rs;
  y[o + lane] = ha * s[lane] + b[lane];
  y[o + lane + 32] = hc * s[lane + 32] + b[lane + 32];
  xhat[o + lane] = ha;
  xhat[o + lane + 32] = hc;
  if (lane == 0) rstd[row] = rs;
}

// out = base + LN backward of dy:  rstd (dxh - mean(dxh) - xhat mean(dxh
// xhat)), dxh = dy * scale; out2 = out + extra when out2 is given. One warp
// per row.
__global__ void ln_bwd_kernel(const float* __restrict__ dy,
                              const float* __restrict__ xhat,
                              const float* __restrict__ rstd,
                              const float* __restrict__ scale,
                              const float* __restrict__ base,
                              const float* __restrict__ extra,
                              float* __restrict__ out,
                              float* __restrict__ out2, long long rows) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t o = (size_t)row * C;
  const float da = dy[o + lane] * scale[lane];
  const float dc = dy[o + lane + 32] * scale[lane + 32];
  const float xa = xhat[o + lane], xc = xhat[o + lane + 32];
  const float m1 = warp_sum(da + dc) * (1.f / C);
  const float m2 = warp_sum(da * xa + dc * xc) * (1.f / C);
  const float rs = rstd[row];
  const float oa = base[o + lane] + rs * (da - m1 - xa * m2);
  const float oc = base[o + lane + 32] + rs * (dc - m1 - xc * m2);
  out[o + lane] = oa;
  out[o + lane + 32] = oc;
  if (out2) {
    out2[o + lane] = oa + extra[o + lane];
    out2[o + lane + 32] = oc + extra[o + lane + 32];
  }
}

// The combine layer's backward over ROWS rows per block, one thread per
// channel c (blockDim.x == C):
//   a     = ctx @ out_w + out_b                      (recomputed)
//   comb  = [g @ lin_w[:C]] + a @ lin_w[C or 0:] + lin_b
//   dcomb = dout * (comb >= 0 ? 1 : 0.2)
//   dga   = dcomb @ lin_w^T  -> dg_lin = dga[:, :C] (frequency block), da
//   dctx  = da @ out_w^T
// Writes ga = [g | a] (rounded: the Linear's gradient operands), dcomb and
// da (unrounded: their column sums are the bias gradients), dg_lin, dctx.
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
                                float* __restrict__ dctx, long long rows,
                                int round) {
  __shared__ float t0[ROWS][C];  // ctx rounded, then dcomb rounded
  __shared__ float t1[ROWS][C];  // a rounded, then da rounded
  __shared__ float t2[ROWS][C];  // g rounded (frequency block)
  const long long row0 = (long long)blockIdx.x * ROWS;
  const int c = threadIdx.x;
  const bool freq = lin_in == 2 * C;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = row0 + r;
    float g = 0.f, cv = 0.f;
    if (row < rows) {
      const size_t o = (size_t)row * C + c;
      g = hid[o];
      if (D == 2) g += hid[(size_t)rows * C + o];
      cv = ctx[o];
    }
    t2[r][c] = rnd(g, round);
    t0[r][c] = rnd(cv, round);
  }
  __syncthreads();

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < C; ++k) {
    const float w = rnd(__ldg(out_w + k * C + c), round);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(t0[r][k], w, acc[r]);
  }
  const float ob = out_b[c];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float a = rnd(acc[r] + ob, round);
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
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  const float* lw_a = lin_w;
  if (freq) {
#pragma unroll 4
    for (int k = 0; k < C; ++k) {
      const float w = rnd(__ldg(lin_w + k * C + c), round);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(t2[r][k], w, acc[r]);
    }
    lw_a = lin_w + C * C;
  }
#pragma unroll 4
  for (int k = 0; k < C; ++k) {
    const float w = rnd(__ldg(lw_a + k * C + c), round);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(t1[r][k], w, acc[r]);
  }
  const float lb = lin_b[c];
  __syncthreads();  // every thread is done reading t0 (ctx)
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = row0 + r;
    float dc = 0.f;
    if (row < rows) {
      const size_t o = (size_t)row * C + c;
      const float comb = acc[r] + lb;
      dc = dout[o] * (comb >= 0.f ? 1.f : 0.2f);
      dcomb[o] = dc;
    }
    t0[r][c] = rnd(dc, round);
  }
  __syncthreads();

  // dga[m] = sum_j dcomb[j] lin_w[m, j]: thread c computes m = c (the da
  // column of the time block, the dg_lin column of the frequency block)
  // and, for the frequency block, m = C + c (its da column).
  float acc2[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = acc2[r] = 0.f;
#pragma unroll 4
  for (int j = 0; j < C; ++j) {
    const float w = rnd(__ldg(lin_w + c * C + j), round);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(t0[r][j], w, acc[r]);
  }
  if (freq) {
#pragma unroll 4
    for (int j = 0; j < C; ++j) {
      const float w = rnd(__ldg(lin_w + (C + c) * C + j), round);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc2[r] = fmaf(t0[r][j], w, acc2[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = row0 + r;
    const float dav = freq ? acc2[r] : acc[r];
    if (row < rows) {
      const size_t o = (size_t)row * C + c;
      da[o] = dav;
      if (freq) dglin[o] = acc[r];
    }
    t1[r][c] = rnd(dav, round);
  }
  __syncthreads();

  // dctx[c] = sum_k da[k] out_w[c, k]
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < C; ++k) {
    const float w = rnd(__ldg(out_w + c * C + k), round);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(t1[r][k], w, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = row0 + r;
    if (row < rows) dctx[(size_t)row * C + c] = acc[r];
  }
}

// The attention core's backward. One block per (sequence, head): Q, K, V
// and dctx of that head (rounded) in dynamic shared memory, 67 floats per
// position (137 KB at L = 512).
//   pass A, one thread per query q: the row max m_q and sum den_q, the
//     normalised p (rounded), dp = dctx_q . v_k, rowsum_q = sum_k dp p, and
//     dq = 1/4 sum_k round(p (dp - rowsum_q)) k_k;
//   pass B, one thread per key k: dk = 1/4 sum_q round(ds) q_q and
//     dv = sum_q p dctx_q over the queries whose band holds k, recomputing
//     p and dp from the stored m, den and rowsum (bit-equal to pass A's).
// Keys outside a query's band are never visited (p = 0 there).
__global__ void attn_bwd_kernel(const float* __restrict__ qkv,
                                const float* __restrict__ dctx,
                                float* __restrict__ dqkv, int L, int lookback,
                                int round) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = sm + L * HD;
  float* Vs = sm + 2 * L * HD;
  float* Ds = sm + 3 * L * HD;
  float* mq = sm + 4 * L * HD;
  float* dq_den = mq + L;
  float* rsum = dq_den + L;
  const long long n = blockIdx.x / NH;
  const int h = blockIdx.x % NH;
  const float* base = qkv + (size_t)n * L * (3 * C);
  const float* dbase = dctx + (size_t)n * L * C;
  for (int i = threadIdx.x; i < L * HD; i += blockDim.x) {
    const int t = i / HD, d = i % HD;
    Qs[i] = rnd(base[(size_t)t * 3 * C + h * HD + d], round);
    Ks[i] = rnd(base[(size_t)t * 3 * C + C + h * HD + d], round);
    Vs[i] = rnd(base[(size_t)t * 3 * C + 2 * C + h * HD + d], round);
    Ds[i] = rnd(dbase[(size_t)t * C + h * HD + d], round);
  }
  __syncthreads();

  auto score = [&](int q, int k) {
    const float* qr = Qs + q * HD;
    const float* kr = Ks + k * HD;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
    return s * 0.25f;
  };
  auto dprod = [&](int q, int k) {
    const float* dr = Ds + q * HD;
    const float* vr = Vs + k * HD;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) s = fmaf(dr[d], vr[d], s);
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
    float acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.f;
    for (int k = k0; k <= k1; ++k) {
      const float p = rnd(expf(score(q, k) - m) / den, round);
      const float ds = rnd(p * (dprod(q, k) - rs), round);
      const float* kr = Ks + k * HD;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
    }
    float* o = dqkv + ((size_t)n * L + q) * 3 * C + h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = rnd(acc[d] * 0.25f, round);
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
    float dk[HD], dv[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) dk[d] = dv[d] = 0.f;
    for (int q = q0; q <= q1; ++q) {
      const float p = rnd(expf(score(q, k) - mq[q]) / dq_den[q], round);
      const float ds = rnd(p * (dprod(q, k) - rsum[q]), round);
      const float* qr = Qs + q * HD;
      const float* dr = Ds + q * HD;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dk[d] = fmaf(ds, qr[d], dk[d]);
        dv[d] = fmaf(p, dr[d], dv[d]);
      }
    }
    float* o = dqkv + ((size_t)n * L + k) * 3 * C + h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      o[C + d] = rnd(dk[d] * 0.25f, round);
      o[2 * C + d] = rnd(dv[d], round);
    }
  }
}

// dn2 = dqkv @ in_w^T over ROWS rows per block, one thread per channel c
// (dqkv is stored rounded).
__global__ void dn2_kernel(const float* __restrict__ dqkv,
                           const float* __restrict__ in_w,
                           float* __restrict__ dn2, long long rows,
                           int round) {
  __shared__ float tile[ROWS][3 * C];
  const long long row0 = (long long)blockIdx.x * ROWS;
  const int c = threadIdx.x;
  for (int i = c; i < ROWS * 3 * C; i += blockDim.x) {
    const int r = i / (3 * C), m = i % (3 * C);
    const long long row = row0 + r;
    tile[r][m] = row < rows ? dqkv[(size_t)row * 3 * C + m] : 0.f;
  }
  __syncthreads();
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int m = 0; m < 3 * C; ++m) {
    const float w = rnd(__ldg(in_w + c * 3 * C + m), round);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(tile[r][m], w, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = row0 + r;
    if (row < rows) dn2[(size_t)row * C + c] = acc[r];
  }
}

// The GRU's gate factors for every (row, direction, unit) at once. One
// thread per (row, d, c = g*H + j). hp_{t} = h_{t-1} @ W_hh + b_hh from the
// saved hiddens shifted by one step (h_{t-1} for the forward direction,
// h_{t+1} for the backward one, 0 at the sequence's start), computed as
// the f32 forward's gru_kernel computes it: same rounding, same order of
// sums (the bf16 forward's gates differ by f32 noise). Writes
//   K[d, row, 0..4, c] = (K1, K2, K3, K4, K5)
//     K1 = P hp_n r (1 - r), K2 = (h_prev - n) z (1 - z), K3 = P r,
//     K4 = P, K5 = z,  with P = (1 - z)(1 - n^2)
// and hpv[d, row, c] = round(h_prev), the operand of dW_hh.
__global__ void gate_kernel(const float* __restrict__ xp,
                            const float* __restrict__ hid,
                            const float* __restrict__ w_hh,
                            const float* __restrict__ b_hh,
                            float* __restrict__ K, float* __restrict__ hpv,
                            long long N, int L, int D, int round) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long NL = N * L;
  if (tid >= NL * D * C) return;
  const int c = tid % C;
  const int d = (tid / C) % D;
  const long long row = tid / ((long long)C * D);
  const int g = c / H, j = c % H;
  const int t = row % L;
  const bool has_prev = d ? (t < L - 1) : (t > 0);
  const long long prow = d ? row + 1 : row - 1;
  const float* hp_row =
      has_prev ? hid + ((size_t)d * NL + prow) * C + g * H : nullptr;

  const float* wp = w_hh + (size_t)(d * G + g) * H * (3 * H);
  float ar = 0.f, az = 0.f, an = 0.f;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float hi = has_prev ? rnd(hp_row[i], round) : 0.f;
    ar = fmaf(hi, rnd(wp[i * 3 * H + j], round), ar);
    az = fmaf(hi, rnd(wp[i * 3 * H + H + j], round), az);
    an = fmaf(hi, rnd(wp[i * 3 * H + 2 * H + j], round), an);
  }
  const float* bp = b_hh + (d * G + g) * 3 * H;
  const float* xr = xp + (size_t)row * D * 3 * C + d * 3 * C + g * 3 * H;
  const float r = sigmoidf_(xr[j] + (ar + bp[j]));
  const float z = sigmoidf_(xr[H + j] + (az + bp[H + j]));
  const float hpn = an + bp[2 * H + j];
  const float nn = tanhf(xr[2 * H + j] + r * hpn);
  const float hprev = has_prev ? hp_row[j] : 0.f;
  const float P = (1.f - z) * (1.f - nn * nn);
  float* kp = K + ((size_t)d * NL + row) * 5 * C + c;
  kp[0] = P * hpn * r * (1.f - r);
  kp[C] = (hprev - nn) * z * (1.f - z);
  kp[2 * C] = P * r;
  kp[3 * C] = P;
  kp[4 * C] = z;
  hpv[((size_t)d * NL + row) * C + c] = rnd(hprev, round);
}

// BPTT through the saved gate factors. One thread per (sequence, direction,
// group, unit j), as in gru_kernel: a group's 16 units are 16 lanes of one
// warp that trade the rounded dhp values by shuffles. The forward direction
// walks t descending, the backward direction ascending:
//   dh  = carry + dg[t]
//   dhp = (dh K1, dh K2, dh K3),  dxp = (dh K1, dh K2, dh K4)  (written out)
//   carry = dh K5 + sum_{gate, k} round(dhp[gate, k]) W_hh[g, j, gate*H + k]
__global__ void bptt_kernel(const float* __restrict__ K,
                            const float* __restrict__ dg,
                            const float* __restrict__ w_hh,
                            float* __restrict__ dxp, float* __restrict__ dhp,
                            long long N, int L, int D, int round) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // The total is a multiple of 64 and blocks are too, so a warp is either
  // wholly in range or wholly out: the shuffles below see all 32 lanes.
  if (tid >= N * D * G * H) return;
  const int j = tid % H;
  const int g = (tid / H) % G;
  const int d = (tid / (G * H)) % D;
  const long long n = tid / ((long long)G * H * D);
  const long long NL = N * L;
  const int c = g * H + j;

  const float* wp = w_hh + ((size_t)(d * G + g) * H + j) * (3 * H);
  float wr[H], wz[H], wn[H];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    wr[k] = rnd(wp[k], round);
    wz[k] = rnd(wp[H + k], round);
    wn[k] = rnd(wp[2 * H + k], round);
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
    dxp[o] = er;
    dxp[o + H] = ez;
    dxp[o + 2 * H] = dh * kp[3 * C];
    dhp[o] = er;
    dhp[o + H] = ez;
    dhp[o + 2 * H] = en;
    const float rr = rnd(er, round), rz = rnd(ez, round), rn = rnd(en, round);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      acc = fmaf(__shfl_sync(0xffffffffu, rr, k, H), wr[k], acc);
      acc = fmaf(__shfl_sync(0xffffffffu, rz, k, H), wz[k], acc);
      acc = fmaf(__shfl_sync(0xffffffffu, rn, k, H), wn[k], acc);
    }
    carry = dh * kp[4 * C] + acc;
  }
}

// dn1[row, g*H + i] = sum_d sum_m round(dxp[row, d, g, m]) W_ih[d, g, i, m].
// One thread per (row, channel).
__global__ void dn1_kernel(const float* __restrict__ dxp,
                           const float* __restrict__ w_ih,
                           float* __restrict__ dn1, long long rows, int D,
                           int round) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= rows * C) return;
  const int c = tid % C;
  const long long row = tid / C;
  const int g = c / H, i = c % H;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) {
    const float* e = dxp + (size_t)row * D * 3 * C + d * 3 * C + g * 3 * H;
    const float* w = w_ih + ((size_t)(d * G + g) * H + i) * 3 * H;
#pragma unroll 8
    for (int m = 0; m < 3 * H; ++m)
      acc = fmaf(rnd(e[m], round), rnd(__ldg(w + m), round), acc);
  }
  dn1[(size_t)row * C + c] = acc;
}

// Parameter gradients: out[o] = sum over rows of A(row, ac(o)) * B(row,
// bc(o)), where (ac, bc) follows the mode:
//   WG_DENSE    o = i * J + j                   -> (i, j)        A^T B
//   WG_GROUPED  o = ((d*G + g)*H + i)*3H + m     -> (d*adir? + g*H + i,
//                                                   d*3C + g*3H + m)
//   WG_DIAG     o = c                           -> (c, c)        sum A*B
//   WG_COLSUM   o = c                           -> (-, c)        sum B
// Each block sums a fixed chunk of rows into its own partial row; no atomics.
// A and B sub-tiles of WG_TR rows are staged in shared memory (at most 128
// and 384 columns); each thread owns up to WG_MAXK outputs.
enum { WG_DENSE = 0, WG_GROUPED = 1, WG_DIAG = 2, WG_COLSUM = 3 };
constexpr int WG_THREADS = 256;
constexpr int WG_TR = 16;
constexpr int WG_MAXK = 48;  // 256 * 48 = 12,288 = the largest (in_w) grad
constexpr int WG_MAX_BLOCKS = 264;
constexpr int WG_ACOLS = 2 * C;
constexpr int WG_BCOLS = 6 * C;

__global__ void __launch_bounds__(WG_THREADS)
    wgrad_kernel(const float* __restrict__ A, int lda, long long adir,
                 int ra, const float* __restrict__ B, int ldb, int rb,
                 int mode, int J, int nout, int acols, int bcols,
                 long long rows, long long chunk_rows,
                 float* __restrict__ partial) {
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
      if (row < r1) {
        v = adir ? A[(col / C) * adir + row * lda + col % C]
                 : A[row * lda + col];
        v = rnd(v, ra);
      }
      As[rr][col] = v;
    }
    for (int i = tid; i < WG_TR * bcols; i += WG_THREADS) {
      const int rr = i / bcols, col = i % bcols;
      const long long row = rt + rr;
      Bs[rr][col] = row < r1 ? rnd(B[row * ldb + col], rb) : 0.f;
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
  // (WG_GROUPED with A = [D, rows, C]), else 0.
  cudaError_t operator()(int mode, const float* A, int lda, long long adir,
                         int ra, const float* B, int ldb, int rb, int J,
                         int nout, int acols, int bcols, float* out) const {
    long long nchunks = (rows + WG_TR - 1) / WG_TR;
    if (nchunks > WG_MAX_BLOCKS) nchunks = WG_MAX_BLOCKS;
    long long chunk = (rows + nchunks - 1) / nchunks;
    chunk = (chunk + WG_TR - 1) / WG_TR * WG_TR;
    const int nblocks = (int)((rows + chunk - 1) / chunk);
    wgrad_kernel<<<nblocks, WG_THREADS, 0, st>>>(
        A, lda, adir, ra, B, ldb, rb, mode, J, nout, acols, bcols, rows,
        chunk, partial);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    reduce_kernel<<<(nout + 255) / 256, 256, 0, st>>>(partial, nblocks, nout,
                                                       out);
    return cudaGetLastError();
  }
};

// Scratch layout (floats), rows = N * L.
struct Scratch {
  float *n2, *xh2, *rs2, *qkv, *ctx, *ga, *dcomb, *da, *dglin, *dctx, *dqkv,
      *dn2, *ds, *dgt, *n1, *xh1, *rs1, *xp, *K, *hpv, *dxp, *dhp, *dn1,
      *partial;
  long long total;

  Scratch(float* base, long long rows, int D) {
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
    total = off;
  }
};

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

// Floats of scratch `lct_ftf_backward` needs for N sequences of length L.
extern "C" long long lct_ftf_backward_scratch_floats(long long N, int L,
                                                     int D) {
  return lct::Scratch(nullptr, N * L, D).total;
}

// x, dout, dx: [N, L, 64]; hid: [D, N*L, 64]; parameters as in
// lct_ftf_forward (ftf.cu), their gradients in the same shapes; scratch:
// lct_ftf_backward_scratch_floats(N, L, D) floats. lookback < 0 means no
// band. Returns a cudaError_t.
extern "C" int lct_ftf_backward(
    const float* x, const float* ln1_s, const float* ln1_b,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ln2_s, const float* ln2_b,
    const float* in_w, const float* in_b, const float* out_w,
    const float* out_b, const float* lin_w, const float* lin_b,
    const float* hid, const float* dout, float* dx, float* dln1_s,
    float* dln1_b, float* dw_ih, float* dw_hh, float* db_ih, float* db_hh,
    float* dln2_s, float* dln2_b, float* din_w, float* din_b, float* dout_w,
    float* dout_b, float* dlin_w, float* dlin_b, float* scratch, long long N,
    int L, int D, int lin_in, int lookback, int precise, int device,
    void* stream) {
  using namespace lct;
  cudaSetDevice(device);
  LCT_CHECK();
  cudaStream_t st = (cudaStream_t)stream;
  const int round = precise ? 0 : 1;
  const long long rows = N * L;
  Scratch s(scratch, rows, D);
  const unsigned rblocks = (unsigned)((rows + ROWS - 1) / ROWS);
  const unsigned wblocks = (unsigned)((rows + 7) / 8);  // a warp per row
  const float* hid1 = D == 2 ? hid + (size_t)rows * C : nullptr;
  const bool freq = lin_in == 2 * C;

  // 1-2. recompute LN2, qkv and the attention context.
  ln_kernel<<<wblocks, 256, 0, st>>>(x, hid, hid1, ln2_s, ln2_b, s.n2, s.xh2,
                                     s.rs2, rows);
  LCT_CHECK();
  proj_kernel<false><<<rblocks, 3 * C, 0, st>>>(
      x, hid, hid1, ln2_s, ln2_b, in_w, in_b, s.qkv, rows, 3 * C, round);
  LCT_CHECK();
  LCT_TRY(launch_attn<1>(s.qkv, nullptr, s.ctx, N, L, lookback, round, st));

  // 3. combine layer and out-proj backward.
  comb_bwd_kernel<<<rblocks, C, 0, st>>>(
      hid, D, s.ctx, dout, out_w, out_b, lin_w, lin_b, lin_in, s.ga, s.dcomb,
      s.da, s.dglin, s.dctx, rows, round);
  LCT_CHECK();

  // 4. attention core backward.
  const size_t smem = (size_t)(4 * HD + 3) * L * sizeof(float);
  if (smem > 48 * 1024)
    LCT_TRY(cudaFuncSetAttribute(attn_bwd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem));
  int athreads = ((L + 31) / 32) * 32;
  if (athreads > 256) athreads = 256;
  attn_bwd_kernel<<<(unsigned)(N * NH), athreads, smem, st>>>(
      s.qkv, s.dctx, s.dqkv, L, lookback, round);
  LCT_CHECK();

  // 5. qkv projection and LN2 backward: ds, and dg = ds (+ dg_lin).
  dn2_kernel<<<rblocks, C, 0, st>>>(s.dqkv, in_w, s.dn2, rows, round);
  LCT_CHECK();
  ln_bwd_kernel<<<wblocks, 256, 0, st>>>(s.dn2, s.xh2, s.rs2, ln2_s, dout,
                                         freq ? s.dglin : nullptr, s.ds,
                                         freq ? s.dgt : nullptr, rows);
  LCT_CHECK();
  const float* dg = freq ? s.dgt : s.ds;

  // 6-8. GRU: LN1 and xp, the gate factors, BPTT.
  ln_kernel<<<wblocks, 256, 0, st>>>(x, nullptr, nullptr, ln1_s, ln1_b, s.n1,
                                     s.xh1, s.rs1, rows);
  LCT_CHECK();
  proj_kernel<true><<<rblocks, D * 3 * C, 0, st>>>(
      x, nullptr, nullptr, ln1_s, ln1_b, w_ih, b_ih, s.xp, rows, D * 3 * C,
      round);
  LCT_CHECK();
  const long long gthreads = rows * D * C;
  gate_kernel<<<(unsigned)((gthreads + 255) / 256), 256, 0, st>>>(
      s.xp, hid, w_hh, b_hh, s.K, s.hpv, N, L, D, round);
  LCT_CHECK();
  const long long bthreads = N * D * G * H;
  bptt_kernel<<<(unsigned)((bthreads + 255) / 256), 256, 0, st>>>(
      s.K, dg, w_hh, s.dxp, s.dhp, N, L, D, round);
  LCT_CHECK();

  // 9. input projection and LN1 backward: dx.
  dn1_kernel<<<(unsigned)((rows * C + 255) / 256), 256, 0, st>>>(
      s.dxp, w_ih, s.dn1, rows, D, round);
  LCT_CHECK();
  ln_bwd_kernel<<<wblocks, 256, 0, st>>>(s.dn1, s.xh1, s.rs1, ln1_s, s.ds,
                                         nullptr, dx, nullptr, rows);
  LCT_CHECK();

  // 10. parameter gradients.
  const Wgrad wg{s.partial, rows, st};
  const int D3C = D * 3 * C;
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, 0, s.dcomb, C, 0, 0, C, 0, C, dlin_b));
  LCT_TRY(wg(WG_DENSE, s.ga, lin_in, 0, 0, s.dcomb, C, round, C, lin_in * C,
             lin_in, C, dlin_w));
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, 0, s.da, C, 0, 0, C, 0, C, dout_b));
  LCT_TRY(wg(WG_DENSE, s.ctx, C, 0, round, s.da, C, round, C, C * C, C, C,
             dout_w));
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, 0, s.dqkv, 3 * C, 0, 0, 3 * C, 0,
             3 * C, din_b));
  LCT_TRY(wg(WG_DENSE, s.n2, C, 0, round, s.dqkv, 3 * C, 0, 3 * C,
             C * 3 * C, C, 3 * C, din_w));
  LCT_TRY(wg(WG_DIAG, s.dn2, C, 0, 0, s.xh2, C, 0, 0, C, C, C, dln2_s));
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, 0, s.dn2, C, 0, 0, C, 0, C, dln2_b));
  LCT_TRY(wg(WG_GROUPED, s.n1, C, 0, round, s.dxp, D3C, round, 0,
             D * G * H * 3 * H, C, D3C, dw_ih));
  LCT_TRY(wg(WG_GROUPED, s.hpv, C, rows * C, 0, s.dhp, D3C, round, 0,
             D * G * H * 3 * H, D * C, D3C, dw_hh));
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, 0, s.dxp, D3C, 0, 0, D3C, 0, D3C,
             db_ih));
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, 0, s.dhp, D3C, 0, 0, D3C, 0, D3C,
             db_hh));
  LCT_TRY(wg(WG_DIAG, s.dn1, C, 0, 0, s.xh1, C, 0, 0, C, C, C, dln1_s));
  LCT_TRY(wg(WG_COLSUM, nullptr, 0, 0, 0, s.dn1, C, 0, 0, C, 0, C, dln1_b));
  return 0;
}
