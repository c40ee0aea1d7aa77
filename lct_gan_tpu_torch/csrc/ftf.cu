// FTF block forward for Hopper (sm_90a): the whole function of the TPU
// kernel `lct_gan_tpu/ops/ftf.py::_ftf_kernel`, as five kernels in a row:
//
//   1. proj_kernel<true>  LN1 + grouped GRU input projection  -> xp  [N*L, D*3C]
//   2. gru_kernel         the GRU recurrence (both directions) -> hid [D, N*L, C]
//   3. proj_kernel<false> s = x + sum_d hid; LN2 + qkv        -> qkv [N*L, 3C]
//   4. attn_kernel<0>     4-head attention, band, key bias    -> ctx [N*L, C]
//   5. ftf_out_kernel     out-proj, Linear, LeakyReLU(0.2), +s -> out [N*L, C]
//
// Every product of the TPU kernel's body is computed here, with its bf16
// rounding points (see common.cuh); the scratch buffers are allocated by the
// Python wrapper (lct_gan_tpu_torch/ops/ftf.py).
//
// Bound on the H100: at the main path's shapes (B=128 x 2 s: N*L = 544,896
// rows of 64 channels) one block moves ~279 MB of x and out (~83 us at
// 3.35 TB/s) and does ~45-47 GFLOP of useful products (~46-48 us at the
// 989 TFLOP/s bf16 rate), so the function is bound by bytes. This simple
// design is not: it round-trips xp, hid, qkv and ctx through device memory
// (about 7x the bytes of x) and runs its products on CUDA cores in f32.
// Keeping a tile of sequences resident through all five stages and moving
// the products to wgmma is later work.

#include "common.cuh"

namespace lct {

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

// The grouped GRU recurrence. One thread per (sequence, direction, group,
// hidden unit): a group's 16 units are 16 lanes of one warp, which trade the
// rounded hidden state by shuffles, so the recurrent product h @ W_hh needs
// no shared memory and no barrier. Each thread keeps its three 16-entry
// columns of W_hh (r, z, n) in registers and walks the sequence (backwards
// for direction 1) in a loop: the sequential axis is inside the thread,
// sequences and groups run in parallel across the card.
__global__ void gru_kernel(const float* __restrict__ xp,
                           const float* __restrict__ w_hh,
                           const float* __restrict__ b_hh,
                           float* __restrict__ hid, long long N, int L, int D,
                           int round) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // The total is a multiple of 64 and blocks are too, so a warp is either
  // wholly in range or wholly out: the shuffles below see all 32 lanes.
  if (tid >= N * D * G * H) return;
  const int j = tid % H;
  const int g = (tid / H) % G;
  const int d = (tid / (G * H)) % D;
  const long long n = tid / ((long long)G * H * D);

  const float* wp = w_hh + (size_t)(d * G + g) * H * (3 * H);
  float wr[H], wz[H], wn[H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    wr[i] = rnd(wp[i * 3 * H + j], round);
    wz[i] = rnd(wp[i * 3 * H + H + j], round);
    wn[i] = rnd(wp[i * 3 * H + 2 * H + j], round);
  }
  const float* bp = b_hh + (d * G + g) * 3 * H;
  const float br = bp[j], bz = bp[H + j], bn = bp[2 * H + j];
  const size_t xstride = (size_t)D * 3 * C;
  const size_t NL = (size_t)N * L;

  float h = 0.f;
  for (int s = 0; s < L; ++s) {
    const int t = d ? L - 1 - s : s;
    const size_t row = (size_t)n * L + t;
    const float hr = rnd(h, round);
    float ar = 0.f, az = 0.f, an = 0.f;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float hi = __shfl_sync(0xffffffffu, hr, i, H);
      ar = fmaf(hi, wr[i], ar);
      az = fmaf(hi, wz[i], az);
      an = fmaf(hi, wn[i], an);
    }
    const float* xr = xp + row * xstride + d * 3 * C + g * 3 * H;
    const float r = sigmoidf_(xr[j] + (ar + br));
    const float z = sigmoidf_(xr[H + j] + (az + bz));
    const float nn = tanhf(xr[2 * H + j] + r * (an + bn));
    h = (1.f - z) * nn + z * h;
    hid[((size_t)d * NL + row) * C + g * H + j] = h;
  }
}

// a = ctx @ out_w + out_b; comb = [g @ lin_w[:C]] + a @ lin_w[C:] + lin_b
// (the first term for the frequency block only, lin_in == 2C); out = x + g +
// LeakyReLU(comb). One thread per output channel, ROWS rows per block.
__global__ void ftf_out_kernel(const float* __restrict__ x,
                               const float* __restrict__ hid, int D,
                               const float* __restrict__ ctx,
                               const float* __restrict__ out_w,
                               const float* __restrict__ out_b,
                               const float* __restrict__ lin_w,
                               const float* __restrict__ lin_b, int lin_in,
                               float* __restrict__ out, long long rows,
                               int round) {
  __shared__ float gt[ROWS][C];  // g, rounded (Linear operand)
  __shared__ float at[ROWS][C];  // ctx, then a, rounded
  const long long row0 = (long long)blockIdx.x * ROWS;
  const int c = threadIdx.x;
  float graw[ROWS];
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
    graw[r] = g;
    gt[r][c] = rnd(g, round);
    at[r][c] = rnd(cv, round);
  }
  __syncthreads();

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < C; ++k) {
    const float w = rnd(__ldg(out_w + k * C + c), round);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(at[r][k], w, acc[r]);
  }
  __syncthreads();
  const float ob = out_b[c];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) at[r][c] = rnd(acc[r] + ob, round);
  __syncthreads();

#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  const float* lw_a = lin_w;
  if (lin_in == 2 * C) {
#pragma unroll 4
    for (int k = 0; k < C; ++k) {
      const float w = rnd(__ldg(lin_w + k * C + c), round);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(gt[r][k], w, acc[r]);
    }
    lw_a = lin_w + C * C;
  }
#pragma unroll 4
  for (int k = 0; k < C; ++k) {
    const float w = rnd(__ldg(lw_a + k * C + c), round);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(at[r][k], w, acc[r]);
  }
  const float lb = lin_b[c];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = row0 + r;
    if (row < rows) {
      float comb = acc[r] + lb;
      comb = comb >= 0.f ? comb : 0.2f * comb;
      const size_t o = (size_t)row * C + c;
      out[o] = (x[o] + graw[r]) + comb;
    }
  }
}

}  // namespace lct

#define LCT_CHECK()                              \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// x, out: [N, L, 64]; w_ih, w_hh: [D, 4, 16, 48]; b_ih, b_hh: [D, 4, 48];
// in_w: [64, 192]; out_w: [64, 64]; lin_w: [lin_in, 64]; key_bias: [N, L] or
// null; lookback < 0 means no band. Scratch: xp [N*L, D*192], hid
// [D, N*L, 64], qkv [N*L, 192], ctx [N*L, 64]. Returns a cudaError_t.
extern "C" int lct_ftf_forward(
    const float* x, const float* ln1_s, const float* ln1_b,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ln2_s, const float* ln2_b,
    const float* in_w, const float* in_b, const float* out_w,
    const float* out_b, const float* lin_w, const float* lin_b,
    const float* key_bias, float* xp, float* hid, float* qkv, float* ctx,
    float* out, long long N, int L, int D, int lin_in, int lookback,
    int precise, int device, void* stream) {
  using namespace lct;
  cudaSetDevice(device);
  LCT_CHECK();
  cudaStream_t st = (cudaStream_t)stream;
  const int round = precise ? 0 : 1;
  const long long rows = N * L;
  const unsigned rblocks = (unsigned)((rows + ROWS - 1) / ROWS);

  proj_kernel<true><<<rblocks, D * 3 * C, 0, st>>>(
      x, nullptr, nullptr, ln1_s, ln1_b, w_ih, b_ih, xp, rows, D * 3 * C,
      round);
  LCT_CHECK();
  const long long gthreads = N * D * G * H;
  gru_kernel<<<(unsigned)((gthreads + 255) / 256), 256, 0, st>>>(
      xp, w_hh, b_hh, hid, N, L, D, round);
  LCT_CHECK();
  proj_kernel<false><<<rblocks, 3 * C, 0, st>>>(
      x, hid, D == 2 ? hid + (size_t)rows * C : nullptr, ln2_s, ln2_b, in_w,
      in_b, qkv, rows, 3 * C, round);
  LCT_CHECK();
  cudaError_t e = launch_attn<0>(qkv, key_bias, ctx, N, L, lookback, round, st);
  if (e != cudaSuccess) return (int)e;
  ftf_out_kernel<<<rblocks, C, 0, st>>>(x, hid, D, ctx, out_w, out_b, lin_w,
                                        lin_b, lin_in, out, rows, round);
  LCT_CHECK();
  return 0;
}
