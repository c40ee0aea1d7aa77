// FTF block forward for Hopper (sm_90a): the whole function of the TPU
// kernel `lct_gan_tpu/ops/ftf.py::_ftf_kernel`, with its bf16 rounding
// points (see common.cuh). Two designs, one per mode; the scratch buffers
// are allocated by the Python wrapper (lct_gan_tpu_torch/ops/ftf.py).
//
// bf16 (lct_ftf_forward_bf16), every product on tensor cores (tc.cuh):
//   1. gru_tc_kernel      LN1, grouped input projection and the recurrence
//                         (both directions)            -> hid [D, N*L, C]
//   2. qkv_tc_kernel      s = x + g (g = sum_d hid); LN2; qkv
//                                  -> qkv bf16 [N*L, 3C], s, bf16(g) [N*L, C]
//   3. attn_tc_kernel<0>  C/hd-head attention (band, key bias), out-proj,
//                         Linear, LeakyReLU(0.2), +s   -> out [N*L, C]
// The only intermediates in device memory are values the contract has: the
// hiddens (unrounded f32: the backward and the save-hidden path read them),
// q, k, v (rounded to bf16 by the contract), s, and the Linear's bf16(g)
// (frequency block only). No xp, f32 qkv or context exists. Traffic: ~3.5
// KB per row (D = 2) or ~2.5 KB (D = 1), against ~7.5 KB for the f32
// design.
//
// precise (lct_ftf_forward_f32), all f32 on CUDA cores, five kernels:
//   proj_kernel<true> -> xp, gru_kernel -> hid, proj_kernel<false> -> qkv,
//   attn_kernel<0> -> ctx, ftf_out_kernel -> out.
//
// lct_grouped_gru_f32 is LN1 and the grouped GRU of the composed time block
// above L = 512 (ops/gru.py), all f32, in one launch of its own design
// (gru_f32_kernel, below): no xp in device memory.
//
// Widths: any true width c_true <= C (common.cuh; the kernels run at the
// library's kernel width C) in any num_heads and any GRU group count that
// the wrappers padded to C (ops/padding.py). The GRU
// kernels run over slots of 16 units (gru_tc_kernel<1>, gru_kernel,
// proj_kernel<true, 16>) or dense slots of W = C, or 64 at C = 128
// (gru_tc_kernel<W / 16>, gru_dense_kernel<W>, proj_kernel<true, W>), the
// TPU kernel's packing (lct_gan_tpu/ops/ftf.py:331): groups of 16 and
// groups of W are slots as they are; the caller packs narrower groups
// block-diagonally into slots of 16, and wider ones into those of W
// (ops/gru.py::pack_gru_slots; exact: the entries off the blocks are 0 and
// add nothing). The entry points take the GRU weights in slots: w [D,
// slots, W, 3W], b [D, slots, 3W], slots = C / W. One slot of 128 (a group
// of 128, or of 65-127 padded) would take 192 fragment registers a lane in
// gru_tc_kernel: the bf16 mode runs it on CUDA cores with the same
// rounding points (proj_kernel<true, 128> with round, gru_dense_kernel<
// true, 128>).
//
// Bound on the H100: at the main path's shapes (B=128 x 2 s: N*L = 544,896
// rows of 64 channels) one block moves ~279 MB of x and out (~83 us at
// 3.35 TB/s) and does ~45-47 GFLOP of useful products (~46-48 us at the
// 989 TFLOP/s bf16 rate), so the function is bound by bytes. The bf16
// design's own floor is its 1.4-2.0 GB of traffic (0.42-0.58 ms); its
// attention takes one exp per in-band pair (the max pass needs none).

#include <cooperative_groups.h>

#include "tc.cuh"

namespace lct {

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

// The grouped GRU recurrence over slots of 16 units, all f32. One thread
// per (sequence, direction, slot, hidden unit): a slot's 16 units are 16
// lanes of one warp, which
// trade the hidden state by shuffles, so the recurrent product h @ W_hh needs
// no shared memory and no barrier. Each thread keeps its three 16-entry
// columns of W_hh (r, z, n) in registers and walks the sequence (backwards
// for direction 1) in a loop: the sequential axis is inside the thread,
// sequences and groups run in parallel across the card. The register budget
// keeps 3 blocks (24 warps) resident per SM: the recurrence is latency-bound,
// and nvcc's own choice (82 registers) fits only 2.
__global__ void __launch_bounds__(256, 3)
    gru_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, float* __restrict__ hid,
               long long N, int L, int D) {
  constexpr int H = 16, G = C / H;  // slots of 16 units
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // For C >= 32 the total is a multiple of 32 and blocks are too, so a warp
  // is either wholly in range or wholly out: the shuffles below see all 32
  // lanes. At C = 16 a warp may hang over the end: its lanes past it run
  // sequence 0 and store nothing.
  const bool live = C % 32 == 0 || tid < N * D * G * H;
  if (C % 32 == 0 ? tid >= N * D * G * H : (tid & ~31LL) >= N * D * G * H)
    return;
  const int j = tid % H;
  const int g = (tid / H) % G;
  const int d = (tid / (G * H)) % D;
  const long long n = live ? tid / ((long long)G * H * D) : 0;

  const float* wp = w_hh + (size_t)(d * G + g) * H * (3 * H);
  float wr[H], wz[H], wn[H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    wr[i] = wp[i * 3 * H + j];
    wz[i] = wp[i * 3 * H + H + j];
    wn[i] = wp[i * 3 * H + 2 * H + j];
  }
  const float* bp = b_hh + (d * G + g) * 3 * H;
  const float br = bp[j], bz = bp[H + j], bn = bp[2 * H + j];
  const size_t xstride = (size_t)D * 3 * C;
  const size_t NL = (size_t)N * L;

  float h = 0.f;
  for (int s = 0; s < L; ++s) {
    const int t = d ? L - 1 - s : s;
    const size_t row = (size_t)n * L + t;
    float ar = 0.f, az = 0.f, an = 0.f;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float hi = __shfl_sync(0xffffffffu, h, i, H);
      ar = fmaf(hi, wr[i], ar);
      az = fmaf(hi, wz[i], az);
      an = fmaf(hi, wn[i], an);
    }
    const float* xr = xp + row * xstride + d * 3 * C + g * 3 * H;
    const float r = sigmoidf_(xr[j] + (ar + br));
    const float z = sigmoidf_(xr[H + j] + (az + bz));
    const float nn = tanhf(xr[2 * H + j] + r * (an + bn));
    h = (1.f - z) * nn + z * h;
    if (live) hid[((size_t)d * NL + row) * C + g * H + j] = h;
  }
}

// The same recurrence over dense slots of SW units (wider groups, packed
// block-diagonally): one slot of C, or at C = 128 two of 64, or at C = 256
// four of 64 or two of 128; all f32, or with ROUND the bf16 mode's
// products (bf16(h) @ bf16(W_hh), f32 accumulation; the bf16 GRU of C =
// 128's slot of 128 and of C = 256's slots of 64 and 128). A block takes
// one direction and DS sequences, one thread per (sequence, unit) of its UW
// units: all C, or at C = 256 one slot of 128 (blockIdx.z), whose W_hh
// alone fills the 192 KB that all of C = 128's take; W_hh of those units
// sits in shared memory (48 KB at C = 64; read by consecutive units: no
// bank conflict) and each step's hidden state is traded through a double
// buffer of shared memory, one barrier a step. Bound: latency, as
// gru_kernel.
constexpr int DS = 4;  // sequences per block of gru_dense_kernel

template <int SW>
inline size_t gru_dense_smem() {
  constexpr int UW = dense_units<SW>();
  return (size_t)(UW * 3 * SW + 2 * DS * UW) * sizeof(float);
}

template <bool ROUND, int SW>
__global__ void __launch_bounds__(DS * dense_units<SW>())
    gru_dense_kernel(const float* __restrict__ xp,
                     const float* __restrict__ w_hh,
                     const float* __restrict__ b_hh, float* __restrict__ hid,
                     long long N, int L, int D) {
  constexpr bool ONE = SW == C;  // one slot
  constexpr int UW = dense_units<SW>();
  extern __shared__ float gsm[];
  float* wsh = gsm;                // W_hh of the block's slots [UW / SW][SW][3 SW]
  float* hs = gsm + UW * 3 * SW;   // h [2][DS][UW] (ROUND: rounded)
  // u0: the block's first unit; uu the thread's among the block's, u in all
  const int u0 = UW == C ? 0 : (int)blockIdx.z * UW;
  const int d = blockIdx.y, uu = threadIdx.x % UW, sq = threadIdx.x / UW;
  const int u = u0 + uu;
  const int sl = ONE ? 0 : u / SW, j = ONE ? u : u % SW;  // slot, its unit
  const long long n = (long long)blockIdx.x * DS + sq;
  const bool live = n < N;
  const float* wp = w_hh + (size_t)d * C * (3 * SW) + (size_t)u0 * 3 * SW;
  for (int i = threadIdx.x; i < UW * 3 * SW; i += blockDim.x)
    wsh[i] = rnd(wp[i], ROUND);
  hs[sq * UW + uu] = 0.f;
  const float* bp = b_hh + d * 3 * C + sl * 3 * SW;
  const float br = bp[j], bz = bp[SW + j], bn = bp[2 * SW + j];
  const float* ws = wsh + (sl - u0 / SW) * SW * 3 * SW;  // the slot's W_hh
  const size_t xstride = (size_t)D * 3 * C;
  const size_t NL = (size_t)N * L;
  __syncthreads();

  float h = 0.f;
  for (int s = 0; s < L; ++s) {
    const int t = d ? L - 1 - s : s;
    const float* hp = hs + (s & 1) * DS * UW + sq * UW + (sl * SW - u0);
    float ar = 0.f, az = 0.f, an = 0.f;
#pragma unroll 8
    for (int i = 0; i < SW; ++i) {
      const float hi = hp[i];
      ar = fmaf(hi, ws[i * 3 * SW + j], ar);
      az = fmaf(hi, ws[i * 3 * SW + SW + j], az);
      an = fmaf(hi, ws[i * 3 * SW + 2 * SW + j], an);
    }
    if (live) {
      const size_t row = (size_t)n * L + t;
      const float* xr = xp + row * xstride + d * 3 * C + sl * 3 * SW;
      const float r = sigmoidf_(xr[j] + (ar + br));
      const float z = sigmoidf_(xr[SW + j] + (az + bz));
      const float nn = tanhf(xr[2 * SW + j] + r * (an + bn));
      h = (1.f - z) * nn + z * h;
      hid[((size_t)d * NL + row) * C + u] = h;
    }
    hs[((s + 1) & 1) * DS * UW + sq * UW + uu] = rnd(h, ROUND);
    __syncthreads();
  }
}

// The recurrence over dense slots of SW = 256 units (one GRU group of 256:
// the one slot of C = 256, or one of C = 512's two, blockIdx.z), all f32
// or with ROUND the bf16 mode's products, over xp from proj_kernel<true,
// SW>. One direction's W_hh of a slot is SW x 3SW f32 = 768 KB, more
// than the 227 KB of shared memory a block may hold, so a cluster of
// GC_CL = 8 blocks on neighbouring SMs walks the steps together: block
// `rank` owns units [32 rank, 32 rank + 32) of the slot and keeps their
// three gate columns of W_hh in registers (96 floats a thread: 256
// threads, thread (unit, k-part kq) holding inputs 4 kq + 32 i + e, i < 8,
// e < 4, so the 8 lanes of a unit read neighbouring 16-byte pieces of h:
// no bank conflict).
// Each step every block forms its units' r, z, n from the whole h in its
// own shared memory (partial sums added over a unit's 8 lanes by xor
// shuffles), lane kq writes the unit's new h into block kq's next h buffer
// through distributed shared memory, and the cluster crosses one barrier
// (release / acquire: the writes are visible after it). The h buffers are
// double-buffered, so one barrier a step is enough: a buffer is written
// one step after its last reads, with a barrier between. A cluster takes
// GC_DS sequences and one direction (blockIdx.y). Bound: latency, one
// cluster barrier and a 32-deep FMA chain a step.
#if LCT_C > 128
constexpr int GC_CL = 8;   // blocks of a cluster
constexpr int GC_DS = 4;   // sequences of a cluster
constexpr int GC_SW = 256;  // units a slot (C / GC_SW slots: blockIdx.z)

template <bool ROUND>
__global__ void __cluster_dims__(GC_CL, 1, 1) __launch_bounds__(256, 1)
    gru_cluster_kernel(const float* __restrict__ xp,
                       const float* __restrict__ w_hh,
                       const float* __restrict__ b_hh, float* __restrict__ hid,
                       long long N, int L, int D) {
  namespace cg = cooperative_groups;
  constexpr int SW = GC_SW;
  constexpr int UPC = SW / GC_CL;  // units a block: 32
  constexpr int KQ = 256 / UPC;    // lanes a unit: 8
  constexpr int KI = SW / KQ;      // inputs a lane: 32
  static_assert(UPC == 32 && KQ == GC_CL && KI % 4 == 0, "cluster GRU");
  __shared__ __align__(16) float hs[2][GC_DS][SW];  // h (ROUND: rounded)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.y, kq = threadIdx.x % KQ;
  const int sl = SW == C ? 0 : (int)blockIdx.z;  // the slot
  const int u = rank * UPC + threadIdx.x / KQ;   // the unit in the slot
  const long long n0 = (long long)(blockIdx.x / GC_CL) * GC_DS;
  const float* wp = w_hh + (size_t)(d * (C / SW) + sl) * SW * 3 * SW + u;
  float wr[KI], wz[KI], wn[KI];
#pragma unroll
  for (int i = 0; i < KI / 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t k = (size_t)(4 * kq + 32 * i + e) * 3 * SW;
      wr[4 * i + e] = rnd(wp[k], ROUND);
      wz[4 * i + e] = rnd(wp[k + SW], ROUND);
      wn[4 * i + e] = rnd(wp[k + 2 * SW], ROUND);
    }
  const float* bp = b_hh + (size_t)(d * (C / SW) + sl) * 3 * SW + u;
  const float br = bp[0], bz = bp[SW], bn = bp[2 * SW];
  for (int i = threadIdx.x; i < 2 * GC_DS * SW; i += blockDim.x)
    (&hs[0][0][0])[i] = 0.f;
  cluster.sync();  // every block's buffers are zero before any remote write

  const size_t xstride = (size_t)D * 3 * C;
  const size_t NL = (size_t)N * L;
  float h[GC_DS];
#pragma unroll
  for (int q = 0; q < GC_DS; ++q) h[q] = 0.f;
  for (int s = 0; s < L; ++s) {
    const int t = d ? L - 1 - s : s;
    float xr[GC_DS], xz[GC_DS], xn[GC_DS];
#pragma unroll
    for (int q = 0; q < GC_DS; ++q) {
      xr[q] = xz[q] = xn[q] = 0.f;
      if (n0 + q < N) {
        const float* x = xp + ((size_t)(n0 + q) * L + t) * xstride +
                         (size_t)d * 3 * C + sl * 3 * SW + u;
        xr[q] = x[0];
        xz[q] = x[SW];
        xn[q] = x[2 * SW];
      }
    }
    const float* hb = &hs[s & 1][0][0] + 4 * kq;
    float ar[GC_DS], az[GC_DS], an[GC_DS];
#pragma unroll
    for (int q = 0; q < GC_DS; ++q) ar[q] = az[q] = an[q] = 0.f;
#pragma unroll
    for (int i = 0; i < KI / 4; ++i)
#pragma unroll
      for (int q = 0; q < GC_DS; ++q) {
        const float4 hv =
            *reinterpret_cast<const float4*>(hb + q * SW + 32 * i);
        ar[q] = fmaf(hv.x, wr[4 * i], ar[q]);
        az[q] = fmaf(hv.x, wz[4 * i], az[q]);
        an[q] = fmaf(hv.x, wn[4 * i], an[q]);
        ar[q] = fmaf(hv.y, wr[4 * i + 1], ar[q]);
        az[q] = fmaf(hv.y, wz[4 * i + 1], az[q]);
        an[q] = fmaf(hv.y, wn[4 * i + 1], an[q]);
        ar[q] = fmaf(hv.z, wr[4 * i + 2], ar[q]);
        az[q] = fmaf(hv.z, wz[4 * i + 2], az[q]);
        an[q] = fmaf(hv.z, wn[4 * i + 2], an[q]);
        ar[q] = fmaf(hv.w, wr[4 * i + 3], ar[q]);
        az[q] = fmaf(hv.w, wz[4 * i + 3], az[q]);
        an[q] = fmaf(hv.w, wn[4 * i + 3], an[q]);
      }
    float* nb = cluster.map_shared_rank(&hs[(s + 1) & 1][0][0], kq);
#pragma unroll
    for (int q = 0; q < GC_DS; ++q) {
#pragma unroll
      for (int o = 1; o < KQ; o <<= 1) {
        ar[q] += __shfl_xor_sync(0xffffffffu, ar[q], o);
        az[q] += __shfl_xor_sync(0xffffffffu, az[q], o);
        an[q] += __shfl_xor_sync(0xffffffffu, an[q], o);
      }
      const float r = sigmoidf_(xr[q] + (ar[q] + br));
      const float z = sigmoidf_(xz[q] + (az[q] + bz));
      const float nn = tanhf(xn[q] + r * (an[q] + bn));
      h[q] = (1.f - z) * nn + z * h[q];
      nb[q * SW + u] = rnd(h[q], ROUND);
      if (kq == 0 && n0 + q < N)
        hid[((size_t)d * NL + (size_t)(n0 + q) * L + t) * C + sl * SW + u] =
            h[q];
    }
    cluster.sync();
  }
}
#endif

#if LCT_C > 256
// The recurrence over one dense slot of C = 512 units (one GRU group of
// 512), all f32 or with ROUND the bf16 mode's products, over xp from
// proj_kernel<true, C>: one launch a step, for every sequence and both
// directions at once (the shape of the TPU kernel's own step, hp =
// dot(h, whh) over a tile of sequences, lct_gan_tpu/ops/ftf.py:190). One
// direction's W_hh is C x 3C f32 = 3 MB: a cluster of 8 would hold 192
// floats a thread in registers, and one of 16 (the most a cluster may
// take) would run each step ~1,000 waves of clusters deep at the
// frequency block's 16,512 sequences, against this design's 8,256 blocks
// a step. So each step is a tiled product over all sequences,
//   [h_{t-1}](N x C) @ W_hh[d](C x 3C), the gates in its epilogue:
// a block takes GSR = 64 sequences and GSU = 32 units (their r, z and n
// columns: 96), streams h and W_hh through shared memory in k-chunks of
// GSK = 32 inputs, and each thread keeps 4 sequences x 2 units x 3 gates
// of f32 sums (f32 FMAs on CUDA cores; ROUND rounds both operands to bf16
// first, which makes each product exact in f32, the tensor cores'
// arithmetic up to the order of the sums). h_{t-1} is read from the
// hiddens the previous step wrote (hid, unrounded f32: the carry), W_hh
// from L2 (3 MB a direction). Bound: each step moves the N x C hiddens in
// and out and reads W_hh; at N = 16,512 its 26 GFLOP a direction take
// ~0.4 ms on the f32 pipes, so the function is bound by operations (the
// products); at small N (the banded long shape's 132 sequences) by the
// launch a step.
constexpr int GSR = 64;  // sequences a block
constexpr int GSU = 32;  // units a block
constexpr int GSK = 32;  // inputs a k-chunk

template <bool ROUND>
__global__ void __launch_bounds__(256)
    gru_step_kernel(const float* __restrict__ xp,
                    const float* __restrict__ w_hh,
                    const float* __restrict__ b_hh, float* __restrict__ hid,
                    long long N, int L, int D, int s) {
  __shared__ __align__(16) float hsm[GSK][GSR + 4];  // h chunk, [input][seq]
  __shared__ __align__(16) float wsm[GSK][3 * GSU];  // W_hh [in][gate, unit]
  const int d = blockIdx.z;
  const int t = d ? L - 1 - s : s, tp = d ? t + 1 : t - 1;  // tp: step s - 1
  const long long n0 = (long long)blockIdx.x * GSR;
  const int u0 = blockIdx.y * GSU;
  // Thread (ty, tx): sequences n0 + 4 ty + r (r < 4), units u0 + 2 tx + e.
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t NL = (size_t)N * L;
  const float* hd = hid + (size_t)d * NL * C;  // this direction's hiddens
  float acc[3][4][2];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[g][r][0] = acc[g][r][1] = 0.f;
  if (s > 0) {  // h before the first step is 0
    for (int k0 = 0; k0 < C; k0 += GSK) {
      for (int i = threadIdx.x; i < GSR * GSK; i += blockDim.x) {
        const int r = i / GSK, k = i % GSK;
        const long long n = n0 + r;
        hsm[k][r] =
            n < N ? rnd(hd[((size_t)n * L + tp) * C + k0 + k], ROUND) : 0.f;
      }
      for (int i = threadIdx.x; i < GSK * 3 * GSU; i += blockDim.x) {
        const int k = i / (3 * GSU), c = i % (3 * GSU);
        wsm[k][c] = rnd(w_hh[((size_t)d * C + k0 + k) * 3 * C +
                             (c / GSU) * C + u0 + c % GSU],
                        ROUND);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < GSK; ++k) {
        const float4 hv = *reinterpret_cast<const float4*>(&hsm[k][4 * ty]);
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float2 w =
              *reinterpret_cast<const float2*>(&wsm[k][g * GSU + 2 * tx]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[g][r][0] = fmaf(hr[r], w.x, acc[g][r][0]);
            acc[g][r][1] = fmaf(hr[r], w.y, acc[g][r][1]);
          }
        }
      }
      __syncthreads();
    }
  }
  const float* bp = b_hh + (size_t)d * 3 * C;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long n = n0 + 4 * ty + r;
    if (n >= N) continue;
    const size_t row = (size_t)n * L + t;
    const float* xr = xp + row * ((size_t)D * 3 * C) + (size_t)d * 3 * C;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int u = u0 + 2 * tx + e;
      const float h = s > 0 ? hd[((size_t)n * L + tp) * C + u] : 0.f;
      const float rg = sigmoidf_(xr[u] + (acc[0][r][e] + bp[u]));
      const float z = sigmoidf_(xr[C + u] + (acc[1][r][e] + bp[C + u]));
      const float nn =
          tanhf(xr[2 * C + u] + rg * (acc[2][r][e] + bp[2 * C + u]));
      hid[((size_t)d * NL + row) * C + u] = (1.f - z) * nn + z * h;
    }
  }
}

// L launches of gru_step_kernel<ROUND>, one a step.
template <bool ROUND>
cudaError_t launch_gru_steps(const float* xp, const float* w_hh,
                             const float* b_hh, float* hid, long long N,
                             int L, int D, cudaStream_t st) {
  if (N == 0) return cudaSuccess;
  const dim3 grid((unsigned)((N + GSR - 1) / GSR), C / GSU, (unsigned)D);
  for (int s = 0; s < L; ++s) {
    gru_step_kernel<ROUND><<<grid, 256, 0, st>>>(xp, w_hh, b_hh, hid, N, L,
                                                 D, s);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
#endif

// a = ctx @ out_w + out_b; comb = [g @ lin_w[:C]] + a @ lin_w[C:] + lin_b
// (the first term for the frequency block only, lin_in == 2C); out = x + g +
// LeakyReLU(comb), all f32. One thread per output channel, OUT_ROWS rows
// per block; the register budget keeps 8 blocks resident per SM at C = 64
// (nvcc's own choice, 158 registers, fits 6 and was slower despite no
// spills), 4 at C = 128 (the same registers a thread), 2 at C = 256, whose
// blocks take 16 rows: two tiles of 32 rows of 256 floats would pass the 48
// KB of static shared memory; 1 at C = 512, whose blocks take 8 rows.
constexpr int OUT_ROWS = C > 256 ? 8 : C > 128 ? 16 : ROWS;

__global__ void __launch_bounds__(C, C > 64 ? 8 * 64 / C : 8)
    ftf_out_kernel(const float* __restrict__ x, const float* __restrict__ hid,
                   int D, const float* __restrict__ ctx,
                   const float* __restrict__ out_w,
                   const float* __restrict__ out_b,
                   const float* __restrict__ lin_w,
                   const float* __restrict__ lin_b, int lin_in,
                   float* __restrict__ out, long long rows) {
  __shared__ float gt[OUT_ROWS][C];  // g (Linear operand)
  __shared__ float at[OUT_ROWS][C];  // ctx, then a
  const long long row0 = (long long)blockIdx.x * OUT_ROWS;
  const int c = threadIdx.x;
#pragma unroll
  for (int r = 0; r < OUT_ROWS; ++r) {
    const long long row = row0 + r;
    float g = 0.f, cv = 0.f;
    if (row < rows) {
      const size_t o = (size_t)row * C + c;
      g = hid[o];
      if (D == 2) g += hid[(size_t)rows * C + o];
      cv = ctx[o];
    }
    gt[r][c] = g;
    at[r][c] = cv;
  }
  __syncthreads();

  float acc[OUT_ROWS];
#pragma unroll
  for (int r = 0; r < OUT_ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < C; ++k) {
    const float w = __ldg(out_w + k * C + c);
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) acc[r] = fmaf(at[r][k], w, acc[r]);
  }
  __syncthreads();
  const float ob = out_b[c];
#pragma unroll
  for (int r = 0; r < OUT_ROWS; ++r) at[r][c] = acc[r] + ob;
  __syncthreads();

#pragma unroll
  for (int r = 0; r < OUT_ROWS; ++r) acc[r] = 0.f;
  const float* lw_a = lin_w;
  if (lin_in == 2 * C) {
#pragma unroll 4
    for (int k = 0; k < C; ++k) {
      const float w = __ldg(lin_w + k * C + c);
#pragma unroll
      for (int r = 0; r < OUT_ROWS; ++r) acc[r] = fmaf(gt[r][k], w, acc[r]);
    }
    lw_a = lin_w + C * C;
  }
#pragma unroll 4
  for (int k = 0; k < C; ++k) {
    const float w = __ldg(lw_a + k * C + c);
#pragma unroll
    for (int r = 0; r < OUT_ROWS; ++r) acc[r] = fmaf(at[r][k], w, acc[r]);
  }
  const float lb = lin_b[c];
#pragma unroll
  for (int r = 0; r < OUT_ROWS; ++r) {
    const long long row = row0 + r;
    if (row < rows) {
      float comb = acc[r] + lb;
      comb = comb >= 0.f ? comb : 0.2f * comb;
      const size_t o = (size_t)row * C + c;
      out[o] = (x[o] + gt[r][c]) + comb;
    }
  }
}

namespace tc {

// Steps per chunk of staged LN1 rows: 8, at C = 512 4 (two chunks of 8
// steps of 16 rows of 520 bf16 would pass the shared memory of a block).
constexpr int TS = C > 256 ? 4 : 8;
// Blocks a direction's slots of 16 take in gru_tc_kernel<1>: 1, at C = 512
// 2 (blockIdx.z), each 16 slots (a direction's 32 warps would fill 1,024
// threads, 64 registers a thread).
constexpr int GRU_PARTS = C > 256 ? 2 : 1;
// LN1 rows a warp stages per step (D GS / warps, C / 16 / GRU_PARTS warps a
// direction).
constexpr int GRU_ROWS = C > 256 ? 1 : 256 / C;
constexpr int WPD_LOG2 = PIECES_LOG2 - 1;  // log2 of C / 16

struct GruArgs {
  const float* x;
  const float* ln_s;
  const float* ln_b;
  const float* w_ih;  // slots [D, C/W, W, 3W] (pack_gru_slots)
  const float* w_hh;
  const float* b_ih;  // [D, C/W, 3W]
  const float* b_hh;
  float* hid;  // [D, N*L, C]
  long long N;
  int L;
  int D;
  float inv_c;  // 1 / the true channel count (LN1's)
};

// Whether gru_tc_kernel<KS> takes one direction a block (dense slots at
// C = 128, and every slot at C >= 256, where both directions' 32 warps
// would pass 1,024 threads) rather than all of them.
__host__ __device__ constexpr bool split_directions(int KS) {
  return C > 128 || (C > 64 && KS > 1);
}

// The threads of a gru_tc_kernel<KS> block: 32 a warp, C / 16 warps a
// direction (over GRU_PARTS blocks).
__host__ __device__ constexpr int gru_tc_threads(int KS) {
  return C > 256 ? 2 * C / GRU_PARTS : split_directions(KS) ? 2 * C : 4 * C;
}

// Two chunk buffers of LN1 rows, bf16 [2][D][TS][GS][LDS], and for KS > 1
// two buffers of the hidden state, bf16 [2][D][GS][LDS] (D: directions a
// block).
template <int KS>
inline size_t gru_smem(int D) {
  return (size_t)2 * D * (TS + (KS > 1 ? 1 : 0)) * GS * LDS *
         sizeof(__nv_bfloat16);
}

// LN1, the grouped input projection and the GRU recurrence in one pass, on
// tensor cores. A block takes 16 sequences; with P = C / 16 warps a
// direction, warp w runs direction w / P and the 16 units 16 (w % P) ..
// over them, walking the steps (backwards for direction 1). KS = 1: slots
// of 16 units, warp w's units are slot w % P. Per step, with the 16
// sequences as the M rows of one m16n8k16 tile:
//   bf16(n1_t) [16 x 16] @ bf16(W_ih[d, g]) [16 x 48]   6 products
//   bf16(h)    [16 x 16] @ bf16(W_hh[d, g]) [16 x 48]   6 products
// KS > 1: dense slots of W = 16 KS units (one of C <= 64, or two of 64 at
// C = 128); each product takes the slot's W inputs as KS k-steps (6 KS + 6
// KS products a step), and the P warps of a direction trade their units'
// bf16 h through shared memory, one block barrier a step (double-buffered).
// At C = 128 a block then takes one direction (blockIdx.y): 8 warps of 96
// fragment registers each, where both directions' 16 warps would leave a
// thread 128 registers.
// W_ih and W_hh stay in registers as B fragments. The r and z gates sum
// both products in one accumulator started from b_ih + b_hh; n keeps them
// apart (r multiplies only the hidden part). The accumulator layout is the
// same in every n8 tile, so the lane that holds r for (sequence, unit) also
// holds z and n for it, and the gate math needs no exchange; the new h,
// rounded and packed, is exactly the next step's A fragment, so the hidden
// state never leaves registers (the f32 carry stays unrounded).
//
// LN1 rows (proj_kernel's LayerNorm arithmetic, so the backward's ln_kernel
// computes the same operand) go to shared memory as bf16 in chunks of TS
// steps, double-buffered: during each step of chunk c every warp loads
// GRU_ROWS rows of chunk c + 1, and normalises and stores them after the
// step's products, so the loads' latency hides under the recurrence's.
// No xp exists in memory.
//
// Bound: the recurrence is sequential in L, so each step's chain (one
// product, three gates) is latency; across the card it moves x in (once per
// direction) and the f32 hiddens out.
//
// PADDED: the rows hold fewer true channels than C, and LN1 divides by
// their count (a.inv_c). Rows of C true channels take the instance that
// divides by the constant 1 / C: with the divisor a kernel argument, nvcc
// gave the C = 64 slots of 16 134 registers a thread, not 116, which fits
// one block of 256 threads an SM instead of two.
template <int KS, bool PADDED>
__global__ void __launch_bounds__(gru_tc_threads(KS))
    gru_tc_kernel(GruArgs a) {
  constexpr bool SPLIT = split_directions(KS);
  constexpr int SLOTS = C / (16 * KS);  // KS > 1: dense slots a direction
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* n1s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // grp: the warp's 16 units; d its direction, dl that within the block
  const int d = SPLIT ? (int)blockIdx.y : warp >> WPD_LOG2;
  const int grp = GRU_PARTS > 1
                      ? (int)blockIdx.z * (C / 16 / GRU_PARTS) + warp
                      : warp & ((1 << WPD_LOG2) - 1);
  const int dl = SPLIT ? 0 : d;
  const int L = a.L, D = SPLIT ? 1 : a.D;  // directions in the block
  const long long n0 = (long long)blockIdx.x * GS;
  const size_t NL = (size_t)a.N * L;
  __nv_bfloat16* hx = n1s + (size_t)2 * D * TS * GS * LDS;  // KS > 1
  // KS > 1: the first unit of the warp's slot
  const int slot0 = SLOTS == 1 ? 0 : (grp / KS) * 16 * KS;

  typename GruFragsOf<KS>::type f;
  if constexpr (KS == 1)
    load_gru_frags(f, a.w_ih, a.w_hh, a.b_ih, a.b_hh, d * (C / 16) + grp,
                   lane);
  else
    load_gru_frags(f, a.w_ih, a.w_hh, a.b_ih, a.b_hh,
                   SLOTS == 1 ? d : d * SLOTS + grp / KS,
                   SLOTS == 1 ? grp : grp % KS, lane);
  const auto& bi = f.bi;
  const auto& bh = f.bh;
  const auto& brz = f.brz;
  const auto& bxn = f.bxn;
  const auto& bhn = f.bhn;
  float ls[CPL], lb[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    ls[i] = lane_holds(lane, i) ? a.ln_s[lane + 32 * i] : 0.f;
    lb[i] = lane_holds(lane, i) ? a.ln_b[lane + 32 * i] : 0.f;
  }

  // Row task i of a chunk: direction i / (TS GS), step (i / GS) % TS,
  // sequence i % GS (D TS GS = nwarps TS GRU_ROWS tasks in all).
  auto fetch = [&](int cc, int i, float (&v)[CPL]) {
    const int dd = SPLIT ? d : i / (TS * GS), step = cc * TS + (i / GS) % TS;
    const long long n = n0 + i % GS;
#pragma unroll
    for (int j = 0; j < CPL; ++j) v[j] = 0.f;
    if (step < L && n < a.N) {
      const size_t o = ((size_t)n * L + (dd ? L - 1 - step : step)) * C;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (lane_holds(lane, j)) v[j] = a.x[o + lane + 32 * j];
    }
  };
  auto put = [&](int cc, int i, float (&v)[CPL]) {
    ln_row(v, ls, lb, PADDED ? a.inv_c : 1.f / C);
    __nv_bfloat16* dst = n1s + ((size_t)(cc & 1) * D * TS * GS + i) * LDS;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (lane_holds(lane, j)) dst[lane + 32 * j] = __float2bfloat16_rn(v[j]);
  };

  // Chunk 0, 2 GRU_ROWS rows at a time.
#pragma unroll 1
  for (int st = 0; st < TS; st += 2) {
    float v[2 * GRU_ROWS][CPL];
    const int i0 = (st * nwarps + 2 * warp) * GRU_ROWS;
#pragma unroll
    for (int k = 0; k < 2 * GRU_ROWS; ++k) fetch(0, i0 + k, v[k]);
#pragma unroll
    for (int k = 0; k < 2 * GRU_ROWS; ++k) put(0, i0 + k, v[k]);
  }
  __syncthreads();

  // h[jh][e]: sequence g + 8 (e >> 1), unit 8 jh + 2t + (e & 1): the C
  // fragment layout of n-tiles jh (r), 2 + jh (z), 4 + jh (n).
  float h[2][4] = {};
  uint32_t ha[KS][4] = {};
  const int nchunks = (L + TS - 1) / TS;
  for (int cc = 0; cc < nchunks; ++cc) {
    const int c0 = cc * TS, ns = min(TS, L - c0);
    const bool more = cc + 1 < nchunks;  // then ns == TS
    const __nv_bfloat16* cur = n1s +
                               (size_t)((cc & 1) * D + dl) * TS * GS * LDS +
                               (KS == 1 ? grp * 16 : slot0);
    for (int st = 0; st < ns; ++st) {
      float v[GRU_ROWS][CPL];
      const int i0 = (st * nwarps + warp) * GRU_ROWS;
      if (more) {
#pragma unroll
        for (int k = 0; k < GRU_ROWS; ++k) fetch(cc + 1, i0 + k, v[k]);
      }
      const int tt = d ? L - 1 - (c0 + st) : c0 + st;
      uint32_t ax[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        load_a(ax[kk], cur + st * GS * LDS + kk * 16, LDS, lane);
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
          mma(ar[jh], ax[0], bi[jh][0], bi[jh][1]);
          mma(az[jh], ax[0], bi[2 + jh][0], bi[2 + jh][1]);
          mma(xn[jh], ax[0], bi[4 + jh][0], bi[4 + jh][1]);
        }
#pragma unroll
        for (int jh = 0; jh < 2; ++jh) {
          mma(ar[jh], ha[0], bh[jh][0], bh[jh][1]);
          mma(az[jh], ha[0], bh[2 + jh][0], bh[2 + jh][1]);
          mma(hn[jh], ha[0], bh[4 + jh][0], bh[4 + jh][1]);
        }
      } else {
#pragma unroll
        for (int jh = 0; jh < 2; ++jh)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            mma(ar[jh], ax[kk], bi[jh][kk][0], bi[jh][kk][1]);
            mma(az[jh], ax[kk], bi[2 + jh][kk][0], bi[2 + jh][kk][1]);
            mma(xn[jh], ax[kk], bi[4 + jh][kk][0], bi[4 + jh][kk][1]);
            mma(ar[jh], ha[kk], bh[jh][kk][0], bh[jh][kk][1]);
            mma(az[jh], ha[kk], bh[2 + jh][kk][0], bh[2 + jh][kk][1]);
            mma(hn[jh], ha[kk], bh[4 + jh][kk][0], bh[4 + jh][kk][1]);
          }
      }
#pragma unroll
      for (int jh = 0; jh < 2; ++jh)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float r = sigmoid_sfu(ar[jh][e]);
          const float z = sigmoid_sfu(az[jh][e]);
          const float nn = tanh_sfu(fmaf(r, hn[jh][e], xn[jh][e]));
          h[jh][e] = (1.f - z) * nn + z * h[jh][e];
        }
      if constexpr (KS == 1) {
        ha[0][0] = pack_bf16(h[0][0], h[0][1]);
        ha[0][1] = pack_bf16(h[0][2], h[0][3]);
        ha[0][2] = pack_bf16(h[1][0], h[1][1]);
        ha[0][3] = pack_bf16(h[1][2], h[1][3]);
      } else {
        // This warp's units into the step's buffer, then all C back as
        // the A fragments of the next step's hidden product.
        __nv_bfloat16* hb =
            hx + ((size_t)((c0 + st) & 1) * D + dl) * GS * LDS;
#pragma unroll
        for (int jh = 0; jh < 2; ++jh)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            *reinterpret_cast<uint32_t*>(hb + (g + 8 * rr) * LDS + grp * 16 +
                                         8 * jh + 2 * t) =
                pack_bf16(h[jh][2 * rr], h[jh][2 * rr + 1]);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          load_a(ha[kk], hb + slot0 + kk * 16, LDS, lane);
      }
#pragma unroll
      for (int jh = 0; jh < 2; ++jh)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const long long n = n0 + g + 8 * rr;
          if (n < a.N)
            *reinterpret_cast<float2*>(
                a.hid + ((size_t)d * NL + (size_t)n * L + tt) * C + grp * 16 +
                8 * jh + 2 * t) = make_float2(h[jh][2 * rr], h[jh][2 * rr + 1]);
        }
      if (more) {
#pragma unroll
        for (int k = 0; k < GRU_ROWS; ++k) put(cc + 1, i0 + k, v[k]);
      }
    }
    __syncthreads();  // chunk cc + 1 is staged; buffer cc & 1 is free
  }
}

template <int KS, bool PADDED>
cudaError_t launch_gru_tc_as(const GruArgs& a, cudaStream_t st) {
  constexpr bool SPLIT = split_directions(KS);
  const int D = SPLIT ? 1 : a.D;  // directions a block
  const size_t smem = gru_smem<KS>(D);
  cudaError_t e = allow_smem(gru_tc_kernel<KS, PADDED>, smem);
  if (e != cudaSuccess) return e;
  gru_tc_kernel<KS, PADDED>
      <<<dim3((unsigned)((a.N + GS - 1) / GS), SPLIT ? a.D : 1, GRU_PARTS),
         D * (C / 16 / GRU_PARTS) * 32, smem, st>>>(a);
  return cudaGetLastError();
}

// gru_tc_kernel<KS, c_true < C>.
template <int KS>
cudaError_t launch_gru_tc(const GruArgs& a, int c_true, cudaStream_t st) {
  return c_true < C ? launch_gru_tc_as<KS, true>(a, st)
                    : launch_gru_tc_as<KS, false>(a, st);
}

}  // namespace tc

// Dense slots of SW units: LN1's input projection, then the recurrence.
template <bool ROUND, int SW>
inline cudaError_t launch_gru_dense(const float* x, const float* ln1_s,
                                    const float* ln1_b, const float* w_ih,
                                    const float* w_hh, const float* b_ih,
                                    const float* b_hh, float* xp, float* hid,
                                    long long N, int L, int D, float inv_c,
                                    cudaStream_t st) {
  const long long rows = N * L;
  const unsigned rblocks = (unsigned)((rows + PROJ_ROWS - 1) / PROJ_ROWS);
  proj_kernel<true, SW><<<row_grid(rblocks, D * 3 * C),
                          row_threads(D * 3 * C), 0, st>>>(
      x, nullptr, nullptr, ln1_s, ln1_b, w_ih, b_ih, xp, rows, D * 3 * C,
      /*round=*/ROUND ? 1 : 0, inv_c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
#if LCT_C > 128
  if constexpr (SW == GC_SW) {
    // slots of 256: the cluster kernel, a slot in blockIdx.z
    gru_cluster_kernel<ROUND>
        <<<dim3((unsigned)((N + GC_DS - 1) / GC_DS * GC_CL), (unsigned)D,
                C / GC_SW),
           256, 0, st>>>(xp, w_hh, b_hh, hid, N, L, D);
    return cudaGetLastError();
  } else
#endif
#if LCT_C > 256
  if constexpr (SW == C) {
    // one slot of 512: a launch a step over all sequences
    return launch_gru_steps<ROUND>(xp, w_hh, b_hh, hid, N, L, D, st);
  } else
#endif
  {
    constexpr int UW = dense_units<SW>();
    const size_t smem = gru_dense_smem<SW>();
    e = cudaFuncSetAttribute(gru_dense_kernel<ROUND, SW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    gru_dense_kernel<ROUND, SW>
        <<<dim3((unsigned)((N + DS - 1) / DS), (unsigned)D,
                (unsigned)(C / UW)),
           DS * UW, smem, st>>>(xp, w_hh, b_hh, hid, N, L, D);
    return cudaGetLastError();
  }
}

// LN1's input projection and the recurrence in all-f32 arithmetic, over
// `slots` GRU slots: xp [N*L, D*3C], hid [D, N*L, C]. ROUND: the bf16
// mode's rounding points instead (the dense slot of C = 128, C = 256's
// slots of 64, 128 and 256, and C = 512's of 64, 128, 256 and 512).
template <bool ROUND = false>
inline cudaError_t launch_gru_f32(const float* x, const float* ln1_s,
                                  const float* ln1_b, const float* w_ih,
                                  const float* w_hh, const float* b_ih,
                                  const float* b_hh, int slots, float* xp,
                                  float* hid, long long N, int L, int D,
                                  float inv_c, cudaStream_t st) {
  const long long rows = N * L;
  const unsigned rblocks = (unsigned)((rows + PROJ_ROWS - 1) / PROJ_ROWS);
  const unsigned threads = row_threads(D * 3 * C);
  if (!ROUND && gru_slot(slots) == 16) {
    proj_kernel<true, 16><<<row_grid(rblocks, D * 3 * C), threads, 0, st>>>(
        x, nullptr, nullptr, ln1_s, ln1_b, w_ih, b_ih, xp, rows, D * 3 * C,
        /*round=*/0, inv_c);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const long long gthreads = N * D * C;
    gru_kernel<<<(unsigned)((gthreads + 255) / 256), 256, 0, st>>>(
        xp, w_hh, b_hh, hid, N, L, D);
    return cudaGetLastError();
  }
#if LCT_C > 128
  switch (gru_slot(slots)) {
    case 64:
      return launch_gru_dense<ROUND, 64>(x, ln1_s, ln1_b, w_ih, w_hh, b_ih,
                                         b_hh, xp, hid, N, L, D, inv_c, st);
    case 128:
      return launch_gru_dense<ROUND, 128>(x, ln1_s, ln1_b, w_ih, w_hh, b_ih,
                                          b_hh, xp, hid, N, L, D, inv_c, st);
#if LCT_C > 256
    case 256:
      return launch_gru_dense<ROUND, 256>(x, ln1_s, ln1_b, w_ih, w_hh, b_ih,
                                          b_hh, xp, hid, N, L, D, inv_c, st);
#endif
    case C:
      return launch_gru_dense<ROUND, C>(x, ln1_s, ln1_b, w_ih, w_hh, b_ih,
                                        b_hh, xp, hid, N, L, D, inv_c, st);
  }
  return cudaErrorInvalidValue;
#else
  if constexpr (!ROUND && C > 64) {
    if (gru_slot(slots) == 64)
      return launch_gru_dense<false, 64>(x, ln1_s, ln1_b, w_ih, w_hh, b_ih,
                                         b_hh, xp, hid, N, L, D, inv_c, st);
  }
  return launch_gru_dense<ROUND, C>(x, ln1_s, ln1_b, w_ih, w_hh, b_ih, b_hh,
                                    xp, hid, N, L, D, inv_c, st);
#endif
}

// ---------------------------------------------------------------------------
// LN1, the grouped input projection and the recurrence of the composed time
// block above L = 512, all f32, in one launch (lct_grouped_gru_f32;
// ops/gru.py::fused_grouped_gru). It replaces no TPU kernel: the JAX package
// runs this GRU as one lax.scan outside any Pallas kernel
// (lct_gan_tpu/ops/gru.py:28).
//
// Bound on the H100 at (N, L) = (1,023, 516), C = 64, one direction: the
// function moves x in and the hiddens out once, 270 MB (0.081 ms at 3.35
// TB/s), and does 6.5 GFLOP of f32 products (0.097 ms at 67 TFLOP/s). Its
// sequential floor is L times the latency of one step's dependent chain.
// Estimated from this design's instructions for a slot of 16 (cycles, SM
// clock): the barrier and four broadcast 16-byte loads of h (~35), 48 FMAs
// in six chains of 8 (~50), the r gate (add, ex2, add, reciprocal: ~45),
// n's multiply-add and tanh (~50), the new h and its store (~30): ~210
// cycles, 0.055 ms at L = 516 at 1,980 MHz; a dense slot of 64 adds 48
// FMAs, one shuffle level and a named barrier, ~280. Slots of 32 and 128
// are not counted. chip_smoke.py measures the floor instead of counting
// it: the same call on one sequence (one block), and one sequence of each
// slot kind (check_gru_chains).
//
// What held the two-kernel design (proj_kernel<true> -> xp -> gru_kernel,
// the precise FTF forward's, which keeps it) 15-17x from its bound, and what
// this design does about each:
//   1. xp [N L, 3C] f32 went to device memory and back (2 x 405 MB at the
//      shape above): here it lives only in a shared-memory ring of two
//      chunks of TS = 16 steps; device traffic is x in once, the hiddens out
//      once.
//   2. every step loaded its xp from device memory after the previous
//      step's h existed: here x arrives by cp.async a chunk ahead of its
//      LN1, and LN1 and the projection of chunk c + 1 run in producer warps
//      while consumer warps walk chunk c. A step reads only registers and
//      shared memory.
//   3. the dense slots ended each step with a block barrier: here a step
//      synchronises only the warps of its own slot (a named barrier with a
//      count; one warp's __syncwarp for slots of 16 and 32); the block meets
//      once a chunk.
//   4. chains are few at the banded long shape (132 sequences x 4 slots):
//      one block takes one sequence and direction, so all 132 SMs walk, and
//      the step's chain is kept short (no load, split accumulators, the
//      gates on the special-function unit). More chains a thread would
//      shorten nothing there: with one sequence a SM the chain is the floor.
//
// Block: one sequence (blockIdx.x) and direction (blockIdx.y).
//   consumers (CONS threads): thread (unit u, k-part kq) keeps W_hh[KP of
//     the slot's inputs][its unit's r, z, n] in registers (KP = 16 for
//     slots of 16, else 32: 48 or 96 floats; KS = W / KP lanes a unit,
//     partial sums added by an xor shuffle) and walks the steps; h of each
//     step goes to the hidden ring, which is also the next step's operand.
//     A slot of 128 reads W_hh from shared memory (192 KB), one lane a
//     unit: 3 x 128 x 128 floats do not fit in registers.
//   producers (PT threads): cp.async of chunk c + 2's x rows, LN1 in place
//     (a warp a row, ln_row) and the projection of chunk c + 1 into the xp
//     ring (slots of 16: a unit a thread, its W_ih columns in registers;
//     dense slots: an xp column of all TS rows at a time, W_ih read through
//     L1), and the hidden ring of chunk c - 1 out to device memory as
//     16-byte stores.
// Gates: sigmoid and tanh from one ex2 and one reciprocal each (tc.cuh), a
// few f32 ulps from expf / tanhf.
namespace gruf {

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

constexpr int PRODUCER_BARRIER = 15;  // named barrier id; slots use 1, 2

__host__ __device__ constexpr int warps32(int threads) {
  return (threads + 31) / 32 * 32;
}

// One instance per slot width W (16, 32, 64, 128; a group of 256 or 512
// is the cluster or step kernel's, over an xp scratch). A block takes SPB
// of the SLOTS slots (blockIdx.z picks them): all of them, but at C >= 256
// one slot of 64 or 128, whose consumers' W_hh would pass the register
// file (four slots of 64) or the shared memory (two of 128) of one block,
// and at C = 512 half the slots of 16 or 32 (all of them would take 1,024
// threads, or registers past a thread's share). LN1 runs over the whole
// rows in every block.
template <int W>
struct Cfg {
  static constexpr bool WSMEM = W > 64;  // W_hh in shared memory
  // Inputs a consumer lane takes (its W_hh rows in registers: 3 KP floats)
  // and lanes a unit.
  static constexpr int KP = WSMEM ? W : W < 32 ? W : 32;
  static constexpr int KS = W / KP;
  static constexpr int SLOTS = C / W;
  static constexpr int SPB = C > 128 && W >= 64 ? 1          // slots a block
                             : C > 256          ? SLOTS / 2
                                                : SLOTS;
  static constexpr int NB = SLOTS / SPB;                        // blocks in z
  static constexpr int UB = SPB * W;                            // units a block
  static constexpr int W3 = 3 * W;
  // Steps a chunk (at C = 512 half, so that the rings of C-wide rows fit
  // beside a slot of 128's W_hh).
  static constexpr int TS = (WSMEM ? 4 : 16) / (C > 256 ? 2 : 1);
  static constexpr int CONS = warps32(UB * KS);
  // Producers: slots of 16 one unit of the block a thread (its W_ih
  // columns in registers); dense slots one xp column of all TS rows a
  // thread at a time (W_ih read through L1), 96 to 192 threads.
  static constexpr int PT = W == 16 ? warps32(UB) : W == 128 ? 128
                            : 3 * UB < 192 ? 3 * UB : 192;
  static constexpr int PW = PT / 32;  // producer warps
  static constexpr int THREADS = CONS + PT;
  // Shared memory, floats: xp ring [2][TS][3 UB] (the block's slots), hidden
  // ring [2][TS][C], x ring [2][TS][C] (LN1 in place), a zero row (h before
  // the first step), W_hh of the block's slot [W][3W] (WSMEM).
  static constexpr int XP = 2 * TS * 3 * UB, HS = 2 * TS * C, XR = 2 * TS * C;
  static constexpr int WH = WSMEM ? UB * W3 : 0;
  static constexpr size_t SMEM = (size_t)(XP + HS + XR + C + WH) * 4;
  static_assert(C % W == 0 && (TS % 4 == 0 || (WSMEM && TS % 2 == 0)) &&
                    (!WSMEM || SPB == 1) && (W * KS <= 32 || SPB <= 2) &&
                    SMEM <= 232448,
                "gru_f32_kernel configuration");
};

// The first slot of the block (blockIdx.z: 0 where a block takes them all).
template <int W>
__device__ __forceinline__ int first_slot() {
  using K = Cfg<W>;
  return K::SPB == K::SLOTS ? 0 : (int)blockIdx.z * K::SPB;
}

struct Args {
  const float* x;  // [N, L, C]
  const float* ln_s;
  const float* ln_b;
  const float* w_ih;  // grouped [D, G, H, 3H], H = C / G a power of two
  const float* w_hh;
  const float* b_ih;  // [D, G, 3H]
  const float* b_hh;
  float* hid;  // [D, N*L, C]
  long long N;
  int L;
  int G;
  float inv_c;  // 1 / the true channel count (LN1's)
};

// Entry (input channel i, unit u, gate) of direction d's weights in grouped
// layout w [D, G, H, 3H], as a slot holding u sees it: 0 where i and u lie
// in different groups (a slot of 16 holding several narrower groups is
// block-diagonal; the entries off the blocks add nothing). A dense slot is
// one group (H = W).
__device__ __forceinline__ float grouped_w(const float* w, int d, int G,
                                           int i, int u, int gate) {
  const int H = C / G, g = u / H;
  if (i / H != g) return 0.f;
  return w[(((size_t)d * G + g) * H + i % H) * 3 * H + gate * H + u % H];
}

__device__ __forceinline__ float grouped_b(const float* b, int d, int G,
                                           int u, int gate) {
  const int H = C / G;
  return b[((size_t)d * G + u / H) * 3 * H + gate * H + u % H];
}

template <int W>
__device__ __forceinline__ void consume(const Args& a, float* sm, int tid) {
  using K = Cfg<W>;
  constexpr int TS = K::TS, KS = K::KS, W3 = K::W3;
  const float* xps = sm;
  float* hss = sm + K::XP;
  const float* zr = hss + K::HS + K::XR;
  const float* whs = zr + C;
  const int d = blockIdx.y, L = a.L, s0 = first_slot<W>();
  const int uu = tid / KS, kq = tid % KS;
  const bool live = uu < K::UB;    // C = 16: the warp's upper half idles
  const int u = (live ? uu : 0) + s0 * W;  // (walking unit 0, storing nothing)
  const int s = u / W, j = u % W;
  constexpr int KP = K::KP, NW = K::WSMEM ? 1 : KP;
  float wr[NW], wz[NW], wn[NW];
  if constexpr (!K::WSMEM) {
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      const int ii = s * W + kq * KP + i;
      wr[i] = grouped_w(a.w_hh, d, a.G, ii, u, 0);
      wz[i] = grouped_w(a.w_hh, d, a.G, ii, u, 1);
      wn[i] = grouped_w(a.w_hh, d, a.G, ii, u, 2);
    }
  }
  const float br = grouped_b(a.b_hh, d, a.G, u, 0);
  const float bz = grouped_b(a.b_hh, d, a.G, u, 1);
  const float bn = grouped_b(a.b_hh, d, a.G, u, 2);
  __syncthreads();  // the producers' chunk 0 and the shared W_hh

  float h = 0.f;
  const int nchunks = (L + TS - 1) / TS;
  for (int c = 0; c < nchunks; ++c) {
    const int ns = min(TS, L - c * TS);
    const float* xpc =
        xps + (size_t)(c & 1) * TS * 3 * K::UB + (s - s0) * W3 + j;
    float* hsc = hss + (c & 1) * TS * C;
    const float* prev = c == 0 ? zr : hss + ((c - 1) & 1) * TS * C +
                                          (TS - 1) * C;
    for (int st = 0; st < ns; ++st) {
      const float* xr = xpc + st * 3 * K::UB;
      const float xr0 = xr[0], xz0 = xr[W], xn0 = xr[2 * W];
      float ar0 = 0.f, ar1 = 0.f, az0 = 0.f, az1 = 0.f, an0 = 0.f, an1 = 0.f;
      if constexpr (!K::WSMEM) {
        const float4* hp =
            reinterpret_cast<const float4*>(prev + s * W + kq * KP);
        float4 hv[KP / 4];
#pragma unroll
        for (int q = 0; q < KP / 4; ++q) hv[q] = hp[q];
#pragma unroll
        for (int q = 0; q < KP / 4; ++q) {
          ar0 = fmaf(hv[q].x, wr[4 * q], ar0);
          az0 = fmaf(hv[q].x, wz[4 * q], az0);
          an0 = fmaf(hv[q].x, wn[4 * q], an0);
          ar1 = fmaf(hv[q].y, wr[4 * q + 1], ar1);
          az1 = fmaf(hv[q].y, wz[4 * q + 1], az1);
          an1 = fmaf(hv[q].y, wn[4 * q + 1], an1);
          ar0 = fmaf(hv[q].z, wr[4 * q + 2], ar0);
          az0 = fmaf(hv[q].z, wz[4 * q + 2], az0);
          an0 = fmaf(hv[q].z, wn[4 * q + 2], an0);
          ar1 = fmaf(hv[q].w, wr[4 * q + 3], ar1);
          az1 = fmaf(hv[q].w, wz[4 * q + 3], az1);
          an1 = fmaf(hv[q].w, wn[4 * q + 3], an1);
        }
      } else {
        const float4* hp = reinterpret_cast<const float4*>(prev + s0 * W);
        const float* wp = whs + j;
#pragma unroll 2
        for (int q = 0; q < W / 4; ++q) {
          const float4 hv = hp[q];
          const float* w0 = wp + 4 * q * W3;
          ar0 = fmaf(hv.x, w0[0], ar0);
          az0 = fmaf(hv.x, w0[W], az0);
          an0 = fmaf(hv.x, w0[2 * W], an0);
          ar1 = fmaf(hv.y, w0[W3], ar1);
          az1 = fmaf(hv.y, w0[W3 + W], az1);
          an1 = fmaf(hv.y, w0[W3 + 2 * W], an1);
          ar0 = fmaf(hv.z, w0[2 * W3], ar0);
          az0 = fmaf(hv.z, w0[2 * W3 + W], az0);
          an0 = fmaf(hv.z, w0[2 * W3 + 2 * W], an0);
          ar1 = fmaf(hv.w, w0[3 * W3], ar1);
          az1 = fmaf(hv.w, w0[3 * W3 + W], az1);
          an1 = fmaf(hv.w, w0[3 * W3 + 2 * W], an1);
        }
      }
      float ar = ar0 + ar1, az = az0 + az1, an = an0 + an1;
#pragma unroll
      for (int o = KS / 2; o > 0; o >>= 1) {
        ar += __shfl_xor_sync(0xffffffffu, ar, o);
        az += __shfl_xor_sync(0xffffffffu, az, o);
        an += __shfl_xor_sync(0xffffffffu, an, o);
      }
      if (kq == 0 && live) {
        const float r = tc::sigmoid_sfu(xr0 + (ar + br));
        const float z = tc::sigmoid_sfu(xz0 + (az + bz));
        const float nn = tc::tanh_sfu(xn0 + r * (an + bn));
        h = (1.f - z) * nn + z * h;
        hsc[st * C + u] = h;
      }
      if constexpr (W * KS <= 32)
        __syncwarp();  // the slot is this warp's
      else
        named_sync(1 + s - s0, W * KS);
      prev = hsc + st * C;
    }
    __syncthreads();  // chunk c walked; chunk c + 1's xp is in its ring
  }
}

template <int W>
__device__ __forceinline__ void produce(const Args& a, float* sm, int p) {
  using K = Cfg<W>;
  constexpr int TS = K::TS, PT = K::PT, PW = K::PW, W3 = K::W3;
  float* xps = sm;
  const float* hss = sm + K::XP;
  float* xrs = sm + K::XP + K::HS;
  const int d = blockIdx.y, L = a.L, s0 = first_slot<W>();
  const long long n = blockIdx.x;
  const size_t NL = (size_t)a.N * L;
  const int pw = p >> 5, lane = p & 31;
  const int nchunks = (L + TS - 1) / TS;
  auto time_of = [&](int step) { return d ? L - 1 - step : step; };

  float ls[CPL], lb[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    ls[i] = lane_holds(lane, i) ? a.ln_s[lane + 32 * i] : 0.f;
    lb[i] = lane_holds(lane, i) ? a.ln_b[lane + 32 * i] : 0.f;
  }
  // Slots of 16: producer p projects the block's unit p (all three gates),
  // its W_ih columns and biases in registers.
  constexpr int NW = W == 16 ? 16 : 1;
  float wi[3][NW], bi[3];
  const int pu = s0 * 16 + (p < K::UB ? p : 0), ps = pu / 16, pj = pu % 16;
  if constexpr (W == 16) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        wi[g][k] = grouped_w(a.w_ih, d, a.G, ps * 16 + k, pu, g);
#pragma unroll
    for (int g = 0; g < 3; ++g) bi[g] = grouped_b(a.b_ih, d, a.G, pu, g);
  }

  // x rows of chunk cc into x ring cc & 1 (zeros past L).
  auto fetch = [&](int cc) {
    float* dst = xrs + (cc & 1) * TS * C;
    for (int i = p; i < TS * C / 4; i += PT) {
      const int st = i / (C / 4), q = i % (C / 4), step = cc * TS + st;
      float* dp = dst + st * C + 4 * q;
      if (step < L)
        cp_async16(dp, a.x + ((size_t)n * L + time_of(step)) * C + 4 * q);
      else
        *reinterpret_cast<float4*>(dp) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_commit();
  };
  // LN1 in place over chunk cc's rows, a warp a row (proj_kernel's
  // LayerNorm arithmetic).
  auto normalize = [&](int cc) {
    float* rows = xrs + (cc & 1) * TS * C;
#pragma unroll
    for (int st = pw; st < TS; st += PW) {
      float v[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        v[i] = lane_holds(lane, i) ? rows[st * C + lane + 32 * i] : 0.f;
      ln_row(v, ls, lb, a.inv_c);
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        if (lane_holds(lane, i)) rows[st * C + lane + 32 * i] = v[i];
    }
  };
  // xp of chunk cc into xp ring cc & 1: [TS][3 UB], the block's slot s's
  // columns at (s - s0) 3W + gate W + unit.
  auto project = [&](int cc) {
    const float* n1 = xrs + (cc & 1) * TS * C;
    float* out = xps + (size_t)(cc & 1) * TS * 3 * K::UB;
    if constexpr (W == 16) {
      constexpr int RG = 4;  // rows at a time
      if (p >= K::UB) return;
#pragma unroll 1
      for (int r0 = 0; r0 < TS; r0 += RG) {
        float acc[3][RG];
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int rr = 0; rr < RG; ++rr) acc[g][rr] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int rr = 0; rr < RG; ++rr) {
            const float4 v = *reinterpret_cast<const float4*>(
                n1 + (r0 + rr) * C + ps * 16 + 4 * q);
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              float t = fmaf(v.x, wi[g][4 * q], acc[g][rr]);
              t = fmaf(v.y, wi[g][4 * q + 1], t);
              t = fmaf(v.z, wi[g][4 * q + 2], t);
              acc[g][rr] = fmaf(v.w, wi[g][4 * q + 3], t);
            }
          }
#pragma unroll
        for (int rr = 0; rr < RG; ++rr)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            out[(r0 + rr) * 3 * K::UB + (ps - s0) * 48 + g * 16 + pj] =
                acc[g][rr] + bi[g];
      }
    } else {
      // Column o = (s - s0) 3W + gate W + unit of slot s (group s), all TS
      // rows.
#pragma unroll 1
      for (int o = p; o < 3 * K::UB; o += PT) {
        const int s = s0 + o / W3;
        const float* wp =
            a.w_ih + (size_t)(d * K::SLOTS + s) * W * W3 + o % W3;
        const float* nr = n1 + s * W;
        float acc[TS];
#pragma unroll
        for (int r = 0; r < TS; ++r) acc[r] = 0.f;
#pragma unroll 2
        for (int k = 0; k < W; k += 4) {
          float w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) w[e] = __ldg(wp + (size_t)(k + e) * W3);
#pragma unroll
          for (int r = 0; r < TS; ++r) {
            const float4 v =
                *reinterpret_cast<const float4*>(nr + r * C + k);
            float t = fmaf(v.x, w[0], acc[r]);
            t = fmaf(v.y, w[1], t);
            t = fmaf(v.z, w[2], t);
            acc[r] = fmaf(v.w, w[3], t);
          }
        }
        const float b =
            __ldg(a.b_ih + (size_t)(d * K::SLOTS + s) * W3 + o % W3);
#pragma unroll
        for (int r = 0; r < TS; ++r) out[r * 3 * K::UB + o] = acc[r] + b;
      }
    }
  };
  // Chunk cc's hiddens of the block's units from the hidden ring to hid,
  // 16 bytes a store.
  auto store_hid = [&](int cc) {
    const float* src = hss + (cc & 1) * TS * C + s0 * W;
    const int ns = min(TS, L - cc * TS);
    for (int i = p; i < ns * K::UB / 4; i += PT) {
      const int st = i / (K::UB / 4), q = i % (K::UB / 4);
      const size_t row = (size_t)n * L + time_of(cc * TS + st);
      *reinterpret_cast<float4*>(a.hid + ((size_t)d * NL + row) * C + s0 * W +
                                 4 * q) =
          *reinterpret_cast<const float4*>(src + st * C + 4 * q);
    }
  };

  fetch(0);
  cp_async_wait_all();
  named_sync(PRODUCER_BARRIER, PT);
  normalize(0);
  named_sync(PRODUCER_BARRIER, PT);
  if (nchunks > 1) fetch(1);
  project(0);
  __syncthreads();  // chunk 0's xp is in its ring
  for (int c = 0; c < nchunks; ++c) {
    if (c > 0) store_hid(c - 1);
    if (c + 1 < nchunks) {
      cp_async_wait_all();  // chunk c + 1's rows have landed
      named_sync(PRODUCER_BARRIER, PT);
      normalize(c + 1);
      named_sync(PRODUCER_BARRIER, PT);
      // into x ring c & 1: chunk c's rows, projected before the last
      // block barrier
      if (c + 2 < nchunks) fetch(c + 2);
      project(c + 1);
    }
    __syncthreads();
  }
  store_hid(nchunks - 1);
}

template <int W>
__global__ void __launch_bounds__(Cfg<W>::THREADS)
    gru_f32_kernel(Args a) {
  using K = Cfg<W>;
  extern __shared__ __align__(16) float gru_sm[];
  float* zr = gru_sm + K::XP + K::HS + K::XR;
  for (int i = threadIdx.x; i < C; i += blockDim.x) zr[i] = 0.f;
  if constexpr (K::WSMEM) {
    // the block's group: the grouped layout is the slot's
    const float4* src = reinterpret_cast<const float4*>(
        a.w_hh + ((size_t)blockIdx.y * K::SLOTS + first_slot<W>()) * K::WH);
    float4* dst = reinterpret_cast<float4*>(zr + C);
    for (int i = threadIdx.x; i < K::WH / 4; i += blockDim.x) dst[i] = src[i];
  }
  // Warp-uniform roles: each meets the block barrier once before its loop
  // and once a chunk.
  if (threadIdx.x < K::CONS)
    consume<W>(a, gru_sm, threadIdx.x);
  else
    produce<W>(a, gru_sm, threadIdx.x - K::CONS);
}

template <int W>
cudaError_t launch(const Args& a, int D, cudaStream_t st) {
  using K = Cfg<W>;
  cudaError_t e = tc::allow_smem(gru_f32_kernel<W>, K::SMEM);
  if (e != cudaSuccess) return e;
  gru_f32_kernel<W><<<dim3((unsigned)a.N, (unsigned)D, (unsigned)K::NB),
                      K::THREADS, K::SMEM, st>>>(a);
  return cudaGetLastError();
}

// The instance for `groups` groups of H = C / groups units: slots of W =
// H, or of 16 holding 16 / H groups where H < 16 (groups of 256 and 512
// are the cluster and step kernels', lct_grouped_gru_f32). A template, so
// that only the instances of the library's C are built.
template <int CC = C>
cudaError_t launch_groups(const Args& a, int D, cudaStream_t st) {
  const int H = C / a.G;
  if (H <= 16) return launch<16>(a, D, st);
  if constexpr (CC >= 32)
    if (H == 32) return launch<32>(a, D, st);
  if constexpr (CC >= 64)
    if (H == 64) return launch<64>(a, D, st);
  if constexpr (CC >= 128)
    if (H == 128) return launch<128>(a, D, st);
  return cudaErrorInvalidValue;
}

}  // namespace gruf

}  // namespace lct

#define LCT_CHECK()                              \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// x, out: [N, L, C]; w_ih, w_hh: [D, slots, W, 3W]; b_ih, b_hh: [D,
// slots, 3W] (W = C / slots, slots = C / 16 or 1); in_w: [C, 3C]; out_w:
// [C, C]; lin_w: [lin_in, C]; key_bias: [N, L] or null; lookback < 0
// means no band; c_true true channels (the LayerNorms' count; the rest of
// each row zero), num_heads dividing it (heads of c_true / num_heads true
// channels at head_width of it, common.cuh), scale their score scale (the
// f32 rounding of 1 / sqrt(c_true / num_heads)). Scratch: hid [D, N*L, C]
// f32 (the per-direction hiddens, unrounded), qkv bf16 [N*L, 3C], s f32
// [N*L, C] (x + g), when lin_in == 2C gb bf16 [N*L, C] (bf16(g); else
// null), for the GRU slots on CUDA cores (C = 128's dense slot, C = 256's
// slots of 64, 128 and 256, C = 512's of 64 .. 512) xp f32 [N*L, D*3C]
// (else null), at C >= 256 ctx bf16 [N*L, C] (the attention's context,
// which the split epilogue reads; else null). Returns a cudaError_t.
extern "C" int lct_ftf_forward_bf16(
    const float* x, const float* ln1_s, const float* ln1_b,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ln2_s, const float* ln2_b,
    const float* in_w, const float* in_b, const float* out_w,
    const float* out_b, const float* lin_w, const float* lin_b,
    const float* key_bias, float* hid, void* qkv, float* s, void* gb,
    float* xp, void* ctx, float* out, long long N, int L, int D, int lin_in,
    int lookback, int c_true, int num_heads, float scale, int slots,
    int device, void* stream) {
  using namespace lct;
  if ((lin_in == 2 * C) != (gb != nullptr) ||
      !widths_ok(c_true, num_heads, slots) ||
      (C > 128 ? gru_slot(slots) != 16 : C > 64 && slots == 1) !=
          (xp != nullptr) ||
      (C > 128) != (ctx != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = N * L;
  __nv_bfloat16* q = static_cast<__nv_bfloat16*>(qkv);
  __nv_bfloat16* g = static_cast<__nv_bfloat16*>(gb);
  const float inv_c = 1.f / c_true;

  const tc::GruArgs ga = {x,    ln1_s, ln1_b, w_ih, w_hh, b_ih,
                          b_hh, hid,   N,     L,    D,    inv_c};
  if (gru_slot(slots) == 16) {
    e = tc::launch_gru_tc<1>(ga, c_true, st);
  } else {
#if LCT_C > 128
    // C >= 256: slots of 64 and 128 on CUDA cores, of 256 the cluster
    // kernel, of 512 (C = 512) the step kernel
    e = launch_gru_f32<true>(x, ln1_s, ln1_b, w_ih, w_hh, b_ih, b_hh, slots,
                             xp, hid, N, L, D, inv_c, st);
#else
    if constexpr (C <= 64) {
      e = tc::launch_gru_tc<C / 16>(ga, c_true, st);
    } else if (gru_slot(slots) == 64) {
      e = tc::launch_gru_tc<4>(ga, c_true, st);
    } else {
      e = launch_gru_f32<true>(x, ln1_s, ln1_b, w_ih, w_hh, b_ih, b_hh,
                               slots, xp, hid, N, L, D, inv_c, st);
    }
#endif
  }
  if (e != cudaSuccess) return (int)e;
  e = tc::launch_qkv({x, hid, D == 2 ? hid + (size_t)rows * C : nullptr,
                      ln2_s, ln2_b, in_w, in_b, q, s, g, rows, inv_c},
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
  a.s = s;
  a.g = g;
  a.lin_w = lin_w;
  a.lin_b = lin_b;
  a.lin_in = lin_in;
  a.hd = head_width(c_true / num_heads);
  a.scale2 = tc::qk_scale2(scale);
  return (int)tc::launch_attn_tc<0>(a, st,
                                    static_cast<__nv_bfloat16*>(ctx));
}

// LN1 and the grouped GRU alone, all f32, in one launch of gru_f32_kernel
// (gruf, above): the composed time block above L = 512, where the fused
// block's attention stops (ops/gru.py, fused_grouped_gru). x: [N, L, C];
// the GRU weights grouped, w [D, groups, H, 3H], b [D, groups, 3H], H = C /
// groups a power of two (the caller pads other widths, ops/padding.py), of
// which c_true channels are true (LN1's count); out hid [D, N*L, C] f32,
// the per-direction hiddens (the caller sums them). Scratch: for one group
// of C = 256, or groups of 256 or 512 at C = 512, xp f32 [N*L, D*3C]
// (LN1's input projection, which the cluster or step kernel reads), else
// null. Returns a cudaError_t.
extern "C" int lct_grouped_gru_f32(const float* x, const float* ln1_s,
                                   const float* ln1_b, const float* w_ih,
                                   const float* w_hh, const float* b_ih,
                                   const float* b_hh, float* hid, float* xp,
                                   long long N, int L, int D, int groups,
                                   int c_true, int device, void* stream) {
  using namespace lct;
  const int H = groups > 0 ? C / groups : 0;
  if (H < 1 || H * groups != C || (H & (H - 1)) != 0 || N < 0 || L < 1 ||
      D < 1 || D > 2 || c_true < 1 || c_true > C ||
      (C > 128 && H > 128) != (xp != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  LCT_CHECK();
  if (N == 0) return 0;
#if LCT_C > 256
  if (H == 256)
    return (int)launch_gru_dense<false, 256>(
        x, ln1_s, ln1_b, w_ih, w_hh, b_ih, b_hh, xp, hid, N, L, D,
        1.f / c_true, (cudaStream_t)stream);
#endif
#if LCT_C > 128
  if (H == C)
    return (int)launch_gru_dense<false, C>(x, ln1_s, ln1_b, w_ih, w_hh, b_ih,
                                           b_hh, xp, hid, N, L, D,
                                           1.f / c_true, (cudaStream_t)stream);
#endif
  const gruf::Args a = {x,    ln1_s, ln1_b, w_ih, w_hh, b_ih,
                        b_hh, hid,   N,     L,    groups, 1.f / c_true};
  return (int)gruf::launch_groups(a, D, (cudaStream_t)stream);
}

// The same function in all-f32 arithmetic (precise mode), arguments as
// lct_ftf_forward_bf16's. Scratch: xp [N*L, D*3C], hid [D, N*L, C], qkv
// [N*L, 3C], ctx [N*L, C], f32.
extern "C" int lct_ftf_forward_f32(
    const float* x, const float* ln1_s, const float* ln1_b,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ln2_s, const float* ln2_b,
    const float* in_w, const float* in_b, const float* out_w,
    const float* out_b, const float* lin_w, const float* lin_b,
    const float* key_bias, float* xp, float* hid, float* qkv, float* ctx,
    float* out, long long N, int L, int D, int lin_in, int lookback,
    int c_true, int num_heads, float scale, int slots, int device,
    void* stream) {
  using namespace lct;
  if (!widths_ok(c_true, num_heads, slots)) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  LCT_CHECK();
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = N * L;
  const unsigned rblocks = (unsigned)((rows + PROJ_ROWS - 1) / PROJ_ROWS);
  const float inv_c = 1.f / c_true;

  cudaError_t e = launch_gru_f32(x, ln1_s, ln1_b, w_ih, w_hh, b_ih, b_hh,
                                 slots, xp, hid, N, L, D, inv_c, st);
  if (e != cudaSuccess) return (int)e;
  proj_kernel<false><<<row_grid(rblocks, 3 * C), row_threads(3 * C), 0, st>>>(
      x, hid, D == 2 ? hid + (size_t)rows * C : nullptr, ln2_s, ln2_b, in_w,
      in_b, qkv, rows, 3 * C, /*round=*/0, inv_c);
  LCT_CHECK();
  e = launch_attn<0>(qkv, key_bias, ctx, N, L, lookback, /*round=*/0,
                     head_width(c_true / num_heads), scale, st);
  if (e != cudaSuccess) return (int)e;
  ftf_out_kernel<<<(unsigned)((rows + OUT_ROWS - 1) / OUT_ROWS), C, 0, st>>>(
      x, hid, D, ctx, out_w, out_b, lin_w, lin_b, lin_in, out, rows);
  LCT_CHECK();
  return 0;
}
