// Banded-causal multi-head self-attention for Hopper (sm_90a): the function
// of the TPU kernel `lct_gan_tpu/ops/banded_attention.py::_banded_kernel`
// over x [N, S, C] with no upper bound on S, with the TPU kernel's bf16
// rounding points (x, in_w; q, k, v; the normalised p; ctx, out_w) and f32
// accumulation. Each query q attends the keys of its inclusive band
// [q - W, q] ∩ [0, S) with a per-key bias; out-of-band keys are skipped
// (the JAX reference's -inf fill), and a row whose whole band carries
// key_bias -1e30 scores -1e30 on every key (-1e30 + s == -1e30 in f32) and
// comes out uniform over its band. Two designs, one per mode:
//
// bf16 (lct_banded_forward_bf16), tensor cores (tc.cuh):
//   banded_tc_kernel<NCH>   one fused pass per work item: qkv projection,
//                           C/hd-head softmax attention over the band, output
//                           projection; q, k, v and the context never leave
//                           the SM.
//   W > MAX_REG_W (the band's scores no longer fit in registers), and every
//   band at C = 128, 256 and 512 (in_w, out_w and the key ring pass the 227
//   KB of shared memory a block may hold):
//   qkv_tc_kernel -> qkv bf16 [N*S, 3C], then attn_tc_kernel<1> with the
//   band (mhsa.cu's kernel: it streams key tiles and skips those outside
//   the band, for any S); at C = 256 and 512 mhsa.cu's split design
//   (tc.cuh: qkv_panel_kernel, attn_head_kernel<1> -> ctx bf16 [N*S, C],
//   epi_kernel<1>).
// precise (lct_banded_forward_f32), all f32 on CUDA cores (common.cuh):
//   proj_kernel -> qkv f32, banded_attn_kernel -> ctx f32, proj_kernel -> out
//   (at C >= 256 heads of 128 to 512 channels take attn_warp_kernel<1>
//   with the band instead of banded_attn_kernel, whose thread a row would
//   hold 2 HDP floats).
//
// Bound on the H100 at C = 64: at the banded time block of the
// 196,608-sample bucket (N = 20*33 sequences of S = 772, W = 64) the
// function moves ~261 MB (x in, out back; ~78 us at 3.35 TB/s) and does
// ~25 GFLOP of useful products, 82% of them in the qkv and output
// projections (~25 us at 989 TFLOP/s bf16): it is bound by bytes. Its one
// exp per in-band pair (127 M) takes ~31 us at the ~4.15 T/s that
// ops/probe.py measures for ex2.
//
// The bf16 design keeps device memory to x in and out back. Work item: one
// (sequence, tile of BQ query rows); each block of a persistent grid walks a
// contiguous range of items, in_w and out_w staged in shared memory as bf16
// once. Each warp stages the x rows of its own 16 queries by cp.async under
// the previous item's attention, reads them as bf16 A fragments and
// projects them on tensor cores: k and v into a ring of rows in shared
// memory, q into the A fragments of its scores. The keys of the band before
// the item, its halo, are the previous item's rows, still in the ring; only
// an item that starts a sequence or the block's range projects its halo
// too, staged through the same rows (the TPU kernel recomputes its previous
// tile every time). Each warp then takes its 16
// query rows through the heads, two at a time: it scores them against
// the W + 16 keys its band can reach (NCH chunks of 16; the scores stay in
// registers), masks only the chunks that cross the band's edges or the
// sequence start, takes the exact row max, one ex2 per pair in log2 units,
// the row sum, p = bf16(e / l) and P @ V from the registers. The context,
// rounded and packed, is the A fragment of the output projection. Two block
// barriers per item. At W = 64 an item takes about four times the clocks
// its instructions need at full instruction throughput (counted from the
// source, against the measured time; PERF.md), with 8 warps per SM (255
// registers a thread): the dependent steps of each warp's softmax, more
// than a pipe or device memory, set its pace.
//
// Heads: any num_heads dividing the true width c_true <= C (run at
// head_width, common.cuh), the score scale from the caller.
// The kernels are built per padded head width (head_pad in common.cuh):
// 16, 32 (two k-steps a score) or 64 (four, one head a pass) with every head
// unrolled, or 8 for hd <= 8, whose heads take masked fragments (tc.cuh's
// q_mask, v_mask) in a loop, two at a time, their context summed in f32 and
// rounded once for the output projection.

#include <limits.h>

#include "tc.cuh"

namespace lct {

// ---------------------------------------------------------------------------
// Precise mode: CUDA cores, all f32.
//
// One block takes one (sequence, head, tile of BT = 128 query rows), stages
// the K/V rows its queries can reach, [t0 - W, t0 + BT), in shared memory,
// and scores each query only against those, so the work is O(S * W) for any
// S. A warp walks the union of its 32 rows' bands in step (W + 32 keys), so
// every K/V read from shared memory is a broadcast; each row keeps its own
// keys by a test. Heads of hd channels are staged HDP wide (head_pad: 8 for
// hd <= 8, zero past hd, which adds nothing to a score or a context).
constexpr int BT = 128;  // query rows per block, one per thread
// Key rows staged in shared memory at a time: 32 KB of K and V for any head.
template <int HDP>
struct BandKeys {
  static constexpr int BKC = HDP <= 16 ? 256 : 4096 / HDP;
};

// One pass over the staged keys [c0, c1) that the warp's rows can reach,
// [wk0, wk1]: PASS 0 takes the row max, PASS 1 the softmax denominator,
// PASS 2 accumulates the context with p = exp(s - m) / den.
template <int PASS, int HDP>
__device__ __forceinline__ void band_pass(const float* Ks, const float* Vs,
                                          const float* kb, int c0, int c1,
                                          int wk0, int wk1, int q, int W,
                                          bool live, float scale,
                                          const float (&qv)[HDP], float& m,
                                          float& den, float (&acc)[HDP]) {
  const int a = max(c0, wk0), b = min(c1 - 1, wk1);
  for (int k = a; k <= b; ++k) {
    const float4* kr = reinterpret_cast<const float4*>(Ks + (k - c0) * HDP);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < HDP / 4; ++i) {
      const float4 kk = kr[i];
      s = fmaf(qv[4 * i], kk.x, s);
      s = fmaf(qv[4 * i + 1], kk.y, s);
      s = fmaf(qv[4 * i + 2], kk.z, s);
      s = fmaf(qv[4 * i + 3], kk.w, s);
    }
    s = s * scale + kb[k - c0];
    if (!(live && k >= q - W && k <= q)) continue;
    if (PASS == 0) {
      m = fmaxf(m, s);
    } else if (PASS == 1) {
      den += expf(s - m);
    } else {
      const float p = expf(s - m) / den;
      const float4* vr = reinterpret_cast<const float4*>(Vs + (k - c0) * HDP);
#pragma unroll
      for (int i = 0; i < HDP / 4; ++i) {
        const float4 vv = vr[i];
        acc[4 * i] = fmaf(p, vv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
      }
    }
  }
}

// qkv [N*S, 3C] -> ctx [N*S, C], C / hd heads (scores scaled by `scale`).
// Block b covers sequence n, head h and query rows [t0, t0 + BT) with b =
// (n * nh + h) * ntiles + t0 / BT. The keys the tile can reach,
// [max(0, t0 - W), min(S, t0 + BT)), are staged BKC rows at a time: with
// W <= BKC - BT they fit at once and are loaded once; a wider band reloads
// each chunk in each of the three passes, so shared memory stays 33 KB for
// any W.
template <int HDP>
__global__ void __launch_bounds__(BT)
    banded_attn_kernel(const float* __restrict__ qkv,
                       const float* __restrict__ key_bias,
                       float* __restrict__ ctx, int S, int W, int ntiles,
                       int hd_rt, float scale) {
  constexpr int BKC = BandKeys<HDP>::BKC;
  __shared__ __align__(16) float Ks[BKC * HDP];
  __shared__ __align__(16) float Vs[BKC * HDP];
  __shared__ float kb[BKC];
  const int hd = HDP >= 16 ? HDP : hd_rt;
  const int nh = C / hd;
  const int tid = threadIdx.x;
  const int tile = (int)(blockIdx.x % (unsigned)ntiles);
  const long long seq_head = blockIdx.x / (unsigned)ntiles;
  const long long n = seq_head / nh;
  const int h = (int)(seq_head % nh);
  const float* base = qkv + (size_t)n * S * (3 * C);
  const int t0 = tile * BT;
  const int q = t0 + tid;
  const bool live = q < S;
  const int kbeg = max(0, t0 - W), kend = min(S, t0 + BT);
  const int warp0 = t0 + (tid & ~31);
  const int wk0 = max(0, warp0 - W), wk1 = min(S - 1, warp0 + 31);

  float qv[HDP];
  if (live) {
    const float* qp = base + (size_t)q * 3 * C + h * hd;
    if (HDP >= 16) {
#pragma unroll
      for (int i = 0; i < HDP / 4; ++i) {
        const float4 t = reinterpret_cast<const float4*>(qp)[i];
        qv[4 * i] = t.x;
        qv[4 * i + 1] = t.y;
        qv[4 * i + 2] = t.z;
        qv[4 * i + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int d = 0; d < HDP; ++d) qv[d] = d < hd ? qp[d] : 0.f;
    }
  } else {
#pragma unroll
    for (int d = 0; d < HDP; ++d) qv[d] = 0.f;
  }

  float m = -INFINITY, den = 0.f, acc[HDP];
#pragma unroll
  for (int d = 0; d < HDP; ++d) acc[d] = 0.f;
  const int nchunks = (kend - kbeg + BKC - 1) / BKC;
  for (int pass = 0; pass < 3; ++pass) {
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = kbeg + c * BKC, c1 = min(kend, c0 + BKC);
      if (nchunks > 1 || pass == 0) {
        __syncthreads();  // the previous chunk's readers are done
        if (HDP >= 16) {
          for (int i = tid; i < (c1 - c0) * (HDP / 4); i += BT) {
            const int r = i / (HDP / 4), part = i % (HDP / 4);
            const float* row =
                base + (size_t)(c0 + r) * 3 * C + h * hd + 4 * part;
            *reinterpret_cast<float4*>(Ks + r * HDP + 4 * part) =
                *reinterpret_cast<const float4*>(row + C);
            *reinterpret_cast<float4*>(Vs + r * HDP + 4 * part) =
                *reinterpret_cast<const float4*>(row + 2 * C);
          }
        } else {
          for (int i = tid; i < (c1 - c0) * HDP; i += BT) {
            const int r = i / HDP, d = i % HDP;
            const float* row = base + (size_t)(c0 + r) * 3 * C + h * hd + d;
            Ks[i] = d < hd ? row[C] : 0.f;
            Vs[i] = d < hd ? row[2 * C] : 0.f;
          }
        }
        for (int r = tid; r < c1 - c0; r += BT)
          kb[r] = key_bias ? key_bias[(size_t)n * S + c0 + r] : 0.f;
        __syncthreads();
      }
      if (pass == 0)
        band_pass<0, HDP>(Ks, Vs, kb, c0, c1, wk0, wk1, q, W, live, scale,
                          qv, m, den, acc);
      else if (pass == 1)
        band_pass<1, HDP>(Ks, Vs, kb, c0, c1, wk0, wk1, q, W, live, scale,
                          qv, m, den, acc);
      else
        band_pass<2, HDP>(Ks, Vs, kb, c0, c1, wk0, wk1, q, W, live, scale,
                          qv, m, den, acc);
    }
  }
  if (!live) return;
  float* o = ctx + ((size_t)n * S + q) * C + h * hd;
  if (HDP >= 16) {
#pragma unroll
    for (int i = 0; i < HDP / 4; ++i)
      reinterpret_cast<float4*>(o)[i] = make_float4(
          acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  } else {
#pragma unroll
    for (int d = 0; d < HDP; ++d)
      if (d < hd) o[d] = acc[d];
  }
}

// ---------------------------------------------------------------------------
// bf16 mode: one fused tensor-core pass (see the note at the top).
//
// Query rows per work item, 16 per warp: 64-row items fit two blocks per SM
// (89 KB of shared memory at W <= 64 and C = 64, up to 255 registers a
// thread);
// 128-row items, one block per SM, were 3-7% slower at S = 772 and at most
// 5% faster at S = 3,588 (PERF.md).
constexpr int BQ = 64;
constexpr int BQ_THREADS = 2 * BQ;
constexpr int MIN_BLOCKS = 2;
constexpr int XLD = C + 8;  // f32 row stride of the staged x rows
// Heads a warp takes through the softmax at once: two independent chains of
// dependent steps (max, shuffles, ex2, sum, P @ V) for twice the score
// registers (one head at a time was 7% slower, and a three-block register
// budget with its spills 19%: PERF.md).
constexpr int HP = 2;
// The widest band whose scores a warp keeps in registers: MAX_CHUNKS chunks
// of 16 keys (64 f32 scores a thread). Wider bands take attn_tc_kernel<1>,
// and so does every band at C = 128 (no fused kernel there: -1).
constexpr int MAX_CHUNKS = 8;
constexpr int MAX_REG_W = C <= 64 ? 16 * (MAX_CHUNKS - 1) : -1;

struct BandedArgs {
  const float* x;         // [N, S, C]
  const float* in_w;      // [C, 3C]
  const float* in_b;      // [3C]
  const float* out_w;     // [C, C]
  const float* out_b;     // [C]
  const float* key_bias;  // [N, S] or null
  float* out;             // [N, S, C]
  long long N;
  int S;
  int lookback;
  int hd;  // head width the kernels run: a power of two
  float scale2;  // the score scale in log2 units (tc::qk_scale2)
};

// NCH = ceil(W / 16) + 1 key chunks per warp: the halo of 16 (NCH - 1) rows
// before the item's first query holds every key its band reaches. K, V and
// the key bias live in a ring of KR rows, key k in row k mod KR: an item
// that continues its block's previous one (the next query tile of the same
// sequence) finds its halo there and projects only its own rows.
template <int NCH>
struct BandShape {
  static constexpr int HALO = 16 * (NCH - 1);
  static constexpr int KR = BQ + HALO;  // ring rows
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (C * tc::LDW + C * tc::LDS)  // in_w, out_w
      + sizeof(__nv_bfloat16) * 2 * KR * tc::LDS           // k, v
      + sizeof(float) * KR                                 // key bias
      + sizeof(float) * BQ * XLD;                          // next x rows
};

// Stage x rows [row0, row0 + 16) of one sequence (zeros outside [0, S)) in
// this warp's rows of shared memory by cp.async.
__device__ __forceinline__ void stage_rows(float* xw,
                                           const float* __restrict__ xn,
                                           int row0, int S, int lane) {
  constexpr int PL = tc::PIECES_LOG2 + 1;  // log2 of C / 4, f32 pieces a row
  for (int c = lane; c < 16 * (C / 4); c += 32) {
    const int r = c >> PL, part = c & ((1 << PL) - 1), row = row0 + r;
    const bool ok = row >= 0 && row < S;
    tc::cp_async16(xw + r * XLD + part * 4,
                   xn + (size_t)(ok ? row : 0) * C + part * 4, ok);
  }
}

// The A fragments (C / 16 16-column k-steps) of the 16 x rows a warp
// staged, rounded to bf16.
__device__ __forceinline__ void staged_frags(uint32_t (&af)[C / 16][4],
                                             const float* xw, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p0 = xw + g * XLD + 2 * t;
  const float* p1 = p0 + 8 * XLD;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const float2 a0 = *reinterpret_cast<const float2*>(p0 + kk * 16);
    const float2 a1 = *reinterpret_cast<const float2*>(p1 + kk * 16);
    const float2 a2 = *reinterpret_cast<const float2*>(p0 + kk * 16 + 8);
    const float2 a3 = *reinterpret_cast<const float2*>(p1 + kk * 16 + 8);
    af[kk][0] = tc::pack_bf16(a0.x, a0.y);
    af[kk][1] = tc::pack_bf16(a1.x, a1.y);
    af[kk][2] = tc::pack_bf16(a2.x, a2.y);
    af[kk][3] = tc::pack_bf16(a3.x, a3.y);
  }
}

// k and v of 16 key rows from their x fragments: bf16(x @ in_w[:, C:3C]
// + in_b), stored at rows [r0, r0 + 16) of ks and vs.
__device__ __forceinline__ void project_kv(const uint32_t (&af)[C / 16][4],
                                           const __nv_bfloat16* ws,
                                           const float* __restrict__ in_b,
                                           __nv_bfloat16* ks,
                                           __nv_bfloat16* vs, int r0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int np = 0; np < C / 8; ++np) {
    float acc[2][4];
    tc::product_16cols(acc, af, ws + C + np * 16, tc::LDW, lane);
    __nv_bfloat16* dst = np < C / 16 ? ks : vs;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = (np & (C / 16 - 1)) * 16 + j * 8 + 2 * t;
      const float b0 = __ldg(in_b + C + np * 16 + j * 8 + 2 * t);
      const float b1 = __ldg(in_b + C + np * 16 + j * 8 + 2 * t + 1);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<uint32_t*>(dst + (r0 + g + 8 * rr) * tc::LDS +
                                     col) =
            tc::pack_bf16(acc[j][2 * rr] + b0, acc[j][2 * rr + 1] + b1);
    }
  }
}

// The context of n8 tile nt, element e, summed over the NACC accumulators.
template <int NACC, int NT>
__device__ __forceinline__ float acc_sum(const float (&o)[NACC][NT][4],
                                         int nt, int e) {
  return NACC > 1 ? o[0][nt][e] + o[NACC - 1][nt][e] : o[0][nt][e];
}

// HDP: the padded head width (head_pad): 16, 32 or 64 (at most C <= 64),
// or 8 for any hd <= 8 (the true width a.hd at run time, each head a masked
// fragment as in tc.cuh's attention).
template <int NCH, int HDP>
__global__ void __launch_bounds__(BQ_THREADS, MIN_BLOCKS)
    banded_tc_kernel(BandedArgs a) {
  constexpr int HALO = BandShape<NCH>::HALO, KR = BandShape<NCH>::KR;
  constexpr int NW = BQ / 16, HALO_TILES = HALO / 16;
  // A head's 16-channel k-steps and n8 tiles of context, the heads a warp
  // takes at once, and its context accumulators (even and odd chunks, but
  // one for the wider heads: their tiles give the chains enough to do).
  constexpr int KS = HDP >= 16 ? HDP / 16 : 1;
  constexpr int NT = HDP >= 16 ? HDP / 8 : 1;
  constexpr int HPW = HDP == 64 || HDP == C ? 1 : HP;
  constexpr int NACC = HDP > 16 ? 1 : 2;
  const int hd = HDP >= 16 ? HDP : a.hd;
  const int nh = C / hd;
  const float scale2 = a.scale2;
  using tc::LDS;
  using tc::LDW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // in_w
  __nv_bfloat16* wo = ws + C * LDW;                                 // out_w
  __nv_bfloat16* ks = wo + C * LDS;   // k [KR][LDS]
  __nv_bfloat16* vs = ks + KR * LDS;  // v [KR][LDS]
  float* kbs = reinterpret_cast<float*>(vs + KR * LDS);  // key bias [KR]
  // This warp's 16 staged x rows (f32 [16][XLD]).
  float* xw = kbs + KR + 16 * (threadIdx.x >> 5) * XLD;
  tc::stage_weight(ws, LDW, a.in_w, C, 3 * C);
  tc::stage_weight(wo, LDS, a.out_w, C, C);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int S = a.S, W = a.lookback;
  const int nqt = (S + BQ - 1) / BQ;
  const long long items = a.N * nqt;
  // Each block walks a contiguous range of items, so that most continue
  // the previous one.
  const long long per = (items + gridDim.x - 1) / gridDim.x;
  const long long first = blockIdx.x * per;
  const long long last = min(items, first + per);
  if (first < last) {
    stage_rows(xw, a.x + (size_t)(first / nqt) * S * C,
               (int)(first % nqt) * BQ + 16 * warp, S, lane);
    tc::cp_async_commit();
  }

  for (long long item = first; item < last; ++item) {
    const long long n = item / nqt;
    const int q0 = (int)(item % nqt) * BQ;
    const int k0 = q0 - HALO;  // the item's first key
    const bool fresh = item == first || q0 == 0;  // no halo in the ring yet
    const int r0 = q0 + 16 * warp;  // this warp's first query
    const float* xn = a.x + (size_t)n * S * C;
    // Each warp projects its own 16 query rows (q, k, v), staged under the
    // previous item, and, for a fresh item, halo tiles warp, warp + NW, ...
    // (k, v), staged in turn in the same rows; the loads of the first halo
    // tile and of the new key bias are in flight across the barrier.
    uint32_t own[C / 16][4];
    tc::cp_async_wait<0>();
    __syncwarp();
    staged_frags(own, xw, lane);
    if (fresh && warp < HALO_TILES) {
      __syncwarp();  // every lane has read its own rows
      stage_rows(xw, xn, k0 + 16 * warp, S, lane);
      tc::cp_async_commit();
    }
    const int kb0 = fresh ? k0 : q0, nkb = fresh ? KR : BQ;
    constexpr int KB_PER_THREAD = (KR + BQ_THREADS - 1) / BQ_THREADS;
    float kbv[KB_PER_THREAD];
#pragma unroll
    for (int i = 0; i < KB_PER_THREAD; ++i) {
      const int key = kb0 + tid + i * BQ_THREADS;
      kbv[i] = a.key_bias != nullptr && key >= 0 && key < S &&
                       tid + i * BQ_THREADS < nkb
                   ? __ldg(a.key_bias + (size_t)n * S + key)
                   : 0.f;
    }
    __syncthreads();  // the last item's readers of the ring are done
#pragma unroll
    for (int i = 0; i < KB_PER_THREAD; ++i)
      if (tid + i * BQ_THREADS < nkb)
        kbs[(kb0 + tid + i * BQ_THREADS + KR) % KR] = kbv[i];
    // q, rounded: the C fragments of each 16-channel k-step's two n8 tiles
    // are the A fragment of the scores over those channels.
    uint32_t qa[C / 16][4];
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      float acc[2][4];
      tc::product_16cols(acc, own, ws + kk * 16, LDW, lane);
      const int col = kk * 16 + 2 * t;
      const float b00 = __ldg(a.in_b + col), b01 = __ldg(a.in_b + col + 1);
      const float b10 = __ldg(a.in_b + col + 8);
      const float b11 = __ldg(a.in_b + col + 9);
      qa[kk][0] = tc::pack_bf16(acc[0][0] + b00, acc[0][1] + b01);
      qa[kk][1] = tc::pack_bf16(acc[0][2] + b00, acc[0][3] + b01);
      qa[kk][2] = tc::pack_bf16(acc[1][0] + b10, acc[1][1] + b11);
      qa[kk][3] = tc::pack_bf16(acc[1][2] + b10, acc[1][3] + b11);
    }
    project_kv(own, ws, a.in_b, ks, vs, r0 % KR, lane);
    if (fresh) {
      for (int h = warp; h < HALO_TILES; h += NW) {
        if (h != warp) {
          __syncwarp();  // the last halo tile is read
          stage_rows(xw, xn, k0 + 16 * h, S, lane);
          tc::cp_async_commit();
        }
        uint32_t halo[C / 16][4];
        tc::cp_async_wait<0>();
        __syncwarp();
        staged_frags(halo, xw, lane);
        project_kv(halo, ws, a.in_b, ks, vs, (k0 + 16 * h + KR) % KR, lane);
      }
    }
    __syncthreads();  // k, v and key bias complete; x rows read
    if (item + 1 < last) {  // the next item's rows load under this one
      const long long nx = item + 1;
      stage_rows(xw, a.x + (size_t)(nx / nqt) * S * C,
                 (int)(nx % nqt) * BQ + 16 * warp, S, lane);
      tc::cp_async_commit();
    }
    if (r0 >= S) continue;

    // Chunk c holds keys r0 - back + [0, 16), back = 16 (NCH - 1 - c):
    // `need` if some key of it may be in some row's band, `full` if every
    // key is in every row's band (no mask). Key i of the chunk is in row
    // rho's band iff d = rho - i + back lies in [0, min(W, r0 + rho)] (the
    // band, and key >= 0): one unsigned compare against `hi`.
    unsigned need = 0u, full = 0u;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int back = 16 * (NCH - 1 - c);
      if (back - 15 <= W && r0 - back + 15 >= 0) need |= 1u << c;
      if (back >= 15 && back + 15 <= W && r0 - back >= 0) full |= 1u << c;
    }
    const unsigned hi[2] = {(unsigned)min(W, r0 + g),
                            (unsigned)min(W, r0 + g + 8)};
    int slot[NCH];  // ring row of chunk c's first key
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      slot[c] = (r0 - 16 * (NCH - 1 - c) + KR) % KR;
    uint32_t ca[C / 16][4];
    float cx[HDP == 8 ? C / 8 : 1][4] = {};  // HDP = 8: all heads' context
    // Heads h0 .. h0 + HPW - 1 through the softmax (unrolled for a fixed
    // head count, a loop over the C / hd heads for HDP = 8).
#pragma unroll (HDP == 16 ? 2 : 1)
    for (int h0 = 0; h0 < nh; h0 += HPW) {
      // Their q fragments (KS k-steps each; HDP = 8: the head's k-step,
      // masked to its channels) and first channel in K and V.
      uint32_t qh[HPW][KS][4];
      int col0[HPW];
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
        const int h = h0 + hh;
        if (HDP >= 16) {
          col0[hh] = h * HDP;
#pragma unroll
          for (int ki = 0; ki < KS; ++ki)
#pragma unroll
            for (int i = 0; i < 4; ++i) qh[hh][ki][i] = qa[h * KS + ki][i];
        } else {
          col0[hh] = (h * hd) & ~15;
#pragma unroll
          for (int kk = 0; kk < C / 16; ++kk)
            if (kk == col0[hh] / 16)
#pragma unroll
              for (int i = 0; i < 4; ++i) qh[hh][0][i] = qa[kk][i];
          tc::q_mask(qh[hh][0], h, hd, lane);
        }
      }
      // Scores in log2 units, s log2(e) = (q . k) log2(e) / sqrt(hd) +
      // key_bias log2(e); -inf outside the band.
      float sc[HPW][NCH][2][4];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (!((need >> c) & 1u)) continue;
        const float2 kb[2] = {
            *reinterpret_cast<const float2*>(kbs + slot[c] + 2 * t),
            *reinterpret_cast<const float2*>(kbs + slot[c] + 8 + 2 * t)};
#pragma unroll
        for (int hh = 0; hh < HPW; ++hh) {
          uint32_t kf[KS][4];
#pragma unroll
          for (int ki = 0; ki < KS; ++ki)
            tc::load_b_nk(kf[ki], ks + slot[c] * LDS + col0[hh] + ki * 16,
                          LDS, lane);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float* sj = sc[hh][c][j];
            sj[0] = sj[1] = sj[2] = sj[3] = 0.f;
#pragma unroll
            for (int ki = 0; ki < KS; ++ki)
              tc::mma(sj, qh[hh][ki], kf[ki][2 * j], kf[ki][2 * j + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float v = fmaf(sj[e], scale2,
                             ((e & 1) ? kb[j].y : kb[j].x) * tc::LOG2E);
              if (!((full >> c) & 1u)) {
                const int d = g + 8 * (e >> 1) - (j * 8 + 2 * t + (e & 1)) +
                              16 * (NCH - 1 - c);
                v = (unsigned)d <= hi[e >> 1] ? v : -INFINITY;
              }
              sj[e] = v;
            }
          }
        }
      }
      // The exact row max (a chunk's four values of a row first, then
      // across chunks: short chains), one ex2 per pair, the row sum.
      float mx[HPW][2], sum[HPW][2], inv[HPW][2];
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float m = -INFINITY;
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            if (!((need >> c) & 1u)) continue;
            const float* s0 = sc[hh][c][0] + 2 * r;
            const float* s1 = sc[hh][c][1] + 2 * r;
            m = fmaxf(m, fmaxf(fmaxf(s0[0], s0[1]), fmaxf(s1[0], s1[1])));
          }
          m = tc::quad_max(m);
          mx[hh][r] = m == -INFINITY ? 0.f : m;  // guard: a row's own key
        }
      }
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
        sum[hh][0] = sum[hh][1] = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          if (!((need >> c) & 1u)) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[hh][c][j][e] = tc::ex2(sc[hh][c][j][e] - mx[hh][e >> 1]);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            sum[hh][r] += (sc[hh][c][0][2 * r] + sc[hh][c][0][2 * r + 1]) +
                          (sc[hh][c][1][2 * r] + sc[hh][c][1][2 * r + 1]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float tot = tc::quad_sum(sum[hh][r]);
          inv[hh][r] = tot > 0.f ? 1.f / tot : 0.f;
        }
      // p = bf16(e / l) as the A fragment of P @ V, chunk by chunk, into
      // NACC accumulators (even and odd chunks: half the chain).
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
        const int h = h0 + hh;
        float o[NACC][NT][4] = {};
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          if (!((need >> c) & 1u)) continue;
          const float(&p)[2][4] = sc[hh][c];
          const float* iv = inv[hh];
          const uint32_t pa[4] = {
              tc::pack_bf16(p[0][0] * iv[0], p[0][1] * iv[0]),
              tc::pack_bf16(p[0][2] * iv[1], p[0][3] * iv[1]),
              tc::pack_bf16(p[1][0] * iv[0], p[1][1] * iv[0]),
              tc::pack_bf16(p[1][2] * iv[1], p[1][3] * iv[1])};
          uint32_t vf[4];
          if (HDP >= 16) {
#pragma unroll
            for (int ki = 0; ki < KS; ++ki) {
              tc::load_b_kn(vf, vs + slot[c] * LDS + col0[hh] + ki * 16, LDS,
                            lane);
              tc::mma(o[c % NACC][2 * ki], pa, vf[0], vf[1]);
              tc::mma(o[c % NACC][2 * ki + 1], pa, vf[2], vf[3]);
            }
          } else {
            // The head's n8 tile of V, the other heads' columns zeroed.
            tc::load_b_kn(vf, vs + slot[c] * LDS + col0[hh], LDS, lane);
            const int nt = (h * hd) >> 3;
            const uint32_t vm = tc::v_mask(h, hd, lane);
            tc::mma(o[c % NACC][0], pa, ((nt & 1) ? vf[2] : vf[0]) & vm,
                    ((nt & 1) ? vf[3] : vf[1]) & vm);
          }
        }
        if (HDP >= 16) {
#pragma unroll
          for (int ki = 0; ki < KS; ++ki)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              uint32_t* cah = ca[h * KS + ki];
              const int nt = 2 * ki + j;
              cah[2 * j] = tc::pack_bf16(acc_sum(o, nt, 0), acc_sum(o, nt, 1));
              cah[2 * j + 1] =
                  tc::pack_bf16(acc_sum(o, nt, 2), acc_sum(o, nt, 3));
            }
        } else {
          const int nt = (h * hd) >> 3;
#pragma unroll
          for (int q = 0; q < C / 8; ++q)
            if (q == nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                cx[HDP == 8 ? q : 0][e] += acc_sum(o, 0, e);
        }
      }
    }
    if (HDP == 8) {
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* v = cx[HDP == 8 ? 2 * kk + j : 0];
          ca[kk][2 * j] = tc::pack_bf16(v[0], v[1]);
          ca[kk][2 * j + 1] = tc::pack_bf16(v[2], v[3]);
        }
    }

    // out = bf16(ctx) @ bf16(out_w) + out_b, f32.
    float acc[C / 8][4];
    tc::out_projection(acc, ca, wo, lane);
    const size_t rowbase = (size_t)n * S;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float b0 = __ldg(a.out_b + col), b1 = __ldg(a.out_b + col + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (row < S)
          *reinterpret_cast<float2*>(a.out + (rowbase + row) * C + col) =
              make_float2(acc[nt][2 * r] + b0, acc[nt][2 * r + 1] + b1);
      }
    }
  }
}

template <int NCH, int HDP>
cudaError_t launch_banded_tc(const BandedArgs& a, cudaStream_t st) {
  constexpr size_t smem = BandShape<NCH>::SMEM;
  cudaError_t e = tc::allow_smem(banded_tc_kernel<NCH, HDP>, smem);
  if (e != cudaSuccess) return e;
  unsigned grid = 1;
  e = tc::persistent_grid(banded_tc_kernel<NCH, HDP>, BQ_THREADS, smem,
                          a.N * ((a.S + BQ - 1) / BQ), &grid);
  if (e != cudaSuccess) return e;
  banded_tc_kernel<NCH, HDP><<<grid, BQ_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// banded_tc_kernel<NCH, HDP> for NCH = ceil(W / 16) + 1 chunks.
template <int HDP>
cudaError_t launch_banded_hd(const BandedArgs& a, cudaStream_t st) {
  switch ((a.lookback + 15) / 16 + 1) {
    case 1: return launch_banded_tc<1, HDP>(a, st);
    case 2: return launch_banded_tc<2, HDP>(a, st);
    case 3: return launch_banded_tc<3, HDP>(a, st);
    case 4: return launch_banded_tc<4, HDP>(a, st);
    case 5: return launch_banded_tc<5, HDP>(a, st);
    case 6: return launch_banded_tc<6, HDP>(a, st);
    case 7: return launch_banded_tc<7, HDP>(a, st);
    default: return launch_banded_tc<MAX_CHUNKS, HDP>(a, st);
  }
}

template <int HDP>
cudaError_t launch_banded_f32(const float* qkv, const float* key_bias,
                              float* ctx, long long N, int S, int lookback,
                              int hd, float scale, cudaStream_t st) {
  const int ntiles = (S + BT - 1) / BT;
  const long long ablocks = N * (C / hd) * ntiles;
  banded_attn_kernel<HDP><<<(unsigned)ablocks, BT, 0, st>>>(
      qkv, key_bias, ctx, S, lookback, ntiles, hd, scale);
  return cudaGetLastError();
}

}  // namespace lct

// x, out: [N, S, C]; in_w: [C, 3C]; out_w: [C, C]; key_bias: [N, S] or
// null; lookback >= 0; c_true true channels (the rest of each row zero) in
// num_heads heads, scale their score scale (the f32 rounding of 1 /
// sqrt(c_true / num_heads)). Scratch: none for lookback <= MAX_REG_W, else
// qkv bf16 [N*S, 3C], and at C >= 256 ctx bf16 [N*S, C] (else null).
// Returns a cudaError_t.
extern "C" int lct_banded_forward_bf16(const float* x, const float* in_w,
                                       const float* in_b, const float* out_w,
                                       const float* out_b,
                                       const float* key_bias, void* qkv,
                                       void* ctx, float* out, long long N,
                                       int S,
                                       int lookback, int c_true,
                                       int num_heads, float scale,
                                       int device, void* stream) {
  using namespace lct;
  if (lookback < 0 || N < 0 || S < 0 || !widths_ok(c_true, num_heads, 1) ||
      (C > 128) != (ctx != nullptr))
    return (int)cudaErrorInvalidValue;
  if (N * S == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const int hd = head_width(c_true / num_heads);
  const float scale2 = tc::qk_scale2(scale);
  if (lookback > MAX_REG_W) {
    if (qkv == nullptr) return (int)cudaErrorInvalidValue;
    __nv_bfloat16* q = static_cast<__nv_bfloat16*>(qkv);
    e = tc::launch_qkv({x, nullptr, nullptr, nullptr, nullptr, in_w, in_b, q,
                        nullptr, nullptr, N * S},
                       st);
    if (e != cudaSuccess) return (int)e;
    tc::AttnArgs a = {};
    a.qkv = q;
    a.key_bias = key_bias;
    a.out_w = out_w;
    a.out_b = out_b;
    a.out = out;
    a.N = N;
    a.L = S;
    a.lookback = lookback;
    a.hd = hd;
    a.scale2 = scale2;
    return (int)tc::launch_attn_tc<1>(a, st,
                                      static_cast<__nv_bfloat16*>(ctx));
  }
  if constexpr (C <= 64) {
    const BandedArgs a = {x, in_w, in_b, out_w, out_b, key_bias, out,
                          N, S, lookback, hd, scale2};
    switch (head_pad(hd)) {
      case 8: return (int)launch_banded_hd<8>(a, st);
      case 16: return (int)launch_banded_hd<16>(a, st);
      case 32:
        if constexpr (C >= 32) return (int)launch_banded_hd<32>(a, st);
        break;
      case 64:
        if constexpr (C >= 64) return (int)launch_banded_hd<64>(a, st);
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The widest band lct_banded_forward_bf16 serves from registers, with no
// scratch (the Python wrapper reads it to size the scratch).
extern "C" int lct_banded_max_register_lookback() { return lct::MAX_REG_W; }

// The same function in all-f32 arithmetic (precise mode), arguments as
// lct_banded_forward_bf16's. Scratch: qkv [N*S, 3C], ctx [N*S, C], f32.
extern "C" int lct_banded_forward_f32(const float* x, const float* in_w,
                                      const float* in_b, const float* out_w,
                                      const float* out_b,
                                      const float* key_bias, float* qkv,
                                      float* ctx, float* out, long long N,
                                      int S, int lookback, int c_true,
                                      int num_heads, float scale, int device,
                                      void* stream) {
  using namespace lct;
  if (lookback < 0 || N < 0 || S < 0 || !widths_ok(c_true, num_heads, 1))
    return (int)cudaErrorInvalidValue;
  const long long rows = N * S;
  if (rows == 0) return 0;
  const int hd = head_width(c_true / num_heads);
  const long long rblocks = (rows + PROJ_ROWS - 1) / PROJ_ROWS;
  if (rblocks > INT_MAX || N * (C / hd) * ((S + BT - 1) / BT) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;

  proj_kernel<false><<<row_grid((unsigned)rblocks, 3 * C),
                       row_threads(3 * C), 0, st>>>(
      x, nullptr, nullptr, nullptr, nullptr, in_w, in_b, qkv, rows, 3 * C,
      /*round=*/0, /*inv_c=*/0.f);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  e = cudaErrorInvalidValue;
  switch (head_pad(hd)) {
    case 8:
      e = launch_banded_f32<8>(qkv, key_bias, ctx, N, S, lookback, hd, scale,
                               st);
      break;
    case 16:
      e = launch_banded_f32<16>(qkv, key_bias, ctx, N, S, lookback, hd, scale,
                                st);
      break;
    case 32:
      if constexpr (C >= 32)
        e = launch_banded_f32<32>(qkv, key_bias, ctx, N, S, lookback, hd,
                                  scale, st);
      break;
    case 64:
      if constexpr (C >= 64)
        e = launch_banded_f32<64>(qkv, key_bias, ctx, N, S, lookback, hd,
                                  scale, st);
      break;
#if LCT_C > 128
    case 128:
      e = launch_attn_hd<1, 128>(qkv, key_bias, ctx, N, S, lookback, 0, hd,
                                 scale, st);
      break;
    case 256:
      e = launch_attn_hd<1, 256>(qkv, key_bias, ctx, N, S, lookback, 0, hd,
                                 scale, st);
      break;
#if LCT_C > 256
    case 512:
      e = launch_attn_hd<1, 512>(qkv, key_bias, ctx, N, S, lookback, 0, hd,
                                 scale, st);
      break;
#endif
#else
    case 128:
      if constexpr (C >= 128)
        e = launch_banded_f32<128>(qkv, key_bias, ctx, N, S, lookback, hd,
                                   scale, st);
      break;
#endif
  }
  if (e != cudaSuccess) return (int)e;
  proj_kernel<false><<<row_grid((unsigned)rblocks, C), row_threads(C), 0,
                       st>>>(
      ctx, nullptr, nullptr, nullptr, nullptr, out_w, out_b, out, rows, C,
      /*round=*/0, /*inv_c=*/0.f);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return 0;
}
