// Throughput probe of the special-function unit: how many exps per second
// the card sustains with the instruction the bf16 attention kernels use for
// theirs (tc::ex2, `ex2.approx.ftz.f32`). Not on any path of the model:
// chip_smoke.py divides a kernel's exp count by this rate to get the exp
// floor it prints beside the bound.
//
// Each thread runs EX2_CHAINS independent chains v = ex2(v) - 1 (which stay
// in [-1, 0]), so the special-function unit, not the latency of one chain,
// sets the pace once every SM holds a full complement of warps. The FADD
// between two exps runs on the FMA pipe, eight times wider.

#include "tc.cuh"

namespace lct {

constexpr int EX2_CHAINS = 8;

__global__ void ex2_rate_kernel(float* __restrict__ out, int iters) {
  float v[EX2_CHAINS];
#pragma unroll
  for (int i = 0; i < EX2_CHAINS; ++i)
    v[i] = -0.01f * (threadIdx.x & 31) - 0.1f * i / EX2_CHAINS;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < EX2_CHAINS; ++i) v[i] = tc::ex2(v[i]) - 1.f;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < EX2_CHAINS; ++i) s += v[i];
  out[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace lct

// out: f32 [blocks * threads]. Runs blocks x threads x iters x EX2_CHAINS
// exps. Returns a cudaError_t.
extern "C" int lct_ex2_rate_probe(float* out, int blocks, int threads,
                                  int iters, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  lct::ex2_rate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out,
                                                                      iters);
  return (int)cudaGetLastError();
}

extern "C" int lct_ex2_chains() { return lct::EX2_CHAINS; }
