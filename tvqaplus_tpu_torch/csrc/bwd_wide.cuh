// Device code shared by the backward kernels at the hidden widths D = 64
// and 256 (tri_bridge_bwd_wide.cu, qa_ctx_attention_bwd_wide.cu,
// encoder_bwd_wide.cu, encoder_bwd_tc_wide.cu), which sit beside the D = 128
// sources so that those keep their code: dropout keep multipliers for
// D / 32 adjacent columns, the rounding to bf16 of the bf16 compute mode and
// the persistent kernels' grid.  The weight-gradient passes are those of
// every width (wgrad_tc.cuh on the tensor cores for the bf16
// instantiations, grad_reduce.cuh's wgrad on CUDA cores for the float32
// ones), which take D as an argument.
//
// The bf16 backwards are tensor-core kernels at both widths, rounding the
// products' operands where the TPU kernels' bf16 compute mode rounds; the
// float32 ones (the exactness check) run their row passes and their
// products other than the weight gradient on CUDA cores.  The weight
// gradient, the largest product of each backward, is the tensor-core pass
// in every bf16 instantiation.
#pragma once

#include "grad_reduce.cuh"
#include "philox.cuh"
#include "wgmma.cuh"
#include "wgrad_tc.cuh"

namespace tvqa {

// Dropout multipliers (0 or scale) of the N elements e0 .. e0 + N - 1 (N a
// multiple of 4 with e0 a multiple of 4, or N = 2 with e0 even).
template <int N>
__device__ __forceinline__ void keep_n(uint64_t seed, uint64_t e0,
                                       uint32_t threshold, float scale,
                                       float (&m)[N]) {
  if constexpr (N == 2) {
    const Philox4 r = philox4x32_10(e0 >> 2, seed);
    const bool hi = e0 & 2;
    m[0] = ((hi ? r.z : r.x) >> 8) >= threshold ? scale : 0.f;
    m[1] = ((hi ? r.w : r.y) >> 8) >= threshold ? scale : 0.f;
  } else {
#pragma unroll
    for (int u = 0; u < N / 4; ++u) {
      float q[4];
      keep4(seed, e0 + 4 * u, threshold, scale, q);
#pragma unroll
      for (int t = 0; t < 4; ++t) m[4 * u + t] = q[t];
    }
  }
}

// The N multipliers of keep_n, or ones when the dropout is off.
template <int N>
__device__ __forceinline__ void keep_or_one(const Dropout& drop, uint64_t e0,
                                            float (&m)[N]) {
#pragma unroll
  for (int t = 0; t < N; ++t) m[t] = 1.f;
  if (drop.on()) keep_n<N>(drop.seed, e0, drop.threshold, drop.scale, m);
}

// The device's multiprocessor count (the persistent kernels' grid).
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace tvqa
