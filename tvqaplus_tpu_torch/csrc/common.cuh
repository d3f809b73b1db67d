// Shared device helpers for the port's kernels.
//
// The forward kernels take the hidden width D as a template parameter and
// are built for D = 64, 128 and 256.  The backward kernels of *_bwd.cu are
// D = 128's (BWD_D), and every helper shared with them defaults its D to
// that; those of *_bwd_wide.cu take D = 64 and 256 as a template parameter
// (bwd_wide.cuh).  In the float32 CUDA-core kernels a warp of 32 lanes
// covers one D-wide row at D / 32 values a lane (channels lane + 32 q, q <
// D / 32), and the row-tile GEMM below gives each lane D / 32 adjacent
// output columns (4 at D = 128).  Activations arrive as float or bfloat16
// (template T); all arithmetic and every intermediate is float32.  The
// row-tile GEMMs here serve the float32 CUDA-core kernels; the bf16
// kernels' products are wgmma (wgmma.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace tvqa {

constexpr int BWD_D = 128;             // the width of *_bwd.cu
// The name D at namespace scope, for the sources built for BWD_D alone (the
// D = 128 backward kernels and the MLP bridge, whose output-column tile it
// is):
// their headers (grad_reduce.cuh, mlp_bridge.cuh) bring it into scope, so a
// forward kernel, which never includes them, cannot use it by mistake.
namespace bwd {
constexpr int D = BWD_D;
}
constexpr int NTHREADS = 256;          // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int KC = 32;                 // weight rows staged per GEMM chunk
constexpr float LN_EPS = 1e-5f;
constexpr float NEG_INF = -1e10f;      // additive mask value
constexpr float SAFE_FLOOR = -3e4f;    // softmax logit floor

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The CPL floats at p (CPL = 2, 4 or 8; p aligned to min(CPL, 4) floats).
template <int CPL>
__device__ __forceinline__ void ld_cols(float (&w)[CPL], const float* p) {
  if constexpr (CPL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int u = 0; u < CPL / 4; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(p + 4 * u);
      w[4 * u] = v.x;
      w[4 * u + 1] = v.y;
      w[4 * u + 2] = v.z;
      w[4 * u + 3] = v.w;
    }
  }
}

// acc[j][t] += sum_{k < kc} Y[(r0 + j) * ys + ky + k] * Ws[k * D + c0 + t]
// for one chunk of kc (a multiple of 4) weight rows held in shared memory,
// t < D / 32.  A warp shares r0 (its rows) and its lanes take adjacent
// column groups, so the Y reads are broadcasts and the Ws reads are
// conflict-free 8- or 16-byte loads.  Y's base and ys must keep float4
// alignment.
template <int RPT, int D = BWD_D>
__device__ __forceinline__ void gemm_chunk(float (&acc)[RPT][D / 32],
                                           const float* Y, int ys, int ky,
                                           const float* Ws, int kc, int r0,
                                           int c0) {
  constexpr int CPL = D / 32;
  // D = 128: the code the kernels had before D became a parameter, so that
  // their machine code stays as it was; other widths load D / 32 columns
  if constexpr (CPL == 4) {
#pragma unroll 2
    for (int k = 0; k < kc; k += 4) {
      const float4 w0 = *reinterpret_cast<const float4*>(&Ws[(k + 0) * D + c0]);
      const float4 w1 = *reinterpret_cast<const float4*>(&Ws[(k + 1) * D + c0]);
      const float4 w2 = *reinterpret_cast<const float4*>(&Ws[(k + 2) * D + c0]);
      const float4 w3 = *reinterpret_cast<const float4*>(&Ws[(k + 3) * D + c0]);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float4 y =
            *reinterpret_cast<const float4*>(&Y[(r0 + j) * ys + ky + k]);
        acc[j][0] = fmaf(y.w, w3.x, fmaf(y.z, w2.x,
                    fmaf(y.y, w1.x, fmaf(y.x, w0.x, acc[j][0]))));
        acc[j][1] = fmaf(y.w, w3.y, fmaf(y.z, w2.y,
                    fmaf(y.y, w1.y, fmaf(y.x, w0.y, acc[j][1]))));
        acc[j][2] = fmaf(y.w, w3.z, fmaf(y.z, w2.z,
                    fmaf(y.y, w1.z, fmaf(y.x, w0.z, acc[j][2]))));
        acc[j][3] = fmaf(y.w, w3.w, fmaf(y.z, w2.w,
                    fmaf(y.y, w1.w, fmaf(y.x, w0.w, acc[j][3]))));
      }
    }
    return;
  }
#pragma unroll 2
  for (int k = 0; k < kc; k += 4) {
    float w0[CPL], w1[CPL], w2[CPL], w3[CPL];
    ld_cols<CPL>(w0, &Ws[(k + 0) * D + c0]);
    ld_cols<CPL>(w1, &Ws[(k + 1) * D + c0]);
    ld_cols<CPL>(w2, &Ws[(k + 2) * D + c0]);
    ld_cols<CPL>(w3, &Ws[(k + 3) * D + c0]);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const float4 y =
          *reinterpret_cast<const float4*>(&Y[(r0 + j) * ys + ky + k]);
#pragma unroll
      for (int t = 0; t < CPL; ++t)
        acc[j][t] = fmaf(y.w, w3[t], fmaf(y.z, w2[t],
                    fmaf(y.y, w1[t], fmaf(y.x, w0[t], acc[j][t]))));
    }
  }
}

// acc = Y (rows r0.., K wide, smem) x B[:, 0:D], where B is K x ldb
// row-major in device memory (columns past D unread), staged through the
// block's KC x D shared buffer Ws one chunk at a time.  Every thread of the
// block must call it (it synchronises).
template <int RPT, int D = BWD_D>
__device__ __forceinline__ void gemm_staged_ld(float (&acc)[RPT][D / 32],
                                               const float* Y, int ys, int K,
                                               const float* __restrict__ B,
                                               int ldb, float* Ws, int r0,
                                               int c0) {
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int t = 0; t < D / 32; ++t) acc[j][t] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();                   // previous chunk fully consumed
    float4* dst = reinterpret_cast<float4*>(Ws);
    for (int i = threadIdx.x; i < KC * D / 4; i += NTHREADS) {
      const int r = i / (D / 4), c = i % (D / 4);
      dst[i] = __ldg(reinterpret_cast<const float4*>(
                         B + static_cast<size_t>(k0 + r) * ldb) + c);
    }
    __syncthreads();
    gemm_chunk<RPT, D>(acc, Y, ys, k0, Ws, KC, r0, c0);
  }
}

// acc = Y (rows r0.., K wide, smem) x W (K x D row-major, device memory).
template <int RPT, int D = BWD_D>
__device__ __forceinline__ void gemm_staged(float (&acc)[RPT][D / 32],
                                            const float* Y, int ys, int K,
                                            const float* __restrict__ W,
                                            float* Ws, int r0, int c0) {
  gemm_staged_ld<RPT, D>(acc, Y, ys, K, W, D, Ws, r0, c0);
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float a, float b, float c,
                                       float d) {
  dst[0] = from_f<T>(a);
  dst[1] = from_f<T>(b);
  dst[2] = from_f<T>(c);
  dst[3] = from_f<T>(d);
}

// The N values v to dst[0 .. N) in T.
template <typename T, int N>
__device__ __forceinline__ void store_n(T* dst, const float (&v)[N]) {
#pragma unroll
  for (int t = 0; t < N; ++t) dst[t] = from_f<T>(v[t]);
}

// Opt a kernel into `bytes` of dynamic shared memory (above 48 KB needs
// it); returns the CUDA error code.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tvqa
