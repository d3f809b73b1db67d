// Deterministic sums across blocks for the backward kernels.
//
// On the TPU the grid runs in order, so the Pallas backward kernels add
// every parameter gradient into an output block that each grid step
// revisits (pallas_attention.py:382-387, pallas_tri_bridge.py:151-166,
// pallas_encoder.py:394-395).  On Hopper blocks run at once and in no
// order.  Here every block writes its partial sums into its own slot of a
// scratch buffer that the wrapper allocates, with plain stores, and a second
// launch from the same source sums the slots in a fixed order: gradients are
// the same bits from run to run.
//
//   sum_slots: out[b, n] = sum_s part[b, s, n]      (float32 in, T out)
//   wgrad:     out[k, n] = sum_r X[r, k] G[r, n]     (X: R x K, G: R x D)
// The weight gradient (the largest sum: 3D x D floats for the attention and
// the tri bridge) is its own small GEMM over row chunks: each block owns a
// 64 x D output tile and one chunk of rows, and writes the tile into the
// chunk's slot; sum_slots then adds the chunks.
#pragma once

#include "common.cuh"

namespace tvqa {

using bwd::D;

template <typename TO>
__global__ void __launch_bounds__(NTHREADS)
sum_slots_kernel(const float* __restrict__ part, TO* __restrict__ out, int S,
                 long long N) {
  const long long n = static_cast<long long>(blockIdx.x) * NTHREADS
                      + threadIdx.x;
  if (n >= N) return;
  const long long b = blockIdx.y;
  const float* p = part + b * S * N + n;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += p[s * N];
  out[b * N + n] = from_f<TO>(acc);
}

template <typename TO>
inline cudaError_t sum_slots(const float* part, TO* out, int batches, int S,
                             long long N, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((N + NTHREADS - 1) / NTHREADS),
                  batches);
  sum_slots_kernel<TO><<<grid, NTHREADS, 0, stream>>>(part, out, S, N);
  return cudaGetLastError();
}

constexpr int WG_K = 64;               // output rows (of K) per block
constexpr int WG_R = 32;               // rows of X and G staged at a time

__global__ void __launch_bounds__(NTHREADS)
wgrad_kernel(const float* __restrict__ X, const float* __restrict__ G,
             float* __restrict__ part, long long R, int K,
             long long rows_per_chunk) {
  __shared__ __align__(16) float xs[WG_R][WG_K];
  __shared__ __align__(16) float gs[WG_R][D];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * WG_K;
  const long long r_begin = static_cast<long long>(blockIdx.y)
                            * rows_per_chunk;
  const long long r_end = min(R, r_begin + rows_per_chunk);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (long long r0 = r_begin; r0 < r_end; r0 += WG_R) {
    for (int i = tid; i < WG_R * WG_K / 4; i += NTHREADS) {
      const int r = i / (WG_K / 4), c = i % (WG_K / 4);
      const long long row = r0 + r;
      reinterpret_cast<float4*>(&xs[r][0])[c] =
          row < r_end ? __ldg(reinterpret_cast<const float4*>(
                            X + row * K + k0) + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = tid; i < WG_R * D / 4; i += NTHREADS) {
      const int r = i / (D / 4), c = i % (D / 4);
      const long long row = r0 + r;
      reinterpret_cast<float4*>(&gs[r][0])[c] =
          row < r_end ? __ldg(reinterpret_cast<const float4*>(G + row * D)
                              + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < WG_R; ++r) {
      const float4 g = reinterpret_cast<const float4*>(&gs[r][0])[lane];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = xs[r][warp * 8 + i];
        acc[i][0] = fmaf(x, g.x, acc[i][0]);
        acc[i][1] = fmaf(x, g.y, acc[i][1]);
        acc[i][2] = fmaf(x, g.z, acc[i][2]);
        acc[i][3] = fmaf(x, g.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
  float* dst = part + static_cast<size_t>(blockIdx.y) * K * D;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(dst + static_cast<size_t>(k0 + warp * 8 + i)
                               * D + lane * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// out (K x D) = X^T G over R rows, through `chunks` slots of part
// (chunks x K x D floats).  K must be a multiple of WG_K.
inline cudaError_t wgrad(const float* X, const float* G, float* part,
                         float* out, long long R, int K, int chunks,
                         cudaStream_t stream) {
  if (K % WG_K != 0 || chunks < 1) return cudaErrorInvalidValue;
  const long long per = (R + chunks - 1) / chunks;
  wgrad_kernel<<<dim3(K / WG_K, chunks), NTHREADS, 0, stream>>>(
      X, G, part, R, K, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_slots<float>(part, out, 1, chunks,
                          static_cast<long long>(K) * D, stream);
}

}  // namespace tvqa
