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
//   wgrad:     out[k, n] = sum_r X[r, k] G[r, n]     (X: R x K, G: R x Dn)
// The weight gradient (the largest sum: 3D x D floats for the attention and
// the tri bridge) is its own small GEMM over row chunks, on CUDA cores in
// float32 at every width Dn: each block owns a 64 x min(Dn, 128) output
// tile and one chunk of rows, and writes the tile into the chunk's slot;
// sum_slots then adds the chunks.
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

// Block (x, chunk, z) owns 64 rows of K against G's columns [NC z, NC z +
// NC) (NC = min(Dn, 128)) and one chunk of rows; a lane owns NC / 32
// adjacent columns.
template <int NC>
__global__ void __launch_bounds__(NTHREADS)
wgrad_kernel(const float* __restrict__ X, const float* __restrict__ G,
             float* __restrict__ part, long long R, int K, int Dn,
             long long rows_per_chunk) {
  constexpr int CPL = NC / 32;
  __shared__ __align__(16) float xs[WG_R][WG_K];
  __shared__ __align__(16) float gs[WG_R][NC];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * WG_K, n0 = blockIdx.z * NC;
  const long long r_begin = static_cast<long long>(blockIdx.y)
                            * rows_per_chunk;
  const long long r_end = min(R, r_begin + rows_per_chunk);
  float acc[8][CPL];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[i][t] = 0.f;
  for (long long r0 = r_begin; r0 < r_end; r0 += WG_R) {
    for (int i = tid; i < WG_R * WG_K / 4; i += NTHREADS) {
      const int r = i / (WG_K / 4), c = i % (WG_K / 4);
      const long long row = r0 + r;
      reinterpret_cast<float4*>(&xs[r][0])[c] =
          row < r_end ? __ldg(reinterpret_cast<const float4*>(
                            X + row * K + k0) + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = tid; i < WG_R * NC / 4; i += NTHREADS) {
      const int r = i / (NC / 4), c = i % (NC / 4);
      const long long row = r0 + r;
      reinterpret_cast<float4*>(&gs[r][0])[c] =
          row < r_end ? __ldg(reinterpret_cast<const float4*>(
                            G + row * Dn + n0) + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < WG_R; ++r) {
      float g[CPL];
      ld_cols<CPL>(g, &gs[r][lane * CPL]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = xs[r][warp * 8 + i];
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[i][t] = fmaf(x, g[t], acc[i][t]);
      }
    }
    __syncthreads();
  }
  float* dst = part + static_cast<size_t>(blockIdx.y) * K * Dn + n0
               + lane * CPL;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      dst[static_cast<size_t>(k0 + warp * 8 + i) * Dn + t] = acc[i][t];
}

// out (K x Dn) = X^T G over R rows, through `chunks` slots of part (chunks
// x K x Dn floats).  Dn = 64, 128 or 256; K a multiple of WG_K.
inline cudaError_t wgrad(const float* X, const float* G, float* part,
                         float* out, long long R, int K, int Dn, int chunks,
                         cudaStream_t stream) {
  if (K % WG_K != 0 || chunks < 1 || (Dn != 64 && Dn != 128 && Dn != 256))
    return cudaErrorInvalidValue;
  const long long per = (R + chunks - 1) / chunks;
  if (Dn == 64)
    wgrad_kernel<64><<<dim3(K / WG_K, chunks, 1), NTHREADS, 0, stream>>>(
        X, G, part, R, K, Dn, per);
  else
    wgrad_kernel<128><<<dim3(K / WG_K, chunks, Dn / 128), NTHREADS, 0,
                        stream>>>(X, G, part, R, K, Dn, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_slots<float>(part, out, 1, chunks,
                          static_cast<long long>(K) * Dn, stream);
}

}  // namespace tvqa
