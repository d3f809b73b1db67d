// The weight gradient of a dense product on the tensor cores, shared by the
// bfloat16 backward kernels (attention, tri bridge, encoder) at every width:
//   out[k][n] = sum_r X[r][k] G[r][n]   (X: R x K, G: R x Dn, both bf16),
//   out[K][n] = sum_r G[r][n]           (the bias gradient).
// It replaces the float32 CUDA-core wgrad_kernel of grad_reduce.cuh for
// those kernels: their X and G rows are rounded to bf16 before the product
// in the TPU kernels' bf16 compute mode anyway (pallas_attention.py:377,
// pallas_tri_bridge.py:157-159, pallas_encoder.py:221-223), so the main
// kernels write them as bf16 rows and this pass reads half the bytes.
//
// What bounds it on the H100: it reads R (K + Dn) bf16 values and does
// 2 R K Dn operations (Dn = 128, K = 3 Dn, R = 160,000: 164 MB and
// 21 GFLOP, bytes bind at ~49 us; K = Dn: 82 MB, 7 GFLOP, ~24 us).
// Design: block (x, chunk, z) owns X's columns [128 x, 128 x + 128) (64 a
// warpgroup; a warpgroup past K idles, as at K = 3 x 64) against G's
// columns [NC z, NC z + NC) and one chunk of rows, so the accumulator
// stays 64 x NC a warpgroup (NC = 64 at Dn = 64, 128 at Dn = 128 and 256:
// 64 registers a thread at most).  Both operands are read as they lie in
// memory (rows = depth: the transposed 16-bit operands), 64 rows a step,
// double-buffered with cp.async; two blocks an SM.  Each block writes its
// tile into its chunk's (K + 1) x Dn slot, and grad_reduce.cuh's sum_slots
// adds the chunks in a fixed order: the same bits from run to run.
#pragma once

#include "grad_reduce.cuh"
#include "wgmma.cuh"

namespace tvqa {

template <int NC>
struct WgradTc {
  static constexpr int X_BYTES = 2 * TILE_PANEL;               // 128 cols
  static constexpr int G_BYTES = NC / 64 * TILE_PANEL;
  static constexpr int STAGE = X_BYTES + G_BYTES;
  static constexpr int SMEM = 2 * STAGE + tc::ATOM_BYTES;
};

template <int NC>
__global__ void __launch_bounds__(NTHREADS, 2)
wgrad_tc_kernel(const __nv_bfloat16* __restrict__ X,
                const __nv_bfloat16* __restrict__ G,
                float* __restrict__ part, long long R, int K, int Dn,
                long long rows_per_chunk) {
  using S = WgradTc<NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * 2 * TM, n0 = blockIdx.z * NC;
  const bool x1 = k0 + TM < K;         // the second 64 columns exist
  const bool live = wg == 0 || x1;
  const long long r_begin = blockIdx.y * rows_per_chunk;
  const long long r_end = min(R, r_begin + rows_per_chunk);
  const int steps = r_end > r_begin
      ? static_cast<int>((r_end - r_begin + TM - 1) / TM) : 0;
  float acc[NC / 2], gb = 0.f;
#pragma unroll
  for (int k = 0; k < NC / 2; ++k) acc[k] = 0.f;

  auto load = [&](int step) {
    uint8_t* st = sm + (step & 1) * S::STAGE;
    const long long r0 = r_begin + static_cast<long long>(step) * TM;
    const int rows = static_cast<int>(min(static_cast<long long>(TM),
                                          r_end - r0));
    tc_load_rows<64>(st, TM, X + r0 * K + k0, K, rows, tid, NTHREADS);
    if (x1)
      tc_load_rows<64>(st + TILE_PANEL, TM, X + r0 * K + k0 + TM, K, rows,
                       tid, NTHREADS);
    tc_load_rows<NC>(st + S::X_BYTES, TM, G + r0 * Dn + n0, Dn, rows, tid,
                     NTHREADS);
    tc::cp_async_commit();
  };
  if (steps > 0) load(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      load(step + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_async_smem();
    __syncthreads();
    const uint32_t st = tc::smem_u32(sm + (step & 1) * S::STAGE);
    if (live) {
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < TM / 16; ++ks) {
        const int off = ks * 2 * tc::ATOM_BYTES;
        tc::mma_ss<NC, 1, 1>(
            acc, tc::make_desc(st + wg * TILE_PANEL + off, TILE_PANEL),
            tc::make_desc(st + S::X_BYTES + off, TILE_PANEL), 1);
      }
      tc::commit();
    }
    if (blockIdx.x == 0 && tid < NC) {
      const uint8_t* go = sm + (step & 1) * S::STAGE + S::X_BYTES
                          + (tid >> 6) * TILE_PANEL;
#pragma unroll 8
      for (int r = 0; r < TM; ++r)
        gb += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
            go + tc::swz(r, tid & 63)));
    }
    if (live) tc::wait_all();
    __syncthreads();                   // the stage is free for step + 2
  }
  tc::fence_regs(acc);
  float* slot = part + static_cast<size_t>(blockIdx.y) * (K + 1) * Dn;
  if (live) {
    float* dst = slot + static_cast<size_t>(k0 + wg * TM) * Dn + n0;
    const int rl = 16 * warp + (lane >> 2);
#pragma unroll
    for (int pr = 0; pr < NC / 4; ++pr) {
      const int k = rl + 8 * (pr & 1), n = 8 * (pr >> 1) + 2 * (lane & 3);
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(k) * Dn + n) =
          make_float2(acc[2 * pr], acc[2 * pr + 1]);
    }
  }
  if (blockIdx.x == 0 && tid < NC)
    slot[static_cast<size_t>(K) * Dn + n0 + tid] = gb;
}

template <int NC>
inline cudaError_t wgrad_tc_launch(const __nv_bfloat16* X,
                                   const __nv_bfloat16* G, float* part,
                                   long long R, int K, int Dn, int chunks,
                                   long long per, cudaStream_t stream) {
  cudaError_t err = allow_smem(wgrad_tc_kernel<NC>, WgradTc<NC>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((K + 2 * TM - 1) / (2 * TM), chunks, Dn / NC);
  wgrad_tc_kernel<NC><<<grid, NTHREADS, WgradTc<NC>::SMEM, stream>>>(
      X, G, part, R, K, Dn, per);
  return cudaGetLastError();
}

// out ((K + 1) x Dn float32: [X^T G; column sums of G]) over R rows,
// through `chunks` slots of part (chunks x (K + 1) x Dn floats).  Dn = 64,
// 128 or 256; K a multiple of 64; X and G 16-byte aligned.
inline cudaError_t wgrad_tc(const __nv_bfloat16* X, const __nv_bfloat16* G,
                            float* part, float* out, long long R, int K,
                            int Dn, int chunks, cudaStream_t stream) {
  if (K % TM != 0 || chunks < 1 || (Dn != 64 && Dn != 128 && Dn != 256))
    return cudaErrorInvalidValue;
  const long long per = ((R + chunks - 1) / chunks + TM - 1) / TM * TM;
  cudaError_t err =
      Dn == 64 ? wgrad_tc_launch<64>(X, G, part, R, K, Dn, chunks, per,
                                     stream)
               : wgrad_tc_launch<128>(X, G, part, R, K, Dn, chunks, per,
                                      stream);
  if (err != cudaSuccess) return err;
  return sum_slots<float>(part, out, 1, chunks,
                          static_cast<long long>(K + 1) * Dn, stream);
}

}  // namespace tvqa
