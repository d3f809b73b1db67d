// Device functions shared by the fused MLP bridge's float32 CUDA-core
// kernels, the exactness check: the forward (mlp_bridge_fwd.cu) and the
// backward's recompute (mlp_bridge_bwd.cu), so the two cannot drift (the
// bf16 tensor-core kernels share mlp_bridge_tc.cuh).  The bridge's widths
// are run-time values (Din, Dout, multiples of 4; 768 -> 300 and 300 -> 300
// in STAGE), unlike every other kernel of the port, so a row's columns are
// walked in strides of the warp and the output columns are tiled by D = 128
// with a guarded tail.  A block owns BR_RT rows; each warp owns BR_RPT of
// them.
#pragma once

#include "common.cuh"
#include "philox.cuh"

namespace tvqa {

using bwd::D;

constexpr int BR_RPT = 4;
constexpr int BR_RT = BR_RPT * NWARPS;  // 32 rows per block

// a K extent rounded up to whole GEMM chunks: shared rows carry zero
// columns up to it, so a chunk never reads past a row
__host__ __device__ constexpr int round_kc(int n) {
  return (n + KC - 1) / KC * KC;
}

// y = dropout(LN_in(x)) of the block's rows r0 .. r0 + BR_RT - 1 into y_s
// (BR_RT x ys floats, ys = round_kc(Din)); columns [Din, ys) and rows past R
// are zero.  LN: float32 stats, fast variance clipped at 0.  The dropout
// mask is keyed by the flat index of the (R, Din) LN output.  Optionally
// keeps each row's (mean, 1/std) in st_s and writes the rows to yd_buf
// (R x Din, device memory) for the weight-gradient pass.
__device__ __forceinline__ void bridge_ln_in(
    const float* __restrict__ x, float* y_s, float* st_s,
    float* __restrict__ yd_buf, const float* __restrict__ gin,
    const float* __restrict__ bin, long long r0, long long R, int Din, int ys,
    const Dropout& drop, int warp, int lane) {
  for (int jj = 0; jj < BR_RPT; ++jj) {
    const int r = warp * BR_RPT + jj;
    const long long row = r0 + r;
    float* yr = y_s + r * ys;
    if (row >= R) {
      for (int c = lane; c < ys; c += 32) yr[c] = 0.f;
      continue;
    }
    const float* xr = x + row * Din;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < Din; c += 32) {
      const float v = xr[c];
      yr[c] = v;
      s += v;
      ss = fmaf(v, v, ss);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / Din;
    const float istd = rsqrtf(fmaxf(ss / Din - mean * mean, 0.f) + LN_EPS);
    if (st_s != nullptr && lane == 0) {
      st_s[2 * r] = mean;
      st_s[2 * r + 1] = istd;
    }
    __syncwarp();
    for (int c4 = lane * 4; c4 < ys; c4 += 128) {
      float y[4] = {0.f, 0.f, 0.f, 0.f};
      if (c4 < Din) {                  // Din % 4 == 0: the whole quad is live
        float km[4] = {1.f, 1.f, 1.f, 1.f};
        if (drop.on())
          keep4(drop.seed, static_cast<unsigned long long>(row) * Din + c4,
                drop.threshold, drop.scale, km);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          y[t] = ((yr[c4 + t] - mean) * istd * gin[c4 + t] + bin[c4 + t])
                 * km[t];
        if (yd_buf != nullptr)
          *reinterpret_cast<float4*>(yd_buf + row * Din + c4) =
              make_float4(y[0], y[1], y[2], y[3]);
      }
      *reinterpret_cast<float4*>(yr + c4) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

// acc = Y (rows r0.., smem, stride ys, K columns then zeros up to
// round_kc(K)) x B[:, col0 : col0 + D], where B (K x ncols) is B itself
// (TRANS false: K x ldb row-major in device memory, ldb % 4 == 0) or the
// transpose of the ncols x K row-major matrix at B (TRANS true, K % 4 ==
// 0: W^T read from W, with no transposed copy); 16-byte aligned.  Rows
// past K and columns past ncols read as zero.  B is staged from L2 through
// the block's KC x D shared buffer Ws one chunk at a time.  Every thread of
// the block must call it (it synchronises).
template <int RPT, bool TRANS>
__device__ __forceinline__ void bridge_gemm(float (&acc)[RPT][4],
                                            const float* Y, int ys, int K,
                                            const float* __restrict__ B,
                                            int ldb, int ncols, int col0,
                                            float* Ws, int r0, int c0) {
#pragma unroll
  for (int j = 0; j < RPT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();                   // previous chunk fully consumed
    if (TRANS) {
      // thread i reads 4 consecutive k of output column i % D
      for (int i = threadIdx.x; i < KC * D / 4; i += NTHREADS) {
        const int c = i % D, k = 4 * (i / D), col = col0 + c;
        float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + k < K && col < ncols)
          b = __ldg(reinterpret_cast<const float4*>(
              B + static_cast<size_t>(col) * K + k0 + k));
        Ws[k * D + c] = b.x;
        Ws[(k + 1) * D + c] = b.y;
        Ws[(k + 2) * D + c] = b.z;
        Ws[(k + 3) * D + c] = b.w;
      }
    } else {
      float4* dst = reinterpret_cast<float4*>(Ws);
      for (int i = threadIdx.x; i < KC * D / 4; i += NTHREADS) {
        const int r = i / (D / 4), col = col0 + 4 * (i % (D / 4));
        float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < K && col < ncols)
          b = __ldg(reinterpret_cast<const float4*>(
              B + static_cast<size_t>(k0 + r) * ldb + col));
        dst[i] = b;
      }
    }
    __syncthreads();
    gemm_chunk<RPT>(acc, Y, ys, k0, Ws, KC, r0, c0);
  }
}

}  // namespace tvqa
