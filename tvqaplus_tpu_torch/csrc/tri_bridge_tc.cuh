// Device functions shared by the fused tri-concat bridge's tensor-core
// kernels: the forward (tri_bridge_fwd.cu, tri_bridge_fwd_tc_kernel) and
// the backward's recompute (tri_bridge_bwd.cu, tri_bridge_bwd_tc_kernel),
// so the two cannot drift.  The two warpgroups share a 64-row tile and
// split its columns: warpgroup wg owns columns [64 wg, 64 wg + 64) (half)
// of s, v, y1 and of every LN group; a thread holds rows rl and rl + 8 (row
// half h) of its columns in the accumulator layout of wgmma.cuh, value
// pair pr at row half pr % 2, columns half + 8 (pr / 2) + cl and the next,
// cl = 2 (lane % 4).  Row statistics cross the warpgroups through shared
// memory (tri_row_pair_sums).  s and v arrive as bf16 tiles (two panels of
// 64 rows, 128-byte swizzle), W is resident as 2 panels of 3D rows.
#pragma once

#include "philox.cuh"
#include "wgmma.cuh"

namespace tvqa {

// The pair of (row half h, column c) of a staged s or v tile.
__device__ __forceinline__ float2 tri_pair(const uint8_t* tile, int rl,
                                           int h, int c) {
  return tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(
      tile + (c >> 6) * TILE_PANEL + tc::swz(rl + 8 * h, c & 63)));
}

// Per row half h: the sums of both warpgroups of exchange round `ex` (each
// warpgroup first stores its quad sums of the row's own columns).
__device__ __forceinline__ void tri_row_pair_sums(float* ex, float (&a)[2],
                                                  float (&b)[2], int wg,
                                                  int rl, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[h] = quad_sum(a[h]);
    b[h] = quad_sum(b[h]);
    if ((lane & 3) == 0) {
      ex[(wg * TM + rl + 8 * h) * 2] = a[h];
      ex[(wg * TM + rl + 8 * h) * 2 + 1] = b[h];
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rl + 8 * h;
    a[h] = ex[r * 2] + ex[(TM + r) * 2];
    b[h] = ex[r * 2 + 1] + ex[(TM + r) * 2 + 1];
  }
}

// The dropout's keep bits of the three LN_in groups of the thread's values
// (row[h]: the rows' indices in the (R, 3D) LN output), drawn while few
// registers are live.
__device__ __forceinline__ void tri_keep_bits(const Dropout& drop,
                                              const long long (&row)[2],
                                              int lane, int half,
                                              uint32_t (&kw)[3][2][1]) {
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    kw[g][0][0] = kw[g][1][0] = ~0u;
    if (drop.on())
      tc_keep_bits<8, true>(drop, ((lane & 1) ? row[1] : row[0]) * (3 * D)
                                + g * D + half, lane, kw[g]);
  }
}

// LN_in statistics of the thread's two rows over [s; v; s * v] (fast
// variance, clipped at 0): mean and 1 / std.  One exchange round.
__device__ __forceinline__ void tri_ln_in_stats(const uint8_t* s_s,
                                                const uint8_t* v_s, float* ex,
                                                float (&mean)[2],
                                                float (&istd)[2], int wg,
                                                int rl, int lane) {
  const int half = 64 * wg, cl = 2 * (lane & 3);
  mean[0] = mean[1] = istd[0] = istd[1] = 0.f;
#pragma unroll
  for (int pr = 0; pr < 16; ++pr) {
    const int h = pr & 1, c = half + 8 * (pr >> 1) + cl;
    const float2 a = tri_pair(s_s, rl, h, c), b = tri_pair(v_s, rl, h, c);
    const float x0 = a.x * b.x, x1 = a.y * b.y;
    mean[h] += (a.x + a.y) + (b.x + b.y) + (x0 + x1);
    istd[h] += fmaf(a.x, a.x, a.y * a.y) + fmaf(b.x, b.x, b.y * b.y)
               + fmaf(x0, x0, x1 * x1);
  }
  tri_row_pair_sums(ex, mean, istd, wg, rl, lane);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean[h] *= 1.f / (3 * D);
    istd[h] = rsqrtf(fmaxf(istd[h] * (1.f / (3 * D)) - mean[h] * mean[h],
                           0.f) + LN_EPS);
  }
}

// yd = dropout(LN_in(x)) of the thread's values of the three groups into
// the bf16 tile yd_s (6 panels of 64 rows: group g's column half wg is
// panel 2 g + wg); with ROWS also out as rows of the (R, 3D) yd_rows.
template <bool ROWS>
__device__ __forceinline__ void tri_yd_tile(
    const uint8_t* s_s, const uint8_t* v_s, uint8_t* yd_s,
    const uint32_t (&kw)[3][2][1], const Dropout& drop,
    const float (&mean)[2], const float (&istd)[2], const float* gin_s,
    const float* bin_s, __nv_bfloat16* __restrict__ yd_rows,
    const bool (&live)[2], const long long (&row)[2], int wg, int rl,
    int lane) {
  const int half = 64 * wg, cl = 2 * (lane & 3);
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int pr = 0; pr < 16; ++pr) {
      const int h = pr & 1, q = pr >> 1, c = half + 8 * q + cl;
      const float2 a = tri_pair(s_s, rl, h, c), b = tri_pair(v_s, rl, h, c);
      const float x0 = g == 0 ? a.x : (g == 1 ? b.x : a.x * b.x);
      const float x1 = g == 0 ? a.y : (g == 1 ? b.y : a.y * b.y);
      const uint32_t bits = kw[g][h][0] >> (4 * q);
      const float k0 = !drop.on() ? 1.f : (bits & 1u ? drop.scale : 0.f);
      const float k1 = !drop.on() ? 1.f : (bits & 2u ? drop.scale : 0.f);
      const int k = g * D + c;
      const uint32_t y = tc::pack_bf16(
          ((x0 - mean[h]) * istd[h] * gin_s[k] + bin_s[k]) * k0,
          ((x1 - mean[h]) * istd[h] * gin_s[k + 1] + bin_s[k + 1]) * k1);
      *reinterpret_cast<uint32_t*>(yd_s + (2 * g + wg) * TILE_PANEL
                                   + tc::swz(rl + 8 * h, c & 63)) = y;
      if (ROWS && live[h])
        *reinterpret_cast<uint32_t*>(yd_rows + row[h] * (3 * D) + k) = y;
    }
}

// acc = yd W on the warpgroup's 64 columns (yd K-major from its tile, W
// MN-major).
__device__ __forceinline__ void tri_y1_mma(float (&acc)[32],
                                           const uint8_t* yd_s,
                                           const uint8_t* w_s, int wg) {
  tc::fence();
#pragma unroll
  for (int ks = 0; ks < 3 * D / 16; ++ks)
    tc::mma_ss<64, 0, 1>(
        acc,
        tc::make_desc(tc::smem_u32(yd_s) + (ks / 4) * TILE_PANEL
                          + (ks % 4) * 32, 16),
        tc::make_desc(tc::smem_u32(w_s) + wg * W_PANEL
                          + ks * 2 * tc::ATOM_BYTES, W_PANEL),
        ks > 0);
  tc::commit();
  tc::wait_all();
}

// acc (y1 without its bias) += bias; the LN_out statistics of ReLU(y1)
// over both column halves (fast variance, clipped at 0): mean m2 and
// 1 / std i2.  One exchange round.
__device__ __forceinline__ void tri_ln_out_stats(float (&acc)[32],
                                                 const float* bias_s,
                                                 float* ex, float (&m2)[2],
                                                 float (&i2)[2], int wg,
                                                 int rl, int lane) {
  const int half = 64 * wg;
  m2[0] = m2[1] = i2[0] = i2[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1, c = half + acc_col(i, lane);
    acc[i] += bias_s[c];                                   // y1
    const float y2 = fmaxf(acc[i], 0.f);
    m2[h] += y2;
    i2[h] = fmaf(y2, y2, i2[h]);
  }
  tri_row_pair_sums(ex, m2, i2, wg, rl, lane);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m2[h] *= 1.f / D;
    i2[h] = rsqrtf(fmaxf(i2[h] * (1.f / D) - m2[h] * m2[h], 0.f) + LN_EPS);
  }
}

}  // namespace tvqa
