// Device functions shared by the fused tri-concat bridge's tensor-core
// kernels: the forward (tri_bridge_fwd.cu, tri_bridge_fwd_tc_kernel) and
// the backward's recompute (tri_bridge_bwd.cu, tri_bridge_bwd_tc_kernel),
// so the two cannot drift; D defaults to the backward's BWD_D.  The two
// warpgroups share a 64-row tile and split its columns: warpgroup wg owns
// columns [D / 2 wg, D / 2 (wg + 1)) (from `half`) of s, v, y1 and of
// every LN group; a thread holds rows rl and rl + 8 (row half h) of its
// columns in the accumulator layout of wgmma.cuh, value pair pr at row half
// pr % 2, columns half + 8 (pr / 2) + cl and the next, cl = 2 (lane % 4).
// Row statistics cross the warpgroups through shared memory
// (tri_row_pair_sums).  s and v arrive as bf16 tiles (D / 64 panels of 64
// rows, 128-byte swizzle).  W is resident at D = 128 as 2 panels of 3D rows
// (read MN-major).  (The forwards at D = 64 and 256, tri_bridge_fwd.cu,
// have designs of their own; the backward at 256 takes the row passes
// here.)
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

// The dropout's keep bits of the three LN_in groups of the thread's values
// (row[h]: the rows' indices in the (R, 3D) LN output), drawn while few
// registers are live.
template <int D = BWD_D>
__device__ __forceinline__ void tri_keep_bits(
    const Dropout& drop, const long long (&row)[2], int lane, int half,
    uint32_t (&kw)[3][2][(D / 16 + 7) / 8]) {
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int w = 0; w < (D / 16 + 7) / 8; ++w) kw[g][0][w] = kw[g][1][w] = ~0u;
    if (drop.on())
      tc_keep_bits<D / 16, true>(
          drop, drop.key3((lane & 1) ? row[1] : row[0], g, half), lane,
          kw[g]);
  }
}

// LN_in statistics of the thread's two rows over [s; v; s * v] (fast
// variance, clipped at 0): mean and 1 / std.  One exchange round.
template <int D = BWD_D>
__device__ __forceinline__ void tri_ln_in_stats(const uint8_t* s_s,
                                                const uint8_t* v_s, float* ex,
                                                float (&mean)[2],
                                                float (&istd)[2], int wg,
                                                int rl, int lane,
                                                float inv3) {
  const int half = D / 2 * wg, cl = 2 * (lane & 3);
  mean[0] = mean[1] = istd[0] = istd[1] = 0.f;
#pragma unroll
  for (int pr = 0; pr < D / 8; ++pr) {
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
    mean[h] *= inv3;
    istd[h] = rsqrtf(fmaxf(istd[h] * inv3 - mean[h] * mean[h],
                           0.f) + LN_EPS);
  }
}

// yd = dropout(LN_in(x)) of the thread's values of the three groups into
// the bf16 tile yd_s (3 D / 64 panels of 64 rows: column c of group g is in
// panel g D / 64 + c / 64); with ROWS also out as rows of the (R, 3D)
// yd_rows.
template <bool ROWS, int D = BWD_D>
__device__ __forceinline__ void tri_yd_tile(
    const uint8_t* s_s, const uint8_t* v_s, uint8_t* yd_s,
    const uint32_t (&kw)[3][2][(D / 16 + 7) / 8], const Dropout& drop,
    const float (&mean)[2], const float (&istd)[2], const float* gin_s,
    const float* bin_s, __nv_bfloat16* __restrict__ yd_rows,
    const bool (&live)[2], const long long (&row)[2], int wg, int rl,
    int lane) {
  constexpr int KW = (D / 16 + 7) / 8;          // keep words of a group
  const int half = D / 2 * wg, cl = 2 * (lane & 3);
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int pr = 0; pr < D / 8; ++pr) {
      const int h = pr & 1, q = pr >> 1, c = half + 8 * q + cl;
      const float2 a = tri_pair(s_s, rl, h, c), b = tri_pair(v_s, rl, h, c);
      const float x0 = g == 0 ? a.x : (g == 1 ? b.x : a.x * b.x);
      const float x1 = g == 0 ? a.y : (g == 1 ? b.y : a.y * b.y);
      // one keep word at D <= 128, indexed by a constant: an index that is
      // not one before the unrolling made the compiler version this loop on
      // drop.on() (736 more instructions at D = 128)
      const uint32_t bits = KW == 1 ? kw[g][h][0] >> (4 * q)
                                    : kw[g][h][q >> 3] >> (4 * (q & 7));
      const float k0 = !drop.on() ? 1.f : (bits & 1u ? drop.scale : 0.f);
      const float k1 = !drop.on() ? 1.f : (bits & 2u ? drop.scale : 0.f);
      const int k = g * D + c;
      const uint32_t y = tc::pack_bf16(
          ((x0 - mean[h]) * istd[h] * gin_s[k] + bin_s[k]) * k0,
          ((x1 - mean[h]) * istd[h] * gin_s[k + 1] + bin_s[k + 1]) * k1);
      // a warpgroup's columns start at panel wg D / 128, and a chunk of 8
      // never crosses a panel
      *reinterpret_cast<uint32_t*>(yd_s + (g * (D / 64) + wg * (D / 128)
                                           + (q >> 3)) * TILE_PANEL
                                   + tc::swz(rl + 8 * h, c & 63)) = y;
      if (ROWS && live[h])
        *reinterpret_cast<uint32_t*>(yd_rows + row[h] * (3 * D) + k) = y;
    }
}

// acc = yd W on the warpgroup's D / 2 columns (yd K-major from its tile;
// W resident, read MN-major).
template <int D = BWD_D>
__device__ __forceinline__ void tri_y1_mma(float (&acc)[D / 4],
                                           const uint8_t* yd_s,
                                           const uint8_t* w_s, int wg) {
  static_assert(D == 128, "W is resident at D = 128");
  tc::fence();
#pragma unroll
  for (int ks = 0; ks < 3 * D / 16; ++ks) {
    const uint64_t a = tc::make_desc(tc::smem_u32(yd_s)
                                     + (ks / 4) * TILE_PANEL + (ks % 4) * 32,
                                     16);
    tc::mma_ss<64, 0, 1>(
        acc, a,
        tc::make_desc(tc::smem_u32(w_s) + wg * W_PANEL
                          + ks * 2 * tc::ATOM_BYTES, W_PANEL),
        ks > 0);
  }
  tc::commit();
  tc::wait_all();
}

// acc (y1 without its bias) += bias; the LN_out statistics of ReLU(y1)
// over both column halves (fast variance, clipped at 0): mean m2 and
// 1 / std i2.  One exchange round.
template <int D = BWD_D>
__device__ __forceinline__ void tri_ln_out_stats(float (&acc)[D / 4],
                                                 const float* bias_s,
                                                 float* ex, float (&m2)[2],
                                                 float (&i2)[2], int wg,
                                                 int rl, int lane,
                                                 float inv1) {
  const int half = D / 2 * wg;
  m2[0] = m2[1] = i2[0] = i2[1] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const int h = (i >> 1) & 1, c = half + acc_col(i, lane);
    acc[i] += bias_s[c];                                   // y1
    const float y2 = fmaxf(acc[i], 0.f);
    m2[h] += y2;
    i2[h] = fmaf(y2, y2, i2[h]);
  }
  tri_row_pair_sums(ex, m2, i2, wg, rl, lane);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m2[h] *= inv1;
    i2[h] = rsqrtf(fmaxf(i2[h] * inv1 - m2[h] * m2[h], 0.f) + LN_EPS);
  }
}

}  // namespace tvqa
