// Device code of the fused encoder block's tensor-core kernels, at hidden
// width D (the backward's BWD_D unless given).  The
// parameter offsets and the R1 layout serve the forward (encoder_fwd.cu,
// encoder_fwd_tc_kernel) and the backwards (encoder_bwd.cu,
// encoder_bwd_tc_kernel; encoder_bwd_tc_wide.cu at D = 64 and 256, with the
// column folds of the parameter sums, fold8); the row passes below are the
// forward's.  The
// backward's recompute computes the same with lambdas of its own: moved
// onto these functions it spilled more and ran ~1% slower (PERF.md PR 6),
// and the card tests hold both kernels against one plain version.
// A warpgroup owns 64 rows of a tile and all D columns; a thread
// holds rows row[0] and row[1] = row[0] + 8 in the accumulator layout of
// wgmma.cuh, value pair pr (values 2 pr, 2 pr + 1) at row half h = pr % 2,
// columns c = 8 (pr / 2) + cl and c + 1 with cl = 2 (lane % 4).  The LN
// output t of a tile sits in shared memory as the float32 tile R1 (the
// depthwise taps cross rows, warps and warpgroups); row statistics are
// sums over the thread's values and its quad.
#pragma once

#include "encoder.cuh"
#include "wgmma.cuh"

namespace tvqa {

constexpr int ENC_MAX_K = 9;

// The packed parameters (ops/encoder.py PARAM_KEYS order) at offsets known
// at compile time: EncParams' fourteen pointers held 28 registers.
template <int K, int D = BWD_D>
struct TcParams {
  static constexpr int LAYER = (4 + K) * D + D * D;
  const float* p;
  __device__ const float* ln_s(int i) const { return p + i * LAYER; }
  __device__ const float* ln_b(int i) const { return p + i * LAYER + D; }
  __device__ const float* dw(int i) const { return p + i * LAYER + 2 * D; }
  __device__ const float* dwb(int i) const {
    return p + i * LAYER + (2 + K) * D;
  }
  __device__ const float* pw(int i) const {
    return p + i * LAYER + (3 + K) * D;
  }
  __device__ const float* pwb(int i) const {
    return p + i * LAYER + (3 + K) * D + D * D;
  }
  __device__ const float* lnf_s() const { return p + 2 * LAYER; }
  __device__ const float* lnf_b() const { return p + 2 * LAYER + D; }
};

// Element (r, c) of the float32 tile R1: the column's 8-groups are swizzled
// by the row, so that the accumulator layout's float2 accesses (8 rows x 4
// lanes) and the column passes (32 columns of a row) spread over the banks.
template <int D = BWD_D>
__device__ __forceinline__ int r1_at(int r, int c) {
  return r * D + (c ^ ((r & 3) << 3));
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Conv 0's dropout multiplier of value (h, q, e) from the keep bits of
// tc_keep_bits (wgmma.cuh).
template <int W>
__device__ __forceinline__ float enc_keep(const uint32_t (&kw)[2][W],
                                          const Dropout& drop, int h, int q,
                                          int e) {
  return !drop.on() ? 1.f
      : ((kw[h][q >> 3] >> (4 * (q & 7) + e)) & 1u ? drop.scale : 0.f);
}

// The thread's NV values in its two rows (NV / 2 columns each, from column
// cl of its quad: pair pr at row half pr % 2, columns 8 (pr / 2) + cl and
// the next).  NV = D at D <= 128 (a warpgroup owns all D columns); at
// D = 256 a warpgroup owns 128 and the caller passes cl = 128 wg + 2
// (lane % 4).

// h0 = x + pe of the thread's values; xpair(h, c) gives x's pair at (row
// half h, columns c, c + 1) of a valid row as float2.  Rows past the
// tile's sequences are 0.
template <int D, int NV, typename X>
__device__ __forceinline__ void enc_load_h0(float (&hv)[NV], X xpair,
                                            const float* __restrict__ pe,
                                            const bool (&valid)[2],
                                            const int (&lrow)[2], int cl) {
#pragma unroll
  for (int pr = 0; pr < NV / 2; ++pr) {
    const int h = pr & 1, c = 8 * (pr >> 1) + cl;
    float2 a = make_float2(0.f, 0.f);
    if (valid[h]) {
      a = xpair(h, c);
      const float2 p = ldg2(pe + lrow[h] * D + c);
      a.x += p.x;
      a.y += p.y;
    }
    hv[2 * pr] = a.x;
    hv[2 * pr + 1] = a.y;
  }
}

// Row statistics of the thread's two rows when its values cover them (fast
// variance, clipped at 0).
template <int D>
__device__ __forceinline__ void enc_stats(const float (&hv)[D / 2],
                                          float (&mean)[2],
                                          float (&istd)[2], float inv) {
  mean[0] = mean[1] = istd[0] = istd[1] = 0.f;
#pragma unroll
  for (int j = 0; j < D / 2; ++j) {
    mean[(j >> 1) & 1] += hv[j];
    istd[(j >> 1) & 1] = fmaf(hv[j], hv[j], istd[(j >> 1) & 1]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean[h] = quad_sum(mean[h]) * inv;
    istd[h] = rsqrtf(fmaxf(quad_sum(istd[h]) * inv - mean[h] * mean[h],
                           0.f) + LN_EPS);
  }
}

// LN(hv) with the rows' mean / istd, scale sc and bias bi, times conv 0's
// dropout when drop0, as value pairs: emit(pr, y) for each pair pr.
template <int NV, int W, typename E>
__device__ __forceinline__ void enc_ln_apply(
    const float (&hv)[NV], const float (&mean)[2], const float (&istd)[2],
    const float* __restrict__ sc, const float* __restrict__ bi, bool drop0,
    const uint32_t (&kw)[2][W], const Dropout& drop, int cl, E emit) {
#pragma unroll
  for (int pr = 0; pr < NV / 2; ++pr) {
    const int h = pr & 1, q = pr >> 1, c = 8 * q + cl;
    const float2 s2 = ldg2(sc + c), b2 = ldg2(bi + c);
    float y0 = (hv[2 * pr] - mean[h]) * istd[h] * s2.x + b2.x;
    float y1 = (hv[2 * pr + 1] - mean[h]) * istd[h] * s2.y + b2.y;
    if (drop0) {
      y0 *= enc_keep(kw, drop, h, q, 0);
      y1 *= enc_keep(kw, drop, h, q, 1);
    }
    emit(pr, make_float2(y0, y1));
  }
}

// LN(hv) (its statistics over the thread's values, which cover the rows)
// as enc_ln_apply.
template <int D, int W, typename E>
__device__ __forceinline__ void enc_ln(const float (&hv)[D / 2],
                                       const float* __restrict__ sc,
                                       const float* __restrict__ bi,
                                       bool drop0, const uint32_t (&kw)[2][W],
                                       const Dropout& drop, int cl, E emit) {
  float mean[2], istd[2];
  enc_stats<D>(hv, mean, istd, drop.inv1);
  enc_ln_apply(hv, mean, istd, sc, bi, drop0, kw, drop, cl, emit);
}

// LN(hv) (times conv 0's dropout when drop0) into the thread's values of
// R1.
template <int D, int W>
__device__ __forceinline__ void enc_ln_to_r1(
    const float (&hv)[D / 2], const float* __restrict__ sc,
    const float* __restrict__ bi, bool drop0, const uint32_t (&kw)[2][W],
    const Dropout& drop, float* r1, const int (&row)[2], int cl) {
  enc_ln<D>(hv, sc, bi, drop0, kw, drop, cl, [&](int pr, float2 y) {
    *reinterpret_cast<float2*>(r1 + r1_at<D>(row[pr & 1],
                                             8 * (pr >> 1) + cl)) = y;
  });
}

// The depthwise conv's output pair at (row half h, columns c, c + 1):
// dwb + sum over the K taps inside the sequence of dw times t v, with t
// from R1 and v the rows' zero-mask factors (v_s, by tile row).  A row past
// the tile's sequences gets dwb.
template <int K, int D = BWD_D>
__device__ __forceinline__ float2 enc_conv_pair(
    const float* r1, const float* v_s, const float* __restrict__ dw,
    const float* __restrict__ dwb, const int (&row)[2],
    const int (&lrow)[2], const bool (&valid)[2], int L, int h, int c) {
  constexpr int pad = K / 2;
  float2 a = ldg2(dwb + c);
  if (valid[h]) {
    const int base = row[h] - lrow[h];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int rr = lrow[h] + j - pad;
      if (rr < 0 || rr >= L) continue;
      const float vv = v_s[base + rr];
      const float2 tt = *reinterpret_cast<const float2*>(
          r1 + r1_at<D>(base + rr, c));
      const float2 w = ldg2(dw + j * D + c);
      a.x = fmaf(w.x, tt.x * vv, a.x);
      a.y = fmaf(w.y, tt.y * vv, a.y);
    }
  }
  return a;
}

// The depthwise conv of one column `col` of a tile, the sums of
// enc_conv_pair in the same order (a tap outside the sequence adds w 0,
// which leaves the sum as it is), rounded to bf16 into the c tile at cs
// (the product's A: D / 64 panels of TM rows): the taps stay in registers
// and a window of the last K values of t v slides down each of the tile's
// sequences (rows [s L, s L + L) below `rows`), so every value is read
// once; rows past them get dwb.  A thread a column.
template <int K, int D>
__device__ __forceinline__ void enc_conv_column(
    uint8_t* cs, const float* r1, const float* v_s,
    const float* __restrict__ dw, const float* __restrict__ dwb, int col,
    int rows, int L) {
  constexpr int pad = K / 2;
  float w[K], win[K];
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = __ldg(dw + j * D + col);
  const float b = __ldg(dwb + col);
  uint8_t* cp = cs + (col >> 6) * TILE_PANEL;
  auto put = [&](int r, float a) {
    *reinterpret_cast<__nv_bfloat16*>(cp + tc::swz(r, col & 63)) =
        __float2bfloat16(a);
  };
  for (int s0 = 0; s0 < rows; s0 += L) {
#pragma unroll
    for (int j = 0; j < K; ++j) win[j] = 0.f;
    for (int i = 0; i < L + pad; ++i) {
#pragma unroll
      for (int j = 0; j + 1 < K; ++j) win[j] = win[j + 1];
      win[K - 1] = i < L ? r1[r1_at<D>(s0 + i, col)] * v_s[s0 + i] : 0.f;
      if (i >= pad) {
        float a = b;
#pragma unroll
        for (int j = 0; j < K; ++j) a = fmaf(w[j], win[j], a);
        put(s0 + i - pad, a);
      }
    }
  }
  for (int r = rows; r < TM; ++r) put(r, b);
}

// The sum of t[0 .. 8) over the eight lanes that hold the same columns'
// other rows; entry j of lane l is column pair 8 (4 qb + j / 2) + 2 (l % 4)
// + j % 2 of a block qb, and the lane keeps j = b2 + 2 b3 + 4 b4 (bN = bit
// N of the lane): column fold8_col(qb, lane).
__device__ __forceinline__ float fold8(float (&t)[8], int lane) {
  fold<8>(t, 16, lane);
  fold<4>(t, 8, lane);
  fold<2>(t, 4, lane);
  return t[0];
}

__device__ __forceinline__ int fold8_col(int qb, int lane) {
  return 8 * (4 * qb + ((lane >> 3) & 1) + 2 * ((lane >> 4) & 1))
         + 2 * (lane & 3) + ((lane >> 2) & 1);
}

}  // namespace tvqa
