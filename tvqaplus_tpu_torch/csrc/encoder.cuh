// Device functions shared by the fused encoder block's float32 CUDA-core
// forward (encoder_fwd.cu) and the backward's recompute (encoder_bwd.cu),
// so the two cannot drift (the tensor-core pair shares encoder_tc.cuh).
// A sequence's rows (L x D float32) sit in shared memory; row-wise work
// gives each warp rows r = warp, warp + 8, ... with lane owning channels
// lane + 32 q, q < D / 32.  D defaults to the backward's BWD_D.
#pragma once

#include "common.cuh"
#include "philox.cuh"

namespace tvqa {

// offsets into the packed float32 parameter buffer (see ops/encoder.py)
template <int D = BWD_D>
struct EncParams {
  const float *ln_s[2], *ln_b[2], *dw[2], *dwb[2], *pw[2], *pwb[2];
  const float *lnf_s, *lnf_b;
  __device__ EncParams(const float* p, int k) {
    for (int i = 0; i < 2; ++i) {
      ln_s[i] = p; p += D;
      ln_b[i] = p; p += D;
      dw[i] = p;   p += k * D;
      dwb[i] = p;  p += D;
      pw[i] = p;   p += D * D;
      pwb[i] = p;  p += D;
    }
    lnf_s = p; p += D;
    lnf_b = p;
  }
};

// LayerNorm of rows [0, L) of src into dst (warp per row, float32 stats,
// fast variance clipped at 0; the sums divided by the true width, times
// inv = 1 / dv, philox.cuh).
template <int D = BWD_D>
__device__ __forceinline__ void ln_rows(const float* src, float* dst, int L,
                                        const float* __restrict__ g,
                                        const float* __restrict__ bta,
                                        int warp, int lane, float inv) {
  constexpr int VPL = D / 32;
  for (int r = warp; r < L; r += NWARPS) {
    float x[VPL], s = 0.f, ss = 0.f;
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      x[q] = src[r * D + lane + 32 * q];
      s += x[q];
      ss = fmaf(x[q], x[q], ss);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s * inv;
    const float istd =
        rsqrtf(fmaxf(ss * inv - mean * mean, 0.f) + LN_EPS);
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int d = lane + 32 * q;
      dst[r * D + d] = (x[q] - mean) * istd * g[d] + bta[d];
    }
  }
}

// LayerNorm backward of rows [0, L): src is the LN input, gup the upstream
// gradient; out = residual + d LN / d src (residual may be NULL and may
// alias out; gup may alias out).  Accumulates the scale and bias gradients
// of the thread's channels lane + 32 q into gs / gb.
template <int D = BWD_D>
__device__ __forceinline__ void ln_bwd_rows(const float* src,
                                            const float* gup,
                                            const float* residual,
                                            float* out, int L,
                                            const float* __restrict__ scale,
                                            float (&gs)[D / 32],
                                            float (&gb)[D / 32], int warp,
                                            int lane, float inv) {
  constexpr int VPL = D / 32;
  for (int r = warp; r < L; r += NWARPS) {
    float x[VPL], s = 0.f, ss = 0.f;
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      x[q] = src[r * D + lane + 32 * q];
      s += x[q];
      ss = fmaf(x[q], x[q], ss);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s * inv;
    const float istd =
        rsqrtf(fmaxf(ss * inv - mean * mean, 0.f) + LN_EPS);
    float xh[VPL], gxh[VPL], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int d = lane + 32 * q;
      const float g = gup[r * D + d];
      xh[q] = (x[q] - mean) * istd;
      gs[q] = fmaf(g, xh[q], gs[q]);
      gb[q] += g;
      gxh[q] = g * scale[d];
      s1 += gxh[q];
      s2 = fmaf(gxh[q], xh[q], s2);
    }
    const float m1 = warp_sum(s1) * inv;
    const float m2 = warp_sum(s2) * inv;
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int d = lane + 32 * q;
      const float gx = istd * (gxh[q] - m1 - xh[q] * m2);
      out[r * D + d] = residual != nullptr ? residual[r * D + d] + gx : gx;
    }
  }
}

// Same-padded depthwise conv along L of rows [0, L): the taps read only
// rows inside the sequence (zero padding at both ends), each times its
// validity factor v[row] (the sequence's zero-mask row in shared memory,
// all ones without a zero mask): a tap that reads past a merged stream's
// true length sees the zero that per-stream padding would give it.
template <int D = BWD_D>
__device__ __forceinline__ void dwconv_rows(const float* src, float* dst,
                                            int L, int k,
                                            const float* dw,
                                            const float* __restrict__ dwb,
                                            const float* v) {
  const int pad = k / 2;
  for (int idx = threadIdx.x; idx < L * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    float acc = dwb[d];
    for (int j = 0; j < k; ++j) {
      const int rr = r + j - pad;
      if (rr >= 0 && rr < L)
        acc = fmaf(dw[j * D + d], src[rr * D + d] * v[rr], acc);
    }
    dst[idx] = acc;
  }
}

// The zero-mask row of sequence n into v (L floats of shared memory): row
// n % G of the (G, L) mask, which is constant over the batch; all ones when
// there is no zero mask.
__device__ __forceinline__ void load_zmask_row(float* v,
                                               const float* __restrict__ zmask,
                                               int n, int G, int L) {
  for (int l = threadIdx.x; l < L; l += NTHREADS)
    v[l] = zmask != nullptr ? zmask[static_cast<size_t>(n % G) * L + l] : 1.f;
}

// Conv 0's dropout on rows [0, L) of buf (in place): element (l, d) of
// sequence n keys drop.row_key(n L + l) + d (philox.cuh; (n L + l) D + d,
// the flat index of the (B*G*L, D) LN output, at dv = D without a map).
template <int D = BWD_D>
__device__ __forceinline__ void dropout_rows(float* buf, int L,
                                             unsigned long long n,
                                             const Dropout& drop) {
  for (int i4 = threadIdx.x; i4 < L * D / 4; i4 += NTHREADS) {
    const int l = 4 * i4 / D;
    float km[4];
    keep4(drop.seed, drop.row_key(static_cast<long long>(n) * L + l)
                         + (4 * i4 - l * D),
          drop.threshold, drop.scale, km);
#pragma unroll
    for (int t = 0; t < 4; ++t) buf[4 * i4 + t] *= km[t];
  }
}

}  // namespace tvqa
