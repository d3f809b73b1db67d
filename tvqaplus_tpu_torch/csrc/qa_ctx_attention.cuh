// Device functions shared by the fused QA-context attention forward
// (qa_ctx_attention_fwd.cu) and the backward's recompute
// (qa_ctx_attention_bwd.cu), so the two cannot drift.
//
// One warp owns one answer-word row m of a frame: lanes j = lane and
// lane + 32 hold the row's scores against regions j (Lr <= 64).  The
// frame's qn and qe tiles sit in shared memory with row stride QS = D + 1,
// so lanes that index regions hit distinct banks.
#pragma once

#include "common.cuh"

namespace tvqa {

constexpr int QS = D + 1;              // padded qn / qe row stride

struct AttnRow {
  float mk[2];                         // masked scores (the raw output)
  float sm[2];                         // c_mask * q_mask
  float p0[2];                         // softmax before the mask
  float gate[2];                       // 1 where scale * masked > floor
};

// Scores of the row held in smem at `cr` (D floats) against the frame's
// regions: masked = S - 1e10 (1 - mask), then softmax of
// max(scale * masked, -3e4).  A fully masked row gets a uniform p0, which
// the mask then zeroes, so att = 0, never NaN.
__device__ __forceinline__ AttnRow attn_scores(const float* cr,
                                               const float* qn_s,
                                               const float* qm_s, float cm,
                                               int Lr, float scale,
                                               int lane) {
  const int j0 = lane, j1 = lane + 32;
  const bool v0 = j0 < Lr, v1 = j1 < Lr;
  const float* q0 = qn_s + min(j0, Lr - 1) * QS;
  const float* q1 = qn_s + min(j1, Lr - 1) * QS;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float c = cr[d];
    s0 = fmaf(c, q0[d], s0);
    s1 = fmaf(c, q1[d], s1);
  }
  AttnRow o;
  o.sm[0] = v0 ? cm * qm_s[j0] : 0.f;
  o.sm[1] = v1 ? cm * qm_s[j1] : 0.f;
  o.mk[0] = s0 - 1e10f * (1.f - o.sm[0]);
  o.mk[1] = s1 - 1e10f * (1.f - o.sm[1]);
  const float zc0 = o.mk[0] * scale, zc1 = o.mk[1] * scale;
  o.gate[0] = zc0 > SAFE_FLOOR ? 1.f : 0.f;
  o.gate[1] = zc1 > SAFE_FLOOR ? 1.f : 0.f;
  const float z0 = v0 ? fmaxf(zc0, SAFE_FLOOR) : -CUDART_INF_F;
  const float z1 = v1 ? fmaxf(zc1, SAFE_FLOOR) : -CUDART_INF_F;
  const float mx = warp_max(fmaxf(z0, z1));
  const float e0 = v0 ? expf(z0 - mx) : 0.f;
  const float e1 = v1 ? expf(z1 - mx) : 0.f;
  const float inv = 1.f / warp_sum(e0 + e1);
  o.p0[0] = e0 * inv;
  o.p0[1] = e1 * inv;
  return o;
}

// att[lane + 32 q] = sum_j p[j] qe[j, lane + 32 q], p in smem (Lr floats).
__device__ __forceinline__ void attn_apply(const float* pr,
                                           const float* qe_s, int Lr,
                                           int lane, float (&at)[4]) {
  at[0] = at[1] = at[2] = at[3] = 0.f;
  for (int j = 0; j < Lr; ++j) {
    const float pj = pr[j];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      at[q] = fmaf(pj, qe_s[j * QS + lane + 32 * q], at[q]);
  }
}

// Mean and 1/std over the virtual [ce; att; ce * att] concat of one row
// (3D values, 12 a lane): fast variance, NOT clipped at 0 (the Pallas
// kernel's LN, pallas_attention.py:143-151).
__device__ __forceinline__ void ln3_stats(const float (&x)[3][4],
                                          float& mean, float& istd) {
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s += x[g][q];
      ss = fmaf(x[g][q], x[g][q], ss);
    }
  s = warp_sum(s);
  ss = warp_sum(ss);
  mean = s * (1.f / (3 * D));
  istd = rsqrtf(ss * (1.f / (3 * D)) - mean * mean + LN_EPS);
}

// Flat row of `mixed` (B, A, Li, Lqa): the dropout acts on the
// (B*A*Li*Lqa, 3D) LN output in this row order.
__device__ __forceinline__ unsigned long long mixed_row(int b, int m, int i,
                                                        int A, int Lqa,
                                                        int Li) {
  const int a = m / Lqa, w = m % Lqa;
  return ((static_cast<unsigned long long>(b) * A + a) * Li + i) * Lqa + w;
}

}  // namespace tvqa
