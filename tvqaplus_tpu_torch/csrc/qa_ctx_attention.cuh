// Device functions shared by the fused QA-context attention forward
// (qa_ctx_attention_fwd.cu) and the backward's recompute
// (qa_ctx_attention_bwd.cu), so the two cannot drift: first those of the
// float32 instantiation (CUDA cores), then those of the bfloat16 one (tensor
// cores, from "tensor-core path" on).  Neither is bound by the card's memory
// or tensor-core rate; see the two sources.
//
// float32: one warp owns one answer-word row m of a frame: lanes j = lane and
// lane + 32 hold the row's scores against regions j (Lr <= 64).  The
// frame's qn and qe tiles sit in shared memory with row stride D + 1 (QS at
// the backward's width), so lanes that index regions hit distinct banks.
// D defaults to the backward's BWD_D.
#pragma once

#include "common.cuh"
#include "philox.cuh"
#include "wgmma.cuh"

namespace tvqa {

constexpr int QS = BWD_D + 1;          // padded qn / qe row stride

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
template <int D = BWD_D>
__device__ __forceinline__ AttnRow attn_scores(const float* cr,
                                               const float* qn_s,
                                               const float* qm_s, float cm,
                                               int Lr, float scale,
                                               int lane) {
  const int j0 = lane, j1 = lane + 32;
  const bool v0 = j0 < Lr, v1 = j1 < Lr;
  const float* q0 = qn_s + min(j0, Lr - 1) * (D + 1);
  const float* q1 = qn_s + min(j1, Lr - 1) * (D + 1);
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
template <int D = BWD_D>
__device__ __forceinline__ void attn_apply(const float* pr,
                                           const float* qe_s, int Lr,
                                           int lane, float (&at)[D / 32]) {
#pragma unroll
  for (int q = 0; q < D / 32; ++q) at[q] = 0.f;
  for (int j = 0; j < Lr; ++j) {
    const float pj = pr[j];
#pragma unroll
    for (int q = 0; q < D / 32; ++q)
      at[q] = fmaf(pj, qe_s[j * (D + 1) + lane + 32 * q], at[q]);
  }
}

// Mean and 1/std over the virtual [ce; att; ce * att] concat of one row
// (3D values, 3 D / 32 a lane): fast variance, NOT clipped at 0 (the
// Pallas kernel's LN, pallas_attention.py:143-151).
template <int D = BWD_D>
__device__ __forceinline__ void ln3_stats(const float (&x)[3][D / 32],
                                          float& mean, float& istd,
                                          float inv3) {
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int q = 0; q < D / 32; ++q) {
      s += x[g][q];
      ss = fmaf(x[g][q], x[g][q], ss);
    }
  s = warp_sum(s);
  ss = warp_sum(ss);
  mean = s * inv3;
  istd = rsqrtf(ss * inv3 - mean * mean + LN_EPS);
}

// Flat row of `mixed` (B, A, Li, Lqa): the dropout acts on the
// (B*A*Li*Lqa, 3D) LN output in this row order.
__device__ __forceinline__ unsigned long long mixed_row(int b, int m, int i,
                                                        int A, int Lqa,
                                                        int Li) {
  const int a = m / Lqa, w = m % Lqa;
  return ((static_cast<unsigned long long>(b) * A + a) * Li + i) * Lqa + w;
}


// ---- tensor-core path (the bfloat16 instantiation) -------------------------
//
// Every product is a wgmma (wgmma.cuh) on bf16 operands with float32 sums,
// rounding where the TPU kernel's bf16 compute mode rounds and nowhere
// else.  A warpgroup owns a tile of TM = 64 answer-word rows (wgmma.cuh's
// row tiles), so the softmax, the LayerNorm and the dropout run on
// registers between the products.

// The frame's qn and qe tiles (64 rows, rows past Lr zero), its q mask
// (zero past Lr) and, unless it streams (D = 256), W (3D x D bf16) into
// shared memory; every thread of the block calls it and the data is ready
// for wgmma on return.
template <int D = BWD_D>
__device__ __forceinline__ void tc_load_frame(
    uint8_t* w_s, uint8_t* qn_s, uint8_t* qe_s, float* qm_s,
    const __nv_bfloat16* W, const __nv_bfloat16* qn, const __nv_bfloat16* qe,
    const float* qmask, size_t fbase, int Lr) {
  const int tid = threadIdx.x;
  tc_load_rows<D>(qn_s, TM, qn + fbase * D, D, Lr, tid, NTHREADS);
  tc_load_rows<D>(qe_s, TM, qe + fbase * D, D, Lr, tid, NTHREADS);
  if constexpr (D <= 128)
    tc_load_rows<D>(w_s, 3 * D, W, D, 3 * D, tid, NTHREADS);
  if (tid < TM) qm_s[tid] = tid < Lr ? qmask[fbase + tid] : 0.f;
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  tc::fence_async_smem();
  __syncthreads();
}

// s (64 x LRP) = cn tile . qn^T, both K-major matrices of 64 rows and
// D / 64 panels.
template <int LRP, int D = BWD_D>
__device__ __forceinline__ void tc_scores(float (&s)[LRP / 2], uint32_t cn_a,
                                          uint32_t qn_a) {
  tc::fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int off = (ks / 4) * TILE_PANEL + (ks % 4) * 32;
    tc::mma_ss<LRP, 0, 0>(s, tc::make_desc(cn_a + off, 16),
                          tc::make_desc(qn_a + off, 16), ks > 0);
  }
  tc::commit();
  tc::wait_all();
}

// In: s = the tile's dot products.  Out: s = masked scores (the raw
// output), p0 = softmax before the mask; returns the floor gate as bits
// (bit i set where scale * masked > floor).  cm = the c mask of the
// thread's two rows; qm_s is zero past Lr.  Same arithmetic as attn_scores.
template <int LRP>
__device__ __forceinline__ uint32_t tc_softmax(float (&s)[LRP / 2],
                                               float (&p0)[LRP / 2],
                                               const float (&cm)[2],
                                               const float* qm_s, int Lr,
                                               float scale, int lane) {
  uint32_t gate = 0u;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < LRP / 2; ++i) {
    const int h = (i / 2) % 2, j = acc_col(i, lane);
    const bool v = j < Lr;
    const float smv = v ? cm[h] * qm_s[j] : 0.f;
    const float mk = s[i] - 1e10f * (1.f - smv);
    s[i] = mk;
    const float zc = mk * scale;
    if (zc > SAFE_FLOOR) gate |= 1u << i;
    p0[i] = v ? fmaxf(zc, SAFE_FLOOR) : -CUDART_INF_F;
    mx[h] = fmaxf(mx[h], p0[i]);
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < LRP / 2; ++i) {
    const int h = (i / 2) % 2;
    p0[i] = acc_col(i, lane) < Lr ? expf(p0[i] - mx[h]) : 0.f;
    sum[h] += p0[i];
  }
  const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
#pragma unroll
  for (int i = 0; i < LRP / 2; ++i) p0[i] *= inv[(i / 2) % 2];
  return gate;
}

// att (64 x 64 NP) = p . qe[:, col0 : col0 + 64 NP] with p = p0 * mask
// rounded to bf16 and fed from registers; qe_a = the shared address of the
// qe tile's panel that holds column col0.
template <int LRP, int NP>
__device__ __forceinline__ void tc_att(float (&att)[32 * NP],
                                       const float (&p0)[LRP / 2],
                                       const float (&cm)[2],
                                       const float* qm_s, uint32_t qe_a,
                                       int lane) {
  tc::fence();
#pragma unroll
  for (int ts = 0; ts < LRP / 16; ++ts) {
    uint32_t a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * ts + 2 * r, j = acc_col(i, lane);
      const float c = cm[r & 1];
      a[r] = tc::pack_bf16(p0[i] * (c * qm_s[j]),
                           p0[i + 1] * (c * qm_s[j + 1]));
    }
    tc::mma_rs<64 * NP, 1>(att, a,
                           tc::make_desc(qe_a + ts * 2 * tc::ATOM_BYTES,
                                         TILE_PANEL), ts > 0);
  }
  tc::commit();
  tc::wait_all();
}

}  // namespace tvqa
