// Device functions shared by the fused QA-context attention forward
// (qa_ctx_attention_fwd.cu) and the backward's recompute
// (qa_ctx_attention_bwd.cu), so the two cannot drift: first those of the
// float32 instantiation (CUDA cores), then those of the bfloat16 one (tensor
// cores, from "tensor-core path" on).  Neither is bound by the card's memory
// or tensor-core rate; see the two sources.
//
// float32: one warp owns one answer-word row m of a frame: lanes j = lane and
// lane + 32 hold the row's scores against regions j (Lr <= 64).  The
// frame's qn and qe tiles sit in shared memory with row stride QS = D + 1,
// so lanes that index regions hit distinct banks.
#pragma once

#include "common.cuh"
#include "philox.cuh"
#include "wgmma.cuh"

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


// ---- tensor-core path (the bfloat16 instantiation) -------------------------
//
// Every product is a wgmma (wgmma.cuh) on bf16 operands with float32 sums,
// rounding where the TPU kernel's bf16 compute mode rounds and nowhere
// else.  A warpgroup owns a tile of TM = 64 answer-word rows; a thread holds
// two rows of it (rl and rl + 8) in the accumulator layout, so the softmax,
// the LayerNorm and the dropout run on registers between the products, and
// a row statistic is a sum over the thread's values and the four lanes of
// its quad.  Shared-memory operands are panels of 128-byte rows (wgmma.cuh).

constexpr int TM = 64;                  // rows of a tile (the wgmma M)
constexpr int TILE_PANEL = TM * tc::ROW_BYTES;       // panel of a 64-row tile
constexpr int W_ROWS = 3 * D;
constexpr int W_PANEL = W_ROWS * tc::ROW_BYTES;      // panel of W (3D rows)
constexpr int W_BYTES = 2 * W_PANEL;
constexpr int TILE_BYTES = 2 * TILE_PANEL;           // 64 x 128 bf16

__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  return p + ((tc::ATOM_BYTES - (tc::smem_u32(p) & (tc::ATOM_BYTES - 1)))
              & (tc::ATOM_BYTES - 1));
}

// cp.async `rows` rows of D bf16 (row stride ld values) into the two panels
// of an R-row matrix at dst; rows past `rows` are zeroed.  Thread t of n.
__device__ __forceinline__ void tc_load_rows(uint8_t* dst, int R,
                                             const __nv_bfloat16* src,
                                             int ld, int rows, int t,
                                             int n) {
  for (int c = t; c < R * 16; c += n) {
    const int r = c >> 4, ch = c & 15;
    uint8_t* d = dst + (ch >> 3) * (R * tc::ROW_BYTES)
                 + tc::swz_chunk(r, ch & 7);
    if (r < rows)
      tc::cp_async16(d, src + static_cast<size_t>(r) * ld + ch * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The frame's qn and qe tiles (64 rows, rows past Lr zero), its q mask
// (zero past Lr) and W (3D x D bf16) into shared memory; every thread of
// the block calls it and the data is ready for wgmma on return.
__device__ __forceinline__ void tc_load_frame(
    uint8_t* w_s, uint8_t* qn_s, uint8_t* qe_s, float* qm_s,
    const __nv_bfloat16* W, const __nv_bfloat16* qn, const __nv_bfloat16* qe,
    const float* qmask, size_t fbase, int Lr) {
  const int tid = threadIdx.x;
  tc_load_rows(qn_s, TM, qn + fbase * D, D, Lr, tid, NTHREADS);
  tc_load_rows(qe_s, TM, qe + fbase * D, D, Lr, tid, NTHREADS);
  tc_load_rows(w_s, W_ROWS, W, D, W_ROWS, tid, NTHREADS);
  if (tid < TM) qm_s[tid] = tid < Lr ? qmask[fbase + tid] : 0.f;
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  tc::fence_async_smem();
  __syncthreads();
}

// s (64 x LRP) = cn tile . qn^T, both K-major two-panel matrices of 64 rows.
template <int LRP>
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

// Sum over the four lanes that share a row of the accumulator layout.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Column of accumulator value i (row half (i / 2) % 2) for this lane.
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
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

// Eight Philox4x32-10 blocks (counters blk0, blk0 + 2, .., blk0 + 14, as
// philox.cuh's philox4x32_10) advanced round by round side by side, so that
// eight independent chains are in flight instead of one ten-round chain
// after another; returns their 32 keep bits, block n in bits 4 n .. 4 n + 3.
__device__ __forceinline__ uint32_t keep_word(uint64_t seed, uint64_t blk0,
                                              uint32_t threshold) {
  uint32_t c0[8], c1[8], c2[8], c3[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const uint64_t blk = blk0 + 2 * n;
    c0[n] = static_cast<uint32_t>(blk);
    c1[n] = static_cast<uint32_t>(blk >> 32);
    c2[n] = c3[n] = 0u;
  }
  uint32_t k0 = static_cast<uint32_t>(seed),
           k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
      philox_round(c0[n], c1[n], c2[n], c3[n], k0, k1);
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  uint32_t bits = 0u;
#pragma unroll
  for (int n = 0; n < 8; ++n)
    bits |= (((c0[n] >> 8) >= threshold ? 1u : 0u)
             | ((c1[n] >> 8) >= threshold ? 2u : 0u)
             | ((c2[n] >> 8) >= threshold ? 4u : 0u)
             | ((c3[n] >> 8) >= threshold ? 8u : 0u)) << (4 * n);
  return bits;
}

// keep_word as a call: one copy of the code, compiled apart from its
// caller's register pressure.  The backward draws at the start of a tile,
// where little is live and a call is cheap; inlined into its 64-wide
// instantiation the draw ran three times slower than in the 32-wide one.
// The forward draws with the att accumulator live and inlines.
__device__ __noinline__ uint32_t keep_word_call(uint64_t seed, uint64_t blk0,
                                                uint32_t threshold) {
  return keep_word(seed, blk0, threshold);
}

// Keep bits of the Philox dropout for the thread's values in 8 NQ columns
// of its two rows.  A Philox call covers four adjacent columns, which two
// neighbouring lanes share, so the even lane draws for row rl, the odd one
// for row rl + 8, and one shuffle per eight calls trades the bits.
// e_mine = the flat index of column 0 of this group in the row this lane
// draws for.  Value (half h, chunk q, t) is kept when
// bit 4 (q % 8) + t of kw[h][q / 8] is set.
template <int NQ, bool CALL>
__device__ __forceinline__ void tc_keep_bits(const Dropout& drop,
                                             uint64_t e_mine, int lane,
                                             uint32_t (&kw)[2][NQ / 8]) {
  const bool odd = lane & 1;
#pragma unroll
  for (int wd = 0; wd < NQ / 8; ++wd) {
    // chunk q = 8 wd + qq draws block (e_mine + 8 q + 4 (lane % 4 / 2)) / 4
    const uint64_t blk0 = (e_mine + 64 * wd + 4 * ((lane & 3) >> 1)) >> 2;
    const uint32_t mine = CALL
        ? keep_word_call(drop.seed, blk0, drop.threshold)
        : keep_word(drop.seed, blk0, drop.threshold);
    const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
    kw[0][wd] = (odd ? other : mine) >> (2 * (lane & 1));
    kw[1][wd] = (odd ? mine : other) >> (2 * (lane & 1));
  }
}

}  // namespace tvqa
