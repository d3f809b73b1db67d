// Fused QA-context attention, backward, at the hidden widths D = 64 and 256
// (qa_ctx_attention_bwd.cu is the same function at D = 128).
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_attention.py
// (_pallas_backward / _bwd_kernel :479), which reads D from its operands
// (:488) and so runs at any width.  Per (b, frame i), as
// qa_ctx_attention_bwd.cu's header sets out: recompute the scores, the
// softmax, att, the LayerNorm statistics and the replayed Philox dropout
// mask (keyed by the flat index of the (B*A*Li*Lqa, 3D) LN output, as the
// forward drew it); the ReLU sign from the saved `mixed`.  Then gW, gb,
// g_yd = g_out W^T, the LN backward over the virtual 3D concat, gce, g_att,
// the softmax backward (plus the raw cotangent where the forward wrote raw
// scores: every answer for "full", the target answer for "target"), gcn;
// gqn = g_s^T cn and gqe = p^T g_att in a second kernel.
//
// What bounds it on the H100: at the headline train shapes (vid site,
// 160,000 rows) it reads ~55 MB at D = 64 and ~220 MB at D = 256 and does
// ~13 and ~170 GFLOP (the score and att recompute, g_yd, gW, g_p, gqe, gcn,
// gqn), so the operations bind at D = 256 (~0.17 ms) and the bytes at D =
// 64 (~16 us).
//
// Three designs.
// * bfloat16 at D = 256 (the hsz-256 main paths): qa_ctx_bwd_tc_wide_kernel,
//   the D = 128 tensor-core design at this width (a warpgroup's 128
//   columns in two quarters of 64, W streamed through a ring, g_yd once a
//   tile; the note at the kernel), then the gqn / gqe kernel and the weight
//   gradient over the bf16 rows it writes.
// * bfloat16 at D = 64 (the hsz-64 main paths): qa_ctx_bwd_tc64_kernel, the
//   D = 128 tensor-core arithmetic with the two warpgroups on rows of their
//   own (the note at the kernel), then qa_ctx_gq_tc64_kernel and the
//   weight gradient over the bf16 rows it writes.
// * float32 at D = 64 and 256 (the exactness check): CUDA cores for all:
//   - qa_ctx_bwd_wide_kernel: one block per (b, i), tiles of RT = 8 RPT
//     answer-word rows, a warp owning RPT rows; the frame's qn and qe in
//     shared memory for the block's life (row stride D + 1: lanes that
//     index regions hit distinct banks), the scores and softmax on the
//     lanes j = lane, lane + 32 (qa_ctx_attention.cuh, the forward's own
//     recompute), g_yd = g_out W^T staged from L2 32 rows at a time.  At D
//     = 256 a tile is 16 rows, or 8 when the frame's Lr leaves too little
//     shared memory for 16 (Lr > 50).  It writes g_s, p and g_att rows
//     (float32) for the second kernel.
//   - qa_ctx_gq_wide_kernel (gqn and gqe of a (b, i) from those rows,
//     staged through shared memory 16 rows at a time; a thread owns one
//     column and up to 32 regions) and the weight gradient over the yd and
//     g_out rows (grad_reduce.cuh, shared with D = 128).
// The bf16 weight gradient is wgrad_tc.cuh's (its bias row is gb).  Sums
// across blocks go through scratch slots and a fixed-order second pass:
// the same bits from run to run, no atomics.
#include "bwd_wide.cuh"
#include "qa_ctx_attention.cuh"

namespace {

using namespace tvqa;

constexpr int MAX_LR = 64;

template <int D, int RPT>
struct Layout {
  static constexpr int RT = RPT * NWARPS;
  int qn, qe, qm, p, gt, gs, cn, ce, a, ga, go, st, w, total;
  __host__ __device__ explicit Layout(int lr) {
    const int lrp = round4(lr);
    qn = 0;
    qe = qn + lr * (D + 1);
    qm = round4(qe + lr * (D + 1));
    p = qm + lrp;
    gt = p + RT * lrp;
    gs = gt + RT * lrp;
    cn = gs + RT * lrp;
    ce = cn + RT * D;
    a = ce + RT * D;
    ga = a + RT * D;
    go = ga + RT * D;
    st = go + RT * D;
    w = st + 2 * RT;
    total = w + KC * D;
  }
};

// The outputs and scratch of a call; R is the type of the g_s, p and g_att
// rows the main kernel hands to the gq kernel (float32 from the CUDA-core
// kernel, ld = round4(Lr) wide; bf16 from the tensor-core one, ld = LRP).
template <typename T, typename R>
struct WideGrads {
  T* gqn;
  T* gqe;
  float* gcn_part;                     // (B, Li, M, D)
  float* gce_part;
  T* yd;                               // (B*Li*M, 3D)
  T* gout;                             // (B*Li*M, D)
  float* vec_part;                     // (B*Li, 7D), 6D when bf16; a
                                       // slot a block at D = 256
  R* gs;                               // (B*Li*M, ld): g_s
  R* p;                                // (B*Li*M, ld): p
  R* ga;                               // (B*Li*M, D): g_att
  int ld;
};

template <int D, int RPT>
__global__ void __launch_bounds__(NTHREADS)
qa_ctx_bwd_wide_kernel(const float* __restrict__ cn,
                       const float* __restrict__ ce,
                       const float* __restrict__ qn,
                       const float* __restrict__ qe,
                       const float* __restrict__ cmask,
                       const float* __restrict__ qmask,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ Wt,
                       const float* __restrict__ gmixed,
                       const float* __restrict__ mixed,
                       const float* __restrict__ graw,
                       const int* __restrict__ targets,
                       WideGrads<float, float> out,
                       int A, int Lqa, int Li, int Lr, float scale,
                       Dropout drop) {
  constexpr int CPL = D / 32, VPL = D / 32, QS = D + 1;
  constexpr int RT = RPT * NWARPS;
  constexpr int NV = 7 * D;
  drop.load_seed();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout<D, RPT> lay(Lr);
  float* qn_s = smem + lay.qn;
  float* qe_s = smem + lay.qe;
  float* qm_s = smem + lay.qm;
  float* p_s = smem + lay.p;           // p0
  float* gt_s = smem + lay.gt;         // softmax-floor gate
  float* gs_s = smem + lay.gs;         // p = p0 * mask, then g_s
  float* cn_s = smem + lay.cn;
  float* ce_s = smem + lay.ce;
  float* a_s = smem + lay.a;
  float* ga_s = smem + lay.ga;
  float* go_s = smem + lay.go;
  float* st_s = smem + lay.st;
  float* w_s = smem + lay.w;
  const int lrp = round4(Lr);

  const int i = blockIdx.x, b = blockIdx.y;
  const int M = A * Lqa;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = lane * CPL;
  const int target = targets != nullptr ? targets[b] : -1;
  const size_t blk = static_cast<size_t>(b) * Li + i;

  const size_t fbase = blk * Lr;
  for (int idx = tid; idx < Lr * D; idx += NTHREADS) {
    const int j = idx / D, d = idx % D;
    qn_s[j * QS + d] = qn[fbase * D + idx];
    qe_s[j * QS + d] = qe[fbase * D + idx];
  }
  for (int j = tid; j < Lr; j += NTHREADS) qm_s[j] = qmask[fbase + j];

  float vg[3][CPL], vb[3][CPL], vgb[CPL];
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    vgb[t] = 0.f;
#pragma unroll
    for (int g = 0; g < 3; ++g) vg[g][t] = vb[g][t] = 0.f;
  }

  for (int m0 = 0; m0 < M; m0 += RT) {
    const int rows = min(RT, M - m0);
    // ---- stage the tile's rows and g_out = g_mixed * (mixed > 0) --------
    __syncthreads();                   // previous tile fully consumed
    for (int idx = tid; idx < RT * D; idx += NTHREADS) {
      const int r = idx / D, d = idx % D, m = m0 + r;
      float c = 0.f, e = 0.f, go = 0.f;
      if (r < rows) {
        const size_t row = static_cast<size_t>(b) * M + m;
        c = cn[row * D + d];
        e = ce[row * D + d];
        const size_t mrow = mixed_row(b, m, i, A, Lqa, Li);
        go = mixed[mrow * D + d] > 0.f ? gmixed[mrow * D + d] : 0.f;
        out.gout[(blk * M + m) * D + d] = go;
      }
      cn_s[idx] = c;
      ce_s[idx] = e;
      go_s[idx] = go;
    }
    __syncthreads();
    // ---- recompute: scores, softmax, att, LN statistics ----------------
#pragma unroll 1
    for (int jj = 0; jj < RPT; ++jj) {
      const int r = warp * RPT + jj, m = m0 + r;
      if (r >= rows) break;
      const float cm = cmask[static_cast<size_t>(b) * M + m];
      const AttnRow sc = attn_scores<D>(cn_s + r * D, qn_s, qm_s, cm, Lr,
                                        scale, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        if (j < Lr) {
          p_s[r * lrp + j] = sc.p0[h];
          gt_s[r * lrp + j] = sc.gate[h];
          gs_s[r * lrp + j] = sc.p0[h] * sc.sm[h];
        }
      }
      __syncwarp();
      float at[VPL];
      attn_apply<D>(gs_s + r * lrp, qe_s, Lr, lane, at);
      float x[3][VPL];
#pragma unroll
      for (int q = 0; q < VPL; ++q) {
        const float c = ce_s[r * D + lane + 32 * q];
        a_s[r * D + lane + 32 * q] = at[q];
        x[0][q] = c;
        x[1][q] = at[q];
        x[2][q] = c * at[q];
      }
      float mean, istd;
      ln3_stats<D>(x, mean, istd, drop.inv3);
      if (lane == 0) {
        st_s[2 * r] = mean;
        st_s[2 * r + 1] = istd;
      }
    }
    // ---- g_yd = g_out W^T, three D-column groups -----------------------
    float acc3[3][RPT][CPL];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      gemm_staged_ld<RPT, D>(acc3[g], go_s, D, D, Wt + g * D, 3 * D, w_s,
                             warp * RPT, c0);
    // ---- per row: dropout replay, LN backward, softmax backward --------
#pragma unroll
    for (int jj = 0; jj < RPT; ++jj) {
      const int r = warp * RPT + jj, m = m0 + r;
      if (r >= rows) break;
      const float mean = st_s[2 * r], istd = st_s[2 * r + 1];
      float cev[CPL], av[CPL];
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        cev[t] = ce_s[r * D + c0 + t];
        av[t] = a_s[r * D + c0 + t];
        vgb[t] += go_s[r * D + c0 + t];
      }
      const unsigned long long er = mixed_row(b, m, i, A, Lqa, Li);
      const size_t yrow = (blk * M + m) * (3 * D);
      float xh[3][CPL], gxh[3][CPL], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float km[CPL];
        keep_or_one<CPL>(drop, drop.key3(er, g, c0), km);
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          const int k = g * D + c0 + t;
          const float x = g == 0 ? cev[t] : (g == 1 ? av[t] : cev[t] * av[t]);
          xh[g][t] = (x - mean) * istd;
          out.yd[yrow + k] = (xh[g][t] * gamma[k] + beta[k]) * km[t];
          const float gy = acc3[g][jj][t] * km[t];
          vg[g][t] = fmaf(gy, xh[g][t], vg[g][t]);
          vb[g][t] += gy;
          gxh[g][t] = gy * gamma[k];
          s1 += gxh[g][t];
          s2 = fmaf(gxh[g][t], xh[g][t], s2);
        }
      }
      const float m1 = warp_sum(s1) * drop.inv3;
      const float m2 = warp_sum(s2) * drop.inv3;
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        float gx[3];
#pragma unroll
        for (int g = 0; g < 3; ++g)
          gx[g] = istd * (gxh[g][t] - m1 - xh[g][t] * m2);
        out.gce_part[(blk * M + m) * D + c0 + t] = gx[0] + gx[2] * av[t];
        const float gat = gx[1] + gx[2] * cev[t];
        ga_s[r * D + c0 + t] = gat;
        out.ga[(blk * M + m) * D + c0 + t] = gat;
      }
      __syncwarp();
      // softmax backward on lanes j = lane, lane + 32
      const float cm = cmask[static_cast<size_t>(b) * M + m];
      const int a = m / Lqa, w = m % Lqa;
      const bool has_raw = graw != nullptr
                           && (targets == nullptr || a == target);
      const float* graw_row = graw == nullptr ? nullptr
          : (targets == nullptr
                 ? graw + ((((static_cast<size_t>(b) * A + a) * Li + i)
                            * Lqa + w) * Lr)
                 : graw + ((blk * Lqa + w) * Lr));
      float gp[2] = {0.f, 0.f}, p0[2] = {0.f, 0.f}, sm[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        if (j < Lr) {
          const float* qr = qe_s + j * QS;
          const float* gr = ga_s + r * D;
          float acc = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) acc = fmaf(gr[d], qr[d], acc);
          sm[h] = cm * qm_s[j];
          p0[h] = p_s[r * lrp + j];
          gp[h] = acc * sm[h];
        }
      }
      const float tot = warp_sum(gp[0] * p0[0] + gp[1] * p0[1]);
      const size_t srow = (blk * M + m) * lrp;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        if (j < Lr) {
          float gsv = p0[h] * (gp[h] - tot) * scale * gt_s[r * lrp + j];
          if (has_raw) gsv += graw_row[j];
          gs_s[r * lrp + j] = gsv;
          out.gs[srow + j] = gsv;
          out.p[srow + j] = p0[h] * sm[h];
        }
      }
      __syncwarp();
      // gcn row: g_s qn
      float gc[VPL];
#pragma unroll
      for (int q = 0; q < VPL; ++q) gc[q] = 0.f;
      for (int j = 0; j < Lr; ++j) {
        const float gsv = gs_s[r * lrp + j];
#pragma unroll
        for (int q = 0; q < VPL; ++q)
          gc[q] = fmaf(gsv, qn_s[j * QS + lane + 32 * q], gc[q]);
      }
#pragma unroll
      for (int q = 0; q < VPL; ++q)
        out.gcn_part[(blk * M + m) * D + lane + 32 * q] = gc[q];
    }
  }
  // the block's parameter-vector partials, summed over warps in order
  // (NWARPS x NV floats over cn_s .. w_s: 5 RT D + 2 RT + KC D >= 8 x 7 D)
  __syncthreads();
  float* red = cn_s;
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      red[warp * NV + g * D + c0 + t] = vg[g][t];
      red[warp * NV + 3 * D + g * D + c0 + t] = vb[g][t];
    }
    red[warp * NV + 6 * D + c0 + t] = vgb[t];
  }
  __syncthreads();
  for (int k = tid; k < NV; k += NTHREADS) {
    float s = 0.f;
    for (int wp = 0; wp < NWARPS; ++wp) s += red[wp * NV + k];
    out.vec_part[blk * NV + k] = s;
  }
}

// gqn[j] = sum_m g_s[m, j] cn[m], gqe[j] = sum_m p[m, j] g_att[m] for the
// frame (b, i) = (blockIdx.y, blockIdx.x).  The frame's rows come through
// shared memory GR at a time; thread t owns column t % D and JT regions j
// of a sweep (the NTHREADS / D threads of a column split a sweep's 64
// regions at D = 64; at 256 a sweep takes 32), so its sums stay in
// registers while the rows stream by.
template <typename T, typename R, int D>
__global__ void __launch_bounds__(NTHREADS)
qa_ctx_gq_wide_kernel(const R* __restrict__ gs, const R* __restrict__ p,
                      const R* __restrict__ ga, const T* __restrict__ cn,
                      T* __restrict__ gqn, T* __restrict__ gqe, int M,
                      int Li, int Lr, int ld) {
  constexpr int NG = NTHREADS / D, JT = NG == 1 ? 32 : MAX_LR / NG;
  constexpr int GR = 16;
  __shared__ __align__(16) float gs_s[GR][MAX_LR], p_s[GR][MAX_LR];
  __shared__ __align__(16) float cn_s[GR][D], ga_s[GR][D];
  const int i = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int d = tid % D, jg = tid / D;
  const size_t blk = static_cast<size_t>(b) * Li + i;
  const int sweeps = (Lr + JT * NG - 1) / (JT * NG);   // the same for all
  for (int sw = 0; sw < sweeps; ++sw) {
    const int j0 = JT * (jg + NG * sw);
    float an[JT], ae[JT];
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) an[jj] = ae[jj] = 0.f;
    for (int m0 = 0; m0 < M; m0 += GR) {
      const int rows = min(GR, M - m0);
      __syncthreads();                 // the previous rows are consumed
      for (int idx = tid; idx < GR * ld; idx += NTHREADS) {
        const int r = idx / ld, j = idx % ld;
        const size_t o = (blk * M + m0 + r) * ld + j;
        gs_s[r][j] = r < rows ? to_f(gs[o]) : 0.f;
        p_s[r][j] = r < rows ? to_f(p[o]) : 0.f;
      }
      for (int idx = tid; idx < GR * D; idx += NTHREADS) {
        const int r = idx / D, dd = idx % D;
        cn_s[r][dd] = r < rows
            ? to_f(cn[(static_cast<size_t>(b) * M + m0 + r) * D + dd]) : 0.f;
        ga_s[r][dd] = r < rows ? to_f(ga[(blk * M + m0 + r) * D + dd]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < GR; ++r) {
        const float c = cn_s[r][d], g = ga_s[r][d];
#pragma unroll
        for (int jj = 0; jj < JT; ++jj) {
          an[jj] = fmaf(gs_s[r][j0 + jj], c, an[jj]);
          ae[jj] = fmaf(p_s[r][j0 + jj], g, ae[jj]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) {
      if (j0 + jj < Lr) {
        const size_t o = (blk * Lr + j0 + jj) * D + d;
        gqn[o] = from_f<T>(an[jj]);
        gqe[o] = from_f<T>(ae[jj]);
      }
    }
  }
}

template <int D, int RPT>
cudaError_t launch_main(const void* cn, const void* ce, const void* qn,
                        const void* qe, const float* cmask,
                        const float* qmask, const float* gamma,
                        const float* beta, const float* Wt,
                        const void* gmixed, const void* mixed,
                        const float* graw, const int* targets,
                        WideGrads<float, float> g, int B, int A, int Lqa,
                        int Li, int Lr, float scale, Dropout drop,
                        cudaStream_t stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const size_t bytes = sizeof(float) * Layout<D, RPT>(Lr).total;
  auto kern = qa_ctx_bwd_wide_kernel<D, RPT>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Li, B), NTHREADS, bytes, stream>>>(
      f(cn), f(ce), f(qn), f(qe), cmask, qmask, gamma, beta, Wt, f(gmixed),
      f(mixed), graw, targets, g, A, Lqa, Li, Lr, scale, drop);
  return cudaGetLastError();
}

// The main kernel's shared memory at D = 256 with 16-row tiles fits the
// H100's 232,448 bytes up to Lr = 50; past that the tiles take 8 rows.
constexpr size_t SMEM_LIMIT = 232448;

// The weight gradient over the yd and g_out rows (tensor cores from bf16
// rows, CUDA cores from float32 ones) and the fixed-order slot sums
// (vec_slots slots of parameter sums, the frames' gcn and gce partials).
template <typename T, typename R, int D>
int launch_sums(WideGrads<T, R> g, void* gcn, void* gce, float* gvec,
                float* wg_part, float* gw, int B, int A, int Lqa, int Li,
                int wg_chunks, int vec_slots, cudaStream_t stream) {
  constexpr bool BF = sizeof(T) == 2;
  const int M = A * Lqa;
  const long long rows = static_cast<long long>(B) * Li * M;
  cudaError_t err;
  if constexpr (BF)       // [gw; gb] (the wrapper lays gb behind gw)
    err = wgrad_tc(g.yd, g.gout, wg_part, gw, rows, 3 * D, D, wg_chunks,
                   stream);
  else
    err = wgrad(g.yd, g.gout, wg_part, gw, rows, 3 * D, D, wg_chunks,
                stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = sum_slots<float>(g.vec_part, gvec, 1, vec_slots,
                              (BF ? 6 : 7) * D, stream)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = sum_slots<T>(g.gcn_part, static_cast<T*>(gcn), B, Li,
                          static_cast<long long>(M) * D, stream))
      != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(sum_slots<T>(g.gce_part, static_cast<T*>(gce), B,
                                       Li, static_cast<long long>(M) * D,
                                       stream));
}

// After the main kernel: gqn and gqe (CUDA cores), then launch_sums.
template <typename T, typename R, int D>
int launch_tail(const void* cn, WideGrads<T, R> g, void* gcn, void* gce,
                float* gvec, float* wg_part, float* gw, int B, int A,
                int Lqa, int Li, int Lr, int wg_chunks, int vec_slots,
                cudaStream_t stream) {
  const int M = A * Lqa;
  qa_ctx_gq_wide_kernel<T, R, D><<<dim3(Li, B), NTHREADS, 0, stream>>>(
      g.gs, g.p, g.ga, static_cast<const T*>(cn), g.gqn, g.gqe, M, Li, Lr,
      g.ld);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sums<T, R, D>(g, gcn, gce, gvec, wg_part, gw, B, A, Lqa, Li,
                              wg_chunks, vec_slots, stream);
}

// The CUDA-core backward (float32 at D = 64 and 256).
template <int D>
int launch(const void* cn, const void* ce, const void* qn, const void* qe,
           const float* cmask, const float* qmask, const float* gamma,
           const float* beta, const float* Wt, const void* gmixed,
           const void* mixed, const float* graw, const int* targets,
           WideGrads<float, float> g, void* gcn, void* gce, float* gvec,
           float* wg_part, float* gw, int B, int A, int Lqa, int Li, int Lr,
           float scale, Dropout drop, int wg_chunks, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (D == 256) {
    err = sizeof(float) * Layout<D, 2>(Lr).total <= SMEM_LIMIT
        ? launch_main<D, 2>(cn, ce, qn, qe, cmask, qmask, gamma, beta, Wt,
                            gmixed, mixed, graw, targets, g, B, A, Lqa, Li,
                            Lr, scale, drop, stream)
        : launch_main<D, 1>(cn, ce, qn, qe, cmask, qmask, gamma, beta, Wt,
                            gmixed, mixed, graw, targets, g, B, A, Lqa, Li,
                            Lr, scale, drop, stream);
  } else {
    err = launch_main<D, 4>(cn, ce, qn, qe, cmask, qmask, gamma, beta, Wt,
                            gmixed, mixed, graw, targets, g, B, A, Lqa, Li,
                            Lr, scale, drop, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_tail<float, float, D>(cn, g, gcn, gce, gvec, wg_part, gw, B,
                                      A, Lqa, Li, Lr, wg_chunks, B * Li,
                                      stream);
}

// ---- the bfloat16 instantiation at D = 256: tensor cores -------------------
//
// qa_ctx_bwd_tc_kernel's design (qa_ctx_attention_bwd.cu: one block per
// (b, i), 64-row tiles, the two warpgroups split the columns, every product
// a wgmma on bf16 operands with float32 sums) at D = 256.  A warpgroup owns
// 128 columns and takes them as two quarters of 64, one after the other.
// What the design does about the card:
// * g_yd = g_out W^T once a tile.  The LN backward's gx of the three groups
//   enters the outputs only as gce = gx0 + gx2 att and g_att = gx1 + gx2
//   ce, so pass A, which holds g_yd of a (group, quarter), keeps P = gxh0
//   + gxh2 att and Q = gxh1 + gxh2 ce (gxh = g_yd mask gamma) beside the
//   row sums s1 = sum gxh, s2 = sum gxh xh, and pass B needs no product:
//   gce = istd (P - m1 (1 + att) - m2 (xh0 + xh2 att)), g_att = istd (Q -
//   m1 (1 + ce) - m2 (xh1 + xh2 ce)), m = s / 3dv.  P and Q wait in the
//   rows' own gce_part and gcn_part slots (each thread reads back what it
//   wrote; gcn overwrites Q at the end of the tile).
// * W (384 KB) streams through a ring of NST slabs (both warpgroups' 64
//   rows of a (group, quarter) x 64 columns, 16 KB), one barrier a slab:
//   three slots of its own and, from the scores to the end of pass A (the
//   24 slabs of a tile), two more where qn was (qn is loaded again for
//   gcn), so four slabs are in flight ahead of the tensor cores; the next
//   tile's first three go out behind qn at the end of pass A.
// * A persistent grid (one block an SM) walks items of one frame's tile
//   (B Li ceil(M / 64) of them), so the last round of the grid is nearly
//   full (at the headline 3,200 items over 132 SMs, against 800 frames in
//   seven rounds, the last 6% full); the parameter sums run on in
//   registers over a block's items and go to the block's slot at its end.
// * p0 waits where cn was (the scores are done with it), g_att where g_out
//   was (no product reads g_out after pass A).
// Shared memory: 217 KB at LRP 64.
template <int LRP>
struct AttTcWide {
  static constexpr int D = 256;
  static constexpr int NST = 5;            // slabs of the ring: 3 + 2 in qn
  static constexpr int NOWN = 3;           // ... in its own room
  static constexpr int SLAB = 2 * TILE_PANEL;             // 16 KB
  static constexpr int PER_TILE = 2 * 3 * (D / 64);       // slabs a tile
  static constexpr int TILE = Shapes<D>::TILE_BYTES;      // 64 x 256 bf16
  static constexpr int O_QN = 0;
  static constexpr int O_QE = O_QN + TILE;
  static constexpr int O_CN = O_QE + TILE;                // cn, then p0
  static constexpr int O_GO = O_CN + TILE;                // g_out, g_att
  static constexpr int O_CE = O_GO + TILE;
  static constexpr int O_RING = O_CE + TILE;
  static constexpr int O_EX = O_RING + NOWN * SLAB;
  static constexpr int O_QM = O_EX + 2 * 2 * TM * 2 * 4;
  static constexpr int O_GB = O_QM + TM * 4;              // gamma, beta
  static constexpr int SMEM = O_GB + 6 * D * 4 + tc::ATOM_BYTES;
  static_assert(LRP / 2 * NTHREADS * 4 <= TILE, "p0 where cn was");
};

using bf16 = __nv_bfloat16;

template <int LRP>
__global__ void __launch_bounds__(NTHREADS, 1)
qa_ctx_bwd_tc_wide_kernel(const bf16* __restrict__ cn,
                          const bf16* __restrict__ ce,
                          const bf16* __restrict__ qn,
                          const bf16* __restrict__ qe,
                          const float* __restrict__ cmask,
                          const float* __restrict__ qmask,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          const bf16* __restrict__ W,
                          const bf16* __restrict__ gmixed,
                          const bf16* __restrict__ mixed,
                          const float* __restrict__ graw,
                          const int* __restrict__ targets,
                          WideGrads<bf16, bf16> out, int B, int A, int Lqa,
                          int Li, int Lr, float scale, Dropout drop) {
  using S = AttTcWide<LRP>;
  constexpr int D = S::D, NST = S::NST, AHEAD = NST - 1;
  constexpr int NVT = 6 * D;           // ggamma (3D), gbeta (3D)
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  uint8_t* qn_s = sm + S::O_QN;
  uint8_t* qe_s = sm + S::O_QE;
  uint8_t* cn_s = sm + S::O_CN;
  float* p0_s = reinterpret_cast<float*>(cn_s);   // once the scores are done
  uint8_t* go_s = sm + S::O_GO;
  uint8_t* ga_s = go_s;                // g_att, once pass A is done
  uint8_t* ce_s = sm + S::O_CE;
  uint8_t* ring = sm + S::O_RING;
  float* ex_s = reinterpret_cast<float*>(sm + S::O_EX);  // [2][wg][row][2]
  float* qm_s = reinterpret_cast<float*>(sm + S::O_QM);
  float* gamma_s = reinterpret_cast<float*>(sm + S::O_GB);
  float* beta_s = gamma_s + 3 * D;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int M = A * Lqa, ntile = (M + TM - 1) / TM;
  const int items = B * Li * ntile;
  for (int k = tid; k < 3 * D; k += NTHREADS) {
    gamma_s[k] = gamma[k];
    beta_s[k] = beta[k];
  }

  // ---- the ring: slab j (the block's item j / PER_TILE; quarter u, group
  // g = 2, 0, 1, column block kc of W in that order) into slot (j %
  // PER_TILE) % NST: slots 0 .. NOWN - 1 in the ring's room, the others
  // where qn was.  Each consumed slab commits one group, the item's scores
  // one more (its slab NOWN), so a slab's copies are waited for with the
  // newer AHEAD - 1 groups in flight --------------------------------------
  const int total = (items - static_cast<int>(blockIdx.x)
                     + static_cast<int>(gridDim.x) - 1)
                    / static_cast<int>(gridDim.x) * S::PER_TILE;
  int used = 0;                        // slabs consumed
  auto fetch_slab = [&](int j) {
    if (j < total) {
      const int s = j % S::PER_TILE, u = s / 12, g = (s / 4 + 2) % 3;
      const int kc = s % 4;
      const int k = s % NST;
      uint8_t* slot = k < S::NOWN ? ring + k * S::SLAB
                                  : qn_s + (k - S::NOWN) * S::SLAB;
#pragma unroll
      for (int w2 = 0; w2 < 2; ++w2)
        tc_load_rows<64>(slot + w2 * TILE_PANEL, TM,
                         W + static_cast<size_t>(g * D + 128 * w2 + 64 * u)
                                 * D + 64 * kc, D, TM, tid, NTHREADS);
    }
    tc::cp_async_commit();             // one group a slab
  };
#pragma unroll
  for (int j = 0; j < S::NOWN; ++j) fetch_slab(j);
  // g_yd of the next (quarter, group) on the warpgroup's quarter: acc =
  // g_out W[rows of the slabs]^T over the next four slabs.  Each slab: its
  // copies waited for, a barrier (the slab whole; the previous one's
  // products done in both warpgroups, so its slot takes the slab AHEAD on),
  // the products.  Every thread calls it.
  auto gyd = [&](float (&acc)[32]) {
#pragma unroll
    for (int kc = 0; kc < D / 64; ++kc) {
      tc::cp_async_wait<AHEAD - 1>();
      tc::fence_async_smem();
      __syncthreads();
      const int sl = used % S::PER_TILE;
      if (sl + AHEAD < S::PER_TILE)
        fetch_slab(used + AHEAD);
      else
        tc::cp_async_commit();
      const int k = sl % NST;
      const uint32_t go = tc::smem_u32(go_s) + kc * TILE_PANEL;
      const uint32_t st = tc::smem_u32(k < S::NOWN
                                           ? ring + k * S::SLAB
                                           : qn_s + (k - S::NOWN) * S::SLAB)
                          + wg * TILE_PANEL;
      tc::fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        tc::mma_ss<64, 0, 0>(acc, tc::make_desc(go + s * 32, 16),
                             tc::make_desc(st + s * 32, 16), kc > 0 || s > 0);
      tc::commit();
      tc::wait_all();
      ++used;
    }
    tc::fence_regs(acc);
  };

  const int rl = 16 * warp + (lane >> 2);
  const int cl = 2 * (lane & 3);
  auto ce_pair = [&](int h, int c) {
    return tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(
        ce_s + (c >> 6) * TILE_PANEL + tc::swz(rl + 8 * h, c & 63)));
  };
  // att of quarter u (64 columns) from p0 in shared memory
  auto att_of = [&](float (&att)[32], const float (&cm)[2], int u) {
    float p0[LRP / 2];
#pragma unroll
    for (int k = 0; k < LRP / 2; ++k) p0[k] = p0_s[k * NTHREADS + tid];
    tc_att<LRP, 1>(att, p0, cm, qm_s,
                   tc::smem_u32(qe_s) + (2 * wg + u) * TILE_PANEL, lane);
  };
  float vg[3][2][2], vb[3][2][2];      // [group][quarter][column half]
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      vg[g][u][0] = vg[g][u][1] = vb[g][u][0] = vb[g][u][1] = 0.f;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int bi = item / ntile, m0 = item % ntile * TM;
    const int b = bi / Li, i = bi % Li;
    const int target = targets != nullptr ? targets[b] : -1;
    const size_t blk = bi, fbase = blk * Lr;
    // ---- stage the item: the frame's qn, qe and q mask, the tile's cn and
    // ce rows, g_out = g_mixed * (mixed > 0) -------------------------------
    __syncthreads();                   // the previous item is consumed
    tc_load_rows<D>(qn_s, TM, qn + fbase * D, D, Lr, tid, NTHREADS);
    tc_load_rows<D>(qe_s, TM, qe + fbase * D, D, Lr, tid, NTHREADS);
    if (tid < TM) qm_s[tid] = tid < Lr ? qmask[fbase + tid] : 0.f;
    const size_t rbase = static_cast<size_t>(b) * M + m0;
    tc_load_rows<D>(cn_s, TM, cn + rbase * D, D, min(TM, M - m0), tid,
                    NTHREADS);
    tc_load_rows<D>(ce_s, TM, ce + rbase * D, D, min(TM, M - m0), tid,
                    NTHREADS);
    tc::cp_async_commit();
    for (int c = tid; c < TM * (D / 8); c += NTHREADS) {
      const int r = c / (D / 8), ch = c % (D / 8), m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) {
        const size_t o = mixed_row(b, m, i, A, Lqa, Li) * D + ch * 8;
        const uint4 mx = __ldg(reinterpret_cast<const uint4*>(mixed + o));
        v = __ldg(reinterpret_cast<const uint4*>(gmixed + o));
        const uint32_t mw[4] = {mx.x, mx.y, mx.z, mx.w};
        uint32_t gw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 mv = tc::unpack_bf16(mw[k]);
          gw[k] &= (mv.x > 0.f ? 0x0000FFFFu : 0u)
                   | (mv.y > 0.f ? 0xFFFF0000u : 0u);
        }
        v = make_uint4(gw[0], gw[1], gw[2], gw[3]);
        *reinterpret_cast<uint4*>(out.gout + (blk * M + m) * D + ch * 8) = v;
      }
      *reinterpret_cast<uint4*>(go_s + (ch >> 3) * TILE_PANEL
                                + tc::swz_chunk(r, ch & 7)) = v;
    }
    tc::cp_async_wait<0>();            // (the ring's slabs in flight too)
    tc::fence_async_smem();
    __syncthreads();

    int m[2];
    bool live[2];
    float cm[2];
    size_t mrow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = m0 + rl + 8 * h;
      live[h] = m[h] < M;
      cm[h] = live[h] ? cmask[static_cast<size_t>(b) * M + m[h]] : 0.f;
      mrow[h] = mixed_row(b, live[h] ? m[h] : 0, i, A, Lqa, Li);
    }
    // the dropout's keep bits of the (group, quarter)s, drawn first
    uint32_t kw[3][2][2][1];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        kw[g][u][0][0] = kw[g][u][1][0] = ~0u;
        if (drop.on())
          tc_keep_bits<8, true>(
              drop, drop.key3((lane & 1) ? mrow[1] : mrow[0], g,
                              128 * wg + 64 * u),
              lane, kw[g][u]);
      }
    // ---- recompute: scores and softmax (full rows, both warpgroups) ------
    uint32_t gate;
    {
      float sc[LRP / 2], p0[LRP / 2];
      tc_scores<LRP, D>(sc, tc::smem_u32(cn_s), tc::smem_u32(qn_s));
      gate = tc_softmax<LRP>(sc, p0, cm, qm_s, Lr, scale, lane);
      if (wg == 1) {                   // p rows out, for gqe = p^T g_att
#pragma unroll
        for (int k = 0; k < LRP / 2; k += 2) {
          const int h = (k / 2) % 2, j = acc_col(k, lane);
          const float c = cm[h];
          if (live[h])
            *reinterpret_cast<uint32_t*>(out.p + (blk * M + m[h]) * LRP + j) =
                tc::pack_bf16(p0[k] * (c * qm_s[j]),
                              p0[k + 1] * (c * qm_s[j + 1]));
        }
      }
      __syncthreads();                 // both warpgroups are done with cn
#pragma unroll
      for (int k = 0; k < LRP / 2; ++k) p0_s[k * NTHREADS + tid] = p0[k];
      fetch_slab(used + S::NOWN);           // ... and with qn: the tile's slab 3
    }
    // ---- LN statistics over [ce; att; ce * att] (not clipped) -----------
    float mean[2], istd[2];
    {
      float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float att[32];
        att_of(att, cm, u);
#pragma unroll
        for (int pr = 0; pr < 16; ++pr) {
          const int h = pr & 1, c = 128 * wg + 64 * u + 8 * (pr >> 1) + cl;
          const float2 c2 = ce_pair(h, c);
          const float a0 = att[2 * pr], a1 = att[2 * pr + 1];
          const float x0 = c2.x * a0, x1 = c2.y * a1;
          sum[h] += (c2.x + c2.y) + (a0 + a1) + (x0 + x1);
          sq[h] += fmaf(c2.x, c2.x, c2.y * c2.y) + fmaf(a0, a0, a1 * a1)
                   + fmaf(x0, x0, x1 * x1);
        }
      }
      tri_row_pair_sums(ex_s, sum, sq, wg, rl, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mean[h] = sum[h] * drop.inv3;
        istd[h] = rsqrtf(sq[h] * drop.inv3 - mean[h] * mean[h]
                         + LN_EPS);
      }
    }
    // ---- pass A: g_yd once, the dropout replay, yd rows out, ggamma /
    // gbeta, the LN backward's row sums, P and Q into the rows' slots (the
    // groups 2, 0, 1: gxh2 waits in registers for P and Q) ----------------
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float att[32], gx2[32];
      att_of(att, cm, u);
      const int base = 128 * wg + 64 * u;
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const int g = (n + 2) % 3;
        float acc[32];
        gyd(acc);
#pragma unroll
        for (int qh = 0; qh < 2; ++qh) {
          float tg[8], tb[8];
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const int q = 4 * qh + qq, c = base + 8 * q + cl;
            const float2 ga = *reinterpret_cast<const float2*>(
                gamma_s + g * D + c);
            const float2 be = *reinterpret_cast<const float2*>(
                beta_s + g * D + c);
            tg[2 * qq] = tg[2 * qq + 1] = tb[2 * qq] = tb[2 * qq + 1] = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 c2 = ce_pair(h, c);
              const uint32_t bits = kw[g][u][h][0] >> (4 * q);
              float y[2], pq[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int k = 4 * q + 2 * h + e;
                const float cv = e ? c2.y : c2.x, a = att[k];
                const float x = g == 0 ? cv : (g == 1 ? a : cv * a);
                const float gam = e ? ga.y : ga.x, bet = e ? be.y : be.x;
                const float xh = (x - mean[h]) * istd[h];
                const float km = !drop.on() ? 1.f
                    : ((bits >> e) & 1u ? drop.scale : 0.f);
                y[e] = (xh * gam + bet) * km;
                const float gy = acc[k] * km;
                tg[2 * qq + e] = fmaf(gy, xh, tg[2 * qq + e]);
                tb[2 * qq + e] += gy;
                const float gxh = gy * gam;
                s1[h] += gxh;
                s2[h] = fmaf(gxh, xh, s2[h]);
                if (g == 2)
                  gx2[k] = gxh;
                else                   // P = gxh0 + gxh2 att, Q = gxh1 + gxh2 ce
                  pq[e] = fmaf(gx2[k], g == 0 ? a : cv, gxh);
              }
              if (live[h]) {
                const size_t r = blk * M + m[h];
                *reinterpret_cast<uint32_t*>(out.yd + r * (3 * D) + g * D
                                             + c) =
                    tc::pack_bf16(y[0], y[1]);
                if (g != 2)
                  *reinterpret_cast<float2*>(
                      (g == 0 ? out.gce_part : out.gcn_part) + r * D + c) =
                      make_float2(pq[0], pq[1]);
              }
            }
          }
          // sums over the eight lanes that hold these columns' other rows
          fold<8>(tg, 16, lane);
          fold<4>(tg, 8, lane);
          fold<2>(tg, 4, lane);
          fold<8>(tb, 16, lane);
          fold<4>(tb, 8, lane);
          fold<2>(tb, 4, lane);
          vg[g][u][qh] += tg[0];
          vb[g][u][qh] += tb[0];
        }
      }
    }
    tri_row_pair_sums(ex_s + 2 * TM * 2, s1, s2, wg, rl, lane);
    // the ring is done with qn's room: qn again, for gcn, then the next
    // tile's first slabs into the ring's own room
    tc_load_rows<D>(qn_s, TM, qn + fbase * D, D, Lr, tid, NTHREADS);
    tc::cp_async_commit();
#pragma unroll
    for (int j = 0; j < S::NOWN; ++j) fetch_slab(used + j);
    // ---- pass B: the LN backward from P and Q, gce rows out, g_att tile --
    const float m1[2] = {s1[0] * drop.inv3, s1[1] * drop.inv3};
    const float m2[2] = {s2[0] * drop.inv3, s2[1] * drop.inv3};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float att[32];
      att_of(att, cm, u);
      const int base = 128 * wg + 64 * u;
#pragma unroll
      for (int pr = 0; pr < 16; ++pr) {
        const int h = pr & 1, c = base + 8 * (pr >> 1) + cl;
        const size_t o = (blk * M + m[h]) * D + c;
        const float2 c2 = ce_pair(h, c);
        float2 P = make_float2(0.f, 0.f), Q = P;
        if (live[h]) {
          P = *reinterpret_cast<const float2*>(out.gce_part + o);
          Q = *reinterpret_cast<const float2*>(out.gcn_part + o);
        }
        float gce[2], gat[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float cv = e ? c2.y : c2.x, a = att[2 * pr + e];
          const float xh0 = (cv - mean[h]) * istd[h];
          const float xh1 = (a - mean[h]) * istd[h];
          const float xh2 = (cv * a - mean[h]) * istd[h];
          gce[e] = istd[h] * ((e ? P.y : P.x) - m1[h] * (1.f + a)
                              - m2[h] * fmaf(xh2, a, xh0));
          gat[e] = istd[h] * ((e ? Q.y : Q.x) - m1[h] * (1.f + cv)
                              - m2[h] * fmaf(xh2, cv, xh1));
        }
        if (live[h])
          *reinterpret_cast<float2*>(out.gce_part + o) =
              make_float2(gce[0], gce[1]);
        *reinterpret_cast<uint32_t*>(ga_s + (c >> 6) * TILE_PANEL
                                     + tc::swz(rl + 8 * h, c & 63)) =
            tc::pack_bf16(gat[0], gat[1]);
      }
    }
    tc::cp_async_wait<S::NOWN>();      // qn (the next tile's slabs fly on)
    tc::fence_async_smem();
    __syncthreads();                   // the g_att tile and qn are whole
    for (int c = tid; c < TM * (D / 8); c += NTHREADS) {  // its rows out
      const int r = c / (D / 8), ch = c % (D / 8);
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(out.ga + (blk * M + m0 + r) * D + ch * 8) =
            *reinterpret_cast<const uint4*>(ga_s + (ch >> 3) * TILE_PANEL
                                            + tc::swz_chunk(r, ch & 7));
    }
    // ---- g_p = g_att qe^T, softmax backward, g_s, gcn rows out ----------
    {
      float gs[LRP / 2];
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int off = (ks / 4) * TILE_PANEL + (ks % 4) * 32;
        tc::mma_ss<LRP, 0, 0>(gs, tc::make_desc(tc::smem_u32(ga_s) + off, 16),
                              tc::make_desc(tc::smem_u32(qe_s) + off, 16),
                              ks > 0);
      }
      tc::commit();
      tc::wait_all();
      float p0[LRP / 2], tot[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < LRP / 2; ++k) {
        const int h = (k / 2) % 2;
        p0[k] = p0_s[k * NTHREADS + tid];
        gs[k] *= cm[h] * qm_s[acc_col(k, lane)];
        tot[h] = fmaf(gs[k], p0[k], tot[h]);
      }
      tot[0] = quad_sum(tot[0]);
      tot[1] = quad_sum(tot[1]);
      const float* graw_row[2] = {nullptr, nullptr};   // the rows' g_raw
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (graw == nullptr || !live[h]) continue;
        if (targets == nullptr)
          graw_row[h] = graw + mrow[h] * Lr;
        else if (m[h] / Lqa == target)
          graw_row[h] = graw + (blk * Lqa + m[h] % Lqa) * Lr;
      }
#pragma unroll
      for (int k = 0; k < LRP / 2; ++k) {
        const int h = (k / 2) % 2, j = acc_col(k, lane);
        float v = p0[k] * (gs[k] - tot[h]) * scale
                  * ((gate >> k) & 1u ? 1.f : 0.f);
        if (graw_row[h] != nullptr && j < Lr) v += graw_row[h][j];
        gs[k] = v;
      }
      if (wg == 0) {                   // g_s rows out, for gqn = g_s^T cn
#pragma unroll
        for (int k = 0; k < LRP / 2; k += 2) {
          const int h = (k / 2) % 2;
          if (live[h])
            *reinterpret_cast<uint32_t*>(out.gs + (blk * M + m[h]) * LRP
                                         + acc_col(k, lane)) =
                tc::pack_bf16(gs[k], gs[k + 1]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float gcn[32];
        tc::fence();
#pragma unroll
        for (int ts = 0; ts < LRP / 16; ++ts) {
          uint32_t a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[r] = tc::pack_bf16(gs[8 * ts + 2 * r], gs[8 * ts + 2 * r + 1]);
          tc::mma_rs<64, 1>(gcn, a,
                            tc::make_desc(tc::smem_u32(qn_s)
                                              + (2 * wg + u) * TILE_PANEL
                                              + ts * 2 * tc::ATOM_BYTES,
                                          TILE_PANEL), ts > 0);
        }
        tc::commit();
        tc::wait_all();
#pragma unroll
        for (int pr = 0; pr < 16; ++pr) {
          const int h = pr & 1;
          const int c = 128 * wg + 64 * u + 8 * (pr >> 1) + cl;
          if (live[h])
            *reinterpret_cast<float2*>(out.gcn_part + (blk * M + m[h]) * D
                                       + c) =
                make_float2(gcn[2 * pr], gcn[2 * pr + 1]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  // ---- the block's parameter-vector partials into its slot --------------
  // after the folds a lane holds, per group, quarter and column half qh,
  // the sum over its warp's rows of column 128 wg + 64 u + 8 (4 qh + 2 b4 +
  // b3) + 2 (lane % 4) + b2
  float* red = reinterpret_cast<float*>(cn_s);        // [4 warps][NVT]
  {
    const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int qh = 0; qh < 2; ++qh) {
          const int c = 128 * wg + 64 * u + 8 * (4 * qh + 2 * b4 + b3) + cl
                        + b2;
          red[warp * NVT + g * D + c] = vg[g][u][qh];
          red[warp * NVT + 3 * D + g * D + c] = vb[g][u][qh];
        }
  }
  __syncthreads();
  for (int k = tid; k < NVT; k += NTHREADS)
    out.vec_part[static_cast<size_t>(blockIdx.x) * NVT + k] =
        ((red[k] + red[NVT + k]) + red[2 * NVT + k]) + red[3 * NVT + k];
}

template <int LRP>
cudaError_t launch_tc_main(const void* cn, const void* ce, const void* qn,
                           const void* qe, const float* cmask,
                           const float* qmask, const float* gamma,
                           const float* beta, const void* W,
                           const void* gmixed, const void* mixed,
                           const float* graw, const int* targets,
                           WideGrads<bf16, bf16> g, int B, int A, int Lqa,
                           int Li, int Lr, float scale, Dropout drop,
                           cudaStream_t stream) {
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  constexpr int smem = AttTcWide<LRP>::SMEM;
  cudaError_t err = allow_smem(qa_ctx_bwd_tc_wide_kernel<LRP>, smem);
  if (err != cudaSuccess) return err;
  const int items = B * Li * ((A * Lqa + TM - 1) / TM), sms = sm_count();
  qa_ctx_bwd_tc_wide_kernel<LRP><<<items < sms ? items : sms, NTHREADS, smem,
                                   stream>>>(
      h(cn), h(ce), h(qn), h(qe), cmask, qmask, gamma, beta, h(W), h(gmixed),
      h(mixed), graw, targets, g, B, A, Lqa, Li, Lr, scale, drop);
  return cudaGetLastError();
}

// The bf16 backward at D = 256: the tensor-core main kernel, then gqn /
// gqe, the weight gradient and the sums over the bf16 rows it wrote.
int launch_tc(const void* cn, const void* ce, const void* qn, const void* qe,
              const float* cmask, const float* qmask, const float* gamma,
              const float* beta, const void* W, const void* gmixed,
              const void* mixed, const float* graw, const int* targets,
              WideGrads<bf16, bf16> g, void* gcn, void* gce, float* gvec,
              float* wg_part, float* gw, int B, int A, int Lqa, int Li,
              int Lr, float scale, Dropout drop, int wg_chunks,
              cudaStream_t stream) {
  g.ld = Lr <= 32 ? 32 : 64;
  const cudaError_t err = Lr <= 32
      ? launch_tc_main<32>(cn, ce, qn, qe, cmask, qmask, gamma, beta, W,
                           gmixed, mixed, graw, targets, g, B, A, Lqa, Li, Lr,
                           scale, drop, stream)
      : launch_tc_main<64>(cn, ce, qn, qe, cmask, qmask, gamma, beta, W,
                           gmixed, mixed, graw, targets, g, B, A, Lqa, Li, Lr,
                           scale, drop, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = B * Li * ((A * Lqa + TM - 1) / TM), sms = sm_count();
  return launch_tail<bf16, bf16, 256>(cn, g, gcn, gce, gvec, wg_part, gw, B,
                                      A, Lqa, Li, Lr, wg_chunks,
                                      items < sms ? items : sms, stream);
}

// ---- the bfloat16 instantiation at D = 64: tensor cores --------------------
//
// qa_ctx_bwd_tc_kernel's arithmetic (qa_ctx_attention_bwd.cu: 64-row tiles,
// every product a wgmma on bf16 operands with float32 sums, the same
// rounding sites) at D = 64, where a warpgroup holds all three LN groups of
// a 64-row tile in 96 accumulators (D = 128's count).  So the two
// warpgroups split rows, not columns (a warpgroup's 32 columns would start
// mid-way in a 128-byte swizzled row, where an MN-major operand cannot
// start): each owns whole items (a frame's 64-row tile, B Li ceil(M / 64)
// of them) and walks them apart from the other, warpgroup w of block b
// taking items 2 b + w, 2 b + w + 2 G, ...  (a persistent grid), so every
// row statistic is a quad sum in registers and no block barrier falls
// between the start and the end.  W (3D x D bf16, 24 KB, read K-major as it
// lies: g_yd = g_out W^T) sits in shared memory for the block's life; each
// warpgroup stages its item's frame (qn, qe, q mask) and the tile's cn, ce
// and g_out (then g_att) in a room of its own, with p0 one private slot a
// thread.  It writes the g_s, p and g_att rows in bf16 for the tensor-core
// gq kernel below and the yd and g_out rows for the weight gradient.
template <int LRP>
struct AttTc64 {
  static constexpr int D = 64;
  static constexpr int TILE = TILE_PANEL;                 // 64 x 64 bf16
  static constexpr int O_W = 0;                           // W, 3D rows
  static constexpr int W = 3 * D * tc::ROW_BYTES;
  // a warpgroup's room: qn, qe, cn, ce, g_out (g_att), p0, q mask
  static constexpr int R_QN = 0;
  static constexpr int R_QE = R_QN + TILE;
  static constexpr int R_CN = R_QE + TILE;
  static constexpr int R_CE = R_CN + TILE;
  static constexpr int R_GO = R_CE + TILE;
  static constexpr int R_P0 = R_GO + TILE;
  static constexpr int R_QM = R_P0 + LRP / 2 * 128 * 4;
  static constexpr int ROOM = (R_QM + TM * 4 + 1023) / 1024 * 1024;
  static constexpr int O_ROOM = O_W + W;                  // two rooms
  static constexpr int O_GB = O_ROOM + 2 * ROOM;          // gamma, beta
  static constexpr int SMEM = O_GB + 6 * D * 4 + tc::ATOM_BYTES;
  static_assert(W % 1024 == 0, "rooms on atoms");
  static_assert(8 * 6 * D * 4 <= 2 * ROOM, "block sums in the rooms");
};

template <int LRP>
__global__ void __launch_bounds__(NTHREADS, 1)
qa_ctx_bwd_tc64_kernel(const bf16* __restrict__ cn,
                       const bf16* __restrict__ ce,
                       const bf16* __restrict__ qn,
                       const bf16* __restrict__ qe,
                       const float* __restrict__ cmask,
                       const float* __restrict__ qmask,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const bf16* __restrict__ W,
                       const bf16* __restrict__ gmixed,
                       const bf16* __restrict__ mixed,
                       const float* __restrict__ graw,
                       const int* __restrict__ targets,
                       WideGrads<bf16, bf16> out, int B, int A, int Lqa,
                       int Li, int Lr, float scale, Dropout drop) {
  using S = AttTc64<LRP>;
  constexpr int D = S::D;
  constexpr int NVT = 6 * D;           // ggamma (3D), gbeta (3D)
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  uint8_t* w_s = sm + S::O_W;
  uint8_t* room = sm + S::O_ROOM + wg * S::ROOM;
  uint8_t* qn_s = room + S::R_QN;
  uint8_t* qe_s = room + S::R_QE;
  uint8_t* cn_s = room + S::R_CN;
  uint8_t* ce_s = room + S::R_CE;
  uint8_t* go_s = room + S::R_GO;      // g_out, then g_att
  float* p0_s = reinterpret_cast<float*>(room + S::R_P0);
  float* qm_s = reinterpret_cast<float*>(room + S::R_QM);
  float* gamma_s = reinterpret_cast<float*>(sm + S::O_GB);
  float* beta_s = gamma_s + 3 * D;
  for (int k = tid; k < 3 * D; k += NTHREADS) {
    gamma_s[k] = gamma[k];
    beta_s[k] = beta[k];
  }
  tc_load_rows<D>(w_s, 3 * D, W, D, 3 * D, tid, NTHREADS);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  tc::fence_async_smem();
  __syncthreads();

  const int M = A * Lqa, ntile = (M + TM - 1) / TM;
  const int items = B * Li * ntile;
  const int rl = 16 * warp + (lane >> 2);
  const int cl = 2 * (lane & 3);       // first column of the lane's pairs
  auto ce_pair = [&](int h, int c) {
    return tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(
        ce_s + tc::swz(rl + 8 * h, c)));
  };
  auto wg_sync = [&]() { tc::bar_sync(1 + wg, 128); };
  float vg[3][2], vb[3][2];
#pragma unroll
  for (int g = 0; g < 3; ++g) vg[g][0] = vg[g][1] = vb[g][0] = vb[g][1] = 0.f;

  for (int item = 2 * blockIdx.x + wg; item < items; item += 2 * gridDim.x) {
    const int bi = item / ntile, m0 = item % ntile * TM;
    const int b = bi / Li, i = bi % Li;
    const int target = targets != nullptr ? targets[b] : -1;
    const size_t blk = bi, fbase = blk * Lr;
    // ---- stage the item: the frame's qn, qe and q mask, the tile's cn and
    // ce rows, g_out = g_mixed * (mixed > 0) -------------------------------
    wg_sync();                         // the warpgroup's previous item is done
    tc_load_rows<D>(qn_s, TM, qn + fbase * D, D, Lr, t, 128);
    tc_load_rows<D>(qe_s, TM, qe + fbase * D, D, Lr, t, 128);
    if (t < TM) qm_s[t] = t < Lr ? qmask[fbase + t] : 0.f;
    const size_t rbase = static_cast<size_t>(b) * M + m0;
    tc_load_rows<D>(cn_s, TM, cn + rbase * D, D, min(TM, M - m0), t, 128);
    tc_load_rows<D>(ce_s, TM, ce + rbase * D, D, min(TM, M - m0), t, 128);
    tc::cp_async_commit();
    for (int c = t; c < TM * (D / 8); c += 128) {
      const int r = c / (D / 8), ch = c % (D / 8), m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) {
        const size_t o = mixed_row(b, m, i, A, Lqa, Li) * D + ch * 8;
        const uint4 mx = __ldg(reinterpret_cast<const uint4*>(mixed + o));
        v = __ldg(reinterpret_cast<const uint4*>(gmixed + o));
        const uint32_t mw[4] = {mx.x, mx.y, mx.z, mx.w};
        uint32_t gw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 mv = tc::unpack_bf16(mw[k]);
          gw[k] &= (mv.x > 0.f ? 0x0000FFFFu : 0u)
                   | (mv.y > 0.f ? 0xFFFF0000u : 0u);
        }
        v = make_uint4(gw[0], gw[1], gw[2], gw[3]);
        *reinterpret_cast<uint4*>(out.gout + (blk * M + m) * D + ch * 8) = v;
      }
      *reinterpret_cast<uint4*>(go_s + tc::swz_chunk(r, ch)) = v;
    }
    tc::cp_async_wait<0>();
    tc::fence_async_smem();
    wg_sync();

    int m[2];
    bool live[2];
    float cm[2];
    size_t mrow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = m0 + rl + 8 * h;
      live[h] = m[h] < M;
      cm[h] = live[h] ? cmask[static_cast<size_t>(b) * M + m[h]] : 0.f;
      mrow[h] = mixed_row(b, live[h] ? m[h] : 0, i, A, Lqa, Li);
    }
    // the dropout's keep bits of the three groups, drawn first, while few
    // registers are live
    uint32_t kw[3][2][1];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      kw[g][0][0] = kw[g][1][0] = ~0u;
      if (drop.on())
        tc_keep_bits<8, true>(
            drop, drop.key3((lane & 1) ? mrow[1] : mrow[0], g, 0), lane,
            kw[g]);
    }
    // ---- recompute: scores, softmax, att, LN statistics ------------------
    uint32_t gate;
    float att[32];
    {
      float sc[LRP / 2], p0[LRP / 2];
      tc_scores<LRP, D>(sc, tc::smem_u32(cn_s), tc::smem_u32(qn_s));
      gate = tc_softmax<LRP>(sc, p0, cm, qm_s, Lr, scale, lane);
#pragma unroll
      for (int k = 0; k < LRP / 2; ++k) p0_s[k * 128 + t] = p0[k];
#pragma unroll
      for (int k = 0; k < LRP / 2; k += 2) {   // p rows out, for gqe
        const int h = (k / 2) % 2, j = acc_col(k, lane);
        const float c = cm[h];
        if (live[h])
          *reinterpret_cast<uint32_t*>(out.p + (blk * M + m[h]) * LRP + j) =
              tc::pack_bf16(p0[k] * (c * qm_s[j]),
                            p0[k + 1] * (c * qm_s[j + 1]));
      }
      tc_att<LRP, 1>(att, p0, cm, qm_s, tc::smem_u32(qe_s), lane);
    }
    float mean[2], istd[2];
    {
      float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
      for (int pr = 0; pr < 16; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        const float2 c2 = ce_pair(h, c);
        const float a0 = att[2 * pr], a1 = att[2 * pr + 1];
        const float x0 = c2.x * a0, x1 = c2.y * a1;
        sum[h] += (c2.x + c2.y) + (a0 + a1) + (x0 + x1);
        sq[h] += fmaf(c2.x, c2.x, c2.y * c2.y) + fmaf(a0, a0, a1 * a1)
                 + fmaf(x0, x0, x1 * x1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mean[h] = quad_sum(sum[h]) * drop.inv3;
        istd[h] = rsqrtf(quad_sum(sq[h]) * drop.inv3 - mean[h] * mean[h]
                         + LN_EPS);
      }
    }
    // ---- g_yd = g_out W^T, the three groups ------------------------------
    float acc[3][32];
    tc::fence();
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        tc::mma_ss<64, 0, 0>(
            acc[g], tc::make_desc(tc::smem_u32(go_s) + ks * 32, 16),
            tc::make_desc(tc::smem_u32(w_s) + g * D * tc::ROW_BYTES + ks * 32,
                          16),
            ks > 0);
    tc::commit();
    tc::wait_all();
    // ---- pass A: dropout replay, yd rows out, ggamma / gbeta, LN sums ---
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int qh = 0; qh < 2; ++qh) {
        float tg[8], tb[8];
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const int q = 4 * qh + qq, c = 8 * q + cl;
          const float2 ga = *reinterpret_cast<const float2*>(
              gamma_s + g * D + c);
          const float2 be = *reinterpret_cast<const float2*>(
              beta_s + g * D + c);
          tg[2 * qq] = tg[2 * qq + 1] = tb[2 * qq] = tb[2 * qq + 1] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 c2 = ce_pair(h, c);
            const uint32_t bits = kw[g][h][0] >> (4 * q);
            float y[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = 4 * q + 2 * h + e;
              const float cv = e ? c2.y : c2.x, a = att[k];
              const float x = g == 0 ? cv : (g == 1 ? a : cv * a);
              const float gam = e ? ga.y : ga.x, bet = e ? be.y : be.x;
              const float xh = (x - mean[h]) * istd[h];
              const float km = !drop.on() ? 1.f
                  : ((bits >> e) & 1u ? drop.scale : 0.f);
              y[e] = (xh * gam + bet) * km;
              const float gy = acc[g][k] * km;
              tg[2 * qq + e] = fmaf(gy, xh, tg[2 * qq + e]);
              tb[2 * qq + e] += gy;
              const float gxh = gy * gam;
              acc[g][k] = gxh;
              s1[h] += gxh;
              s2[h] = fmaf(gxh, xh, s2[h]);
            }
            if (live[h])
              *reinterpret_cast<uint32_t*>(
                  out.yd + (blk * M + m[h]) * (3 * D) + g * D + c) =
                  tc::pack_bf16(y[0], y[1]);
          }
        }
        // sums over the eight lanes that hold these columns' other rows
        fold<8>(tg, 16, lane);
        fold<4>(tg, 8, lane);
        fold<2>(tg, 4, lane);
        fold<8>(tb, 16, lane);
        fold<4>(tb, 8, lane);
        fold<2>(tb, 4, lane);
        vg[g][qh] += tg[0];
        vb[g][qh] += tb[0];
      }
    }
    wg_sync();                         // the products are done with g_out
    // ---- pass B: LN backward, gce rows out, g_att tile (over g_out) ------
    {
      float m1[2], m2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m1[h] = quad_sum(s1[h]) * drop.inv3;
        m2[h] = quad_sum(s2[h]) * drop.inv3;
      }
#pragma unroll
      for (int pr = 0; pr < 16; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        const float2 c2 = ce_pair(h, c);
        float gce[2], gat[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 2 * pr + e;
          const float cv = e ? c2.y : c2.x, a = att[k];
          const float xs[3] = {cv, a, cv * a};
          float gx[3];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const float xh = (xs[g] - mean[h]) * istd[h];
            gx[g] = istd[h] * (acc[g][k] - m1[h] - xh * m2[h]);
          }
          gce[e] = gx[0] + gx[2] * a;
          gat[e] = gx[1] + gx[2] * cv;
        }
        if (live[h])
          *reinterpret_cast<float2*>(out.gce_part + (blk * M + m[h]) * D + c)
              = make_float2(gce[0], gce[1]);
        *reinterpret_cast<uint32_t*>(go_s + tc::swz(rl + 8 * h, c)) =
            tc::pack_bf16(gat[0], gat[1]);
      }
    }
    tc::fence_async_smem();
    wg_sync();                         // the g_att tile is whole
    for (int c = t; c < TM * (D / 8); c += 128) {      // its rows out
      const int r = c / (D / 8), ch = c % (D / 8);
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(out.ga + (blk * M + m0 + r) * D + ch * 8) =
            *reinterpret_cast<const uint4*>(go_s + tc::swz_chunk(r, ch));
    }
    // ---- g_p = g_att qe^T, softmax backward, g_s, gcn rows out ----------
    {
      float gs[LRP / 2];
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        tc::mma_ss<LRP, 0, 0>(gs,
                              tc::make_desc(tc::smem_u32(go_s) + ks * 32, 16),
                              tc::make_desc(tc::smem_u32(qe_s) + ks * 32, 16),
                              ks > 0);
      tc::commit();
      tc::wait_all();
      float p0[LRP / 2], tot[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < LRP / 2; ++k) {
        const int h = (k / 2) % 2;
        p0[k] = p0_s[k * 128 + t];
        gs[k] *= cm[h] * qm_s[acc_col(k, lane)];
        tot[h] = fmaf(gs[k], p0[k], tot[h]);
      }
      tot[0] = quad_sum(tot[0]);
      tot[1] = quad_sum(tot[1]);
      const float* graw_row[2] = {nullptr, nullptr};   // the rows' g_raw
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (graw == nullptr || !live[h]) continue;
        if (targets == nullptr)
          graw_row[h] = graw + mrow[h] * Lr;
        else if (m[h] / Lqa == target)
          graw_row[h] = graw + (blk * Lqa + m[h] % Lqa) * Lr;
      }
#pragma unroll
      for (int k = 0; k < LRP / 2; ++k) {
        const int h = (k / 2) % 2, j = acc_col(k, lane);
        float v = p0[k] * (gs[k] - tot[h]) * scale
                  * ((gate >> k) & 1u ? 1.f : 0.f);
        if (graw_row[h] != nullptr && j < Lr) v += graw_row[h][j];
        gs[k] = v;
      }
#pragma unroll
      for (int k = 0; k < LRP / 2; k += 2) {   // g_s rows out, for gqn
        const int h = (k / 2) % 2;
        if (live[h])
          *reinterpret_cast<uint32_t*>(out.gs + (blk * M + m[h]) * LRP
                                       + acc_col(k, lane)) =
              tc::pack_bf16(gs[k], gs[k + 1]);
      }
      float gcn[32];
      tc::fence();
#pragma unroll
      for (int ts = 0; ts < LRP / 16; ++ts) {
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[r] = tc::pack_bf16(gs[8 * ts + 2 * r], gs[8 * ts + 2 * r + 1]);
        tc::mma_rs<64, 1>(gcn, a,
                          tc::make_desc(tc::smem_u32(qn_s)
                                            + ts * 2 * tc::ATOM_BYTES,
                                        TILE_PANEL), ts > 0);
      }
      tc::commit();
      tc::wait_all();
#pragma unroll
      for (int pr = 0; pr < 16; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        if (live[h])
          *reinterpret_cast<float2*>(out.gcn_part + (blk * M + m[h]) * D + c)
              = make_float2(gcn[2 * pr], gcn[2 * pr + 1]);
      }
    }
  }
  __syncthreads();
  // ---- the block's parameter-vector partials into its slot: after the
  // folds a lane holds, per group and column half qh, the sum over its
  // warp's rows of column 8 (4 qh + 2 b4 + b3) + 2 (lane % 4) + b2; the two
  // warpgroups' warps summed in order ----------------------------------------
  float* red = reinterpret_cast<float*>(sm + S::O_ROOM);   // [8 warps][NVT]
  {
    const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
    const int wp = tid >> 5;
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int qh = 0; qh < 2; ++qh) {
        const int c = 8 * (4 * qh + 2 * b4 + b3) + cl + b2;
        red[wp * NVT + g * D + c] = vg[g][qh];
        red[wp * NVT + 3 * D + g * D + c] = vb[g][qh];
      }
  }
  __syncthreads();
  for (int k = tid; k < NVT; k += NTHREADS) {
    float acc_k = red[k];
    for (int wp = 1; wp < NWARPS; ++wp) acc_k += red[wp * NVT + k];
    out.vec_part[static_cast<size_t>(blockIdx.x) * NVT + k] = acc_k;
  }
}

// gqn[j] = sum_m g_s[m, j] cn[m], gqe[j] = sum_m p[m, j] g_att[m] for one
// (b, frame) at D = 64: the frame's M rows of g_s, p (LRP wide) and g_att as
// the main kernel wrote them, and cn, through two stages of 64 rows; the
// products' left operands read as they lie (rows = depth).  Warpgroup 0
// takes gqn, warpgroup 1 gqe, each a 64 x 64 accumulator (all D columns):
// the operands' addresses, not a branch, choose the product.
constexpr int GQ64_STAGE = 4 * TILE_PANEL;       // g_s, p, g_att, cn
constexpr int GQ64_SMEM = 2 * GQ64_STAGE + tc::ATOM_BYTES;

__global__ void __launch_bounds__(NTHREADS, 2)
qa_ctx_gq_tc64_kernel(const bf16* __restrict__ gs, const bf16* __restrict__ p,
                      const bf16* __restrict__ ga, const bf16* __restrict__ cn,
                      bf16* __restrict__ gqn, bf16* __restrict__ gqe, int M,
                      int Li, int Lr, int lrp) {
  constexpr int D = 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int i = blockIdx.x, b = blockIdx.y;
  const size_t blk = static_cast<size_t>(b) * Li + i;
  const int steps = (M + TM - 1) / TM;
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;

  auto load = [&](int step) {
    uint8_t* st = sm + (step & 1) * GQ64_STAGE;
    const int m0 = step * TM, rows = min(TM, M - m0);
    const size_t r0 = blk * M + m0;
    tc_load_panel(st, gs + r0 * lrp, lrp, rows, lrp / 8, tid, NTHREADS);
    tc_load_panel(st + TILE_PANEL, p + r0 * lrp, lrp, rows, lrp / 8, tid,
                  NTHREADS);
    tc_load_rows<D>(st + 2 * TILE_PANEL, TM, ga + r0 * D, D, rows, tid,
                    NTHREADS);
    tc_load_rows<D>(st + 3 * TILE_PANEL, TM,
                    cn + (static_cast<size_t>(b) * M + m0) * D, D, rows, tid,
                    NTHREADS);
    tc::cp_async_commit();
  };
  load(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      load(step + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_async_smem();
    __syncthreads();
    // warpgroup 0: g_s^T cn; warpgroup 1: p^T g_att
    const uint32_t st = tc::smem_u32(sm + (step & 1) * GQ64_STAGE);
    const uint32_t a = st + wg * TILE_PANEL;
    const uint32_t bm = st + (3 - wg) * TILE_PANEL;
    tc::fence();
#pragma unroll
    for (int ks = 0; ks < TM / 16; ++ks) {
      const int off = ks * 2 * tc::ATOM_BYTES;
      tc::mma_ss<64, 1, 1>(acc, tc::make_desc(a + off, TILE_PANEL),
                           tc::make_desc(bm + off, TILE_PANEL), 1);
    }
    tc::commit();
    tc::wait_all();
    __syncthreads();                   // the stage is free for step + 2
  }
  bf16* dst = wg ? gqe : gqn;
  const int rl = 16 * warp + (lane >> 2);
#pragma unroll
  for (int pr = 0; pr < 16; ++pr) {
    const int j = rl + 8 * (pr & 1);
    const int c = 8 * (pr >> 1) + 2 * (lane & 3);
    if (j < Lr)
      *reinterpret_cast<uint32_t*>(dst + (blk * Lr + j) * D + c) =
          tc::pack_bf16(acc[2 * pr], acc[2 * pr + 1]);
  }
}

template <int LRP>
cudaError_t launch_tc64_main(const void* cn, const void* ce, const void* qn,
                             const void* qe, const float* cmask,
                             const float* qmask, const float* gamma,
                             const float* beta, const void* W,
                             const void* gmixed, const void* mixed,
                             const float* graw, const int* targets,
                             WideGrads<bf16, bf16> g, int blocks, int B,
                             int A, int Lqa, int Li, int Lr, float scale,
                             Dropout drop, cudaStream_t stream) {
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  constexpr int smem = AttTc64<LRP>::SMEM;
  cudaError_t err = allow_smem(qa_ctx_bwd_tc64_kernel<LRP>, smem);
  if (err != cudaSuccess) return err;
  qa_ctx_bwd_tc64_kernel<LRP><<<blocks, NTHREADS, smem, stream>>>(
      h(cn), h(ce), h(qn), h(qe), cmask, qmask, gamma, beta, h(W), h(gmixed),
      h(mixed), graw, targets, g, B, A, Lqa, Li, Lr, scale, drop);
  return cudaGetLastError();
}

// The bf16 backward at D = 64: the tensor-core main kernel, the tensor-core
// gqn / gqe kernel, then the weight gradient and the sums over the bf16 rows
// they wrote.
int launch_tc64(const void* cn, const void* ce, const void* qn,
                const void* qe, const float* cmask, const float* qmask,
                const float* gamma, const float* beta, const void* W,
                const void* gmixed, const void* mixed, const float* graw,
                const int* targets, WideGrads<bf16, bf16> g, void* gcn,
                void* gce, float* gvec, float* wg_part, float* gw, int B,
                int A, int Lqa, int Li, int Lr, float scale, Dropout drop,
                int wg_chunks, cudaStream_t stream) {
  g.ld = Lr <= 32 ? 32 : 64;
  const int M = A * Lqa;
  const int items = B * Li * ((M + TM - 1) / TM), sms = sm_count();
  const int blocks = (items + 1) / 2 < sms ? (items + 1) / 2 : sms;
  cudaError_t err = Lr <= 32
      ? launch_tc64_main<32>(cn, ce, qn, qe, cmask, qmask, gamma, beta, W,
                             gmixed, mixed, graw, targets, g, blocks, B, A,
                             Lqa, Li, Lr, scale, drop, stream)
      : launch_tc64_main<64>(cn, ce, qn, qe, cmask, qmask, gamma, beta, W,
                             gmixed, mixed, graw, targets, g, blocks, B, A,
                             Lqa, Li, Lr, scale, drop, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = allow_smem(qa_ctx_gq_tc64_kernel, GQ64_SMEM)) != cudaSuccess)
    return static_cast<int>(err);
  qa_ctx_gq_tc64_kernel<<<dim3(Li, B), NTHREADS, GQ64_SMEM, stream>>>(
      g.gs, g.p, g.ga, static_cast<const bf16*>(cn), g.gqn, g.gqe, M, Li, Lr,
      g.ld);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return launch_sums<bf16, bf16, 64>(g, gcn, gce, gvec, wg_part, gw, B, A,
                                     Lqa, Li, wg_chunks, blocks, stream);
}

}  // namespace

// As qa_ctx_attention_bwd (qa_ctx_attention_bwd.cu) at width D = 64 or 256:
// inputs as qa_ctx_attention_fwd, plus Wt = W^T (D, 3D) float32 (when
// is_bf16: W itself, (3D, D) bf16), g_mixed and the saved mixed (B, A, Li,
// Lqa, D) in the activation type, and g_raw float32 or NULL ((B, A, Li,
// Lqa, Lr) when targets is NULL, else (B, Li, Lqa, Lr) at targets[b]).
// Outputs: gcn, gce (B, A, Lqa, D) and gqn, gqe (B, Li, Lr, D) in the
// activation type; gvec = [ggamma (3D); gbeta (3D); gb (D)] and gw (3D, D)
// float32, or when is_bf16 gvec without gb and gw with 3D + 1 rows, the
// last gb.  Scratch (the wrapper's): gcn_part, gce_part (B, Li, A*Lqa, D)
// float32; yd (B*Li*A*Lqa, 3D) and gout (B*Li*A*Lqa, D) in the activation
// type; vec_part (B*Li, 7D, or when is_bf16 6D a slot for each block of
// the persistent grid, at most B*Li*ceil(A*Lqa / 64)) and wg_part
// (wg_chunks, 3D (+ 1), D) float32; gs_rows, p_rows (B*Li*A*Lqa,
// round4(Lr)) and ga_rows (B*Li*A*Lqa, D) float32, or when is_bf16 bf16
// with gs_rows and p_rows 32 wide (Lr <= 32) or 64.  Lr <= 64; any other D
// is refused.
// dv: the true width, 4 <= dv <= D with 4 | dv, of inputs zero-padded to D
// (every LN's statistics and the Philox keys, philox.cuh).
extern "C" int qa_ctx_attention_bwd_wide(
    const void* cn, const void* ce, const void* qn, const void* qe,
    const void* cmask, const void* qmask, const void* gamma,
    const void* beta, const void* Wt, const void* gmixed, const void* mixed,
    const void* graw, const void* targets, void* gcn, void* gce, void* gqn,
    void* gqe, void* gvec, void* gw, void* gcn_part, void* gce_part,
    void* yd, void* gout, void* vec_part, void* wg_part, void* gs_rows,
    void* p_rows, void* ga_rows, int B, int A, int Lqa, int Li, int Lr,
    int d, float scale, const unsigned long long* drop_seed,
    unsigned drop_threshold, float drop_scale, int wg_chunks, int dv,
    int is_bf16, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  if (Lr > MAX_LR || Lr < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop =
      entry_dropout(drop_seed, drop_threshold, drop_scale, dv);
  if (!width_ok(dv, d)) return static_cast<int>(cudaErrorInvalidValue);
  const int* tg = static_cast<const int*>(targets);
#define TVQA_ATT_WIDE(DD)                                                  \
  {                                                                        \
    const WideGrads<float, float> g{                                       \
        fm(gqn), fm(gqe), fm(gcn_part), fm(gce_part), fm(yd), fm(gout),    \
        fm(vec_part), fm(gs_rows), fm(p_rows), fm(ga_rows), round4(Lr)};   \
    return launch<DD>(cn, ce, qn, qe, f(cmask), f(qmask), f(gamma),        \
                      f(beta), f(Wt), gmixed, mixed, f(graw), tg, g, gcn,  \
                      gce, fm(gvec), fm(wg_part), fm(gw), B, A, Lqa, Li,   \
                      Lr, scale, drop, wg_chunks, s);                      \
  }
  if (is_bf16 && (d == 64 || d == 256)) {
    auto hm = [](void* p) { return static_cast<bf16*>(p); };
    const WideGrads<bf16, bf16> g{
        hm(gqn), hm(gqe), fm(gcn_part), fm(gce_part), hm(yd), hm(gout),
        fm(vec_part), hm(gs_rows), hm(p_rows), hm(ga_rows), 0};
    return (d == 64 ? launch_tc64 : launch_tc)(
        cn, ce, qn, qe, f(cmask), f(qmask), f(gamma), f(beta), Wt, gmixed,
        mixed, f(graw), tg, g, gcn, gce, fm(gvec), fm(wg_part), fm(gw), B, A,
        Lqa, Li, Lr, scale, drop, wg_chunks, s);
  }
  if (d == 64) TVQA_ATT_WIDE(64)
  if (d == 256) TVQA_ATT_WIDE(256)
#undef TVQA_ATT_WIDE
  return static_cast<int>(cudaErrorInvalidValue);
}
