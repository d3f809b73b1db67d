// Fused QA-context attention, backward, at the hidden width D = 128 (D =
// 64 and 256: qa_ctx_attention_bwd_wide.cu).
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_attention.py
// (_pallas_backward / _bwd_kernel).  Per (b, frame i) it recomputes the
// forward from the kernel inputs (scores, softmax, att, the LayerNorm
// statistics and the replayed Philox dropout mask) except the projection
// output: the ReLU sign comes from the SAVED `mixed` (mixed > 0 <=> out > 0,
// exact in bf16 too).  With g_out = g_mixed * (mixed > 0) and
// yd = dropout(LN([ce; att; ce * att])):
//   gb = sum g_out, gW = yd^T g_out, g_yd = g_out W^T, g_y = g_yd * keep
//   ggamma = sum g_y xhat, gbeta = sum g_y, gx = LN backward over the
//   virtual 3D concat, gce = gx0 + gx2 att (summed over frames),
//   g_att = gx1 + gx2 ce, g_p = g_att qe^T, gqe = p^T g_att,
//   g_s = scale * gate * softmax_bwd(g_p * mask) (+ g_raw on the rows the
//   forward wrote raw for), gcn = g_s qn (summed over frames), gqn = g_s^T cn
// gcn/gce/gqn/gqe come out in the activation type, the parameter grads in
// float32.  A fully masked row has p = 0 and a zero softmax gradient, never
// NaN.
//
// What bounds it on the H100: at the headline train shapes (vid site) it
// reads ~110 MB and does ~38 GFLOP (scores and att recompute, g_yd, gW,
// g_p, gqe, gcn, gqn), so at the card's peaks (3.35 TB/s, 989 TF/s bf16) the
// operations bound it (~38 us).  The tensor-core path below is bound by
// neither: its register passes (LN backward, Philox replay, softmax
// backward) run on 8 warps an SM at 255 registers a thread, and it moves
// ~0.5 GB of scratch.
//
// Two instantiations.
// * bfloat16 (what the main paths run), four kernels and three fixed-order
//   sums, every product a wgmma on bf16 operands with float32 sums, rounded
//   where the TPU kernel's bf16 compute mode rounds (g_out, yd, W, g_att, p,
//   g_s, cn, qn, qe before their products):
//   - qa_ctx_bwd_tc_kernel, one block per (b, i), W (bf16, 96 KB, read
//     K-major as it lies: g_yd = g_out W^T) and the frame's qn / qe in
//     shared memory for the block's life.  The LN backward needs a row's
//     three 128-wide groups at once (192 accumulator registers for a
//     64-row tile), so the two warpgroups SHARE each 64-row tile and split
//     the columns: warpgroup h owns columns [64 h, 64 h + 64) of ce, att,
//     every LN group, g_att, gce and gcn (96 accumulators a thread), and a
//     thread holds gx0, gx1, gx2 of the same (row, column).  Row statistics
//     cross the warpgroups through shared memory (two block barriers);
//     scores, softmax and its backward are computed by both (cheap, full
//     rows).  p0 waits in shared memory between the recompute and the
//     softmax backward, one private slot a thread.  ggamma / gbeta: each
//     lane folds its columns' sums over the 8 lanes that hold the other
//     rows with a halving exchange (7 shuffles for 8 values) and keeps 12
//     running sums.  The Philox keep bits are drawn at the start of a tile
//     through a call (qa_ctx_attention.cuh).  Shared memory: 219,392 bytes.
//   - qa_ctx_gq_tc_kernel: gqn = g_s^T cn, gqe = p^T g_att per (b, i) from
//     the bf16 g_s, p, g_att rows the main kernel wrote (their two 64 x 128
//     accumulators do not fit beside the 96 above without spilling: in the
//     main kernel they cost 0.3-0.5 ms, here 0.04-0.06).
//   - wgrad_tc_kernel (wgrad_tc.cuh, shared with the tri bridge and the
//     encoder): gW = yd^T g_out and gb over row chunks from the bf16 yd /
//     g_out rows, slots summed in a fixed order.
//   Scratch: yd, g_out, g_att, g_s, p rows in bf16 (123 + 41 + 41 + 2 x
//   10-20 MB at the headline shapes) and the float32 gcn / gce slots per
//   frame (82 MB each).  A block walks one frame: summing gcn / gce over
//   several frames in a block would need their 64 x 128 accumulators
//   resident too.
// * float32: the exactness check; CUDA cores, one block per (b, i), 32-row
//   tiles, each warp 4 rows; W^T staged from L2 three times per tile; yd and
//   g_out rows in float32 for grad_reduce.cuh's weight-gradient GEMM.
// Sums across blocks go through scratch slots and a fixed-order second pass
// (grad_reduce.cuh) in both: the same bits from run to run, no atomics.
#include "grad_reduce.cuh"
#include "philox.cuh"
#include "qa_ctx_attention.cuh"
#include "wgrad_tc.cuh"

namespace {

using namespace tvqa;

constexpr int RPT = 4;
constexpr int RT = RPT * NWARPS;        // 32 rows per tile
constexpr int MAX_LR = 64;
constexpr int JPW = MAX_LR / NWARPS;    // gqn/gqe rows per warp
constexpr int NV = 7 * D;               // ggamma (3D), gbeta (3D), gb (D)

struct Layout {
  int qn, qe, qm, p, gt, gs, cn, ce, a, ga, go, st, w, total;
  __host__ __device__ explicit Layout(int lr) {
    const int lrp = round4(lr);
    qn = 0;
    qe = qn + lr * QS;
    qm = round4(qe + lr * QS);
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

struct Grads {
  void* gqn;
  void* gqe;
  float* gcn_part;                     // (B, Li, M, D)
  float* gce_part;
  float* yd;                           // (B*Li*M, 3D)
  float* gout;                         // (B*Li*M, D)
  float* vec_part;                     // (B*Li, NV)
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
qa_ctx_bwd_kernel(const T* __restrict__ cn, const T* __restrict__ ce,
                  const T* __restrict__ qn, const T* __restrict__ qe,
                  const float* __restrict__ cmask,
                  const float* __restrict__ qmask,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta,
                  const float* __restrict__ Wt,
                  const T* __restrict__ gmixed, const T* __restrict__ mixed,
                  const float* __restrict__ graw,
                  const int* __restrict__ targets, Grads out, int A, int Lqa,
                  int Li, int Lr, float scale, Dropout drop) {
  drop.load_seed();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout lay(Lr);
  float* qn_s = smem + lay.qn;
  float* qe_s = smem + lay.qe;
  float* qm_s = smem + lay.qm;
  float* p_s = smem + lay.p;           // p0, then p = p0 * mask
  float* gt_s = smem + lay.gt;         // softmax-floor gate
  float* gs_s = smem + lay.gs;         // p, then g_s
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
  const int c0 = lane * 4;
  const int target = targets != nullptr ? targets[b] : -1;
  const size_t blk = static_cast<size_t>(b) * Li + i;

  const size_t fbase = blk * Lr;
  for (int idx = tid; idx < Lr * D; idx += NTHREADS) {
    const int j = idx / D, d = idx % D;
    qn_s[j * QS + d] = to_f(qn[fbase * D + idx]);
    qe_s[j * QS + d] = to_f(qe[fbase * D + idx]);
  }
  for (int j = tid; j < Lr; j += NTHREADS) qm_s[j] = qmask[fbase + j];

  float vg[3][4], vb[3][4], vgb[4];
  float gqn_acc[JPW][4], gqe_acc[JPW][4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    vgb[t] = 0.f;
#pragma unroll
    for (int g = 0; g < 3; ++g) vg[g][t] = vb[g][t] = 0.f;
#pragma unroll
    for (int jj = 0; jj < JPW; ++jj) gqn_acc[jj][t] = gqe_acc[jj][t] = 0.f;
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
        c = to_f(cn[row * D + d]);
        e = to_f(ce[row * D + d]);
        const size_t mrow = mixed_row(b, m, i, A, Lqa, Li);
        go = to_f(mixed[mrow * D + d]) > 0.f ? to_f(gmixed[mrow * D + d])
                                             : 0.f;
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
      const AttnRow sc = attn_scores(cn_s + r * D, qn_s, qm_s, cm, Lr, scale,
                                     lane);
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
      float at[4];
      attn_apply(gs_s + r * lrp, qe_s, Lr, lane, at);
      float x[3][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float c = ce_s[r * D + lane + 32 * q];
        a_s[r * D + lane + 32 * q] = at[q];
        x[0][q] = c;
        x[1][q] = at[q];
        x[2][q] = c * at[q];
      }
      float mean, istd;
      ln3_stats(x, mean, istd, drop.inv3);
      if (lane == 0) {
        st_s[2 * r] = mean;
        st_s[2 * r + 1] = istd;
      }
    }
    // ---- g_yd = g_out W^T, three 128-column groups ----------------------
    float acc3[3][RPT][4];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      gemm_staged_ld<RPT>(acc3[g], go_s, D, D, Wt + g * D, 3 * D, w_s,
                          warp * RPT, c0);
    // ---- per row: dropout replay, LN backward, softmax backward --------
#pragma unroll
    for (int jj = 0; jj < RPT; ++jj) {
      const int r = warp * RPT + jj, m = m0 + r;
      if (r >= rows) break;
      const float mean = st_s[2 * r], istd = st_s[2 * r + 1];
      const float4 ce4 = *reinterpret_cast<const float4*>(ce_s + r * D + c0);
      const float4 a4 = *reinterpret_cast<const float4*>(a_s + r * D + c0);
      const float4 go4 = *reinterpret_cast<const float4*>(go_s + r * D + c0);
      const float cev[4] = {ce4.x, ce4.y, ce4.z, ce4.w};
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      vgb[0] += go4.x;
      vgb[1] += go4.y;
      vgb[2] += go4.z;
      vgb[3] += go4.w;
      const unsigned long long er = mixed_row(b, m, i, A, Lqa, Li);
      const size_t yrow = (blk * M + m) * (3 * D);
      float xh[3][4], gxh[3][4], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float km[4] = {1.f, 1.f, 1.f, 1.f};
        if (drop.on())
          keep4(drop.seed, drop.key3(er, g, c0), drop.threshold,
                drop.scale, km);
        float yd[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int k = g * D + c0 + t;
          const float x = g == 0 ? cev[t] : (g == 1 ? av[t] : cev[t] * av[t]);
          xh[g][t] = (x - mean) * istd;
          yd[t] = (xh[g][t] * gamma[k] + beta[k]) * km[t];
          const float gy = acc3[g][jj][t] * km[t];
          vg[g][t] = fmaf(gy, xh[g][t], vg[g][t]);
          vb[g][t] += gy;
          gxh[g][t] = gy * gamma[k];
          s1 += gxh[g][t];
          s2 = fmaf(gxh[g][t], xh[g][t], s2);
        }
        *reinterpret_cast<float4*>(out.yd + yrow + g * D + c0) =
            make_float4(yd[0], yd[1], yd[2], yd[3]);
      }
      const float m1 = warp_sum(s1) * drop.inv3;
      const float m2 = warp_sum(s2) * drop.inv3;
      float gce[4], gat[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float gx[3];
#pragma unroll
        for (int g = 0; g < 3; ++g)
          gx[g] = istd * (gxh[g][t] - m1 - xh[g][t] * m2);
        gce[t] = gx[0] + gx[2] * av[t];
        gat[t] = gx[1] + gx[2] * cev[t];
      }
      *reinterpret_cast<float4*>(out.gce_part + (blk * M + m) * D + c0) =
          make_float4(gce[0], gce[1], gce[2], gce[3]);
      *reinterpret_cast<float4*>(ga_s + r * D + c0) =
          make_float4(gat[0], gat[1], gat[2], gat[3]);
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
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        if (j < Lr) {
          float gsv = p0[h] * (gp[h] - tot) * scale * gt_s[r * lrp + j];
          if (has_raw) gsv += graw_row[j];
          gs_s[r * lrp + j] = gsv;
          p_s[r * lrp + j] = p0[h] * sm[h];
        }
      }
      __syncwarp();
      // gcn row: g_s qn
      float gc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < Lr; ++j) {
        const float gsv = gs_s[r * lrp + j];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gc[q] = fmaf(gsv, qn_s[j * QS + lane + 32 * q], gc[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        out.gcn_part[(blk * M + m) * D + lane + 32 * q] = gc[q];
    }
    __syncthreads();
    // ---- gqn += g_s^T cn, gqe += p^T g_att over the tile's rows ---------
    for (int r = 0; r < rows; ++r) {
      const float4 c4 = *reinterpret_cast<const float4*>(cn_s + r * D + c0);
      const float4 g4 = *reinterpret_cast<const float4*>(ga_s + r * D + c0);
#pragma unroll
      for (int jj = 0; jj < JPW; ++jj) {
        const int j = warp + NWARPS * jj;
        if (j >= Lr) break;
        const float gsv = gs_s[r * lrp + j], pv = p_s[r * lrp + j];
        gqn_acc[jj][0] = fmaf(gsv, c4.x, gqn_acc[jj][0]);
        gqn_acc[jj][1] = fmaf(gsv, c4.y, gqn_acc[jj][1]);
        gqn_acc[jj][2] = fmaf(gsv, c4.z, gqn_acc[jj][2]);
        gqn_acc[jj][3] = fmaf(gsv, c4.w, gqn_acc[jj][3]);
        gqe_acc[jj][0] = fmaf(pv, g4.x, gqe_acc[jj][0]);
        gqe_acc[jj][1] = fmaf(pv, g4.y, gqe_acc[jj][1]);
        gqe_acc[jj][2] = fmaf(pv, g4.z, gqe_acc[jj][2]);
        gqe_acc[jj][3] = fmaf(pv, g4.w, gqe_acc[jj][3]);
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < JPW; ++jj) {
    const int j = warp + NWARPS * jj;
    if (j >= Lr) break;
    const size_t o = (fbase + j) * D + c0;
    store4<T>(static_cast<T*>(out.gqn) + o, gqn_acc[jj][0], gqn_acc[jj][1],
              gqn_acc[jj][2], gqn_acc[jj][3]);
    store4<T>(static_cast<T*>(out.gqe) + o, gqe_acc[jj][0], gqe_acc[jj][1],
              gqe_acc[jj][2], gqe_acc[jj][3]);
  }
  // the block's parameter-vector partials, summed over warps in order
  __syncthreads();
  float* red = cn_s;                   // NWARPS x NV floats (tiles are done)
#pragma unroll
  for (int t = 0; t < 4; ++t) {
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

template <typename T>
int launch(const void* cn, const void* ce, const void* qn, const void* qe,
           const float* cmask, const float* qmask, const float* gamma,
           const float* beta, const float* Wt, const void* gmixed,
           const void* mixed, const float* graw, const int* targets,
           Grads g, void* gcn, void* gce, float* gvec, float* wg_part,
           float* gw, int B, int A, int Lqa, int Li, int Lr, float scale,
           Dropout drop, int wg_chunks, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * Layout(Lr).total;
  cudaError_t err = allow_smem(qa_ctx_bwd_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  qa_ctx_bwd_kernel<T><<<dim3(Li, B), NTHREADS, bytes, stream>>>(
      static_cast<const T*>(cn), static_cast<const T*>(ce),
      static_cast<const T*>(qn), static_cast<const T*>(qe), cmask, qmask,
      gamma, beta, Wt, static_cast<const T*>(gmixed),
      static_cast<const T*>(mixed), graw, targets, g, A, Lqa, Li, Lr, scale,
      drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = A * Lqa;
  const long long rows = static_cast<long long>(B) * Li * M;
  if ((err = wgrad(g.yd, g.gout, wg_part, gw, rows, 3 * D, D, wg_chunks,
                   stream)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = sum_slots<float>(g.vec_part, gvec, 1, B * Li, NV, stream))
      != cudaSuccess)
    return static_cast<int>(err);
  if ((err = sum_slots<T>(g.gcn_part, static_cast<T*>(gcn), B, Li,
                          static_cast<long long>(M) * D, stream))
      != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(sum_slots<T>(g.gce_part, static_cast<T*>(gce), B,
                                       Li, static_cast<long long>(M) * D,
                                       stream));
}


// ---- the bfloat16 instantiation: tensor cores ------------------------------

struct TcGrads {
  __nv_bfloat16* gqn;
  __nv_bfloat16* gqe;
  float* gcn_part;                     // (B, Li, M, D)
  float* gce_part;
  __nv_bfloat16* yd;                   // (B*Li*M, 3D)
  __nv_bfloat16* gout;                 // (B*Li*M, D)
  float* vec_part;                     // (B*Li, 6D): ggamma, gbeta
  __nv_bfloat16* gs;                   // (B*Li*M, LRP): g_s
  __nv_bfloat16* p;                    // (B*Li*M, LRP): p
  __nv_bfloat16* ga;                   // (B*Li*M, D): g_att
};

// shared memory of the main kernel, bytes from the 1024-aligned base
constexpr int O_QN = W_BYTES;
constexpr int O_QE = O_QN + TILE_BYTES;
constexpr int O_CN = O_QE + TILE_BYTES;
constexpr int O_GO = O_CN + TILE_BYTES;             // g_out, then g_att
constexpr int O_CE = O_GO + TILE_BYTES;             // the tile's ce rows
constexpr int O_P0 = O_CE + TILE_BYTES;             // p0, a thread's own
constexpr int O_EX = O_P0 + 32 * NTHREADS * 4;      // row sums between WGs
constexpr int O_QM = O_EX + 2 * 2 * TM * 2 * 4;
constexpr int O_GB = O_QM + TM * 4;                 // gamma, beta (float32)
constexpr int TC_SMEM = O_GB + 6 * D * 4 + tc::ATOM_BYTES;
constexpr int NVT = 6 * D;             // ggamma (3D), gbeta (3D)

// One block per (b, frame i); its two warpgroups share each 64-row tile and
// warpgroup h owns columns [64 h, 64 h + 64) of every D-wide quantity, so a
// thread holds the three LN groups of the same (row, column).
template <int LRP>
__global__ void __launch_bounds__(NTHREADS, 1)
qa_ctx_bwd_tc_kernel(const __nv_bfloat16* __restrict__ cn,
                     const __nv_bfloat16* __restrict__ ce,
                     const __nv_bfloat16* __restrict__ qn,
                     const __nv_bfloat16* __restrict__ qe,
                     const float* __restrict__ cmask,
                     const float* __restrict__ qmask,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const __nv_bfloat16* __restrict__ W,
                     const __nv_bfloat16* __restrict__ gmixed,
                     const __nv_bfloat16* __restrict__ mixed,
                     const float* __restrict__ graw,
                     const int* __restrict__ targets, TcGrads out, int A,
                     int Lqa, int Li, int Lr, float scale, Dropout drop) {
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  uint8_t* w_s = sm;
  uint8_t* qn_s = sm + O_QN;
  uint8_t* qe_s = sm + O_QE;
  uint8_t* cn_s = sm + O_CN;
  uint8_t* go_s = sm + O_GO;
  float* p0_s = reinterpret_cast<float*>(sm + O_P0);
  float* ex_s = reinterpret_cast<float*>(sm + O_EX);  // [2][wg][row][2]
  float* qm_s = reinterpret_cast<float*>(sm + O_QM);
  float* gamma_s = reinterpret_cast<float*>(sm + O_GB);
  float* beta_s = gamma_s + 3 * D;
  uint8_t* ce_s = sm + O_CE;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int i = blockIdx.x, b = blockIdx.y;
  const int M = A * Lqa;
  const int target = targets != nullptr ? targets[b] : -1;
  const size_t blk = static_cast<size_t>(b) * Li + i;
  const size_t fbase = blk * Lr;
  for (int k = tid; k < 3 * D; k += NTHREADS) {
    gamma_s[k] = gamma[k];
    beta_s[k] = beta[k];
  }
  tc_load_frame(w_s, qn_s, qe_s, qm_s, W, qn, qe, qmask, fbase, Lr);

  const int rl = 16 * warp + (lane >> 2);
  const int cl = 2 * (lane & 3);       // first column of the lane's pairs
  // the lane's ce pair at (row half h, column c) of the staged tile
  auto ce_pair = [&](int h, int c) {
    return tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(
        ce_s + (c >> 6) * TILE_PANEL + tc::swz(rl + 8 * h, c & 63)));
  };
  const int half = 64 * wg;
  float vg[3][2], vb[3][2];
#pragma unroll
  for (int g = 0; g < 3; ++g) vg[g][0] = vg[g][1] = vb[g][0] = vb[g][1] = 0.f;

  for (int m0 = 0; m0 < M; m0 += TM) {
    // ---- stage the tile: cn rows, g_out = g_mixed * (mixed > 0) ---------
    __syncthreads();                   // the previous tile is consumed
    tc_load_rows(cn_s, TM, cn + (static_cast<size_t>(b) * M + m0) * D, D,
                 min(TM, M - m0), tid, NTHREADS);
    tc_load_rows(ce_s, TM, ce + (static_cast<size_t>(b) * M + m0) * D, D,
                 min(TM, M - m0), tid, NTHREADS);
    tc::cp_async_commit();
    for (int c = tid; c < TM * 16; c += NTHREADS) {
      const int r = c >> 4, ch = c & 15, m = m0 + r;
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
    tc::cp_async_wait<0>();
    tc::fence_async_smem();
    __syncthreads();

    // ---- recompute: scores, softmax, att (own columns), LN statistics ---
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
            drop, drop.key3((lane & 1) ? mrow[1] : mrow[0], g, half), lane,
            kw[g]);
    }
    uint32_t gate;
    float att[32];
    {
      float s[LRP / 2], p0[LRP / 2];
      tc_scores<LRP>(s, tc::smem_u32(cn_s), tc::smem_u32(qn_s));
      gate = tc_softmax<LRP>(s, p0, cm, qm_s, Lr, scale, lane);
#pragma unroll
      for (int k = 0; k < LRP / 2; ++k) p0_s[k * NTHREADS + tid] = p0[k];
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
      tc_att<LRP, 1>(att, p0, cm, qm_s,
                     tc::smem_u32(qe_s) + wg * TILE_PANEL, lane);
    }
    float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
    for (int pr = 0; pr < 16; ++pr) {
      const int h = pr & 1, c = half + 8 * (pr >> 1) + cl;
      const float2 c2 = ce_pair(h, c);
      const float a0 = att[2 * pr], a1 = att[2 * pr + 1];
      const float x0 = c2.x * a0, x1 = c2.y * a1;
      sum[h] += (c2.x + c2.y) + (a0 + a1) + (x0 + x1);
      sq[h] += fmaf(c2.x, c2.x, c2.y * c2.y) + fmaf(a0, a0, a1 * a1)
               + fmaf(x0, x0, x1 * x1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] = quad_sum(sum[h]);
      sq[h] = quad_sum(sq[h]);
      if ((lane & 3) == 0) {
        ex_s[(wg * TM + rl + 8 * h) * 2] = sum[h];
        ex_s[(wg * TM + rl + 8 * h) * 2 + 1] = sq[h];
      }
    }
    // ---- g_yd = g_out W^T on the own columns of the three groups --------
    float acc[3][32];
    tc::fence();
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        tc::mma_ss<64, 0, 0>(
            acc[g],
            tc::make_desc(tc::smem_u32(go_s) + (ks / 4) * TILE_PANEL
                              + (ks % 4) * 32, 16),
            tc::make_desc(tc::smem_u32(w_s) + (ks / 4) * W_PANEL
                              + (g * D + half) * tc::ROW_BYTES
                              + (ks % 4) * 32, 16),
            ks > 0);
    tc::commit();
    __syncthreads();                   // the LN sums of both halves
    float mean[2], istd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h;
      const float s_ = ex_s[r * 2] + ex_s[(TM + r) * 2];
      const float q_ = ex_s[r * 2 + 1] + ex_s[(TM + r) * 2 + 1];
      mean[h] = s_ * drop.inv3;
      istd[h] = rsqrtf(q_ * drop.inv3 - mean[h] * mean[h] + LN_EPS);
    }
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
          const int q = 4 * qh + qq, c = half + 8 * q + cl;
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
    float* ex2 = ex_s + 2 * TM * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s1[h] = quad_sum(s1[h]);
      s2[h] = quad_sum(s2[h]);
      if ((lane & 3) == 0) {
        ex2[(wg * TM + rl + 8 * h) * 2] = s1[h];
        ex2[(wg * TM + rl + 8 * h) * 2 + 1] = s2[h];
      }
    }
    __syncthreads();                   // both halves' sums; g_out is consumed
    // ---- pass B: LN backward, gce rows out, g_att tile (over g_out) ------
    {
      float m1[2], m2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rl + 8 * h;
        m1[h] = (ex2[r * 2] + ex2[(TM + r) * 2]) * drop.inv3;
        m2[h] = (ex2[r * 2 + 1] + ex2[(TM + r) * 2 + 1]) * drop.inv3;
      }
#pragma unroll
      for (int pr = 0; pr < 16; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = half + 8 * q + cl;
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
        *reinterpret_cast<uint32_t*>(go_s + wg * TILE_PANEL
                                     + tc::swz(rl + 8 * h, c - half)) =
            tc::pack_bf16(gat[0], gat[1]);
      }
    }
    tc::fence_async_smem();
    __syncthreads();                   // the g_att tile is whole
    for (int c = tid; c < TM * 16; c += NTHREADS) {   // its rows out
      const int r = c >> 4, ch = c & 15;
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(out.ga + (blk * M + m0 + r) * D + ch * 8) =
            *reinterpret_cast<const uint4*>(go_s + (ch >> 3) * TILE_PANEL
                                            + tc::swz_chunk(r, ch & 7));
    }
    // ---- g_p = g_att qe^T, softmax backward, g_s, gcn rows out ----------
    {
      float gs[LRP / 2];
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int off = (ks / 4) * TILE_PANEL + (ks % 4) * 32;
        tc::mma_ss<LRP, 0, 0>(gs, tc::make_desc(tc::smem_u32(go_s) + off, 16),
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
      float gcn[32];
      tc::fence();
#pragma unroll
      for (int ts = 0; ts < LRP / 16; ++ts) {
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[r] = tc::pack_bf16(gs[8 * ts + 2 * r], gs[8 * ts + 2 * r + 1]);
        tc::mma_rs<64, 1>(gcn, a,
                          tc::make_desc(tc::smem_u32(qn_s) + wg * TILE_PANEL
                                            + ts * 2 * tc::ATOM_BYTES,
                                        TILE_PANEL), ts > 0);
      }
      tc::commit();
      tc::wait_all();
#pragma unroll
      for (int pr = 0; pr < 16; ++pr) {
        const int h = pr & 1, c = half + 8 * (pr >> 1) + cl;
        if (live[h])
          *reinterpret_cast<float2*>(out.gcn_part + (blk * M + m[h]) * D + c)
              = make_float2(gcn[2 * pr], gcn[2 * pr + 1]);
      }
    }
  }
  __syncthreads();
  // after the folds a lane holds, per group and column half qh, the sum
  // over its warp's rows of column 8 (4 qh + 2 b4 + b3) + 2 (lane % 4) + b2
  float* red = reinterpret_cast<float*>(cn_s);        // [4 warps][NVT]
  {
    const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int qh = 0; qh < 2; ++qh) {
        const int c = half + 8 * (4 * qh + 2 * b4 + b3) + cl + b2;
        red[warp * NVT + g * D + c] = vg[g][qh];
        red[warp * NVT + 3 * D + g * D + c] = vb[g][qh];
      }
  }
  __syncthreads();
  for (int k = tid; k < NVT; k += NTHREADS)
    out.vec_part[blk * NVT + k] =
        ((red[k] + red[NVT + k]) + red[2 * NVT + k]) + red[3 * NVT + k];
}

// gqn[j] = sum_m g_s[m, j] cn[m], gqe[j] = sum_m p[m, j] g_att[m] for one
// (b, frame): the frame's M rows of g_s, p (LRP wide) and g_att as the main
// kernel wrote them, and cn.  The products' left operands are read as they
// lie (rows = depth).  Warpgroup h owns columns [64 h, 64 h + 64).  Kept out
// of the main kernel, whose registers the two 64-row accumulators overfill.
constexpr int GQ_STAGE = 2 * TILE_PANEL + 2 * TILE_BYTES;   // g_s, p, ga, cn
constexpr int GQ_SMEM = 2 * GQ_STAGE + tc::ATOM_BYTES;

__global__ void __launch_bounds__(NTHREADS, 2)
qa_ctx_gq_tc_kernel(const __nv_bfloat16* __restrict__ gs,
                    const __nv_bfloat16* __restrict__ p,
                    const __nv_bfloat16* __restrict__ ga,
                    const __nv_bfloat16* __restrict__ cn,
                    __nv_bfloat16* __restrict__ gqn,
                    __nv_bfloat16* __restrict__ gqe, int M, int Li, int Lr,
                    int lrp) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int i = blockIdx.x, b = blockIdx.y;
  const size_t blk = static_cast<size_t>(b) * Li + i;
  const int steps = (M + TM - 1) / TM;
  float gqn_acc[32], gqe_acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) gqn_acc[k] = gqe_acc[k] = 0.f;

  auto load = [&](int step) {
    uint8_t* st = sm + (step & 1) * GQ_STAGE;
    const int m0 = step * TM, rows = min(TM, M - m0);
    const size_t r0 = blk * M + m0;
    tc_load_panel(st, gs + r0 * lrp, lrp, rows, lrp / 8, tid, NTHREADS);
    tc_load_panel(st + TILE_PANEL, p + r0 * lrp, lrp, rows, lrp / 8, tid,
                  NTHREADS);
    tc_load_rows(st + 2 * TILE_PANEL, TM, ga + r0 * D, D, rows, tid,
                 NTHREADS);
    tc_load_rows(st + 2 * TILE_PANEL + TILE_BYTES, TM,
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
    const uint32_t st = tc::smem_u32(sm + (step & 1) * GQ_STAGE);
    tc::fence();
#pragma unroll
    for (int ks = 0; ks < TM / 16; ++ks) {
      const int off = ks * 2 * tc::ATOM_BYTES;
      tc::mma_ss<64, 1, 1>(
          gqn_acc, tc::make_desc(st + off, TILE_PANEL),
          tc::make_desc(st + 2 * TILE_PANEL + TILE_BYTES + wg * TILE_PANEL
                            + off, TILE_PANEL), 1);
      tc::mma_ss<64, 1, 1>(
          gqe_acc, tc::make_desc(st + TILE_PANEL + off, TILE_PANEL),
          tc::make_desc(st + 2 * TILE_PANEL + wg * TILE_PANEL + off,
                        TILE_PANEL), 1);
    }
    tc::commit();
    tc::wait_all();
    __syncthreads();                   // the stage is free for step + 2
  }
  const int rl = 16 * warp + (lane >> 2);
#pragma unroll
  for (int pr = 0; pr < 16; ++pr) {
    const int j = rl + 8 * (pr & 1);
    const int c = 64 * wg + 8 * (pr >> 1) + 2 * (lane & 3);
    if (j >= Lr) continue;
    const size_t o = (blk * Lr + j) * D + c;
    *reinterpret_cast<uint32_t*>(gqn + o) =
        tc::pack_bf16(gqn_acc[2 * pr], gqn_acc[2 * pr + 1]);
    *reinterpret_cast<uint32_t*>(gqe + o) =
        tc::pack_bf16(gqe_acc[2 * pr], gqe_acc[2 * pr + 1]);
  }
}

template <int LRP>
cudaError_t launch_tc_main(const void* cn, const void* ce, const void* qn,
                           const void* qe, const float* cmask,
                           const float* qmask, const float* gamma,
                           const float* beta, const void* W,
                           const void* gmixed, const void* mixed,
                           const float* graw, const int* targets, TcGrads g,
                           int B, int A, int Lqa, int Li, int Lr, float scale,
                           Dropout drop, cudaStream_t stream) {
  auto h = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  cudaError_t err = allow_smem(qa_ctx_bwd_tc_kernel<LRP>, TC_SMEM);
  if (err != cudaSuccess) return err;
  qa_ctx_bwd_tc_kernel<LRP><<<dim3(Li, B), NTHREADS, TC_SMEM, stream>>>(
      h(cn), h(ce), h(qn), h(qe), cmask, qmask, gamma, beta, h(W), h(gmixed),
      h(mixed), graw, targets, g, A, Lqa, Li, Lr, scale, drop);
  return cudaGetLastError();
}

// The bf16 backward: the main kernel, the gqn / gqe and the weight-gradient
// kernels over the bf16 rows it wrote, and the fixed-order slot sums.
int launch_tc(const void* cn, const void* ce, const void* qn, const void* qe,
              const float* cmask, const float* qmask, const float* gamma,
              const float* beta, const void* W, const void* gmixed,
              const void* mixed, const float* graw, const int* targets,
              TcGrads g, void* gcn, float* gvec, float* wg_part, float* gw,
              int B, int A, int Lqa, int Li, int Lr, float scale,
              Dropout drop, int wg_chunks, cudaStream_t stream) {
  cudaError_t err = Lr <= 32
      ? launch_tc_main<32>(cn, ce, qn, qe, cmask, qmask, gamma, beta, W,
                           gmixed, mixed, graw, targets, g, B, A, Lqa, Li, Lr,
                           scale, drop, stream)
      : launch_tc_main<64>(cn, ce, qn, qe, cmask, qmask, gamma, beta, W,
                           gmixed, mixed, graw, targets, g, B, A, Lqa, Li, Lr,
                           scale, drop, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = A * Lqa;
  const long long rows = static_cast<long long>(B) * Li * M;
  if (wg_chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((err = allow_smem(qa_ctx_gq_tc_kernel, GQ_SMEM)) != cudaSuccess)
    return static_cast<int>(err);
  qa_ctx_gq_tc_kernel<<<dim3(Li, B), NTHREADS, GQ_SMEM, stream>>>(
      g.gs, g.p, g.ga, static_cast<const __nv_bfloat16*>(cn), g.gqn, g.gqe, M,
      Li, Lr, Lr <= 32 ? 32 : 64);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // [gw; gb] (the wrapper lays gb behind gw)
  if ((err = wgrad_tc(g.yd, g.gout, wg_part, gw, rows, 3 * D, D, wg_chunks,
                      stream)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = sum_slots<float>(g.vec_part, gvec, 1, B * Li, NVT, stream))
      != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(sum_slots<__nv_bfloat16>(
      g.gcn_part, static_cast<__nv_bfloat16*>(gcn), 2 * B, Li,
      static_cast<long long>(M) * D, stream));
}

}  // namespace

// Inputs as qa_ctx_attention_fwd, plus Wt = W^T (D, 3D) float32 (when
// is_bf16: W itself, (3D, D) bfloat16), g_mixed
// and the saved mixed (B, A, Li, Lqa, D) in the activation type, and g_raw
// float32 or NULL ((B, A, Li, Lqa, Lr) when targets is NULL, else
// (B, Li, Lqa, Lr) at targets[b]).  Outputs: gcn, gce (B, A, Lqa, D) and
// gqn, gqe (B, Li, Lr, D) in the activation type; gvec = [ggamma (3D);
// gbeta (3D); gb (D)] and gw (3D, D) float32.  Scratch (float32, the
// wrapper's): gcn_part, gce_part (B, Li, A*Lqa, D); yd (B*Li*A*Lqa, 3D);
// gout (B*Li*A*Lqa, D); vec_part (B*Li, 7D); wg_part (wg_chunks, 3D, D).
// When is_bf16: yd and gout are bfloat16; gce and gce_part lie right behind
// gcn and gcn_part ((2, B, ...) tensors); gw has 3D + 1 rows, the last is gb
// (gvec holds ggamma and gbeta only); vec_part is (B*Li, 6D) and wg_part
// (wg_chunks, 3D + 1, D); gs_rows and p_rows (B*Li*A*Lqa, 32 if Lr <= 32
// else 64) and ga_rows (B*Li*A*Lqa, D) are bfloat16 scratch (unused, may be
// NULL, for float32).
// dv: the true width, 4 <= dv <= D with 4 | dv, of inputs zero-padded to D
// (every LN's statistics and the Philox keys, philox.cuh).
extern "C" int qa_ctx_attention_bwd(
    const void* cn, const void* ce, const void* qn, const void* qe,
    const void* cmask, const void* qmask, const void* gamma,
    const void* beta, const void* Wt, const void* gmixed, const void* mixed,
    const void* graw, const void* targets, void* gcn, void* gce, void* gqn,
    void* gqe, void* gvec, void* gw, void* gcn_part, void* gce_part,
    void* yd, void* gout, void* vec_part, void* wg_part, void* gs_rows,
    void* p_rows, void* ga_rows, int B, int A, int Lqa, int Li, int Lr,
    float scale, const unsigned long long* drop_seed,
    unsigned drop_threshold, float drop_scale, int wg_chunks, int dv,
    int is_bf16, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  if (Lr > MAX_LR) return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop =
      entry_dropout(drop_seed, drop_threshold, drop_scale, dv);
  if (!width_ok(dv, BWD_D)) return static_cast<int>(cudaErrorInvalidValue);
  const int* tg = static_cast<const int*>(targets);
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    const TcGrads g{static_cast<bf16*>(gqn), static_cast<bf16*>(gqe),
                    fm(gcn_part), fm(gce_part), static_cast<bf16*>(yd),
                    static_cast<bf16*>(gout), fm(vec_part),
                    static_cast<bf16*>(gs_rows), static_cast<bf16*>(p_rows),
                    static_cast<bf16*>(ga_rows)};
    return launch_tc(cn, ce, qn, qe, f(cmask), f(qmask), f(gamma), f(beta),
                     Wt, gmixed, mixed, f(graw), tg, g, gcn, fm(gvec),
                     fm(wg_part), fm(gw), B, A, Lqa, Li, Lr, scale, drop,
                     wg_chunks, s);
  }
  const Grads g{gqn, gqe, fm(gcn_part), fm(gce_part), fm(yd), fm(gout),
                fm(vec_part)};
  return launch<float>(cn, ce, qn, qe, f(cmask), f(qmask), f(gamma), f(beta),
                       f(Wt), gmixed, mixed, f(graw), tg, g, gcn, gce,
                       fm(gvec), fm(wg_part), fm(gw), B, A, Lqa, Li, Lr,
                       scale, drop, wg_chunks, s);
}
