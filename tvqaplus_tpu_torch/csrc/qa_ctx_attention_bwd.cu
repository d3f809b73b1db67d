// Fused QA-context attention, backward.
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
// operations bound it (~38 us).  Done on the float32 CUDA cores, as here,
// the products bound it by far, and the scratch passes below add ~0.5 GB of
// traffic.
// Design: one block per (b, i), 32-row tiles as in the forward; each warp
// owns 4 rows.  The LN backward runs in registers on the g_yd tile that the
// block's staged GEMM (g_out x W^T, W^T staged from L2 32 rows at a time)
// leaves in each warp's own rows, with the 3D-wide concat never stored.
// gqn and gqe (Lr x D, summed over the frame's M rows) stay in registers,
// 64 a thread.  What is summed ACROSS blocks goes through scratch slots and
// a fixed-order second pass (grad_reduce.cuh): gcn/gce per (b, i), the
// parameter vectors per block, and gW as its own GEMM over the yd and
// g_out rows the main kernel writes.  Deterministic, simple, and a known
// cost: the yd rows alone are 245 MB at the headline shapes.
#include "grad_reduce.cuh"
#include "philox.cuh"
#include "qa_ctx_attention.cuh"

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
      ln3_stats(x, mean, istd);
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
      const unsigned long long e_row =
          mixed_row(b, m, i, A, Lqa, Li) * (3 * D);
      const size_t yrow = (blk * M + m) * (3 * D);
      float xh[3][4], gxh[3][4], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float km[4] = {1.f, 1.f, 1.f, 1.f};
        if (drop.on())
          keep4(drop.seed, e_row + g * D + c0, drop.threshold, drop.scale,
                km);
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
      const float m1 = warp_sum(s1) * (1.f / (3 * D));
      const float m2 = warp_sum(s2) * (1.f / (3 * D));
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
  if ((err = wgrad(g.yd, g.gout, wg_part, gw, rows, 3 * D, wg_chunks,
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

}  // namespace

// Inputs as qa_ctx_attention_fwd, plus Wt = W^T (D, 3D) float32, g_mixed
// and the saved mixed (B, A, Li, Lqa, D) in the activation type, and g_raw
// float32 or NULL ((B, A, Li, Lqa, Lr) when targets is NULL, else
// (B, Li, Lqa, Lr) at targets[b]).  Outputs: gcn, gce (B, A, Lqa, D) and
// gqn, gqe (B, Li, Lr, D) in the activation type; gvec = [ggamma (3D);
// gbeta (3D); gb (D)] and gw (3D, D) float32.  Scratch (float32, the
// wrapper's): gcn_part, gce_part (B, Li, A*Lqa, D); yd (B*Li*A*Lqa, 3D);
// gout (B*Li*A*Lqa, D); vec_part (B*Li, 7D); wg_part (wg_chunks, 3D, D).
extern "C" int qa_ctx_attention_bwd(
    const void* cn, const void* ce, const void* qn, const void* qe,
    const void* cmask, const void* qmask, const void* gamma,
    const void* beta, const void* Wt, const void* gmixed, const void* mixed,
    const void* graw, const void* targets, void* gcn, void* gce, void* gqn,
    void* gqe, void* gvec, void* gw, void* gcn_part, void* gce_part,
    void* yd, void* gout, void* vec_part, void* wg_part, int B, int A,
    int Lqa, int Li, int Lr, float scale, unsigned long long drop_seed,
    unsigned drop_threshold, float drop_scale, int wg_chunks, int is_bf16,
    void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  if (Lr > MAX_LR) return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{drop_seed, drop_threshold, drop_scale};
  const Grads g{gqn, gqe, fm(gcn_part), fm(gce_part), fm(yd), fm(gout),
                fm(vec_part)};
  const int* tg = static_cast<const int*>(targets);
  if (is_bf16)
    return launch<__nv_bfloat16>(cn, ce, qn, qe, f(cmask), f(qmask),
                                 f(gamma), f(beta), f(Wt), gmixed, mixed,
                                 f(graw), tg, g, gcn, gce, fm(gvec),
                                 fm(wg_part), fm(gw), B, A, Lqa, Li, Lr,
                                 scale, drop, wg_chunks, s);
  return launch<float>(cn, ce, qn, qe, f(cmask), f(qmask), f(gamma), f(beta),
                       f(Wt), gmixed, mixed, f(graw), tg, g, gcn, gce,
                       fm(gvec), fm(wg_part), fm(gw), B, A, Lqa, Li, Lr,
                       scale, drop, wg_chunks, s);
}
