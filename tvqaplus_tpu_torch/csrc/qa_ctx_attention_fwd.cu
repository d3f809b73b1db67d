// Fused QA-context attention, forward, with the projection dropout.
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_attention.py
// (fused_qa_ctx_attention -> _pallas_forward / _fwd_kernel).  For batch b,
// frame i and each of the M = A*Lqa answer-word rows m:
//   S[m, j]  = cn[b, m] . qn[b, i, j]                       (j < Lr)
//   masked   = S - 1e10 * (1 - c_mask[b, m] * q_mask[b, i, j])   -> raw
//   P        = softmax_j(max(scale * masked, -3e4)) * mask
//   att[m]   = sum_j P[m, j] qe[b, i, j]
//   x        = [ce[b, m]; att; ce[b, m] * att]                  (3D wide)
//   mixed    = ReLU(LN(x) W + bias)    LN: fast variance, not clipped at 0
//   (training: LN(x) is multiplied by the Philox dropout mask of
//   philox.cuh, keyed by the flat index of the (B*A*Li*Lqa, 3D) LN output)
// mixed is (B, A, Li, Lqa, D) in the activation type; raw (optional) is
// (B, A, Li, Lqa, Lr) float32 ("full"), or (B, Li, Lqa, Lr) at each
// example's target answer ("target", the only slice the att loss reads).
// A row whose regions are all masked gets P = 0 (the floor keeps the
// softmax finite), so att = 0, never NaN.
//
// What bounds it on the H100: at the headline eval the call moves ~69 MB
// (vid, raw full) or ~63 MB (sub) and does ~18-20 GFLOP, 80% of it the
// projection (2 * M * 3D * D per frame); at the card's peaks (3.35 TB/s,
// 989 TF/s bf16) that is ~20 us either way.  Done on the float32 CUDA
// cores, as here, the operations bound it by far.
// Design: one block per (b, i).  The frame's qn and qe tiles (stride D+1, so
// lanes that index regions hit distinct banks) stay in shared memory as
// float32 while the block walks the M rows in tiles of 32: each warp owns 4
// rows through scores, softmax, att and the LayerNorm, then the whole block
// multiplies the tile's 32 x 3D LN output by W.  W (3D x D float32,
// 196 KB) does not fit beside the tiles, so it is read through L2 and
// staged 32 rows (16 KB) at a time into shared memory, where every warp
// reads it conflict-free; float32 keeps the exactness check tight.  The
// CUDA cores do the products (no tensor cores yet): the first version is
// simple and right, and wgmma is the next step.
#include "philox.cuh"
#include "qa_ctx_attention.cuh"

namespace {

using namespace tvqa;

constexpr int RPT = 4;                  // rows per warp per tile
constexpr int RT = RPT * NWARPS;        // 32 rows per tile

struct Layout {
  int qn, qe, qm, p, y, w, total;       // float offsets / total floats
  __host__ __device__ explicit Layout(int lr) {
    const int lrp = round4(lr);
    qn = 0;
    qe = qn + lr * QS;
    qm = round4(qe + lr * QS);
    p = qm + lrp;
    y = p + RT * lrp;
    w = y + RT * 3 * D;
    total = w + KC * D;
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
qa_ctx_fwd_kernel(const T* __restrict__ cn, const T* __restrict__ ce,
                  const T* __restrict__ qn, const T* __restrict__ qe,
                  const float* __restrict__ cmask,
                  const float* __restrict__ qmask,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta,
                  const float* __restrict__ W, const float* __restrict__ bias,
                  const int* __restrict__ targets, T* __restrict__ mixed,
                  float* __restrict__ raw, int A, int Lqa, int Li, int Lr,
                  float scale, Dropout drop) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout lay(Lr);
  float* qn_s = smem + lay.qn;
  float* qe_s = smem + lay.qe;
  float* qm_s = smem + lay.qm;
  float* p_s = smem + lay.p;
  float* y_s = smem + lay.y;
  float* w_s = smem + lay.w;
  const int lrp = round4(Lr);

  const int i = blockIdx.x, b = blockIdx.y;
  const int M = A * Lqa;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = lane * 4;
  const int target = targets != nullptr ? targets[b] : -1;

  // the frame's context tiles, once per block
  const size_t fbase = (static_cast<size_t>(b) * Li + i) * Lr;
  for (int idx = tid; idx < Lr * D; idx += NTHREADS) {
    const int j = idx / D, d = idx % D;
    qn_s[j * QS + d] = to_f(qn[fbase * D + idx]);
    qe_s[j * QS + d] = to_f(qe[fbase * D + idx]);
  }
  for (int j = tid; j < Lr; j += NTHREADS) qm_s[j] = qmask[fbase + j];
  __syncthreads();

  for (int m0 = 0; m0 < M; m0 += RT) {
    // ---- per-warp rows: scores, softmax, att, LayerNorm, dropout -------
#pragma unroll 1
    for (int jj = 0; jj < RPT; ++jj) {
      const int r = warp * RPT + jj, m = m0 + r;
      float* yr = y_s + r * 3 * D;
      const bool live = m < M;
      const size_t row = static_cast<size_t>(b) * M + m;
      // stage ce in segment 0 and cn in segment 2 (overwritten below)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = lane + 32 * q;
        yr[d] = live ? to_f(ce[row * D + d]) : 0.f;
        yr[2 * D + d] = live ? to_f(cn[row * D + d]) : 0.f;
      }
      __syncwarp();
      const AttnRow sc = attn_scores(yr + 2 * D, qn_s, qm_s,
                                     live ? cmask[row] : 0.f, Lr, scale,
                                     lane);
      const int a = m / Lqa, w = m % Lqa;
      if (raw != nullptr && live && (targets == nullptr || a == target)) {
        float* rr = targets == nullptr
            ? raw + ((((static_cast<size_t>(b) * A + a) * Li + i) * Lqa + w)
                     * Lr)
            : raw + (((static_cast<size_t>(b) * Li + i) * Lqa + w) * Lr);
        if (lane < Lr) rr[lane] = sc.mk[0];
        if (lane + 32 < Lr) rr[lane + 32] = sc.mk[1];
      }
      if (lane < Lr) p_s[r * lrp + lane] = sc.p0[0] * sc.sm[0];
      if (lane + 32 < Lr) p_s[r * lrp + lane + 32] = sc.p0[1] * sc.sm[1];
      __syncwarp();
      float at[4];
      attn_apply(p_s + r * lrp, qe_s, Lr, lane, at);
      float x[3][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float c = yr[lane + 32 * q];
        x[0][q] = c;
        x[1][q] = at[q];
        x[2][q] = c * at[q];
      }
      float mean, istd;
      ln3_stats(x, mean, istd);
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = g * D + lane + 32 * q;
          yr[k] = (x[g][q] - mean) * istd * gamma[k] + beta[k];
        }
      if (drop.on() && live) {
        __syncwarp();
        const unsigned long long e_row =
            mixed_row(b, m, i, A, Lqa, Li) * (3 * D);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          float km[4];
          keep4(drop.seed, e_row + g * D + c0, drop.threshold, drop.scale,
                km);
#pragma unroll
          for (int t = 0; t < 4; ++t) yr[g * D + c0 + t] *= km[t];
        }
      }
    }
    // ---- the tile's projection: (RT x 3D) . (3D x D) ---------------------
    float acc[RPT][4];
    gemm_staged<RPT>(acc, y_s, 3 * D, 3 * D, W, w_s, warp * RPT, c0);
    const float4 bv = *reinterpret_cast<const float4*>(bias + c0);
#pragma unroll
    for (int jj = 0; jj < RPT; ++jj) {
      const int m = m0 + warp * RPT + jj;
      if (m >= M) continue;
      const int a = m / Lqa, w = m % Lqa;
      T* dst = mixed + ((((static_cast<size_t>(b) * A + a) * Li + i) * Lqa
                         + w) * D + c0);
      store4<T>(dst, fmaxf(acc[jj][0] + bv.x, 0.f),
                fmaxf(acc[jj][1] + bv.y, 0.f), fmaxf(acc[jj][2] + bv.z, 0.f),
                fmaxf(acc[jj][3] + bv.w, 0.f));
    }
    __syncthreads();                   // y_s is rewritten by the next tile
  }
}

template <typename T>
int launch(const void* cn, const void* ce, const void* qn, const void* qe,
           const float* cmask, const float* qmask, const float* gamma,
           const float* beta, const float* W, const float* bias,
           const int* targets, void* mixed, float* raw, int B, int A,
           int Lqa, int Li, int Lr, float scale, Dropout drop,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * Layout(Lr).total;
  cudaError_t err = allow_smem(qa_ctx_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  qa_ctx_fwd_kernel<T><<<dim3(Li, B), NTHREADS, bytes, stream>>>(
      static_cast<const T*>(cn), static_cast<const T*>(ce),
      static_cast<const T*>(qn), static_cast<const T*>(qe), cmask, qmask,
      gamma, beta, W, bias, targets, static_cast<T*>(mixed), raw, A, Lqa, Li,
      Lr, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cn, ce: (B, A, Lqa, D); qn, qe: (B, Li, Lr, D), all of one type (bf16
// when is_bf16, else float32); masks, gamma/beta (3D), W (3D, D), bias (D)
// float32; mixed (B, A, Li, Lqa, D) in the activation type; raw float32:
// (B, A, Li, Lqa, Lr) when targets is NULL, else (B, Li, Lqa, Lr) at
// targets[b] (int32, B); raw NULL writes none.  Lr <= 64.  Dropout on the
// LN output when drop_threshold > 0 (philox.cuh).
extern "C" int qa_ctx_attention_fwd(
    const void* cn, const void* ce, const void* qn, const void* qe,
    const void* cmask, const void* qmask, const void* gamma,
    const void* beta, const void* W, const void* bias, const void* targets,
    void* mixed, void* raw, int B, int A, int Lqa, int Li, int Lr,
    float scale, unsigned long long drop_seed, unsigned drop_threshold,
    float drop_scale, int is_bf16, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_seed, drop_threshold, drop_scale};
  const int* tg = static_cast<const int*>(targets);
  if (is_bf16)
    return launch<__nv_bfloat16>(cn, ce, qn, qe, f(cmask), f(qmask),
                                 f(gamma), f(beta), f(W), f(bias), tg, mixed,
                                 static_cast<float*>(raw), B, A, Lqa, Li, Lr,
                                 scale, drop, s);
  return launch<float>(cn, ce, qn, qe, f(cmask), f(qmask), f(gamma), f(beta),
                       f(W), f(bias), tg, mixed, static_cast<float*>(raw), B,
                       A, Lqa, Li, Lr, scale, drop, s);
}
