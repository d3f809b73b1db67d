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
// D, the hidden width, is 64, 128 or 256 (a template parameter; the C
// entry takes it and refuses any other width); a true width dv < D runs on
// inputs zero-padded to D (the LN statistics and the dropout keys over dv,
// philox.cuh).
//
// What bounds it on the H100: at the headline eval the call moves ~69 MB
// (vid, raw full) or ~63 MB (sub) and does ~18-20 GFLOP at D = 128, 80% of
// it the projection (2 * M * 3D * D per frame); at the card's peaks
// (3.35 TB/s, 989 TF/s bf16) that is ~20 us either way.  At D = 64 bytes
// bind (~50 MB, ~5 GFLOP: ~15 us); at D = 256 operations do (~67 GFLOP
// against ~140 MB: ~68 us).  The tensor-core kernels below are bound by
// neither: the softmax, LayerNorm and Philox passes between the products
// run on 8 warps an SM (255 registers a thread), at a fraction of the
// scheduler rate.
//
// The instantiations:
// * bfloat16 (what the main paths run), D = 128
//   (qa_ctx_fwd_tc_kernel<D, LRP>), one block per (b, i), the frame's qn /
//   qe tiles resident in shared memory: every product
//   is a wgmma on bf16 operands with float32 sums (wgmma.cuh), rounding
//   where the TPU kernel's bf16 compute mode rounds: p before p qe, the
//   dropped LN output and W before the projection.  W (bf16, 96 KB at
//   D = 128) is loaded into shared memory ONCE per block and read
//   N-contiguous as it lies.  Each of the two warpgroups walks every second
//   64-row tile of the frame's M rows on its own (named barriers, no
//   block-wide sync in the loop), so one's tensor-core phases overlap the
//   other's register phases: scores (A = the cn tile, B = qn) land in
//   registers in the accumulator layout, where softmax and masks run; p
//   goes back into the tensor cores FROM REGISTERS (p qe); the LayerNorm,
//   the Philox dropout (two lanes share each 4-wide draw through one
//   shuffle) and the bf16 rounding run on the att accumulator; the 64 x 3D
//   tile is stored swizzled (48 KB, over the cn tile) for the projection.
//   Shared memory: 231,168 bytes.  M = 200 pads to four tiles (22% of the
//   products idle; rows of several frames do not share a tile because the
//   scores are per frame).
// * bfloat16, D = 64 (qa_ctx_fwd_tc64_kernel<LRP, DROP>): persistent, three
//   warpgroups a CTA, each on a run of frames of one (b, 64-row tile) with
//   the tile's cn and ce kept and the next frame's qn / qe copied while
//   this one computes, W loaded once a CTA, the LN output fed to the
//   projection from registers (the note at the kernel).  180,224 bytes of
//   shared memory.
// * bfloat16, D = 256 (qa_ctx_fwd_tc_wide_kernel<LRP, DROP>): W is 384 KB
//   and a warpgroup's 64 x 256 att and projection accumulators would take
//   128 registers a thread each, so the two warpgroups work on one tile and
//   split its columns (128 each); the scores are computed once (each
//   warpgroup half the regions, the softmax's row max and sum crossing
//   through shared memory, p in a bf16 tile); W is rounded to bf16 once a
//   call into 24 slabs (w_slab_pack_kernel) that the copy engine brings
//   through a ring of four slots (SlabRing, wgmma.cuh), a pair of CTAs (a
//   cluster over two frames) sharing each slab by multicast: 0.61 GB of W
//   from L2 at the headline shapes, where a pass of W a tile read 1.23 GB.
//   231,744 bytes of shared memory; 255 registers, 12-88 bytes of spill.
//   The serving instantiation (DROP false) holds no Philox code.
// * float32 (qa_ctx_fwd_kernel<float, D>): the exactness check (1e-4
//   bars).  CUDA cores, 32-row tiles (16 at D = 256, where the frame's qn
//   and qe take 128 KB), each warp 4 (2) rows, W (196 KB in float32 at
//   D = 128) staged from L2 32 rows at a time for every tile.
#include "philox.cuh"
#include "qa_ctx_attention.cuh"

namespace {

using namespace tvqa;

// float32 rows per warp per tile: 4 (32-row tiles), 2 at D = 256, where the
// frame's qn / qe tiles take 128 KB of shared memory
template <int D>
constexpr int RPT = D == 256 ? 2 : 4;

template <int D>
struct Layout {
  static constexpr int RT = RPT<D> * NWARPS;      // rows per tile
  int qn, qe, qm, p, y, w, total;       // float offsets / total floats
  __host__ __device__ explicit Layout(int lr) {
    const int lrp = round4(lr);
    qn = 0;
    qe = qn + lr * (D + 1);
    qm = round4(qe + lr * (D + 1));
    p = qm + lrp;
    y = p + RT * lrp;
    w = y + RT * 3 * D;
    total = w + KC * D;
  }
};

template <typename T, int D>
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
  constexpr int R_W = RPT<D>, RT_ = Layout<D>::RT;
  constexpr int VPL = D / 32;            // values of a row a lane
  drop.load_seed();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout<D> lay(Lr);
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
  const int c0 = lane * VPL;
  const int target = targets != nullptr ? targets[b] : -1;

  // the frame's context tiles, once per block
  const size_t fbase = (static_cast<size_t>(b) * Li + i) * Lr;
  for (int idx = tid; idx < Lr * D; idx += NTHREADS) {
    const int j = idx / D, d = idx % D;
    qn_s[j * (D + 1) + d] = to_f(qn[fbase * D + idx]);
    qe_s[j * (D + 1) + d] = to_f(qe[fbase * D + idx]);
  }
  for (int j = tid; j < Lr; j += NTHREADS) qm_s[j] = qmask[fbase + j];
  __syncthreads();

  for (int m0 = 0; m0 < M; m0 += RT_) {
    // ---- per-warp rows: scores, softmax, att, LayerNorm, dropout -------
#pragma unroll 1
    for (int jj = 0; jj < R_W; ++jj) {
      const int r = warp * R_W + jj, m = m0 + r;
      float* yr = y_s + r * 3 * D;
      const bool live = m < M;
      const size_t row = static_cast<size_t>(b) * M + m;
      // stage ce in segment 0 and cn in segment 2 (overwritten below)
#pragma unroll
      for (int q = 0; q < VPL; ++q) {
        const int d = lane + 32 * q;
        yr[d] = live ? to_f(ce[row * D + d]) : 0.f;
        yr[2 * D + d] = live ? to_f(cn[row * D + d]) : 0.f;
      }
      __syncwarp();
      const AttnRow sc = attn_scores<D>(yr + 2 * D, qn_s, qm_s,
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
      float at[VPL];
      attn_apply<D>(p_s + r * lrp, qe_s, Lr, lane, at);
      float x[3][VPL];
#pragma unroll
      for (int q = 0; q < VPL; ++q) {
        const float c = yr[lane + 32 * q];
        x[0][q] = c;
        x[1][q] = at[q];
        x[2][q] = c * at[q];
      }
      float mean, istd;
      ln3_stats<D>(x, mean, istd, drop.inv3);
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int q = 0; q < VPL; ++q) {
          const int k = g * D + lane + 32 * q;
          yr[k] = (x[g][q] - mean) * istd * gamma[k] + beta[k];
        }
      if (drop.on() && live) {
        __syncwarp();
        const unsigned long long er = mixed_row(b, m, i, A, Lqa, Li);
#pragma unroll
        for (int g = 0; g < 3; ++g)
          for (int i4 = lane; i4 < D / 4; i4 += 32) {
            float km[4];
            const int k0 = g * D + 4 * i4;
            keep4(drop.seed, drop.key3(er, g, 4 * i4), drop.threshold,
                  drop.scale, km);
#pragma unroll
            for (int t = 0; t < 4; ++t) yr[k0 + t] *= km[t];
          }
      }
    }
    // ---- the tile's projection: (RT x 3D) . (3D x D) ---------------------
    float acc[R_W][VPL];
    gemm_staged<R_W, D>(acc, y_s, 3 * D, 3 * D, W, w_s, warp * R_W, c0);
    float bv[VPL];
    ld_cols<VPL>(bv, bias + c0);
#pragma unroll
    for (int jj = 0; jj < R_W; ++jj) {
      const int m = m0 + warp * R_W + jj;
      if (m >= M) continue;
      const int a = m / Lqa, w = m % Lqa;
      T* dst = mixed + ((((static_cast<size_t>(b) * A + a) * Li + i) * Lqa
                         + w) * D + c0);
      float o[VPL];
#pragma unroll
      for (int t = 0; t < VPL; ++t) o[t] = fmaxf(acc[jj][t] + bv[t], 0.f);
      store_n<T, VPL>(dst, o);
    }
    __syncthreads();                   // y_s is rewritten by the next tile
  }
}

template <typename T, int D>
int launch(const void* cn, const void* ce, const void* qn, const void* qe,
           const float* cmask, const float* qmask, const float* gamma,
           const float* beta, const float* W, const float* bias,
           const int* targets, void* mixed, float* raw, int B, int A,
           int Lqa, int Li, int Lr, float scale, Dropout drop,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * Layout<D>(Lr).total;
  cudaError_t err = allow_smem(qa_ctx_fwd_kernel<T, D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  qa_ctx_fwd_kernel<T, D><<<dim3(Li, B), NTHREADS, bytes, stream>>>(
      static_cast<const T*>(cn), static_cast<const T*>(ce),
      static_cast<const T*>(qn), static_cast<const T*>(qe), cmask, qmask,
      gamma, beta, W, bias, targets, static_cast<T*>(mixed), raw, A, Lqa, Li,
      Lr, scale, drop);
  return static_cast<int>(cudaGetLastError());
}


// ---- the bfloat16 instantiation: tensor cores, D = 128 ---------------------

template <int D>
struct AttnTc {
  static constexpr int YD_BYTES = 3 * (D / 64) * TILE_PANEL;  // 64 x 3D bf16
  static constexpr int SMEM = Shapes<D>::W_BYTES + 2 * Shapes<D>::TILE_BYTES
                              + 2 * YD_BYTES + (TM + D) * 4 + tc::ATOM_BYTES;
};

// One block per (b, frame i), two warpgroups; each warpgroup walks every
// second 64-row tile of the frame's M rows on its own.
template <int D, int LRP>
__global__ void __launch_bounds__(NTHREADS, 1)
qa_ctx_fwd_tc_kernel(const __nv_bfloat16* __restrict__ cn,
                     const __nv_bfloat16* __restrict__ ce,
                     const __nv_bfloat16* __restrict__ qn,
                     const __nv_bfloat16* __restrict__ qe,
                     const float* __restrict__ cmask,
                     const float* __restrict__ qmask,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const __nv_bfloat16* __restrict__ W,
                     const float* __restrict__ bias,
                     const int* __restrict__ targets,
                     __nv_bfloat16* __restrict__ mixed,
                     float* __restrict__ raw, int A, int Lqa, int Li, int Lr,
                     float scale, Dropout drop) {
  constexpr int YD_BYTES = AttnTc<D>::YD_BYTES;
  constexpr int TILE_BYTES = Shapes<D>::TILE_BYTES;
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* w_s = align_smem(smem_raw);
  uint8_t* qn_s = w_s + Shapes<D>::W_BYTES;
  uint8_t* qe_s = qn_s + TILE_BYTES;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  // the warpgroup's LN-output tile; its first D / 64 panels hold cn before
  uint8_t* yd_s = qe_s + TILE_BYTES + wg * YD_BYTES;
  float* qm_s = reinterpret_cast<float*>(qe_s + TILE_BYTES + 2 * YD_BYTES);
  float* bias_s = qm_s + TM;

  const int i = blockIdx.x, b = blockIdx.y;
  const int M = A * Lqa;
  const int target = targets != nullptr ? targets[b] : -1;
  const size_t fbase = (static_cast<size_t>(b) * Li + i) * Lr;
  if (tid < D) bias_s[tid] = bias[tid];
  tc_load_frame<D>(w_s, qn_s, qe_s, qm_s, W, qn, qe, qmask, fbase, Lr);

  const int rl = 16 * warp + (lane >> 2);             // first of two rows
  for (int m0 = wg * TM; m0 < M; m0 += 2 * TM) {
    // ---- the tile's cn rows, then scores and softmax in registers -------
    tc::bar_sync(1 + wg, 128);         // the previous tile's reads are done
    tc_load_rows<D>(yd_s, TM, cn + (static_cast<size_t>(b) * M + m0) * D, D,
                    min(TM, M - m0), t, 128);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    tc::fence_async_smem();
    tc::bar_sync(1 + wg, 128);
    float s[LRP / 2], p0[LRP / 2];
    tc_scores<LRP, D>(s, tc::smem_u32(yd_s), tc::smem_u32(qn_s));
    int m[2];
    bool live[2];
    float cm[2];
    size_t mrow[2];                    // flat row of mixed / the LN output
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = m0 + rl + 8 * h;
      live[h] = m[h] < M;
      cm[h] = live[h] ? cmask[static_cast<size_t>(b) * M + m[h]] : 0.f;
      mrow[h] = mixed_row(b, live[h] ? m[h] : 0, i, A, Lqa, Li);
    }
    tc_softmax<LRP>(s, p0, cm, qm_s, Lr, scale, lane);
    if (raw != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = m[h] / Lqa, w = m[h] % Lqa;
        if (!live[h] || (targets != nullptr && a != target)) continue;
        float* rr = targets == nullptr
            ? raw + mrow[h] * Lr
            : raw + ((static_cast<size_t>(b) * Li + i) * Lqa + w) * Lr;
#pragma unroll
        for (int k = h * 2; k < LRP / 2; k += 4)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = acc_col(k + e, lane);
            if (j < Lr) rr[j] = s[k + e];
          }
      }
    }
    float att[D / 2];
    tc_att<LRP, D / 64>(att, p0, cm, qm_s, tc::smem_u32(qe_s), lane);

    // ---- LayerNorm over [ce; att; ce * att], dropout, bf16 tile ---------
    // value pair pr = 2 q + h: row half h, columns 8 q + 2 (lane % 4) + {0, 1}
    uint32_t cev[D / 4];
    float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
    for (int pr = 0; pr < D / 4; ++pr) {
      const int h = pr & 1, c = 8 * (pr >> 1) + 2 * (lane & 3);
      cev[pr] = live[h]
          ? __ldg(reinterpret_cast<const unsigned int*>(
                ce + (static_cast<size_t>(b) * M + m[h]) * D + c))
          : 0u;
      const float2 c2 = tc::unpack_bf16(cev[pr]);
      const float a0 = att[2 * pr], a1 = att[2 * pr + 1];
      const float x0 = c2.x * a0, x1 = c2.y * a1;
      sum[h] += (c2.x + c2.y) + (a0 + a1) + (x0 + x1);
      sq[h] += fmaf(c2.x, c2.x, c2.y * c2.y) + fmaf(a0, a0, a1 * a1)
               + fmaf(x0, x0, x1 * x1);
    }
    float mean[2], istd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = quad_sum(sum[h]) * drop.inv3;
      istd[h] = rsqrtf(quad_sum(sq[h]) * drop.inv3 - mean[h] * mean[h]
                       + LN_EPS);
    }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      uint32_t kw[2][D / 64];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int w = 0; w < D / 64; ++w) kw[h][w] = ~0u;
      if (drop.on())
        tc_keep_bits<D / 8, false>(
            drop, drop.key3((lane & 1) ? mrow[1] : mrow[0], g, 0), lane,
            kw);
#pragma unroll
      for (int pr = 0; pr < D / 4; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = 8 * q + 2 * (lane & 3);
        const float2 c2 = tc::unpack_bf16(cev[pr]);
        const float a0 = att[2 * pr], a1 = att[2 * pr + 1];
        const float x0 = g == 0 ? c2.x : (g == 1 ? a0 : c2.x * a0);
        const float x1 = g == 0 ? c2.y : (g == 1 ? a1 : c2.y * a1);
        const float2 ga = __ldg(reinterpret_cast<const float2*>(
            gamma + g * D + c));
        const float2 be = __ldg(reinterpret_cast<const float2*>(
            beta + g * D + c));
        float y0 = (x0 - mean[h]) * istd[h] * ga.x + be.x;
        float y1 = (x1 - mean[h]) * istd[h] * ga.y + be.y;
        if (drop.on()) {
          const uint32_t bits = kw[h][q >> 3] >> (4 * (q & 7));
          y0 *= (bits & 1u) ? drop.scale : 0.f;
          y1 *= (bits & 2u) ? drop.scale : 0.f;
        }
        *reinterpret_cast<uint32_t*>(
            yd_s + (g * (D / 64) + (c >> 6)) * TILE_PANEL
            + tc::swz(rl + 8 * h, c & 63)) = tc::pack_bf16(y0, y1);
      }
    }
    tc::fence_async_smem();
    tc::bar_sync(1 + wg, 128);
    // ---- the projection: (64 x 3D) . W (3D x D), W read N-contiguous ------
    float acc[D / 2];
    tc::fence();
#pragma unroll
    for (int ks = 0; ks < 3 * D / 16; ++ks)
      tc::mma_ss<D, 0, 1>(
          acc,
          tc::make_desc(tc::smem_u32(yd_s) + (ks / 4) * TILE_PANEL
                            + (ks % 4) * 32, 16),
          tc::make_desc(tc::smem_u32(w_s) + ks * 2 * tc::ATOM_BYTES,
                        Shapes<D>::W_PANEL),
          ks > 0);
    tc::commit();
    tc::wait_all();
#pragma unroll
    for (int pr = 0; pr < D / 4; ++pr) {
      const int h = pr & 1, c = 8 * (pr >> 1) + 2 * (lane & 3);
      if (!live[h]) continue;
      const float2 bv = *reinterpret_cast<const float2*>(bias_s + c);
      *reinterpret_cast<uint32_t*>(mixed + mrow[h] * D + c) =
          tc::pack_bf16(fmaxf(acc[2 * pr] + bv.x, 0.f),
                        fmaxf(acc[2 * pr + 1] + bv.y, 0.f));
    }
  }
}

// ---- the bfloat16 instantiation at D = 64: persistent, frames in a loop --
//
// At D = 64 a frame's products are small (a 64-row tile: 0.8 MFLOP of
// scores, att and projection) and the time is in the passes between them
// (softmax, LayerNorm, the Philox draws) and in waiting for the data each
// tile needs, so the design spends the SM's warps and bytes on those:
// * Persistent: at most one CTA an SM, three warpgroups each, and W
//   loaded once a CTA, not once a frame, rounded to bf16 (24 KB) as it is
//   stored: the call launches no cast of W.
// * A warpgroup's items are (b, 64-row tile of M, frame) in that order, a
//   contiguous share of the B T Li items (T = ceil(M / 64)), so a
//   warpgroup walks a run of frames of one (b, tile): the tile's cn rows
//   (the scores' A operand) and ce rows stay in shared memory across the
//   run, and only the frame's qn, qe and q mask
//   (Lr <= 64 rows) come in for each item, through two slots: the next
//   item's rows are copied (cp.async) while this one computes.  The shares
//   differ by one item at most, 8 or 9 items at the headline's 3,200 on
//   396 warpgroups.
// * The warpgroups run apart: named barriers only (two an item), no block
//   barrier after W is loaded.
// * The LN output (yd, 64 x 3D) never leaves registers: the accumulator
//   layout of att is the A fragment layout of wgmma, so each LN group's
//   pairs are rounded to bf16 straight into the projection's A registers,
//   a group at a time.
// * The tail tile (8 live rows of M = 200) is an item like the others:
//   warps whose 16 rows are all past M skip the raw scores and the output
//   stores only (a value that feeds a product computed on a path that
//   only some warps take makes the compiler serialize the products).
// * mixed goes out through the frame's qn slot (read by then): 16 bytes a
//   thread, whole 128-byte rows.  (The raw scores taken out the same way,
//   a warp a row, ran 0.02 ms slower a call than from registers.)
// * DROP false, the serving instantiation, holds no Philox code.
struct AttnTc64 {
  static constexpr int D = 64;
  static constexpr int NWG = 3;                       // warpgroups a CTA
  static constexpr int NT = 128 * NWG;                // threads a CTA
  static constexpr int TILE = TILE_PANEL;             // 64 x 64 bf16
  static constexpr int O_W = 0;                       // W (3D x D) bf16
  static constexpr int O_BIAS = O_W + Shapes<D>::W_BYTES;   // D floats
  static constexpr int O_ROOM = O_BIAS + tc::ATOM_BYTES;
  // a warpgroup's room: its cn and ce tiles, then two slots of a frame's
  // qn and qe (LRP <= 64 rows each) and q mask (64 floats)
  static constexpr int R_CE = TILE;
  static constexpr int R_SLOT = 2 * TILE;
  static constexpr int S_QE = TILE;
  static constexpr int S_QM = 2 * TILE;
  static constexpr int SLOT = 2 * TILE + tc::ATOM_BYTES;
  static constexpr int ROOM = R_SLOT + 2 * SLOT;
  static constexpr int SMEM = O_ROOM + NWG * ROOM + tc::ATOM_BYTES;
  static_assert(SMEM <= 232448, "shared memory of a block");
};

template <int LRP, bool DROP>
__global__ void __launch_bounds__(AttnTc64::NT, 1)
qa_ctx_fwd_tc64_kernel(const __nv_bfloat16* __restrict__ cn,
                       const __nv_bfloat16* __restrict__ ce,
                       const __nv_bfloat16* __restrict__ qn,
                       const __nv_bfloat16* __restrict__ qe,
                       const float* __restrict__ cmask,
                       const float* __restrict__ qmask,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ W,
                       const float* __restrict__ bias,
                       const int* __restrict__ targets,
                       __nv_bfloat16* __restrict__ mixed,
                       float* __restrict__ raw, int B, int A, int Lqa,
                       int Li, int Lr, float scale, Dropout drop) {
  using S = AttnTc64;
  constexpr int D = S::D;
  if (DROP) drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  float* bias_s = reinterpret_cast<float*>(sm + S::O_BIAS);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int rl = 16 * warp + (lane >> 2), cl = 2 * (lane & 3);
  uint8_t* cn_s = sm + S::O_ROOM + wg * S::ROOM;
  const uint8_t* ce_s = cn_s + S::R_CE;
  // the pair of ce at (row half h, column c) of the thread's rows
  auto ce_pair = [&](int h, int c) {
    return tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(
        ce_s + tc::swz(rl + 8 * h, c)));
  };
  const uint32_t w_a = tc::smem_u32(sm + S::O_W);
  const int M = A * Lqa, T = (M + TM - 1) / TM;
  // item f = (b T + tile) Li + frame; the warpgroup's share [f0, f1)
  const long long items = static_cast<long long>(B) * T * Li;
  const long long nw = static_cast<long long>(gridDim.x) * S::NWG;
  const long long wk = static_cast<long long>(blockIdx.x) * S::NWG + wg;
  const int f0 = static_cast<int>(items * wk / nw);
  const int f1 = static_cast<int>(items * (wk + 1) / nw);
  auto slot = [&](int k) { return cn_s + S::R_SLOT + (k & 1) * S::SLOT; };
  // item f's frame: qn and qe rows (past Lr zeroed), q mask, into slot k
  auto load_frame = [&](int f, int k) {
    const int b = f / (T * Li), i = f % Li;
    const size_t fbase = (static_cast<size_t>(b) * Li + i) * Lr;
    uint8_t* sl = slot(k);
    tc_load_rows<D>(sl, LRP, qn + fbase * D, D, Lr, t, 128);
    tc_load_rows<D>(sl + S::S_QE, LRP, qe + fbase * D, D, Lr, t, 128);
    if (t < TM)
      reinterpret_cast<float*>(sl + S::S_QM)[t] =
          t < Lr ? qmask[fbase + t] : 0.f;
  };
  // item f's cn and ce rows (past M zeroed)
  auto load_cn = [&](int f) {
    const int b = f / (T * Li), m0 = (f / Li) % T * TM;
    const size_t at = (static_cast<size_t>(b) * M + m0) * D;
    tc_load_rows<D>(cn_s, TM, cn + at, D, min(TM, M - m0), t, 128);
    tc_load_rows<D>(cn_s + S::R_CE, TM, ce + at, D, min(TM, M - m0), t, 128);
  };
  if (f0 < f1) {
    load_cn(f0);
    load_frame(f0, 0);
  }
  tc_store_rows_f32<D>(sm + S::O_W, 3 * D, W, D, tid, S::NT);
  if (tid < D) bias_s[tid] = bias[tid];
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  tc::fence_async_smem();              // W (generic stores) and the copies
  __syncthreads();

  int unit = -1, b = 0, m0 = 0, target = -1;
  bool wlive = false;                  // a row of the warp's 16 is below M
  int m[2];
  bool live[2];
  float cm[2];
  size_t mbase[2];                     // the rows' flat row of mixed at i = 0
  for (int f = f0; f < f1; ++f) {
    const int k = f - f0, u = f / Li, i = f % Li;
    if (k > 0) {
      tc::cp_async_wait<0>();
      tc::fence_async_smem();
      tc::bar_sync(1 + wg, 128);       // item f's frame; item f - 1 is done
      if (u != unit) {                 // a new (b, tile): its cn, ce rows
        load_cn(f);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        tc::fence_async_smem();
        tc::bar_sync(1 + wg, 128);
      }
    }
    if (f + 1 < f1) load_frame(f + 1, k + 1);
    tc::cp_async_commit();
    if (u != unit) {
      unit = u;
      b = u / T;
      m0 = (u % T) * TM;
      target = targets != nullptr ? targets[b] : -1;
      wlive = m0 + 16 * warp < M;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[h] = m0 + rl + 8 * h;
        live[h] = m[h] < M;
        cm[h] = live[h] ? cmask[static_cast<size_t>(b) * M + m[h]] : 0.f;
        const int mm = live[h] ? m[h] : 0;
        mbase[h] = (static_cast<size_t>(b) * A + mm / Lqa) * Li * Lqa
                   + mm % Lqa;
      }
    }
    uint8_t* sl = slot(k);
    const float* qm_s = reinterpret_cast<const float*>(sl + S::S_QM);
    size_t mrow[2];                    // flat row of mixed / the LN output
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mrow[h] = mbase[h] + static_cast<size_t>(i) * Lqa;
    // the keep bits of the three LN groups, drawn while little is live (at
    // the LayerNorm, with att live, the draws spilled and ran slower)
    uint32_t kw[3][2];
    if constexpr (DROP) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        uint32_t k2[2][1];
        tc_keep_bits<D / 8, false>(
            drop, drop.key3((lane & 1) ? mrow[1] : mrow[0], g, 0), lane, k2);
        kw[g][0] = k2[0][0];
        kw[g][1] = k2[1][0];
      }
    }
    // ---- scores, the masked scores (raw) out, the softmax in place (the
    // arithmetic of tc_softmax, one array fewer, the exponential by the
    // fast path: 7% of a call at Lr 50) -----------------------------------
    float s[LRP / 2];
    tc_scores<LRP, D>(s, tc::smem_u32(cn_s), tc::smem_u32(sl));
#pragma unroll
    for (int kk = 0; kk < LRP / 2; ++kk) {
      const int h = (kk / 2) % 2, j = acc_col(kk, lane);
      const float smv = j < Lr ? cm[h] * qm_s[j] : 0.f;
      s[kk] = s[kk] - 1e10f * (1.f - smv);
    }
    if (raw != nullptr && wlive) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = m[h] / Lqa, w = m[h] % Lqa;
        if (!live[h] || (targets != nullptr && a != target)) continue;
        float* rr = targets == nullptr
            ? raw + mrow[h] * Lr
            : raw + ((static_cast<size_t>(b) * Li + i) * Lqa + w) * Lr;
#pragma unroll
        for (int kk = h * 2; kk < LRP / 2; kk += 4)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = acc_col(kk + e, lane);
            if (j < Lr) rr[j] = s[kk + e];
          }
      }
    }
    {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < LRP / 2; ++kk) {
        const int h = (kk / 2) % 2;
        s[kk] = acc_col(kk, lane) < Lr ? fmaxf(s[kk] * scale, SAFE_FLOOR)
                                       : -CUDART_INF_F;
        mx[h] = fmaxf(mx[h], s[kk]);
      }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
#pragma unroll
      for (int kk = 0; kk < LRP / 2; ++kk) {
        const int h = (kk / 2) % 2;
        s[kk] = acc_col(kk, lane) < Lr ? __expf(s[kk] - mx[h]) : 0.f;
        sum[h] += s[kk];
      }
      const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
#pragma unroll
      for (int kk = 0; kk < LRP / 2; ++kk) s[kk] *= inv[(kk / 2) % 2];
    }
    float att[D / 2];
    tc_att<LRP, 1>(att, s, cm, qm_s, tc::smem_u32(sl + S::S_QE), lane);

    // ---- LayerNorm statistics over [ce; att; ce * att] -------------------
    // value pair pr = 2 q + h: row half h, columns 8 q + cl and the next
    float mean[2], istd[2];
    {
      float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
      for (int pr = 0; pr < D / 4; ++pr) {
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
    // ---- the projection, yd from registers: group g's pairs rounded to
    // bf16 are the A fragments of its four depth steps (step kk's register
    // r holds pair 4 kk + r); a group's products are done before the next
    // group's fragments take their registers (holding all three groups'
    // spilled) ------------------------------------------------------------
    float acc[D / 2];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      uint32_t ya[4][4];
#pragma unroll
      for (int pr = 0; pr < D / 4; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = 8 * q + cl;
        const float2 c2 = ce_pair(h, c);
        const float a0 = att[2 * pr], a1 = att[2 * pr + 1];
        const float x0 = g == 0 ? c2.x : (g == 1 ? a0 : c2.x * a0);
        const float x1 = g == 0 ? c2.y : (g == 1 ? a1 : c2.y * a1);
        const float2 ga = __ldg(reinterpret_cast<const float2*>(
            gamma + g * D + c));
        const float2 be = __ldg(reinterpret_cast<const float2*>(
            beta + g * D + c));
        float y0 = (x0 - mean[h]) * istd[h] * ga.x + be.x;
        float y1 = (x1 - mean[h]) * istd[h] * ga.y + be.y;
        if constexpr (DROP) {
          const uint32_t bits = kw[g][h] >> (4 * q);
          y0 *= (bits & 1u) ? drop.scale : 0.f;
          y1 *= (bits & 2u) ? drop.scale : 0.f;
        }
        ya[pr >> 2][pr & 3] = tc::pack_bf16(y0, y1);
      }
      tc::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::mma_rs<D, 1>(
            acc, ya[kk],
            tc::make_desc(w_a + (4 * g + kk) * 2 * tc::ATOM_BYTES,
                          Shapes<D>::W_PANEL),
            g > 0 || kk > 0);
      tc::commit();
      tc::wait<0>();
    }
    tc::fence_regs(acc);
    // ---- bias, ReLU, out through the frame's qn slot (read by now) -------
    if (wlive) {
#pragma unroll
      for (int pr = 0; pr < D / 4; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        const float2 bv = *reinterpret_cast<const float2*>(bias_s + c);
        *reinterpret_cast<uint32_t*>(sl + tc::swz(rl + 8 * h, c)) =
            tc::pack_bf16(fmaxf(acc[2 * pr] + bv.x, 0.f),
                          fmaxf(acc[2 * pr + 1] + bv.y, 0.f));
      }
    }
    tc::bar_sync(1 + wg, 128);         // the output tile is whole
    const int rows = min(TM, M - m0);
    for (int q = t; q < rows * (D / 8); q += 128) {
      const int r = q >> 3, ch = q & 7, mm = m0 + r;
      const size_t row =
          ((static_cast<size_t>(b) * A + mm / Lqa) * Li + i) * Lqa + mm % Lqa;
      *reinterpret_cast<uint4*>(mixed + row * D + 8 * ch) =
          *reinterpret_cast<const uint4*>(sl + tc::swz_chunk(r, ch));
    }
  }
}

// ---- the bfloat16 instantiation at D = 256: W through a ring, in pairs ----
//
// W (3D x D) is 384 KB in bf16, and a warpgroup's 64 x 256 att and
// projection accumulators would take 128 registers a thread each.  So both
// warpgroups work on one 64-row tile at a time and split its columns:
// warpgroup wg owns columns [128 wg, 128 wg + 128) of att, of each LN group
// and of the projection.  The scores are computed once: warpgroup wg takes
// regions [LRP / 2 wg, LRP / 2 (wg + 1)), the softmax's row max and sum
// cross the warpgroups through shared memory, and p (bf16) goes to a tile
// from which both take p qe.  The LayerNorm's row sums cross the
// warpgroups as well (tri_row_pair_sums); the 64 x 3D LN output goes to
// one bf16 tile (over the cn tile, which the scores have read).  W comes
// rounded to bf16 once a call (the C entry's w_slab_pack_kernel: 24 slabs
// of 32 rows) through the copy engine's ring (SlabRing, wgmma.cuh: four
// slots, no block barrier a slab).  (Taking the LN output to the
// projection a third at a time, to give the ring seven slots, was slower
// on the card.)  Two CTAs on neighbouring SMs form a cluster over a pair
// of frames and take the same tile of each, so one pass of W serves two
// tiles; CTA 0 copies every slab into both (multicast).  A persistent
// grid: cluster c takes units [U c / n, U (c + 1) / n) of the U =
// ceil(frames / 2) x tiles (frame pair, tile) units, a frame's tiles in a
// row (its qn / qe loaded once); past the last frame a CTA runs empty
// tiles, so that both take the same slabs.

constexpr int WD = 256;
struct AttnWide {
  static constexpr int NSLOT = 4;                     // ring slots
  static constexpr int PER = 3 * WD / SLAB_ROWS;      // slabs a tile: 24
  static constexpr int O_QN = 0;                      // 64 x 256 bf16
  static constexpr int O_QE = O_QN + Shapes<WD>::TILE_BYTES;
  static constexpr int O_YD = O_QE + Shapes<WD>::TILE_BYTES;  // 64 x 3D
  // inside the yd tile until its stores: cn (panels 0-3), the softmax's
  // exchange (panel 10), p (panel 11)
  static constexpr int O_SX = O_YD + 10 * TILE_PANEL;
  static constexpr int O_P = O_YD + 11 * TILE_PANEL;
  static constexpr int O_RING = O_YD + 3 * (WD / 64) * TILE_PANEL;
  static constexpr int O_BAR = O_RING + NSLOT * SLAB_BYTES;  // full, empty
  static constexpr int O_EX = O_BAR + 2 * NSLOT * 8;  // [wg][row][2] sums
  static constexpr int O_QM = O_EX + 2 * TM * 2 * 4;
  static constexpr int SMEM = O_QM + TM * 4 + tc::ATOM_BYTES;
  static_assert(O_RING % tc::ATOM_BYTES == 0, "slots on atoms");
  static_assert(SMEM <= 232448, "shared memory of a block");
};

// DROP: the projection dropout is on (a train step); the serving
// instantiation holds no Philox code, which the compiler schedules the
// rest of the kernel around even when it does not run (it cost 30% on
// the card at dropout 0).
template <int LRP, bool DROP>
__global__ void __launch_bounds__(NTHREADS, 1)
qa_ctx_fwd_tc_wide_kernel(const __nv_bfloat16* __restrict__ cn,
                          const __nv_bfloat16* __restrict__ ce,
                          const __nv_bfloat16* __restrict__ qn,
                          const __nv_bfloat16* __restrict__ qe,
                          const float* __restrict__ cmask,
                          const float* __restrict__ qmask,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          const __nv_bfloat16* __restrict__ wp,
                          const float* __restrict__ bias,
                          const int* __restrict__ targets,
                          __nv_bfloat16* __restrict__ mixed,
                          float* __restrict__ raw, int F, int A, int Lqa,
                          int Li, int Lr, float scale, Dropout drop) {
  constexpr int D = WD, NH = LRP / 2;  // a warpgroup's regions
  using S = AttnWide;
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  uint8_t* qn_s = sm + S::O_QN;
  uint8_t* qe_s = sm + S::O_QE;
  uint8_t* yd_s = sm + S::O_YD;        // holds the tile's cn rows first
  uint8_t* p_s = sm + S::O_P;
  float* sx_s = reinterpret_cast<float*>(sm + S::O_SX);
  float* ex_s = reinterpret_cast<float*>(sm + S::O_EX);
  float* qm_s = reinterpret_cast<float*>(sm + S::O_QM);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int rl = 16 * warp + (lane >> 2);             // first of two rows
  const int half = 128 * wg, cl = 2 * (lane & 3), r0 = NH * wg;

  const int M = A * Lqa, T = (M + TM - 1) / TM;
  const int rank = static_cast<int>(tc::cluster_rank());
  const long long units = static_cast<long long>((F + 1) / 2) * T;
  const long long cid = tc::cluster_id(), ncl = tc::cluster_count();
  const int u0 = static_cast<int>(units * cid / ncl);
  const int u1 = static_cast<int>(units * (cid + 1) / ncl);
  SlabRing<S::NSLOT, S::PER, 2> ring;
  ring.init(sm + S::O_RING, reinterpret_cast<uint64_t*>(sm + S::O_BAR), wp,
            (u1 - u0) * S::PER);
  tc::cluster_sync();                  // both CTAs' barriers are initialised
  ring.refill();

  int loaded = -1;                     // the frame in qn_s / qe_s
  for (int u = u0; u < u1; ++u) {
    const int f = 2 * (u / T) + rank, m0 = (u % T) * TM;
    const bool fok = f < F;            // else an empty tile
    const int b = fok ? f / Li : 0, i = fok ? f % Li : 0;
    const int Mf = fok ? M : 0;
    const int target = targets != nullptr && fok ? targets[b] : -1;
    const size_t fbase = (static_cast<size_t>(b) * Li + i) * Lr;
    // ---- the frame's qn, qe (once), the tile's cn rows -----------------
    __syncthreads();                   // the previous tile's reads are done
    if (f != loaded) {
      tc_load_rows<D>(qn_s, TM, qn + fbase * D, D, fok ? Lr : 0, tid,
                      NTHREADS);
      tc_load_rows<D>(qe_s, TM, qe + fbase * D, D, fok ? Lr : 0, tid,
                      NTHREADS);
      if (tid < TM) qm_s[tid] = fok && tid < Lr ? qmask[fbase + tid] : 0.f;
      loaded = f;
    }
    tc_load_rows<D>(yd_s, TM, cn + (static_cast<size_t>(b) * M + m0) * D, D,
                    max(0, min(TM, Mf - m0)), tid, NTHREADS);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    tc::fence_async_smem();
    __syncthreads();
    // ---- scores of the warpgroup's regions, the softmax across both ------
    float s[NH / 2], p0[NH / 2];
    tc_scores<NH, D>(s, tc::smem_u32(yd_s),
                     tc::smem_u32(qn_s) + r0 * tc::ROW_BYTES);
    int m[2];
    bool live[2];
    float cm[2];
    size_t mrow[2];                    // flat row of mixed / the LN output
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = m0 + rl + 8 * h;
      live[h] = m[h] < Mf;
      cm[h] = live[h] ? cmask[static_cast<size_t>(b) * M + m[h]] : 0.f;
      mrow[h] = mixed_row(b, live[h] ? m[h] : 0, i, A, Lqa, Li);
    }
    // the arithmetic of tc_softmax, its row max and sum over both halves
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NH / 2; ++k) {
      const int h = (k / 2) % 2, j = r0 + acc_col(k, lane);
      const bool v = j < Lr;
      const float smv = v ? cm[h] * qm_s[j] : 0.f;
      const float mk = s[k] - 1e10f * (1.f - smv);
      s[k] = mk;
      p0[k] = v ? fmaxf(mk * scale, SAFE_FLOOR) : -CUDART_INF_F;
      mx[h] = fmaxf(mx[h], p0[k]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      if ((lane & 3) == 0) sx_s[(wg * TM + rl + 8 * h) * 2] = mx[h];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mx[h] = fmaxf(sx_s[(rl + 8 * h) * 2], sx_s[(TM + rl + 8 * h) * 2]);
#pragma unroll
    for (int k = 0; k < NH / 2; ++k) {
      const int h = (k / 2) % 2;
      p0[k] = r0 + acc_col(k, lane) < Lr ? expf(p0[k] - mx[h]) : 0.f;
      sum[h] += p0[k];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] = quad_sum(sum[h]);
      if ((lane & 3) == 0) sx_s[(wg * TM + rl + 8 * h) * 2 + 1] = sum[h];
    }
    if (raw != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = m[h] / Lqa, w = m[h] % Lqa;
        if (!live[h] || (targets != nullptr && a != target)) continue;
        float* rr = targets == nullptr
            ? raw + mrow[h] * Lr
            : raw + ((static_cast<size_t>(b) * Li + i) * Lqa + w) * Lr;
#pragma unroll
        for (int k = h * 2; k < NH / 2; k += 4)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = r0 + acc_col(k + e, lane);
            if (j < Lr) rr[j] = s[k + e];
          }
      }
    }
    __syncthreads();
    // p = p0 / sum * mask rounded to bf16 into the p tile (K-major)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = 1.f / (sx_s[(rl + 8 * h) * 2 + 1]
                               + sx_s[(TM + rl + 8 * h) * 2 + 1]);
#pragma unroll
      for (int q = 0; q < NH / 8; ++q) {
        const int k = 4 * q + 2 * h, j = r0 + acc_col(k, lane);
        *reinterpret_cast<uint32_t*>(p_s + tc::swz(rl + 8 * h, j)) =
            tc::pack_bf16((p0[k] * inv) * (cm[h] * qm_s[j]),
                          (p0[k + 1] * inv) * (cm[h] * qm_s[j + 1]));
      }
    }
    tc::fence_async_smem();
    __syncthreads();                   // the p tile is whole
    float att[64];                     // the warpgroup's 128 columns
    {
      const uint32_t pa = tc::smem_u32(p_s);
      const uint32_t qa = tc::smem_u32(qe_s) + 2 * wg * TILE_PANEL;
      tc::fence();
#pragma unroll
      for (int ts = 0; ts < LRP / 16; ++ts)
        tc::mma_ss<128, 0, 1>(
            att, tc::make_desc(pa + ts * 32, 16),
            tc::make_desc(qa + ts * 2 * tc::ATOM_BYTES, TILE_PANEL), ts > 0);
      tc::commit();
      tc::wait_all();
    }

    // ---- LayerNorm over [ce; att; ce * att], dropout, bf16 tile ---------
    uint32_t cev[32];
    float ls[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
    for (int pr = 0; pr < 32; ++pr) {
      const int h = pr & 1, c = half + 8 * (pr >> 1) + cl;
      cev[pr] = live[h]
          ? __ldg(reinterpret_cast<const unsigned int*>(
                ce + (static_cast<size_t>(b) * M + m[h]) * D + c))
          : 0u;
      const float2 c2 = tc::unpack_bf16(cev[pr]);
      const float a0 = att[2 * pr], a1 = att[2 * pr + 1];
      const float x0 = c2.x * a0, x1 = c2.y * a1;
      ls[h] += (c2.x + c2.y) + (a0 + a1) + (x0 + x1);
      sq[h] += fmaf(c2.x, c2.x, c2.y * c2.y) + fmaf(a0, a0, a1 * a1)
               + fmaf(x0, x0, x1 * x1);
    }
    // both warpgroups' sums; its barrier also orders every warpgroup's
    // score and att products (which read cn and p) before the yd stores
    tri_row_pair_sums(ex_s, ls, sq, wg, rl, lane);
    float mean[2], istd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = ls[h] * drop.inv3;
      istd[h] = rsqrtf(sq[h] * drop.inv3 - mean[h] * mean[h] + LN_EPS);
    }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      uint32_t kw[2][2] = {{~0u, ~0u}, {~0u, ~0u}};
      if (DROP)                        // a call: no product is in flight
        tc_keep_bits<16, true>(
            drop, drop.key3((lane & 1) ? mrow[1] : mrow[0], g, half), lane,
            kw);
#pragma unroll
      for (int pr = 0; pr < 32; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = half + 8 * q + cl;
        const float2 c2 = tc::unpack_bf16(cev[pr]);
        const float a0 = att[2 * pr], a1 = att[2 * pr + 1];
        const float x0 = g == 0 ? c2.x : (g == 1 ? a0 : c2.x * a0);
        const float x1 = g == 0 ? c2.y : (g == 1 ? a1 : c2.y * a1);
        const float2 ga = __ldg(reinterpret_cast<const float2*>(
            gamma + g * D + c));
        const float2 be = __ldg(reinterpret_cast<const float2*>(
            beta + g * D + c));
        float y0 = (x0 - mean[h]) * istd[h] * ga.x + be.x;
        float y1 = (x1 - mean[h]) * istd[h] * ga.y + be.y;
        if (DROP) {
          const uint32_t bits = kw[h][q >> 3] >> (4 * (q & 7));
          y0 *= (bits & 1u) ? drop.scale : 0.f;
          y1 *= (bits & 2u) ? drop.scale : 0.f;
        }
        *reinterpret_cast<uint32_t*>(
            yd_s + (g * (D / 64) + (c >> 6)) * TILE_PANEL
            + tc::swz(rl + 8 * h, c & 63)) = tc::pack_bf16(y0, y1);
      }
    }
    tc::fence_async_smem();
    __syncthreads();                   // the yd tile is whole
    // ---- the projection: (64 x 3D) . W (3D x D), W from the ring ----------
    float acc[64];
    mma_ring_w<S::PER>(acc, tc::smem_u32(yd_s), ring, wg, lane);
#pragma unroll
    for (int pr = 0; pr < 32; ++pr) {
      const int h = pr & 1, c = half + 8 * (pr >> 1) + cl;
      if (!live[h]) continue;
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + c));
      *reinterpret_cast<uint32_t*>(mixed + mrow[h] * D + c) =
          tc::pack_bf16(fmaxf(acc[2 * pr] + bv.x, 0.f),
                        fmaxf(acc[2 * pr + 1] + bv.y, 0.f));
    }
  }
  tc::cluster_sync();                  // no CTA leaves while its pair copies
}

template <int D, int LRP>
int launch_tc(const void* cn, const void* ce, const void* qn, const void* qe,
              const float* cmask, const float* qmask, const float* gamma,
              const float* beta, const void* W, const float* bias,
              const int* targets, void* mixed, float* raw, void* wp, int B,
              int A, int Lqa, int Li, int Lr, float scale, Dropout drop,
              cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  if constexpr (D == WD) {
    // W rounded into its slabs, then clusters of two CTAs over (frame
    // pair, tile) units, at most as many as the card holds at once
    auto kern = drop.threshold != 0u ? qa_ctx_fwd_tc_wide_kernel<LRP, true>
                                     : qa_ctx_fwd_tc_wide_kernel<LRP, false>;
    static int most[2] = {0, 0};
    int& n = most[drop.threshold != 0u];
    cudaError_t err = allow_smem(kern, AttnWide::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n == 0) n = pair_clusters(kern, AttnWide::SMEM);
    if (n == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    w_slab_pack_kernel<D><<<dim3(3 * D * D / 8 / NTHREADS, 1), NTHREADS, 0,
                            stream>>>(static_cast<const float*>(W), nullptr,
                                      3 * D, static_cast<bf16*>(wp));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long units = static_cast<long long>((B * Li + 1) / 2)
                            * ((A * Lqa + TM - 1) / TM);
    const int clusters = units < n ? static_cast<int>(units) : n;
    return static_cast<int>(launch_pairs(
        kern, clusters, AttnWide::SMEM, stream, h(cn), h(ce), h(qn), h(qe),
        cmask, qmask, gamma, beta, h(wp), bias, targets,
        static_cast<bf16*>(mixed), raw, B * Li, A, Lqa, Li, Lr, scale,
        drop));
  } else if constexpr (D == 64) {
    // persistent: at most one CTA an SM over the B T Li (b, tile, frame)
    // items, three warpgroups a CTA
    using S = AttnTc64;
    auto kern = drop.threshold != 0u ? qa_ctx_fwd_tc64_kernel<LRP, true>
                                     : qa_ctx_fwd_tc64_kernel<LRP, false>;
    cudaError_t err = allow_smem(kern, S::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const long long items = static_cast<long long>(B) * Li
                            * ((A * Lqa + TM - 1) / TM);
    const long long ctas = (items + S::NWG - 1) / S::NWG;
    if (ctas == 0) return static_cast<int>(cudaSuccess);
    kern<<<static_cast<int>(ctas < sms ? ctas : sms), S::NT, S::SMEM,
           stream>>>(h(cn), h(ce), h(qn), h(qe), cmask, qmask, gamma, beta,
                     static_cast<const float*>(W), bias, targets,
                     static_cast<bf16*>(mixed), raw, B, A, Lqa, Li, Lr, scale,
                     drop);
    return static_cast<int>(cudaGetLastError());
  } else {
    auto kern = qa_ctx_fwd_tc_kernel<D, LRP>;
    cudaError_t err = allow_smem(kern, AttnTc<D>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(Li, B), NTHREADS, AttnTc<D>::SMEM, stream>>>(
        h(cn), h(ce), h(qn), h(qe), cmask, qmask, gamma, beta, h(W), bias,
        targets, static_cast<bf16*>(mixed), raw, A, Lqa, Li, Lr, scale,
        drop);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int D>
int launch_width(const void* cn, const void* ce, const void* qn,
                 const void* qe, const float* cmask, const float* qmask,
                 const float* gamma, const float* beta, const void* W,
                 const float* bias, const int* targets, void* mixed,
                 float* raw, void* wp, int B, int A, int Lqa, int Li, int Lr,
                 float scale, Dropout drop, int is_bf16, cudaStream_t s) {
  if (is_bf16 && D == WD && wp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && Lr <= 32)
    return launch_tc<D, 32>(cn, ce, qn, qe, cmask, qmask, gamma, beta, W,
                            bias, targets, mixed, raw, wp, B, A, Lqa, Li, Lr,
                            scale, drop, s);
  if (is_bf16)
    return launch_tc<D, 64>(cn, ce, qn, qe, cmask, qmask, gamma, beta, W,
                            bias, targets, mixed, raw, wp, B, A, Lqa, Li, Lr,
                            scale, drop, s);
  return launch<float, D>(cn, ce, qn, qe, cmask, qmask, gamma, beta,
                          static_cast<const float*>(W), bias, targets, mixed,
                          raw, B, A, Lqa, Li, Lr, scale, drop, s);
}

}  // namespace

// cn, ce: (B, A, Lqa, D); qn, qe: (B, Li, Lr, D), all of one type (bf16
// when is_bf16, else float32), D one of 64, 128, 256; masks, gamma/beta
// (3D), bias (D) float32; W (3D, D) float32, or bfloat16 when is_bf16 at
// D = 128; mixed (B, A, Li, Lqa, D) in the activation type; raw
// float32: (B, A, Li, Lqa, Lr) when targets is NULL, else (B, Li, Lqa, Lr)
// at targets[b] (int32, B); raw NULL writes none.  wp: scratch for W in
// bf16 slabs (3 D D bf16, 16-byte aligned) of the bf16 kernel at D = 256,
// NULL otherwise.  Lr <= 64.  Dropout on the LN output when
// drop_threshold > 0 (philox.cuh).
// dv: the true width, 4 <= dv <= D with 4 | dv, of inputs zero-padded to D
// (every LN's statistics and the Philox keys, philox.cuh).
extern "C" int qa_ctx_attention_fwd(
    const void* cn, const void* ce, const void* qn, const void* qe,
    const void* cmask, const void* qmask, const void* gamma,
    const void* beta, const void* W, const void* bias, const void* targets,
    void* mixed, void* raw, void* wp, int B, int A, int Lqa, int Li, int Lr,
    int D, float scale, const unsigned long long* drop_seed,
    unsigned drop_threshold, float drop_scale, int dv, int is_bf16,
    void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  const Dropout drop =
      entry_dropout(drop_seed, drop_threshold, drop_scale, dv);
  if (!width_ok(dv, D)) return static_cast<int>(cudaErrorInvalidValue);
  const int* tg = static_cast<const int*>(targets);
  if (Lr > TM) return static_cast<int>(cudaErrorInvalidValue);
#define TVQA_ATTN_FWD(DD)                                                    \
  case DD:                                                                   \
    return launch_width<DD>(cn, ce, qn, qe, f(cmask), f(qmask), f(gamma),    \
                            f(beta), W, f(bias), tg, mixed,                  \
                            static_cast<float*>(raw), wp, B, A, Lqa, Li, Lr, \
                            scale, drop, is_bf16, s);
  switch (D) {
    TVQA_ATTN_FWD(64)
    TVQA_ATTN_FWD(128)
    TVQA_ATTN_FWD(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TVQA_ATTN_FWD
}
