// Fused tri-concat MLP bridge, backward, at the hidden width D = 128 (D =
// 64 and 256: tri_bridge_bwd_wide.cu).
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_tri_bridge.py
// (_backward / _bwd_kernel).  Row-local: for every row it recomputes
// x = [s; v; s*v], y = LN_in(x) times the replayed Philox dropout mask
// (yd), y1 = yd W + b, y2 = ReLU(y1) and the LN_out statistics, then with
// the cotangent g of the output:
//   g_y2 = LN_out backward,  ggout = sum g xhat2,  gbout = sum g
//   g_y1 = g_y2 (y1 > 0),    gb = sum g_y1,  gW = yd^T g_y1
//   g_y = (g_y1 W^T) keep,   ggin = sum g_y xhat,  gbin = sum g_y
//   gx = LN_in backward over the virtual 3D concat
//   gs = gx0 + gx2 v,  gv = gx1 + gx2 s      (in the activation type)
//
// What bounds it on the H100: at the headline train shapes (160,000 rows)
// it reads s, v and g and writes gs and gv (~205 MB in bf16) and does
// ~47 GFLOP (the y1 recompute, g_yd and gW), so at the card's peaks it is
// bound by bytes (~61 us).
//
// Two instantiations.
// * bfloat16 (what the main paths run): every product a wgmma on bf16
//   operands with float32 sums, rounded where the TPU kernel's bf16 compute
//   mode rounds (yd, W, g_y1; pallas_tri_bridge.py:77-79, :157-162).  The
//   function is the tail of the attention backward (qa_ctx_bwd_tc_kernel)
//   plus an LN_out backward over D, and so is the design:
//   - tri_bridge_bwd_tc_kernel, one resident block per SM walking 64-row
//     tiles, W (bf16, 96 KB) in shared memory for the block's life, read
//     MN-major for y1 = yd W and K-major for g_yd = g_y1 W^T.  The LN_in
//     backward needs a row's three 128-wide groups at once (192
//     accumulators for 64 rows), so the two warpgroups SHARE each tile and
//     split the columns: warpgroup h owns columns [64 h, 64 h + 64) of s, v,
//     y1, g_y1 and of every LN group.  Row statistics cross the warpgroups
//     through shared memory; the parameter-vector sums fold over the lanes
//     that hold a column's other rows and go to one slot per block.  The
//     yd and g_y1 rows go out in bf16 (123 + 41 MB at the headline shapes).
//     The recompute (LN_in statistics, yd, y1 = yd W, LN_out statistics)
//     is tri_bridge_tc.cuh's, shared with the forward's
//     tri_bridge_fwd_tc_kernel.
//   - wgrad_tc_kernel (wgrad_tc.cuh): gW and gb from those rows.
//   Rows past R (a ragged last tile) are zero and masked.
// * float32: the exactness check, CUDA cores: one block per 32-row tile,
//   each warp 4 rows; both products stage their weight from L2 32 rows at
//   a time; yd and g_y1 rows in float32 for grad_reduce.cuh's
//   weight-gradient GEMM.
// Sums across blocks go through scratch slots and a fixed-order second pass
// (grad_reduce.cuh) in both: the same bits from run to run, no atomics.
#include "grad_reduce.cuh"
#include "philox.cuh"
#include "tri_bridge_tc.cuh"
#include "wgrad_tc.cuh"

namespace {

using namespace tvqa;

constexpr int RPT = 4;
constexpr int RT = RPT * NWARPS;        // 32 rows per block
constexpr int NV = 9 * D;  // ggin (3D), gbin (3D), gb, ggout, gbout (D)
constexpr int SMEM_FLOATS = RT * 3 * D + RT * D + KC * D + 2 * RT;

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = to_f(p[t]);
}

template <typename T, bool PAD>
__global__ void __launch_bounds__(NTHREADS)
tri_bridge_bwd_kernel(const T* __restrict__ s, const T* __restrict__ v,
                      const float* __restrict__ gin,
                      const float* __restrict__ bin,
                      const float* __restrict__ W,
                      const float* __restrict__ Wt,
                      const float* __restrict__ bias,
                      const float* __restrict__ gout,
                      const T* __restrict__ gy, T* __restrict__ gs,
                      T* __restrict__ gv, float* __restrict__ yd_buf,
                      float* __restrict__ gy1_buf,
                      float* __restrict__ vec_part, long long R,
                      Dropout drop) {
  drop.load_seed();
  // at dv = D (PAD false) the constants and keys of the kernel before the
  // true width: ptxas contracts multiplies and adds by heuristics that other
  // code sways, and only the same code kept this float32 exactness check's
  // bits
  const float inv1 = PAD ? drop.inv1 : 1.f / D;
  const float inv3 = PAD ? drop.inv3 : 1.f / (3 * D);
  extern __shared__ float4 smem4[];
  float* y_s = reinterpret_cast<float*>(smem4);       // RT x 3D
  float* g1_s = y_s + RT * 3 * D;                      // RT x D
  float* w_s = g1_s + RT * D;                          // KC x D
  float* st_s = w_s + KC * D;                          // RT x 2
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = lane * 4;
  const long long r0 = static_cast<long long>(blockIdx.x) * RT;

  float vgi[3][4], vbi[3][4], vgb[4], vgo[4], vbo[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    vgb[t] = vgo[t] = vbo[t] = 0.f;
#pragma unroll
    for (int g = 0; g < 3; ++g) vgi[g][t] = vbi[g][t] = 0.f;
  }

  // ---- recompute yd = dropout(LN_in([s; v; s*v])) ----------------------
#pragma unroll
  for (int jj = 0; jj < RPT; ++jj) {
    const int r = warp * RPT + jj;
    const long long row = r0 + r;
    float* yr = y_s + r * 3 * D;
    if (row >= R) {
#pragma unroll
      for (int g = 0; g < 3; ++g)
        *reinterpret_cast<float4*>(yr + g * D + c0) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    float sv[4], vv[4], x[3][4], sum = 0.f, ss = 0.f;
    load4(s + row * D + c0, sv);
    load4(v + row * D + c0, vv);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x[0][t] = sv[t];
      x[1][t] = vv[t];
      x[2][t] = sv[t] * vv[t];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        sum += x[g][t];
        ss = fmaf(x[g][t], x[g][t], ss);
      }
    }
    sum = warp_sum(sum);
    ss = warp_sum(ss);
    const float mean = sum * inv3;
    const float istd =
        rsqrtf(fmaxf(ss * inv3 - mean * mean, 0.f) + LN_EPS);
    if (lane == 0) {
      st_s[2 * r] = mean;
      st_s[2 * r + 1] = istd;
    }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float km[4] = {1.f, 1.f, 1.f, 1.f};
      const int k0 = g * D + c0;
      if (drop.on())
        keep4(drop.seed,
              PAD ? drop.key3(row, g, c0)
                  : static_cast<unsigned long long>(row) * (3 * D) + k0,
              drop.threshold, drop.scale, km);
      float y[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        y[t] = ((x[g][t] - mean) * istd * gin[k0 + t] + bin[k0 + t]) * km[t];
      const float4 y4 = make_float4(y[0], y[1], y[2], y[3]);
      *reinterpret_cast<float4*>(yr + k0) = y4;
      *reinterpret_cast<float4*>(yd_buf + row * (3 * D) + k0) = y4;
    }
  }

  // ---- y1 = yd W + b; LN_out and ReLU backward --------------------------
  float acc[RPT][4];
  gemm_staged<RPT>(acc, y_s, 3 * D, 3 * D, W, w_s, warp * RPT, c0);
  const float4 bv = *reinterpret_cast<const float4*>(bias + c0);
  const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int jj = 0; jj < RPT; ++jj) {
    const int r = warp * RPT + jj;
    const long long row = r0 + r;
    float g1[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < R) {
      float y1[4], y2[4], sum = 0.f, ss = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        y1[t] = acc[jj][t] + bb[t];
        y2[t] = fmaxf(y1[t], 0.f);
        sum += y2[t];
        ss = fmaf(y2[t], y2[t], ss);
      }
      sum = warp_sum(sum);
      ss = warp_sum(ss);
      const float mean = sum * inv1;
      const float istd =
          rsqrtf(fmaxf(ss * inv1 - mean * mean, 0.f) + LN_EPS);
      float gg[4], xh[4], gxh[4], s1 = 0.f, s2 = 0.f;
      load4(gy + row * D + c0, gg);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        xh[t] = (y2[t] - mean) * istd;
        gxh[t] = gg[t] * gout[c0 + t];
        s1 += gxh[t];
        s2 = fmaf(gxh[t], xh[t], s2);
        vgo[t] = fmaf(gg[t], xh[t], vgo[t]);
        vbo[t] += gg[t];
      }
      const float m1 = warp_sum(s1) * inv1;
      const float m2 = warp_sum(s2) * inv1;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float g2 = istd * (gxh[t] - m1 - xh[t] * m2);
        g1[t] = y1[t] > 0.f ? g2 : 0.f;
        vgb[t] += g1[t];
      }
      *reinterpret_cast<float4*>(gy1_buf + row * D + c0) =
          make_float4(g1[0], g1[1], g1[2], g1[3]);
    }
    *reinterpret_cast<float4*>(g1_s + r * D + c0) =
        make_float4(g1[0], g1[1], g1[2], g1[3]);
  }

  // ---- g_yd = g_y1 W^T; dropout replay; LN_in backward ------------------
  float acc3[3][RPT][4];
#pragma unroll
  for (int g = 0; g < 3; ++g)
    gemm_staged_ld<RPT>(acc3[g], g1_s, D, D, Wt + g * D, 3 * D, w_s,
                        warp * RPT, c0);
#pragma unroll
  for (int jj = 0; jj < RPT; ++jj) {
    const int r = warp * RPT + jj;
    const long long row = r0 + r;
    if (row >= R) continue;
    const float mean = st_s[2 * r], istd = st_s[2 * r + 1];
    float sv[4], vv[4], xh[3][4], gxh[3][4], s1 = 0.f, s2 = 0.f;
    load4(s + row * D + c0, sv);
    load4(v + row * D + c0, vv);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float km[4] = {1.f, 1.f, 1.f, 1.f};
      const int k0 = g * D + c0;
      if (drop.on())
        keep4(drop.seed,
              PAD ? drop.key3(row, g, c0)
                  : static_cast<unsigned long long>(row) * (3 * D) + k0,
              drop.threshold, drop.scale, km);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float x = g == 0 ? sv[t] : (g == 1 ? vv[t] : sv[t] * vv[t]);
        xh[g][t] = (x - mean) * istd;
        const float gyv = acc3[g][jj][t] * km[t];
        vgi[g][t] = fmaf(gyv, xh[g][t], vgi[g][t]);
        vbi[g][t] += gyv;
        gxh[g][t] = gyv * gin[k0 + t];
        s1 += gxh[g][t];
        s2 = fmaf(gxh[g][t], xh[g][t], s2);
      }
    }
    const float m1 = warp_sum(s1) * inv3;
    const float m2 = warp_sum(s2) * inv3;
    float os[4], ov[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float gx[3];
#pragma unroll
      for (int g = 0; g < 3; ++g)
        gx[g] = istd * (gxh[g][t] - m1 - xh[g][t] * m2);
      os[t] = gx[0] + gx[2] * vv[t];
      ov[t] = gx[1] + gx[2] * sv[t];
    }
    store4<T>(gs + row * D + c0, os[0], os[1], os[2], os[3]);
    store4<T>(gv + row * D + c0, ov[0], ov[1], ov[2], ov[3]);
  }

  // ---- the block's parameter-vector partials, warps summed in order ----
  __syncthreads();
  float* red = y_s;                    // NWARPS x NV <= RT x 3D floats
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      red[warp * NV + g * D + c0 + t] = vgi[g][t];
      red[warp * NV + 3 * D + g * D + c0 + t] = vbi[g][t];
    }
    red[warp * NV + 6 * D + c0 + t] = vgb[t];
    red[warp * NV + 7 * D + c0 + t] = vgo[t];
    red[warp * NV + 8 * D + c0 + t] = vbo[t];
  }
  __syncthreads();
  for (int k = tid; k < NV; k += NTHREADS) {
    float acc_k = 0.f;
    for (int wp = 0; wp < NWARPS; ++wp) acc_k += red[wp * NV + k];
    vec_part[static_cast<size_t>(blockIdx.x) * NV + k] = acc_k;
  }
}

template <typename T>
int launch(const void* s, const void* v, const float* gin, const float* bin,
           const float* W, const float* Wt, const float* bias,
           const float* gout, const void* g, void* gs, void* gv,
           float* gvec, float* gw, float* yd_buf, float* gy1_buf,
           float* vec_part, float* wg_part, long long R, int wg_chunks,
           Dropout drop, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * SMEM_FLOATS;
  auto kern = drop.dv == D ? tri_bridge_bwd_kernel<T, false>
                           : tri_bridge_bwd_kernel<T, true>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((R + RT - 1) / RT);
  kern<<<blocks, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(v), gin, bin, W, Wt,
      bias, gout, static_cast<const T*>(g), static_cast<T*>(gs),
      static_cast<T*>(gv), yd_buf, gy1_buf, vec_part, R, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = wgrad(yd_buf, gy1_buf, wg_part, gw, R, 3 * D, D, wg_chunks,
                   stream)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(sum_slots<float>(vec_part, gvec, 1, blocks, NV,
                                           stream));
}


// ---- the bfloat16 instantiation: tensor cores ------------------------------

constexpr int NVT = 8 * D;    // ggin (3D), gbin (3D), ggout, gbout (D)
constexpr int O_S = W_BYTES;                        // the tile's s rows
constexpr int O_V = O_S + TILE_BYTES;               // v rows
constexpr int O_YD = O_V + TILE_BYTES;              // yd (64 x 3D)
constexpr int O_G1 = O_YD + 6 * TILE_PANEL;         // g_y1 (64 x D)
constexpr int O_EX = O_G1 + TILE_BYTES;             // [4][wg][row][2] sums
constexpr int O_PV = O_EX + 4 * 2 * TM * 2 * 4;     // gin, bin, bias, gout
constexpr int TC_SMEM = O_PV + 8 * D * 4 + tc::ATOM_BYTES;

// Sums over the thread's two rows and the eight lanes that hold the
// column's other rows of v[i] (column pair i / 2, element i % 2); after it
// v[0], v[1] hold columns 8 (b2 + 2 b3 + 4 b4) + 2 (lane % 4) + {0, 1}
// (bN = bit N of lane), added into acc.
__device__ __forceinline__ void fold_cols(float (&v)[16], float (&acc)[2],
                                          int lane) {
  fold<16>(v, 16, lane);
  fold<8>(v, 8, lane);
  fold<4>(v, 4, lane);
  acc[0] += v[0];
  acc[1] += v[1];
}

__global__ void __launch_bounds__(NTHREADS, 1)
tri_bridge_bwd_tc_kernel(const __nv_bfloat16* __restrict__ s,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ gin,
                         const float* __restrict__ bin,
                         const __nv_bfloat16* __restrict__ W,
                         const float* __restrict__ bias,
                         const float* __restrict__ gout,
                         const __nv_bfloat16* __restrict__ gy,
                         __nv_bfloat16* __restrict__ gs,
                         __nv_bfloat16* __restrict__ gv,
                         __nv_bfloat16* __restrict__ yd_rows,
                         __nv_bfloat16* __restrict__ gy1_rows,
                         float* __restrict__ vec_part, long long R,
                         Dropout drop) {
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  uint8_t* w_s = sm;
  uint8_t* s_s = sm + O_S;
  uint8_t* v_s = sm + O_V;
  uint8_t* yd_s = sm + O_YD;
  uint8_t* g1_s = sm + O_G1;
  float* ex_s = reinterpret_cast<float*>(sm + O_EX);
  float* gin_s = reinterpret_cast<float*>(sm + O_PV);
  float* bin_s = gin_s + 3 * D;
  float* bias_s = bin_s + 3 * D;
  float* gout_s = bias_s + D;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int rl = 16 * warp + (lane >> 2);
  const int cl = 2 * (lane & 3);
  const int half = 64 * wg;
  for (int k = tid; k < 3 * D; k += NTHREADS) {
    gin_s[k] = gin[k];
    bin_s[k] = bin[k];
  }
  if (tid < D) {
    bias_s[tid] = bias[tid];
    gout_s[tid] = gout[tid];
  }
  tc_load_rows(w_s, W_ROWS, W, D, W_ROWS, tid, NTHREADS);
  tc::cp_async_commit();
  float vgi[3][2], vbi[3][2], vgo[2] = {0.f, 0.f}, vbo[2] = {0.f, 0.f};
#pragma unroll
  for (int g = 0; g < 3; ++g)
    vgi[g][0] = vgi[g][1] = vbi[g][0] = vbi[g][1] = 0.f;

  const long long tiles = (R + TM - 1) / TM;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * TM;
    const int rows = static_cast<int>(min(static_cast<long long>(TM),
                                          R - r0));
    __syncthreads();                   // the previous tile is consumed
    tc_load_rows(s_s, TM, s + r0 * D, D, rows, tid, NTHREADS);
    tc_load_rows(v_s, TM, v + r0 * D, D, rows, tid, NTHREADS);
    tc::cp_async_commit();
    bool live[2];
    long long row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      live[h] = rl + 8 * h < rows;
      row[h] = r0 + (live[h] ? rl + 8 * h : 0);
    }
    // the dropout's keep bits of the three groups
    uint32_t kw[3][2][1];
    tri_keep_bits(drop, row, lane, half, kw);
    tc::cp_async_wait<0>();
    tc::fence_async_smem();            // W (first tile) is read by wgmma
    __syncthreads();
    // ---- LN_in statistics over [s; v; s * v] (fast variance, clipped) ---
    float mean[2], istd[2];
    tri_ln_in_stats(s_s, v_s, ex_s, mean, istd, wg, rl, lane, drop.inv3);
    // ---- yd = dropout(LN_in(x)) into the bf16 tile and out as rows ------
    tri_yd_tile<true>(s_s, v_s, yd_s, kw, drop, mean, istd, gin_s, bin_s,
                      yd_rows, live, row, wg, rl, lane);
    tc::fence_async_smem();
    __syncthreads();                   // the yd tile is whole
    // ---- y1 = yd W (own columns); LN_out and ReLU backward ---------------
    float acc[32], m2[2], i2[2];
    tri_y1_mma(acc, yd_s, w_s, wg);
    tri_ln_out_stats(acc, bias_s, ex_s + 2 * TM * 2, m2, i2, wg, rl, lane,
                     drop.inv1);
    float gg[32], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
    {
      float tg[16], tb[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) tg[k] = tb[k] = 0.f;
#pragma unroll
      for (int pr = 0; pr < 16; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = half + 8 * q + cl;
        const float2 g2 = live[h]
            ? tc::unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(
                  gy + row[h] * D + c)))
            : make_float2(0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * pr + e;
          const float g = e ? g2.y : g2.x;
          const float xh = (fmaxf(acc[i], 0.f) - m2[h]) * i2[h];
          tg[2 * q + e] = fmaf(g, xh, tg[2 * q + e]);
          tb[2 * q + e] += g;
          gg[i] = g * gout_s[c + e];                         // gxh2
          s1[h] += gg[i];
          s2[h] = fmaf(gg[i], xh, s2[h]);
        }
      }
      fold_cols(tg, vgo, lane);
      fold_cols(tb, vbo, lane);
    }
    tri_row_pair_sums(ex_s + 2 * 2 * TM * 2, s1, s2, wg, rl, lane);
#pragma unroll
    for (int pr = 0; pr < 16; ++pr) {
      const int h = pr & 1, c = half + 8 * (pr >> 1) + cl;
      float g1[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * pr + e;
        const float xh = (fmaxf(acc[i], 0.f) - m2[h]) * i2[h];
        const float g2 = i2[h] * (gg[i] - s1[h] * drop.inv1
                                  - xh * s2[h] * drop.inv1);
        g1[e] = acc[i] > 0.f ? g2 : 0.f;
      }
      const uint32_t p = tc::pack_bf16(g1[0], g1[1]);
      *reinterpret_cast<uint32_t*>(g1_s + wg * TILE_PANEL
                                   + tc::swz(rl + 8 * h, c - half)) = p;
      if (live[h])
        *reinterpret_cast<uint32_t*>(gy1_rows + row[h] * D + c) = p;
    }
    tc::fence_async_smem();
    __syncthreads();                   // the g_y1 tile is whole
    // ---- g_yd = g_y1 W^T on the own columns of the three groups ----------
    float acc3[3][32];
    tc::fence();
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        tc::mma_ss<64, 0, 0>(
            acc3[g],
            tc::make_desc(tc::smem_u32(g1_s) + (ks / 4) * TILE_PANEL
                              + (ks % 4) * 32, 16),
            tc::make_desc(tc::smem_u32(w_s) + (ks / 4) * W_PANEL
                              + (g * D + half) * tc::ROW_BYTES
                              + (ks % 4) * 32, 16),
            ks > 0);
    tc::commit();
    tc::wait_all();
    // ---- dropout replay, ggin / gbin, LN_in backward, gs and gv out -------
    float t1[2] = {0.f, 0.f}, t2[2] = {0.f, 0.f};
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float tg[16], tb[16];
#pragma unroll
      for (int pr = 0; pr < 16; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = half + 8 * q + cl;
        const float2 a = tri_pair(s_s, rl, h, c),
                   b = tri_pair(v_s, rl, h, c);
        const uint32_t bits = kw[g][h][0] >> (4 * q);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * pr + e, k = g * D + c + e;
          const float sv = e ? a.y : a.x, vv = e ? b.y : b.x;
          const float x = g == 0 ? sv : (g == 1 ? vv : sv * vv);
          const float xh = (x - mean[h]) * istd[h];
          const float km = !drop.on() ? 1.f
              : ((bits >> e) & 1u ? drop.scale : 0.f);
          const float gyv = acc3[g][i] * km;
          if (h == 0) {
            tg[2 * q + e] = gyv * xh;
            tb[2 * q + e] = gyv;
          } else {
            tg[2 * q + e] = fmaf(gyv, xh, tg[2 * q + e]);
            tb[2 * q + e] += gyv;
          }
          const float gxh = gyv * gin_s[k];
          acc3[g][i] = gxh;
          t1[h] += gxh;
          t2[h] = fmaf(gxh, xh, t2[h]);
        }
      }
      fold_cols(tg, vgi[g], lane);
      fold_cols(tb, vbi[g], lane);
    }
    tri_row_pair_sums(ex_s + 3 * 2 * TM * 2, t1, t2, wg, rl, lane);
#pragma unroll
    for (int pr = 0; pr < 16; ++pr) {
      const int h = pr & 1, c = half + 8 * (pr >> 1) + cl;
      const float2 a = tri_pair(s_s, rl, h, c),
                   b = tri_pair(v_s, rl, h, c);
      float os[2], ov[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * pr + e;
        const float sv = e ? a.y : a.x, vv = e ? b.y : b.x;
        const float xs[3] = {sv, vv, sv * vv};
        float gx[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float xh = (xs[g] - mean[h]) * istd[h];
          gx[g] = istd[h] * (acc3[g][i] - t1[h] * drop.inv3
                             - xh * t2[h] * drop.inv3);
        }
        os[e] = gx[0] + gx[2] * vv;
        ov[e] = gx[1] + gx[2] * sv;
      }
      if (live[h]) {
        *reinterpret_cast<uint32_t*>(gs + row[h] * D + c) =
            tc::pack_bf16(os[0], os[1]);
        *reinterpret_cast<uint32_t*>(gv + row[h] * D + c) =
            tc::pack_bf16(ov[0], ov[1]);
      }
    }
  }
  // ---- the block's parameter-vector partials, warps summed in order -----
  __syncthreads();
  float* red = reinterpret_cast<float*>(yd_s);        // [4 warps][NVT]
  {
    const int c = half + 8 * (((lane >> 2) & 1) + 2 * ((lane >> 3) & 1)
                              + 4 * ((lane >> 4) & 1)) + cl;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        red[warp * NVT + g * D + c + e] = vgi[g][e];
        red[warp * NVT + 3 * D + g * D + c + e] = vbi[g][e];
      }
      red[warp * NVT + 6 * D + c + e] = vgo[e];
      red[warp * NVT + 7 * D + c + e] = vbo[e];
    }
  }
  __syncthreads();
  for (int k = tid; k < NVT; k += NTHREADS)
    vec_part[static_cast<size_t>(blockIdx.x) * NVT + k] =
        ((red[k] + red[NVT + k]) + red[2 * NVT + k]) + red[3 * NVT + k];
}

// The bf16 backward: the main kernel, the weight gradient over the bf16
// rows it wrote and the fixed-order slot sums.
int launch_tc(const void* s, const void* v, const float* gin,
              const float* bin, const void* W, const float* bias,
              const float* gout, const void* g, void* gs, void* gv,
              float* gvec, float* gw, void* yd, void* gy1, float* vec_part,
              float* wg_part, long long R, int wg_chunks, Dropout drop,
              cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  auto hm = [](void* p) { return static_cast<bf16*>(p); };
  cudaError_t err = allow_smem(tri_bridge_bwd_tc_kernel, TC_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (R + TM - 1) / TM;
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  tri_bridge_bwd_tc_kernel<<<blocks, NTHREADS, TC_SMEM, stream>>>(
      h(s), h(v), gin, bin, h(W), bias, gout, h(g), hm(gs), hm(gv), hm(yd),
      hm(gy1), vec_part, R, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // [gw; gb] (the wrapper lays gb behind gw)
  if ((err = wgrad_tc(h(yd), h(gy1), wg_part, gw, R, 3 * D, D, wg_chunks,
                      stream)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(sum_slots<float>(vec_part, gvec, 1, blocks, NVT,
                                           stream));
}

}  // namespace

// s, v, g (the output cotangent), gs, gv: R rows of D, all bf16 (is_bf16)
// or all float32; gin/bin (3D), W (3D, D), Wt = W^T (D, 3D), bias, gout
// (D) float32.  Outputs gvec = [ggin (3D); gbin (3D); gb; ggout; gbout
// (D each)] and gw (3D, D) float32.  Scratch (float32, the wrapper's):
// yd (R, 3D), gy1 (R, D), vec_part (ceil(R / 32), 9D), wg_part
// (wg_chunks, 3D, D).  bout does not enter the backward.
// When is_bf16: W is bfloat16 and Wt unused (may be NULL); s, v, g 16-byte
// aligned; gvec = [ggin; gbin; ggout; gbout] (8D); gw has 3D + 1 rows, the
// last is gb; yd and gy1 are bfloat16; vec_part (min(ceil(R / 64), SMs),
// 8D) and wg_part (wg_chunks, 3D + 1, D).
// dv: the true width, 4 <= dv <= D with 4 | dv, of inputs zero-padded to D
// (every LN's statistics and the Philox keys, philox.cuh).
extern "C" int tri_bridge_bwd(const void* s, const void* v, const void* gin,
                              const void* bin, const void* W, const void* Wt,
                              const void* bias, const void* gout,
                              const void* g, void* gs, void* gv, void* gvec,
                              void* gw, void* yd, void* gy1, void* vec_part,
                              void* wg_part, long long R, int wg_chunks,
                              const unsigned long long* drop_seed,
                              unsigned drop_threshold, float drop_scale, int dv,
                              int is_bf16, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop =
      entry_dropout(drop_seed, drop_threshold, drop_scale, dv);
  if (!width_ok(dv, BWD_D)) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch_tc(s, v, f(gin), f(bin), W, f(bias), f(gout), g, gs, gv,
                     fm(gvec), fm(gw), yd, gy1, fm(vec_part), fm(wg_part), R,
                     wg_chunks, drop, st);
  return launch<float>(s, v, f(gin), f(bin), f(W), f(Wt), f(bias), f(gout),
                       g, gs, gv, fm(gvec), fm(gw), fm(yd), fm(gy1),
                       fm(vec_part), fm(wg_part), R, wg_chunks, drop, st);
}
