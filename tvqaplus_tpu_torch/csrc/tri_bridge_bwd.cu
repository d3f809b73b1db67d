// Fused tri-concat MLP bridge, backward.
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
// bound by bytes (~61 us).  On the float32 CUDA cores it uses, the three
// (rows x 3D x D) products bound it, and the yd and g_y1 rows written for
// the gW pass add ~330 MB of traffic.
// Design: one block per 32-row tile, each warp owns 4 rows, as in the
// forward.  Both products of a tile (y1 = yd W and g_y1 W^T) stage their
// weight from L2 32 rows at a time and leave each warp's own rows in its
// registers, so both LayerNorm backward passes are warp reductions over
// 128 and over the virtual 384.  The parameter vectors are summed per block
// and gW over row chunks through scratch slots, then added in a fixed order
// (grad_reduce.cuh): deterministic.
#include "grad_reduce.cuh"
#include "philox.cuh"

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

template <typename T>
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
    const float mean = sum * (1.f / (3 * D));
    const float istd =
        rsqrtf(fmaxf(ss * (1.f / (3 * D)) - mean * mean, 0.f) + LN_EPS);
    if (lane == 0) {
      st_s[2 * r] = mean;
      st_s[2 * r + 1] = istd;
    }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float km[4] = {1.f, 1.f, 1.f, 1.f};
      const int k0 = g * D + c0;
      if (drop.on())
        keep4(drop.seed, static_cast<unsigned long long>(row) * (3 * D) + k0,
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
      const float mean = sum * (1.f / D);
      const float istd =
          rsqrtf(fmaxf(ss * (1.f / D) - mean * mean, 0.f) + LN_EPS);
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
      const float m1 = warp_sum(s1) * (1.f / D);
      const float m2 = warp_sum(s2) * (1.f / D);
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
        keep4(drop.seed, static_cast<unsigned long long>(row) * (3 * D) + k0,
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
    const float m1 = warp_sum(s1) * (1.f / (3 * D));
    const float m2 = warp_sum(s2) * (1.f / (3 * D));
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
  cudaError_t err = allow_smem(tri_bridge_bwd_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((R + RT - 1) / RT);
  tri_bridge_bwd_kernel<T><<<blocks, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(v), gin, bin, W, Wt,
      bias, gout, static_cast<const T*>(g), static_cast<T*>(gs),
      static_cast<T*>(gv), yd_buf, gy1_buf, vec_part, R, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = wgrad(yd_buf, gy1_buf, wg_part, gw, R, 3 * D, wg_chunks,
                   stream)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(sum_slots<float>(vec_part, gvec, 1, blocks, NV,
                                           stream));
}

}  // namespace

// s, v, g (the output cotangent), gs, gv: R rows of D, all bf16 (is_bf16)
// or all float32; gin/bin (3D), W (3D, D), Wt = W^T (D, 3D), bias, gout
// (D) float32.  Outputs gvec = [ggin (3D); gbin (3D); gb; ggout; gbout
// (D each)] and gw (3D, D) float32.  Scratch (float32, the wrapper's):
// yd (R, 3D), gy1 (R, D), vec_part (ceil(R / 32), 9D), wg_part
// (wg_chunks, 3D, D).  bout does not enter the backward.
extern "C" int tri_bridge_bwd(const void* s, const void* v, const void* gin,
                              const void* bin, const void* W, const void* Wt,
                              const void* bias, const void* gout,
                              const void* g, void* gs, void* gv, void* gvec,
                              void* gw, void* yd, void* gy1, void* vec_part,
                              void* wg_part, long long R, int wg_chunks,
                              unsigned long long drop_seed,
                              unsigned drop_threshold, float drop_scale,
                              int is_bf16, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_seed, drop_threshold, drop_scale};
  if (is_bf16)
    return launch<__nv_bfloat16>(s, v, f(gin), f(bin), f(W), f(Wt), f(bias),
                                 f(gout), g, gs, gv, fm(gvec), fm(gw),
                                 fm(yd), fm(gy1), fm(vec_part), fm(wg_part),
                                 R, wg_chunks, drop, st);
  return launch<float>(s, v, f(gin), f(bin), f(W), f(Wt), f(bias), f(gout),
                       g, gs, gv, fm(gvec), fm(gw), fm(yd), fm(gy1),
                       fm(vec_part), fm(wg_part), R, wg_chunks, drop, st);
}
