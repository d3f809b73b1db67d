// Fused MLP bridge, backward.
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_bridge.py (_backward /
// _bwd_kernel).  Row-local: for every row it recomputes yd = LN_in(x) times
// the replayed Philox dropout mask, y1 = yd W + b, y2 = ReLU(y1) and the
// LN_out statistics, then with the cotangent g of the output:
//   g_y2 = LN_out backward,  ggout = sum g xhat2,  gbout = sum g
//   g_y1 = g_y2 (y1 > 0),    gb = sum g_y1,  gW = yd^T g_y1
//   g_yd = (g_y1 W^T) keep,  ggin = sum g_yd xhat,  gbin = sum g_yd
//   gx   = LN_in backward                     (in the type of x)
// The bf16 compute mode (g in bf16) rounds the products' operands to bf16
// where the TPU kernel's bf16 mode does (pallas_bridge.py:106-111): yd and
// W for the y1 recompute, yd and g_y1 for gW, g_y1 and W for g_yd; gb and
// every LN term stay float32.
//
// What bounds it on the H100: at the subtitle stream's 40,000 rows of 768 it
// reads x and g and writes gx (~147 MB in bf16) and does ~55 GFLOP (the y1
// recompute, g_yd and gW), so at the card's peaks it is bound by operations
// (~56 us).  On the float32 CUDA cores it uses, the three products bound it.
// Design: one block per 32-row tile, each warp owns 4 rows, as in the
// forward.  The tile's yd rows (32 x Din) sit in shared memory for the y1
// product and are then overwritten by g_yd, so one Din-wide buffer serves
// both; y1 and then g_y1 share the 32 x Dout buffer.  W and W^T are staged
// from L2 32 rows at a time.  The TPU kernel adds every parameter gradient
// into an output block that its sequential grid revisits; blocks here run at
// once, so each block sums its 32 rows column by column in a fixed order
// into its own slot of a scratch buffer, and a second launch adds the slots
// in order (grad_reduce.cuh).  gW is its own GEMM over the yd and g_y1 rows
// that the main kernel writes to scratch, through row-chunk slots: at
// (16, 50, 50, 768) -> 300 those rows are ~170 MB of float32 (yd 123 MB,
// g_y1 48 MB).  Gradients are the same bits from run to run.
#include <type_traits>

#include "grad_reduce.cuh"
#include "mlp_bridge.cuh"

namespace {

using namespace tvqa;

__host__ __device__ inline int smem_floats(int Din, int Dout) {
  return BR_RT * round_kc(Din) + BR_RT * round_kc(Dout) + KC * D + 6 * BR_RT;
}

// one scratch slot: ggin, gbin (Din each), gb, ggout, gbout (Dout each)
__host__ __device__ inline int vec_floats(int Din, int Dout) {
  return 2 * Din + 3 * Dout;
}

template <typename TX, typename TO>
__global__ void __launch_bounds__(NTHREADS)
mlp_bridge_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ gin,
                      const float* __restrict__ bin,
                      const float* __restrict__ W,
                      const float* __restrict__ Wt,
                      const float* __restrict__ bias,
                      const float* __restrict__ gout,
                      const TO* __restrict__ gy, TX* __restrict__ gx,
                      float* __restrict__ yd_buf, float* __restrict__ g1_buf,
                      float* __restrict__ vec_part, long long R, int Din,
                      int Dout, Dropout drop) {
  drop.load_seed();
  constexpr bool RND = std::is_same<TO, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  const int ys = round_kc(Din), os = round_kc(Dout);
  float* y_s = reinterpret_cast<float*>(smem4);       // BR_RT x ys: yd, g_yd
  float* o_s = y_s + BR_RT * ys;                       // BR_RT x os: y1, g_y1
  float* w_s = o_s + BR_RT * os;                       // KC x D
  float* st_s = w_s + KC * D;          // BR_RT x 2: LN_in mean, 1/std
  float* st2_s = st_s + 2 * BR_RT;     // BR_RT x 4: LN_out mean, 1/std, m1, m2
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = lane * 4;
  const long long r0 = static_cast<long long>(blockIdx.x) * BR_RT;
  float* slot = vec_part + static_cast<size_t>(blockIdx.x)
                               * vec_floats(Din, Dout);

  // ---- recompute yd = dropout(LN_in(x)); y1 = yd W + b ------------------
  bridge_ln_in<TX, RND>(x, y_s, st_s, yd_buf, gin, bin, r0, R, Din, ys, drop,
                        warp, lane);
  // columns [Dout, os) of o_s stay zero: they are K padding of g_y1 W^T
  for (int i = tid; i < BR_RT * (os - Dout); i += NTHREADS)
    o_s[(i / (os - Dout)) * os + Dout + i % (os - Dout)] = 0.f;
  for (int col0 = 0; col0 < Dout; col0 += D) {
    float acc[BR_RPT][4];
    bridge_gemm<BR_RPT, RND>(acc, y_s, ys, Din, W, Dout, Dout, col0, w_s,
                             warp * BR_RPT, c0);
    const int col = col0 + c0;
    if (col < Dout) {
      const float4 bv = *reinterpret_cast<const float4*>(bias + col);
#pragma unroll
      for (int jj = 0; jj < BR_RPT; ++jj)
        *reinterpret_cast<float4*>(o_s + (warp * BR_RPT + jj) * os + col) =
            make_float4(acc[jj][0] + bv.x, acc[jj][1] + bv.y,
                        acc[jj][2] + bv.z, acc[jj][3] + bv.w);
    }
  }
  __syncwarp();                        // a warp reads back its own rows only

  // ---- LN_out statistics and the two row means of its backward ----------
  for (int jj = 0; jj < BR_RPT; ++jj) {
    const int r = warp * BR_RPT + jj;
    const long long row = r0 + r;
    if (row >= R) continue;
    const float* yr = o_s + r * os;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < Dout; c += 32) {
      const float h = fmaxf(yr[c], 0.f);
      s += h;
      ss = fmaf(h, h, ss);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / Dout;
    const float istd = rsqrtf(fmaxf(ss / Dout - mean * mean, 0.f) + LN_EPS);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < Dout; c += 32) {
      const float gxh = to_f(gy[row * Dout + c]) * gout[c];
      s1 += gxh;
      s2 = fmaf(gxh, (fmaxf(yr[c], 0.f) - mean) * istd, s2);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      st2_s[4 * r] = mean;
      st2_s[4 * r + 1] = istd;
      st2_s[4 * r + 2] = s1 / Dout;
      st2_s[4 * r + 3] = s2 / Dout;
    }
  }
  __syncthreads();

  // ---- column pass: g_y1 in place of y1 (rounded when RND: it is only a
  // product's operand from here), and the Dout-wide sums ------------------
  for (int c = tid; c < Dout; c += NTHREADS) {
    const float go = gout[c];
    float ggo = 0.f, gbo = 0.f, gb = 0.f;
    for (int r = 0; r < BR_RT; ++r) {
      const long long row = r0 + r;
      float g1 = 0.f;
      if (row < R) {
        const float y1 = o_s[r * os + c];
        const float xh = (fmaxf(y1, 0.f) - st2_s[4 * r]) * st2_s[4 * r + 1];
        const float g = to_f(gy[row * Dout + c]);
        ggo = fmaf(g, xh, ggo);
        gbo += g;
        const float g2 = st2_s[4 * r + 1]
                         * (g * go - st2_s[4 * r + 2] - xh * st2_s[4 * r + 3]);
        g1 = y1 > 0.f ? g2 : 0.f;
        gb += g1;
        g1 = op_round<RND>(g1);
        g1_buf[row * Dout + c] = g1;
      }
      o_s[r * os + c] = g1;
    }
    slot[2 * Din + c] = gb;
    slot[2 * Din + Dout + c] = ggo;
    slot[2 * Din + 2 * Dout + c] = gbo;
  }

  // ---- g_yd = (g_y1 W^T) keep, over yd's buffer --------------------------
  for (int col0 = 0; col0 < Din; col0 += D) {
    float acc[BR_RPT][4];
    bridge_gemm<BR_RPT, RND>(acc, o_s, os, Dout, Wt, Din, Din, col0, w_s,
                             warp * BR_RPT, c0);
    const int col = col0 + c0;
    if (col < Din) {
#pragma unroll
      for (int jj = 0; jj < BR_RPT; ++jj) {
        const int r = warp * BR_RPT + jj;
        const long long row = r0 + r;
        float km[4] = {1.f, 1.f, 1.f, 1.f};
        if (drop.on() && row < R)
          keep4(drop.seed, static_cast<unsigned long long>(row) * Din + col,
                drop.threshold, drop.scale, km);
        *reinterpret_cast<float4*>(y_s + r * ys + col) =
            make_float4(acc[jj][0] * km[0], acc[jj][1] * km[1],
                        acc[jj][2] * km[2], acc[jj][3] * km[3]);
      }
    }
  }
  __syncwarp();

  // ---- LN_in backward, row by row ----------------------------------------
  for (int jj = 0; jj < BR_RPT; ++jj) {
    const int r = warp * BR_RPT + jj;
    const long long row = r0 + r;
    if (row >= R) continue;
    const float mean = st_s[2 * r], istd = st_s[2 * r + 1];
    const float* gr = y_s + r * ys;
    const TX* xr = x + row * Din;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < Din; c += 32) {
      const float gxh = gr[c] * gin[c];
      s1 += gxh;
      s2 = fmaf(gxh, (to_f(xr[c]) - mean) * istd, s2);
    }
    const float m1 = warp_sum(s1) / Din;
    const float m2 = warp_sum(s2) / Din;
    for (int c = lane; c < Din; c += 32) {
      const float xh = (to_f(xr[c]) - mean) * istd;
      gx[row * Din + c] = from_f<TX>(istd * (gr[c] * gin[c] - m1 - xh * m2));
    }
  }
  __syncthreads();

  // ---- column pass: the Din-wide sums ------------------------------------
  for (int c = tid; c < Din; c += NTHREADS) {
    float ggi = 0.f, gbi = 0.f;
    for (int r = 0; r < BR_RT; ++r) {
      const long long row = r0 + r;
      if (row >= R) break;
      const float gyd = y_s[r * ys + c];
      ggi = fmaf(gyd, (to_f(x[row * Din + c]) - st_s[2 * r]) * st_s[2 * r + 1],
                 ggi);
      gbi += gyd;
    }
    slot[c] = ggi;
    slot[Din + c] = gbi;
  }
}

// part[chunk][k][n] = sum over the chunk's rows of X[r, k] G[r, n]: the
// weight-gradient GEMM of grad_reduce.cuh with run-time widths (K and N
// multiples of 4, tails guarded).  Each block owns a WG_K x D output tile
// and one chunk of rows.
__global__ void __launch_bounds__(NTHREADS)
bridge_wgrad_kernel(const float* __restrict__ X, const float* __restrict__ G,
                    float* __restrict__ part, long long R, int K, int N,
                    long long rows_per_chunk) {
  __shared__ __align__(16) float xs[WG_R][WG_K];
  __shared__ __align__(16) float gs[WG_R][D];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * WG_K, n0 = blockIdx.y * D;
  const long long r_begin = static_cast<long long>(blockIdx.z)
                            * rows_per_chunk;
  const long long r_end = min(R, r_begin + rows_per_chunk);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (long long rr = r_begin; rr < r_end; rr += WG_R) {
    for (int i = tid; i < WG_R * WG_K / 4; i += NTHREADS) {
      const int r = i / (WG_K / 4), k = k0 + 4 * (i % (WG_K / 4));
      const long long row = rr + r;
      reinterpret_cast<float4*>(&xs[r][0])[i % (WG_K / 4)] =
          (row < r_end && k < K)
              ? __ldg(reinterpret_cast<const float4*>(X + row * K + k))
              : zero4;
    }
    for (int i = tid; i < WG_R * D / 4; i += NTHREADS) {
      const int r = i / (D / 4), n = n0 + 4 * (i % (D / 4));
      const long long row = rr + r;
      reinterpret_cast<float4*>(&gs[r][0])[i % (D / 4)] =
          (row < r_end && n < N)
              ? __ldg(reinterpret_cast<const float4*>(G + row * N + n))
              : zero4;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < WG_R; ++r) {
      const float4 g = reinterpret_cast<const float4*>(&gs[r][0])[lane];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xv = xs[r][warp * 8 + i];
        acc[i][0] = fmaf(xv, g.x, acc[i][0]);
        acc[i][1] = fmaf(xv, g.y, acc[i][1]);
        acc[i][2] = fmaf(xv, g.z, acc[i][2]);
        acc[i][3] = fmaf(xv, g.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
  float* dst = part + static_cast<size_t>(blockIdx.z) * K * N;
  const int n = n0 + lane * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + warp * 8 + i;
    if (k < K && n < N)
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(k) * N + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <typename TX, typename TO>
int launch(const void* x, const float* gin, const float* bin, const float* W,
           const float* Wt, const float* bias, const float* gout,
           const void* g, void* gx, float* gvec, float* gw, float* yd_buf,
           float* g1_buf, float* vec_part, float* wg_part, long long R,
           int Din, int Dout, int wg_chunks, Dropout drop,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(Din, Dout);
  cudaError_t err = allow_smem(mlp_bridge_bwd_kernel<TX, TO>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((R + BR_RT - 1) / BR_RT);
  mlp_bridge_bwd_kernel<TX, TO><<<blocks, NTHREADS, bytes, stream>>>(
      static_cast<const TX*>(x), gin, bin, W, Wt, bias, gout,
      static_cast<const TO*>(g), static_cast<TX*>(gx), yd_buf, g1_buf,
      vec_part, R, Din, Dout, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long per = (R + wg_chunks - 1) / wg_chunks;
  bridge_wgrad_kernel<<<dim3((Din + WG_K - 1) / WG_K, (Dout + D - 1) / D,
                             wg_chunks), NTHREADS, 0, stream>>>(
      yd_buf, g1_buf, wg_part, R, Din, Dout, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = sum_slots<float>(wg_part, gw, 1, wg_chunks,
                              static_cast<long long>(Din) * Dout, stream))
      != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(sum_slots<float>(vec_part, gvec, 1, blocks,
                                           vec_floats(Din, Dout), stream));
}

}  // namespace

// x, gx (R, Din): bf16 (x_bf16) or float32; g, the output's cotangent
// (R, Dout): bf16 in the bf16 compute mode (is_bf16, which x_bf16 needs),
// else float32; gin/bin (Din), W (Din, Dout), Wt = W^T (Dout, Din),
// bias/gout (Dout) float32, 16-byte aligned.  Outputs gvec = [ggin (Din);
// gbin (Din); gb; ggout; gbout (Dout each)] and gw (Din, Dout) float32.
// Scratch (float32, the wrapper's): yd (R, Din), g1 (R, Dout), vec_part
// (ceil(R / 32), 2 Din + 3 Dout), wg_part (wg_chunks, Din, Dout).  bout does
// not enter the backward.  Widths as in mlp_bridge_fwd.
extern "C" int mlp_bridge_bwd(const void* x, const void* gin, const void* bin,
                              const void* W, const void* Wt, const void* bias,
                              const void* gout, const void* g, void* gx,
                              void* gvec, void* gw, void* yd, void* g1,
                              void* vec_part, void* wg_part, long long R,
                              int Din, int Dout, int wg_chunks,
                              const unsigned long long* drop_seed,
                              unsigned drop_threshold, float drop_scale,
                              int x_bf16, int is_bf16, void* stream) {
  if (R < 1 || Din < 4 || Dout < 4 || Din % 4 != 0 || Dout % 4 != 0
      || wg_chunks < 1 || wg_chunks > 65535 || (x_bf16 && !is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_seed, drop_threshold, drop_scale, 0ull};
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    return launch<bf16, bf16>(x, f(gin), f(bin), f(W), f(Wt), f(bias),
                              f(gout), g, gx, fm(gvec), fm(gw), fm(yd),
                              fm(g1), fm(vec_part), fm(wg_part), R, Din,
                              Dout, wg_chunks, drop, st);
  if (is_bf16)
    return launch<float, bf16>(x, f(gin), f(bin), f(W), f(Wt), f(bias),
                               f(gout), g, gx, fm(gvec), fm(gw), fm(yd),
                               fm(g1), fm(vec_part), fm(wg_part), R, Din,
                               Dout, wg_chunks, drop, st);
  return launch<float, float>(x, f(gin), f(bin), f(W), f(Wt), f(bias),
                              f(gout), g, gx, fm(gvec), fm(gw), fm(yd),
                              fm(g1), fm(vec_part), fm(wg_part), R, Din,
                              Dout, wg_chunks, drop, st);
}
