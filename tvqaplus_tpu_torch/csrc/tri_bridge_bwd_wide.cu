// Fused tri-concat MLP bridge, backward, at the hidden widths D = 64 and
// 256 (tri_bridge_bwd.cu is the same function at D = 128).
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_tri_bridge.py
// (_backward / _bwd_kernel :223), which reads D from its operands and so
// runs at any width.  Row-local, as tri_bridge_bwd.cu's header sets out:
// recompute x = [s; v; s*v], yd = dropout(LN_in(x)) (the Philox mask
// keyed by the flat index of the (R, 3D) LN output, as the forward drew
// it), y1 = yd W + b and LN_out's statistics; then LN_out and ReLU
// backward, g_yd = g_y1 W^T, the dropout replay and the LN_in backward over
// the virtual 3D concat; gs = gx0 + gx2 v, gv = gx1 + gx2 s.
//
// What bounds it on the H100: per row it reads s, v and g and writes gs and
// gv (5 D values) and does ~4 x 3D x D operations (the y1 recompute, g_yd,
// gW): at 160,000 rows ~102 MB and ~16 GFLOP at D = 64 (bytes, ~31 us), ~410
// MB and ~252 GFLOP at D = 256 (operations, ~255 us).
//
// Three kernels.
// * bfloat16 at D = 64: tri_bridge_bwd_tc64_kernel: one resident block an
//   SM, each of its three warpgroups on 64-row tiles of its own at all 64
//   columns, every product a wgmma on bf16 operands with float32 sums,
//   rounded where the TPU kernel's bf16 compute mode rounds (yd, W, g_y1;
//   pallas_tri_bridge.py:77-79, :157-162); W resident once (24 KB, read
//   MN-major by y1 and K-major by g_yd), g_yd once a tile, the next tile
//   copied while this one computes (the note at the kernel).
// * bfloat16 at D = 256: tri_bridge_bwd_tc256_kernel, the same tiles and
//   rounding sites with W (384 KB) streamed (the note at the kernel): g_yd
//   once a tile, its LN_in backward folded into two sums a column, W in
//   bf16 slabs that the copy engine brings through a ring.
// * float32: the exactness check, CUDA cores: one block per 32-row tile
//   (16 at D = 256), each warp RPT rows, a lane D / 32 adjacent columns, so
//   LN_out is a warp reduction in registers; both products stage their
//   weight from L2 32 rows at a time (common.cuh gemm_staged); yd and g_y1
//   rows in float32 for the CUDA-core weight gradient.
// The bf16 kernels write the yd and g_y1 rows in bf16 for the tensor-core
// weight gradient (wgrad_tc.cuh wgrad_tc, whose bias row is gb).  Sums
// across blocks go through scratch slots and a fixed-order second pass: the
// same bits from run to run, no atomics.
#include "bwd_wide.cuh"
#include "tri_bridge_tc.cuh"

namespace {

using namespace tvqa;

template <int D>
struct Tri {
  static constexpr int CPL = D / 32;
  static constexpr int RPT = D == 256 ? 2 : 4;
  static constexpr int RT = RPT * NWARPS;
  static constexpr int SMEM = 4 * (RT * 3 * D + RT * D + KC * D + 2 * RT);
};

template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&v)[N]) {
#pragma unroll
  for (int t = 0; t < N; ++t) v[t] = p[t];
}

template <int D, bool PAD>
__global__ void __launch_bounds__(NTHREADS)
tri_bridge_bwd_wide_kernel(const float* __restrict__ s,
                           const float* __restrict__ v,
                           const float* __restrict__ gin,
                           const float* __restrict__ bin,
                           const float* __restrict__ W,
                           const float* __restrict__ Wt,
                           const float* __restrict__ bias,
                           const float* __restrict__ gout,
                           const float* __restrict__ gy,
                           float* __restrict__ gs, float* __restrict__ gv,
                           float* __restrict__ yd_buf,
                           float* __restrict__ gy1_buf,
                           float* __restrict__ vec_part, long long R,
                           Dropout drop) {
  using S = Tri<D>;
  constexpr int CPL = S::CPL, RPT = S::RPT, RT = S::RT;
  constexpr int NV = 9 * D;  // ggin (3D), gbin (3D), gb, ggout, gbout (D)
  // at dv = D (PAD false) the constants the kernel multiplied by before the
  // true width, so that the float32 exactness check keeps its bits
  const float inv1 = PAD ? drop.inv1 : 1.f / D;
  const float inv3 = PAD ? drop.inv3 : 1.f / (3 * D);
  drop.load_seed();
  extern __shared__ float4 smem4[];
  float* y_s = reinterpret_cast<float*>(smem4);       // RT x 3D
  float* g1_s = y_s + RT * 3 * D;                      // RT x D
  float* w_s = g1_s + RT * D;                          // KC x D
  float* st_s = w_s + KC * D;                          // RT x 2
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = lane * CPL;
  const long long r0 = static_cast<long long>(blockIdx.x) * RT;

  float vgi[3][CPL], vbi[3][CPL], vgb[CPL], vgo[CPL], vbo[CPL];
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    vgb[t] = vgo[t] = vbo[t] = 0.f;
#pragma unroll
    for (int g = 0; g < 3; ++g) vgi[g][t] = vbi[g][t] = 0.f;
  }

  // ---- recompute yd = dropout(LN_in([s; v; s*v])) ----------------------
#pragma unroll 1
  for (int jj = 0; jj < RPT; ++jj) {
    const int r = warp * RPT + jj;
    const long long row = r0 + r;
    float* yr = y_s + r * 3 * D;
    if (row >= R) {
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int t = 0; t < CPL; ++t) yr[g * D + c0 + t] = 0.f;
      continue;
    }
    float sv[CPL], vv[CPL], x[3][CPL], sum = 0.f, ss = 0.f;
    load_n(s + row * D + c0, sv);
    load_n(v + row * D + c0, vv);
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
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
      const int k0 = g * D + c0;
      float km[CPL];
      keep_or_one<CPL>(drop, drop.key3(row, g, c0), km);
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const float y =
            ((x[g][t] - mean) * istd * gin[k0 + t] + bin[k0 + t]) * km[t];
        yr[k0 + t] = y;
        yd_buf[row * (3 * D) + k0 + t] = y;
      }
    }
  }

  // ---- y1 = yd W + b; LN_out and ReLU backward --------------------------
  float acc[RPT][CPL];
  gemm_staged<RPT, D>(acc, y_s, 3 * D, 3 * D, W, w_s, warp * RPT, c0);
#pragma unroll
  for (int jj = 0; jj < RPT; ++jj) {
    const int r = warp * RPT + jj;
    const long long row = r0 + r;
    float g1[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) g1[t] = 0.f;
    if (row < R) {
      float y1[CPL], y2[CPL], sum = 0.f, ss = 0.f;
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        y1[t] = acc[jj][t] + bias[c0 + t];
        y2[t] = fmaxf(y1[t], 0.f);
        sum += y2[t];
        ss = fmaf(y2[t], y2[t], ss);
      }
      sum = warp_sum(sum);
      ss = warp_sum(ss);
      const float mean = sum * inv1;
      const float istd =
          rsqrtf(fmaxf(ss * inv1 - mean * mean, 0.f) + LN_EPS);
      float gg[CPL], xh[CPL], gxh[CPL], s1 = 0.f, s2 = 0.f;
      load_n(gy + row * D + c0, gg);
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
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
      for (int t = 0; t < CPL; ++t) {
        const float g2 = istd * (gxh[t] - m1 - xh[t] * m2);
        g1[t] = y1[t] > 0.f ? g2 : 0.f;
        vgb[t] += g1[t];
        gy1_buf[row * D + c0 + t] = g1[t];
      }
    }
#pragma unroll
    for (int t = 0; t < CPL; ++t) g1_s[r * D + c0 + t] = g1[t];
  }

  // ---- g_yd = g_y1 W^T, dropout replay, LN_in backward, one group at a
  // time for the sums, then the three again for gs and gv ----------------
  float ti1[RPT], ti2[RPT];
#pragma unroll
  for (int jj = 0; jj < RPT; ++jj) ti1[jj] = ti2[jj] = 0.f;
  // pass 1: the parameter sums and the row sums of the LN_in backward
#pragma unroll 1
  for (int g = 0; g < 3; ++g) {
    float acc3[RPT][CPL];
    gemm_staged_ld<RPT, D>(acc3, g1_s, D, D, Wt + g * D, 3 * D, w_s,
                           warp * RPT, c0);
#pragma unroll
    for (int jj = 0; jj < RPT; ++jj) {
      const int r = warp * RPT + jj;
      const long long row = r0 + r;
      if (row >= R) continue;
      const float mean = st_s[2 * r], istd = st_s[2 * r + 1];
      float sv[CPL], vv[CPL], km[CPL];
      load_n(s + row * D + c0, sv);
      load_n(v + row * D + c0, vv);
      const int k0 = g * D + c0;
      keep_or_one<CPL>(drop, drop.key3(row, g, c0), km);
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const float x = g == 0 ? sv[t] : (g == 1 ? vv[t] : sv[t] * vv[t]);
        const float xh = (x - mean) * istd;
        const float gyv = acc3[jj][t] * km[t];
        vgi[g][t] = fmaf(gyv, xh, vgi[g][t]);
        vbi[g][t] += gyv;
        const float gxh = gyv * gin[k0 + t];
        ti1[jj] += gxh;
        ti2[jj] = fmaf(gxh, xh, ti2[jj]);
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < RPT; ++jj) {
    ti1[jj] = warp_sum(ti1[jj]) * inv3;
    ti2[jj] = warp_sum(ti2[jj]) * inv3;
  }
  // pass 2: gx of each group; gs = gx0 + gx2 v, gv = gx1 + gx2 s
  float os[RPT][CPL], ov[RPT][CPL];
#pragma unroll 1
  for (int g = 0; g < 3; ++g) {
    float acc3[RPT][CPL];
    gemm_staged_ld<RPT, D>(acc3, g1_s, D, D, Wt + g * D, 3 * D, w_s,
                           warp * RPT, c0);
#pragma unroll
    for (int jj = 0; jj < RPT; ++jj) {
      const int r = warp * RPT + jj;
      const long long row = r0 + r;
      if (row >= R) continue;
      const float mean = st_s[2 * r], istd = st_s[2 * r + 1];
      float sv[CPL], vv[CPL], km[CPL];
      load_n(s + row * D + c0, sv);
      load_n(v + row * D + c0, vv);
      const int k0 = g * D + c0;
      keep_or_one<CPL>(drop, drop.key3(row, g, c0), km);
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const float x = g == 0 ? sv[t] : (g == 1 ? vv[t] : sv[t] * vv[t]);
        const float xh = (x - mean) * istd;
        const float gxh = acc3[jj][t] * km[t] * gin[k0 + t];
        const float gx = istd * (gxh - ti1[jj] - xh * ti2[jj]);
        if (g == 0) {
          os[jj][t] = gx;
        } else if (g == 1) {
          ov[jj][t] = gx;
        } else {
          os[jj][t] = fmaf(gx, vv[t], os[jj][t]);
          ov[jj][t] = fmaf(gx, sv[t], ov[jj][t]);
        }
      }
      if (g == 2) {
        store_n<float, CPL>(gs + row * D + c0, os[jj]);
        store_n<float, CPL>(gv + row * D + c0, ov[jj]);
      }
    }
  }

  // ---- the block's parameter-vector partials, warps summed in order ----
  __syncthreads();
  // NWARPS x NV floats over y_s, g1_s and w_s (RT x 5D + KC x D >= 9 x 8 D)
  float* red = y_s;
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
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

template <int D>
int launch(const float* s, const float* v, const float* gin,
           const float* bin, const float* W, const float* Wt,
           const float* bias, const float* gout, const float* g, float* gs,
           float* gv, float* gvec, float* gw, float* yd, float* gy1,
           float* vec_part, float* wg_part, long long R, int wg_chunks,
           Dropout drop, cudaStream_t stream) {
  using S = Tri<D>;
  auto kern = drop.dv == D ? tri_bridge_bwd_wide_kernel<D, false>
                           : tri_bridge_bwd_wide_kernel<D, true>;
  cudaError_t err = allow_smem(kern, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((R + S::RT - 1) / S::RT);
  kern<<<blocks, NTHREADS, S::SMEM, stream>>>(s, v, gin, bin, W, Wt, bias,
                                              gout, g, gs, gv, yd, gy1,
                                              vec_part, R, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = wgrad(yd, gy1, wg_part, gw, R, 3 * D, D, wg_chunks,
                   stream)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(sum_slots<float>(vec_part, gvec, 1, blocks, 9 * D,
                                           stream));
}

// ---- the bfloat16 instantiation: tensor cores ------------------------------

// Sums over the thread's two rows and the eight lanes that hold the
// column's other rows of v[i] (column pair i / 2 of the thread's 8-column
// blocks, element i % 2), added into acc: entry j of acc is v's entry
// j + N / 8 (4 b4 + 2 b3 + b2) before the folds (bN = bit N of the lane).
template <int N>
__device__ __forceinline__ void fold_cols(float (&v)[N],
                                          float (&acc)[N / 8], int lane) {
  fold<N>(v, 16, lane);
  fold<N / 2>(v, 8, lane);
  fold<N / 4>(v, 4, lane);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) acc[j] += v[j];
}

// Column of fold_cols' entry j for this lane (warpgroup columns from half).
template <int N>
__device__ __forceinline__ int fold_col(int j, int half, int lane) {
  const int i = j + N / 8 * (4 * ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1)
                             + ((lane >> 2) & 1));
  return half + 8 * (i >> 1) + 2 * (lane & 3) + (i & 1);
}

// Rows r < `rows` of a bf16 tile (C / 64 panels of 64 rows, the 128-byte
// swizzle) out to row-major memory (row stride C), 16 bytes a thread at a
// time, neighbouring threads on neighbouring chunks of a row; thread tid of
// N (every thread of the block, or of a warpgroup).
template <int C, int N = NTHREADS>
__device__ __forceinline__ void tile_rows_out(__nv_bfloat16* dst,
                                              const uint8_t* tile, int rows,
                                              int tid) {
  constexpr int CH = C / 8;
  for (int c = tid; c < rows * CH; c += N) {
    const int r = c / CH, ch = c % CH;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * C + ch * 8) =
        *reinterpret_cast<const uint4*>(tile + (ch >> 3) * TILE_PANEL
                                        + tc::swz_chunk(r, ch & 7));
  }
}

// The bf16 backward at D = 64, the design (what bounds it: the header; per
// 64-row tile ~5,000 instructions a thread of row passes, half of them the
// Philox replay, against 3.1 MFLOP of products):
// * Each of a block's three warpgroups walks 64-row tiles of its own (tiles
//   w, w + n, .. of the 3 x blocks warpgroups), at all 64 columns: every
//   product is a wgmma of N = 64 and every row sum a quad's shuffles, so
//   no shared-memory exchange and no block barrier a tile (named
//   barriers, four a tile).  Twelve warps an SM: with eight (two
//   warpgroups) the Philox replay alone took 0.08 ms a call.
// * W resident once, rounded to bf16 as 3D rows of D (24 KB): y1 = yd W
//   reads it MN-major, g_yd = g_y1 W^T K-major (a group's 64 rows).
// * g_yd once a tile (tri_bridge_bwd_tc256_kernel's fold), a group at a
//   time (0, 1, 2): pass A keeps P = gxh0 + gxh2 v and Q = gxh1 + gxh2 s in
//   registers (group 2 adds its term in place) beside the row sums s1 =
//   sum gxh, s2 = sum gxh xh and the LN_in parameter sums, and gs = istd
//   (P - m1 (1 + v) - m2 (xh0 + xh2 v)), gv = istd (Q - m1 (1 + s) - m2
//   (xh1 + xh2 s)), m = s / 3dv.
// * A warpgroup's room holds two halves of three tiles that take turns: a
//   tile's s, v and cotangent rows in one, its yd in the other, into which
//   the next tile's rows are copied (cp.async) as soon as yd is read.
// * yd, g_y1, gs and gv go out through swizzled tiles, 16 bytes a thread,
//   the yd rows while y1's products run; gs and gv through the cotangent
//   and g_y1 tiles, read by then.
// * Shared-memory reads are what the row passes wait on: the thread's s
//   and v pairs are read once for LN_in and yd, the cotangent's once for
//   LN_out and g_y1, the parameter vectors two columns a load (0.035 ms a
//   call less than a read a use).  Keeping the s and v pairs through
//   pass A as well spilled and ran slower.
// * Parameter sums: folded over a warp's rows each tile, kept a warp's,
//   summed over the block's twelve warps in a fixed order: no atomics.
// Shared memory: 199,680 bytes.
struct Tri64 {
  static constexpr int D = 64;
  static constexpr int NWG = 3;                       // warpgroups a block
  static constexpr int NT = 128 * NWG;                // threads a block
  static constexpr int TILE = TILE_PANEL;             // 64 x 64 bf16
  static constexpr int O_W = 0;                       // W (3D x D) bf16
  static constexpr int O_PV = O_W + Shapes<D>::W_BYTES;   // gin bin bias gout
  static constexpr int O_ROOM = O_PV + 8 * D * 4;
  // a warpgroup's room: two halves of three tiles (s, v and the cotangent
  // of one tile, or yd of the other), then g_y1
  static constexpr int HALF = 3 * TILE;
  static constexpr int R_G1 = 2 * HALF;
  static constexpr int ROOM = R_G1 + TILE;
  static constexpr int SMEM = O_ROOM + NWG * ROOM + tc::ATOM_BYTES;
  static_assert(O_ROOM % tc::ATOM_BYTES == 0, "tiles on atoms");
  static_assert(SMEM <= 232448, "shared memory of a block");
  static_assert(4 * NWG * 8 * D * 4 <= HALF, "the block sums in a half");
};

__global__ void __launch_bounds__(Tri64::NT, 1)
tri_bridge_bwd_tc64_kernel(const __nv_bfloat16* __restrict__ s,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ gin,
                           const float* __restrict__ bin,
                           const float* __restrict__ W,
                           const float* __restrict__ bias,
                           const float* __restrict__ gout,
                           const __nv_bfloat16* __restrict__ gy,
                           __nv_bfloat16* __restrict__ gs,
                           __nv_bfloat16* __restrict__ gv,
                           __nv_bfloat16* __restrict__ yd_rows,
                           __nv_bfloat16* __restrict__ gy1_rows,
                           float* __restrict__ vec_part, long long R,
                           Dropout drop) {
  using S = Tri64;
  constexpr int D = S::D;
  constexpr int NVT = 8 * D;   // ggin (3D), gbin (3D), ggout, gbout (D)
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  float* gin_s = reinterpret_cast<float*>(sm + S::O_PV);
  float* bin_s = gin_s + 3 * D;
  float* bias_s = bin_s + 3 * D;
  float* gout_s = bias_s + D;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int rl = 16 * warp + (lane >> 2), cl = 2 * (lane & 3);
  uint8_t* room = sm + S::O_ROOM + wg * S::ROOM;
  uint8_t* g1_s = room + S::R_G1;
  const uint32_t w_a = tc::smem_u32(sm + S::O_W);
  // the warpgroup's tiles: w0, w0 + nw, ..; tile j's rows in half j % 2
  const long long tiles = (R + TM - 1) / TM;
  const long long nw = static_cast<long long>(S::NWG) * gridDim.x;
  const long long w0 = static_cast<long long>(S::NWG) * blockIdx.x + wg;
  const int n = w0 < tiles ? static_cast<int>((tiles - 1 - w0) / nw) + 1 : 0;
  auto half = [&](int j) { return room + (j & 1) * S::HALF; };
  auto rows_of = [&](long long tile) {
    return static_cast<int>(min(static_cast<long long>(TM), R - tile * TM));
  };
  // the s, v and cotangent rows of the walk's tile j (rows past R zeroed)
  auto load = [&](int j) {
    const long long r0 = (w0 + j * nw) * TM;
    const int rows = rows_of(w0 + j * nw);
    uint8_t* h = half(j);
    tc_load_rows<D>(h, TM, s + r0 * D, D, rows, t, 128);
    tc_load_rows<D>(h + S::TILE, TM, v + r0 * D, D, rows, t, 128);
    tc_load_rows<D>(h + 2 * S::TILE, TM, gy + r0 * D, D, rows, t, 128);
  };
  if (n > 0) load(0);
  tc::cp_async_commit();
  tc_store_rows_f32<D>(sm + S::O_W, 3 * D, W, D, tid, S::NT);
  for (int k = tid; k < 3 * D; k += S::NT) {
    gin_s[k] = gin[k];
    bin_s[k] = bin[k];
  }
  if (tid < D) {
    bias_s[tid] = bias[tid];
    gout_s[tid] = gout[tid];
  }
  // the parameter sums of the warp's rows: after the folds a lane holds
  // columns fold_col<16>(j, 0, lane), j = 0, 1
  float vgi[3][2], vbi[3][2], vgo[2], vbo[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    vgo[j] = vbo[j] = 0.f;
#pragma unroll
    for (int g = 0; g < 3; ++g) vgi[g][j] = vbi[g][j] = 0.f;
  }
  tc::cp_async_wait<0>();
  tc::fence_async_smem();
  __syncthreads();                     // W, the parameters, the first tile

  for (int j = 0; j < n; ++j) {
    const long long r0 = (w0 + j * nw) * TM;
    const int rows = rows_of(w0 + j * nw);
    long long row[2];                  // the rows' keys (past R: row 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row[h] = rl + 8 * h < rows ? r0 + rl + 8 * h : 0;
    // ---- the keep bits of the three groups (while the rows land) --------
    uint32_t kw[3][2];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      uint32_t k2[2][1] = {{~0u}, {~0u}};
      if (drop.on())
        tc_keep_bits<D / 8, true>(
            drop, drop.key3((lane & 1) ? row[1] : row[0], g, 0), lane, k2);
      kw[g][0] = k2[0][0];
      kw[g][1] = k2[1][0];
    }
    if (j > 0) {
      tc::cp_async_wait<0>();
      tc::fence_async_smem();
      tc::bar_sync(1 + wg, 128);       // this tile's rows; the last is done
    }
    const uint8_t* s_s = half(j);
    const uint8_t* v_s = s_s + S::TILE;
    uint8_t* g_s = half(j) + 2 * S::TILE;
    uint8_t* yd_s = half(j + 1);
    // ---- LN_in statistics, yd (the thread's s and v pairs read once) ----
    float mean[2] = {0.f, 0.f}, istd[2] = {0.f, 0.f};
    uint32_t sp[D / 4], vp[D / 4];
#pragma unroll
    for (int pr = 0; pr < D / 4; ++pr) {
      const int h = pr & 1, c = 8 * (pr >> 1) + cl;
      sp[pr] = *reinterpret_cast<const uint32_t*>(s_s + tc::swz(rl + 8 * h, c));
      vp[pr] = *reinterpret_cast<const uint32_t*>(v_s + tc::swz(rl + 8 * h, c));
      const float2 a = tc::unpack_bf16(sp[pr]), b = tc::unpack_bf16(vp[pr]);
      const float x0 = a.x * b.x, x1 = a.y * b.y;
      mean[h] += (a.x + a.y) + (b.x + b.y) + (x0 + x1);
      istd[h] += fmaf(a.x, a.x, a.y * a.y) + fmaf(b.x, b.x, b.y * b.y)
                 + fmaf(x0, x0, x1 * x1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = quad_sum(mean[h]) * drop.inv3;
      istd[h] = rsqrtf(fmaxf(quad_sum(istd[h]) * drop.inv3
                             - mean[h] * mean[h], 0.f) + LN_EPS);
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int pr = 0; pr < D / 4; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = 8 * q + cl;
        const float2 a = tc::unpack_bf16(sp[pr]), b = tc::unpack_bf16(vp[pr]);
        const float x0 = g == 0 ? a.x : (g == 1 ? b.x : a.x * b.x);
        const float x1 = g == 0 ? a.y : (g == 1 ? b.y : a.y * b.y);
        const uint32_t bits = kw[g][h] >> (4 * q);
        const float k0 = !drop.on() ? 1.f : (bits & 1u ? drop.scale : 0.f);
        const float k1 = !drop.on() ? 1.f : (bits & 2u ? drop.scale : 0.f);
        const float2 gi = *reinterpret_cast<const float2*>(gin_s + g * D + c);
        const float2 bi = *reinterpret_cast<const float2*>(bin_s + g * D + c);
        *reinterpret_cast<uint32_t*>(yd_s + g * S::TILE
                                     + tc::swz(rl + 8 * h, c)) =
            tc::pack_bf16(((x0 - mean[h]) * istd[h] * gi.x + bi.x) * k0,
                          ((x1 - mean[h]) * istd[h] * gi.y + bi.y) * k1);
      }
    tc::fence_async_smem();
    tc::bar_sync(1 + wg, 128);         // the yd tile is whole
    // ---- y1 = yd W (W MN-major), the yd rows out meanwhile --------------
    float acc[D / 2];
    {
      const uint32_t ya = tc::smem_u32(yd_s);
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < 3 * D / 16; ++ks)
        tc::mma_ss<D, 0, 1>(
            acc, tc::make_desc(ya + (ks / 4) * S::TILE + (ks % 4) * 32, 16),
            tc::make_desc(w_a + ks * 2 * tc::ATOM_BYTES,
                          Shapes<D>::W_PANEL),
            ks > 0);
      tc::commit();
    }
    tile_rows_out<3 * D, 128>(yd_rows + r0 * (3 * D), yd_s, rows, t);
    tc::wait<0>();
    tc::fence_regs(acc);
    // ---- LN_out and ReLU backward; g_y1 into its tile ---------------------
    float m2[2] = {0.f, 0.f}, i2[2] = {0.f, 0.f};
#pragma unroll
    for (int pr = 0; pr < D / 4; ++pr) {
      const int h = pr & 1;
      const float2 bv = *reinterpret_cast<const float2*>(
          bias_s + 8 * (pr >> 1) + cl);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[2 * pr + e] += e ? bv.y : bv.x;                // y1
        const float y2 = fmaxf(acc[2 * pr + e], 0.f);
        m2[h] += y2;
        i2[h] = fmaf(y2, y2, i2[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m2[h] = quad_sum(m2[h]) * drop.inv1;
      i2[h] = rsqrtf(fmaxf(quad_sum(i2[h]) * drop.inv1 - m2[h] * m2[h],
                           0.f) + LN_EPS);
    }
    {
      // the cotangent's bf16 pairs, read once
      uint32_t gp[D / 4];
      float tg[D / 4], tb[D / 4], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int pr = 0; pr < D / 4; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = 8 * q + cl;
        gp[pr] = *reinterpret_cast<const uint32_t*>(g_s + tc::swz(rl + 8 * h,
                                                                  c));
        const float2 g2 = tc::unpack_bf16(gp[pr]);
        const float2 go = *reinterpret_cast<const float2*>(gout_s + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * pr + e, ti = 2 * q + e;
          const float g = e ? g2.y : g2.x;
          const float xh = (fmaxf(acc[i], 0.f) - m2[h]) * i2[h];
          if (h == 0) {
            tg[ti] = g * xh;
            tb[ti] = g;
          } else {
            tg[ti] = fmaf(g, xh, tg[ti]);
            tb[ti] += g;
          }
          const float gxh = g * (e ? go.y : go.x);
          s1[h] += gxh;
          s2[h] = fmaf(gxh, xh, s2[h]);
        }
      }
      fold_cols<D / 4>(tg, vgo, lane);
      fold_cols<D / 4>(tb, vbo, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s1[h] = quad_sum(s1[h]) * drop.inv1;
        s2[h] = quad_sum(s2[h]) * drop.inv1;
      }
#pragma unroll
      for (int pr = 0; pr < D / 4; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        const float2 g2 = tc::unpack_bf16(gp[pr]);
        const float2 go = *reinterpret_cast<const float2*>(gout_s + c);
        float g1[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * pr + e;
          const float xh = (fmaxf(acc[i], 0.f) - m2[h]) * i2[h];
          const float gxh = (e ? g2.y : g2.x) * (e ? go.y : go.x);
          const float g2v = i2[h] * (gxh - s1[h] - xh * s2[h]);
          g1[e] = acc[i] > 0.f ? g2v : 0.f;
        }
        *reinterpret_cast<uint32_t*>(g1_s + tc::swz(rl + 8 * h, c)) =
            tc::pack_bf16(g1[0], g1[1]);
      }
    }
    tc::fence_async_smem();
    tc::bar_sync(1 + wg, 128);         // the g_y1 tile is whole; yd is read
    if (j + 1 < n) load(j + 1);        // into yd's half
    tc::cp_async_commit();
    tile_rows_out<D, 128>(gy1_rows + r0 * D, g1_s, rows, t);
    // ---- pass A: g_yd = g_y1 W^T once, a group at a time (0, 1, 2); the
    // dropout replay, ggin / gbin, the LN_in backward's row sums, P and Q ---
    float P[D / 2], Q[D / 2];
    float t1[2] = {0.f, 0.f}, t2[2] = {0.f, 0.f};
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float ac[D / 2];
      {
        const uint32_t ga = tc::smem_u32(g1_s);
        tc::fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          tc::mma_ss<D, 0, 0>(
              ac, tc::make_desc(ga + ks * 32, 16),
              tc::make_desc(w_a + g * D * tc::ROW_BYTES + ks * 32, 16),
              ks > 0);
        tc::commit();
        tc::wait<0>();
        tc::fence_regs(ac);
      }
      float tg[D / 4], tb[D / 4];
#pragma unroll
      for (int pr = 0; pr < D / 4; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = 8 * q + cl;
        const float2 a = tri_pair(s_s, rl, h, c), b = tri_pair(v_s, rl, h, c);
        const float2 gi = *reinterpret_cast<const float2*>(gin_s + g * D + c);
        const uint32_t bits = kw[g][h] >> (4 * q);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * pr + e, ti = 2 * q + e;
          const float sv = e ? a.y : a.x, vv = e ? b.y : b.x;
          const float x = g == 0 ? sv : (g == 1 ? vv : sv * vv);
          const float xh = (x - mean[h]) * istd[h];
          const float km = !drop.on() ? 1.f
              : ((bits >> e) & 1u ? drop.scale : 0.f);
          const float gyv = ac[i] * km;
          if (h == 0) {
            tg[ti] = gyv * xh;
            tb[ti] = gyv;
          } else {
            tg[ti] = fmaf(gyv, xh, tg[ti]);
            tb[ti] += gyv;
          }
          const float gxh = gyv * (e ? gi.y : gi.x);
          t1[h] += gxh;
          t2[h] = fmaf(gxh, xh, t2[h]);
          if (g == 0) {                // P = gxh0 + gxh2 v, Q = gxh1 + gxh2 s
            P[i] = gxh;
          } else if (g == 1) {
            Q[i] = gxh;
          } else {
            P[i] = fmaf(gxh, vv, P[i]);
            Q[i] = fmaf(gxh, sv, Q[i]);
          }
        }
      }
      fold_cols<D / 4>(tg, vgi[g], lane);
      fold_cols<D / 4>(tb, vbi[g], lane);
    }
    // ---- pass B: gs and gv through the cotangent and g_y1 tiles (read by
    // now: LN_out, and the products every warp waited for), then out -------
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      t1[h] = quad_sum(t1[h]) * drop.inv3;
      t2[h] = quad_sum(t2[h]) * drop.inv3;
    }
#pragma unroll
    for (int pr = 0; pr < D / 4; ++pr) {
      const int h = pr & 1, c = 8 * (pr >> 1) + cl;
      const float2 a = tri_pair(s_s, rl, h, c), b = tri_pair(v_s, rl, h, c);
      float o[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * pr + e;
        const float sv = e ? a.y : a.x, vv = e ? b.y : b.x;
        const float xh0 = (sv - mean[h]) * istd[h];
        const float xh1 = (vv - mean[h]) * istd[h];
        const float xh2 = (sv * vv - mean[h]) * istd[h];
        o[0][e] = istd[h] * (P[i] - t1[h] * (1.f + vv)
                             - t2[h] * fmaf(xh2, vv, xh0));
        o[1][e] = istd[h] * (Q[i] - t1[h] * (1.f + sv)
                             - t2[h] * fmaf(xh2, sv, xh1));
      }
      const int at = tc::swz(rl + 8 * h, c);
      *reinterpret_cast<uint32_t*>(g_s + at) = tc::pack_bf16(o[0][0],
                                                              o[0][1]);
      *reinterpret_cast<uint32_t*>(g1_s + at) = tc::pack_bf16(o[1][0],
                                                               o[1][1]);
    }
    tc::bar_sync(1 + wg, 128);         // the gs and gv tiles are whole
    tile_rows_out<D, 128>(gs + r0 * D, g_s, rows, t);
    tile_rows_out<D, 128>(gv + r0 * D, g1_s, rows, t);
  }
  // ---- the block's parameter-vector partials, warps summed in order -----
  __syncthreads();
  float* red = reinterpret_cast<float*>(sm + S::O_ROOM);  // [warps][NVT]
  const int wi = 4 * wg + warp;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = fold_col<D / 4>(j, 0, lane);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      red[wi * NVT + g * D + c] = vgi[g][j];
      red[wi * NVT + 3 * D + g * D + c] = vbi[g][j];
    }
    red[wi * NVT + 6 * D + c] = vgo[j];
    red[wi * NVT + 7 * D + c] = vbo[j];
  }
  __syncthreads();
  for (int k = tid; k < NVT; k += S::NT) {
    float acc_k = 0.f;
#pragma unroll
    for (int w = 0; w < 4 * S::NWG; ++w) acc_k += red[w * NVT + k];
    vec_part[static_cast<size_t>(blockIdx.x) * NVT + k] = acc_k;
  }
}

// ---- the bfloat16 instantiation at D = 256: W through a ring of slabs -----
//
// One resident block an SM walks 64-row tiles, the two warpgroups split
// the columns, the recompute on tri_bridge_tc.cuh, with W (384 KB)
// streamed.  What the design does about
// the card:
// * g_yd once a tile.  gx of the three LN_in groups enters the outputs only
//   as gs = gx0 + gx2 v and gv = gx1 + gx2 s, so pass A, which holds g_yd
//   of one (quarter, group) at a time (a warpgroup's 128 columns in two
//   quarters of 64, the groups 2, 0, 1), keeps P = gxh0 + gxh2 v and Q =
//   gxh1 + gxh2 s (gxh = g_yd keep gin) beside the row sums s1 = sum gxh
//   and s2 = sum gxh xh and the LN_in parameter sums, and pass B needs no
//   product: gs = istd (P - m1 (1 + v) - m2 (xh0 + xh2 v)), gv = istd (Q -
//   m1 (1 + s) - m2 (xh1 + xh2 s)), m = s / 3dv.  P and Q wait in float32
//   scratch rows (each thread reads back what it wrote).
// * W in bf16, as the products read it: tri_w256_pack_kernel rounds W once
//   a call into 48 slabs of 16 KB, the 24 stages of 32 rows x 256 columns
//   of y1 = yd W (read MN-major), then the 24 slabs of g_yd = g_y1 W^T, one
//   a (quarter, group, column block): both warpgroups' 64 rows of W x 64
//   columns (read K-major), each slab laid out as it lies in shared memory
//   (the 128-byte swizzle).  Thread 0 hands a slab to the copy engine
//   (cp.async.bulk), which completes on its slot's full barrier; each warp
//   arrives on the slot's empty barrier once the products that read it are
//   done, and thread 0 waits for that before it refills the slot.  So no
//   block barrier a slab, and within a product the tensor cores are waited
//   for one slab late.
// * Eleven slots of 16 KB, seven in use at a time: three of their own; the
//   s and v tiles' room during y1 (s and v are loaded again once y1 is
//   done); yd's room past g_y1 during g_yd.  Up to six slabs are in flight,
//   and the next tile's first three come in during this tile's last
//   products.
// Shared memory: 226,560 bytes.
struct Tri256 {
  static constexpr int D = 256;
  static constexpr int SLAB = 2 * TILE_PANEL;          // 16 KB
  static constexpr int PANEL = 32 * tc::ROW_BYTES;     // a y1 stage's panel
  static constexpr int PER_TILE = 48;                  // slabs a tile
  static constexpr int NY1 = 24;                       // ... of y1 = yd W
  static constexpr int RING = 7;                       // slots in use
  static constexpr int NSLOT = 11;                     // slots in all
  static constexpr int AHEAD = 6;                      // slabs in flight
  static constexpr int TILE = Shapes<D>::TILE_BYTES;   // 64 x 256 bf16
  static constexpr int O_S = 0;                        // s, v (slots 3-6)
  static constexpr int O_V = O_S + TILE;
  static constexpr int O_X = O_V + TILE;               // yd; g_y1 (slots 7-10)
  static constexpr int O_OWN = O_X + 3 * TILE;         // slots 0-2
  static constexpr int O_BAR = O_OWN + 3 * SLAB;       // full, empty barriers
  static constexpr int O_EX = O_BAR + 256;             // [4][wg][row][2]
  static constexpr int O_PV = O_EX + 4 * 2 * TM * 2 * 4;   // gin bin bias gout
  static constexpr int SMEM = O_PV + 8 * D * 4 + tc::ATOM_BYTES;
  static_assert(2 * NSLOT * 8 <= O_EX - O_BAR, "barriers");
  static_assert(4 * SLAB == 2 * TILE, "slots 3-6 fill s and v");
  static_assert(NY1 * SLAB == 3 * D * D * 2 && PER_TILE == 2 * NY1,
                "a tile's slabs: W in bf16 in each product's layout");
  // the slot of a tile's slab s: y1's in slots 0-6, g_yd's in 7-10, 0-2
  static __host__ __device__ constexpr int slot(int s) {
    return s < NY1 ? s % RING : (7 + (s - NY1) % RING) % NSLOT;
  }
  static __device__ __forceinline__ uint8_t* slot_ptr(uint8_t* sm, int k) {
    return k < 3 ? sm + O_OWN + k * SLAB
                 : (k < 7 ? sm + O_S + (k - 3) * SLAB
                          : sm + O_X + TILE + (k - 7) * SLAB);
  }
};

// W (3D, D) float32 rounded to bf16 into the PER_TILE slabs a tile reads,
// in order, each as it lies in shared memory: a thread a 16-byte chunk.  A
// y1 stage sl holds rows 32 sl + r of W in four panels (columns 64 pn + j);
// g_yd's slab i = 12 u + 4 n + kc (group g = 2, 0, 1 for n = 0, 1, 2)
// holds, in panel w, rows 256 g + 128 w + 64 u + r (warpgroup w's) and
// columns 64 kc + j.  Row r's chunk j / 8 lies at chunk (j / 8) ^ (r % 8).
__global__ void __launch_bounds__(NTHREADS)
tri_w256_pack_kernel(const float* __restrict__ W,
                     __nv_bfloat16* __restrict__ Wp) {
  constexpr int CHUNKS = Tri256::SLAB / 16;            // a slab's
  const int c = blockIdx.x * NTHREADS + threadIdx.x;
  if (c >= Tri256::PER_TILE * CHUNKS) return;
  const int sl = c / CHUNKS, q = c % CHUNKS;
  int row, r;
  if (sl < Tri256::NY1) {
    r = q / 8 % 32;
    row = 32 * sl + r;
  } else {
    const int i = sl - Tri256::NY1, u = i / 12, g = (i / 4 % 3 + 2) % 3;
    r = q / 8 % 64;
    row = g * Tri256::D + 128 * (q / 512) + 64 * u + r;
  }
  const int pn = sl < Tri256::NY1 ? q / 256 : (sl - Tri256::NY1) % 4;
  const float* src = W + static_cast<size_t>(row) * Tri256::D + 64 * pn
                     + 8 * ((q % 8) ^ (r % 8));
  uint4 out;
  out.x = tc::pack_bf16(src[0], src[1]);
  out.y = tc::pack_bf16(src[2], src[3]);
  out.z = tc::pack_bf16(src[4], src[5]);
  out.w = tc::pack_bf16(src[6], src[7]);
  reinterpret_cast<uint4*>(Wp)[c] = out;
}

__global__ void __launch_bounds__(NTHREADS, 1)
tri_bridge_bwd_tc256_kernel(const __nv_bfloat16* __restrict__ s,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ gin,
                            const float* __restrict__ bin,
                            const __nv_bfloat16* __restrict__ Wp,
                            const float* __restrict__ bias,
                            const float* __restrict__ gout,
                            const __nv_bfloat16* __restrict__ gy,
                            __nv_bfloat16* __restrict__ gs,
                            __nv_bfloat16* __restrict__ gv,
                            __nv_bfloat16* __restrict__ yd_rows,
                            __nv_bfloat16* __restrict__ gy1_rows,
                            float* __restrict__ pq_rows,
                            float* __restrict__ vec_part, long long R,
                            Dropout drop) {
  using S = Tri256;
  constexpr int D = S::D;
  constexpr int NVT = 8 * D;   // ggin (3D), gbin (3D), ggout, gbout (D)
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  uint8_t* s_s = sm + S::O_S;
  uint8_t* v_s = sm + S::O_V;
  uint8_t* yd_s = sm + S::O_X;
  uint8_t* g1_s = sm + S::O_X;         // once y1 is done
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::O_BAR);
  uint64_t* empty = full + S::NSLOT;
  float* ex_s = reinterpret_cast<float*>(sm + S::O_EX);
  float* gin_s = reinterpret_cast<float*>(sm + S::O_PV);
  float* bin_s = gin_s + 3 * D;
  float* bias_s = bin_s + 3 * D;
  float* gout_s = bias_s + D;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int rl = 16 * warp + (lane >> 2);
  const int cl = 2 * (lane & 3);
  const int half = D / 2 * wg;
  for (int k = tid; k < 3 * D; k += NTHREADS) {
    gin_s[k] = gin[k];
    bin_s[k] = bin[k];
  }
  if (tid < D) {                       // D <= NTHREADS
    bias_s[tid] = bias[tid];
    gout_s[tid] = gout[tid];
  }
  if (tid == 0) {
    for (int k = 0; k < S::NSLOT; ++k) {
      tc::mbar_init(full + k, 1);
      tc::mbar_init(empty + k, NWARPS);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  // ---- the ring.  The block's slab j is slab j % PER_TILE of its tile
  // j / PER_TILE (the tile's ordinal in the block's walk); thread 0 hands
  // slabs out in order while fewer than AHEAD are unreleased (by warp 0:
  // a slot is used again six slabs later at the soonest, so the slab it
  // waits for is one warp 0 has released) and the slot's room is open:
  // slots 3-6 only to the tile whose s and v are dead (open_s), 7-10 only
  // to the tile whose yd is dead (open_x) ------------------------------------
  const long long tiles = (R + TM - 1) / TM;
  const int total = static_cast<int>(
      (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x) * S::PER_TILE;
  int fetched = 0, released = 0, open_s = -1, open_x = -1;
  uint32_t ephase = (1u << S::NSLOT) - 1u;   // thread 0: empty waits' parity
  uint32_t fphase = 0u;                       // every thread: full waits'
  auto pump = [&]() {
    if (tid != 0) return;
    while (fetched < total && fetched < released + S::AHEAD) {
      const int ti = fetched / S::PER_TILE, sl = fetched % S::PER_TILE;
      const int k = S::slot(sl);
      if (k >= 3 && ti != (k < 7 ? open_s : open_x)) break;
      tc::mbar_wait(empty + k, (ephase >> k) & 1u);
      ephase ^= 1u << k;
      tc::mbar_expect_tx(full + k, S::SLAB);
      tc::bulk_g2s(S::slot_ptr(sm, k), Wp + static_cast<size_t>(sl) * (S::SLAB / 2),
                   S::SLAB, full + k);
      ++fetched;
    }
  };
  auto take = [&](int k) {             // slot k's slab has landed
    tc::mbar_wait(full + k, (fphase >> k) & 1u);
    fphase ^= 1u << k;
  };
  auto give = [&](int k) {             // the warp's products read slot k
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(empty + k);
    if (tid == 0) ++released;
    pump();
    __syncwarp();
  };
  pump();

  float vgi[3][2][2], vbi[3][2][2];    // [g][quarter][qh]
  float vgo[D / 64], vbo[D / 64];      // [block of four chunks]
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      vgi[g][u][0] = vgi[g][u][1] = vbi[g][u][0] = vbi[g][u][1] = 0.f;
#pragma unroll
  for (int j = 0; j < D / 64; ++j) vgo[j] = vbo[j] = 0.f;

  int ti = 0;
  for (long long tile = blockIdx.x; tile < tiles;
       tile += gridDim.x, ++ti) {
    const long long r0 = tile * TM;
    const int rows = static_cast<int>(min(static_cast<long long>(TM),
                                          R - r0));
    __syncthreads();                   // the previous tile is consumed
    tc_load_rows<D>(s_s, TM, s + r0 * D, D, rows, tid, NTHREADS);
    tc_load_rows<D>(v_s, TM, v + r0 * D, D, rows, tid, NTHREADS);
    tc::cp_async_commit();
    bool live[2];
    long long row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      live[h] = rl + 8 * h < rows;
      row[h] = r0 + (live[h] ? rl + 8 * h : 0);
    }
    uint32_t kw[3][2][2];
    tri_keep_bits<D>(drop, row, lane, half, kw);
    tc::cp_async_wait<0>();
    tc::fence_async_smem();
    __syncthreads();
    // ---- the recompute: LN_in statistics, yd (out as rows) --------------
    float mean[2], istd[2];
    tri_ln_in_stats<D>(s_s, v_s, ex_s, mean, istd, wg, rl, lane, drop.inv3);
    tri_yd_tile<false, D>(s_s, v_s, yd_s, kw, drop, mean, istd, gin_s,
                          bin_s, yd_rows, live, row, wg, rl, lane);
    tc::fence_async_smem();
    __syncthreads();                   // the yd tile is whole; s, v dead
    open_s = ti;
    pump();
    tile_rows_out<3 * D>(yd_rows + r0 * (3 * D), yd_s, rows, tid);
    // ---- y1 = yd W over the 24 stages of 32 rows ------------------------
    float acc[D / 4];
    {
      const uint32_t a = tc::smem_u32(yd_s);
#pragma unroll
      for (int p = 0; p < S::NY1; ++p) {
        const int k = S::slot(p);
        take(k);
        const uint32_t st = tc::smem_u32(S::slot_ptr(sm, k)) + 2 * wg * S::PANEL;
        tc::fence();
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int ks = 2 * p + q;
          tc::mma_ss<128, 0, 1>(
              acc, tc::make_desc(a + (ks / 4) * TILE_PANEL + (ks % 4) * 32, 16),
              tc::make_desc(st + q * 2 * tc::ATOM_BYTES, S::PANEL),
              p > 0 || q > 0);
        }
        tc::commit();
        if (p > 0) {
          tc::wait<1>();
          give(S::slot(p - 1));
        }
      }
      tc::wait<0>();
      give(S::slot(S::NY1 - 1));
      tc::fence_regs(acc);
    }
    tc::fence_async_smem();
    __syncthreads();                   // y1 is done: yd and the slots in s, v
    open_s = -1;
    open_x = ti;
    pump();
    tc_load_rows<D>(s_s, TM, s + r0 * D, D, rows, tid, NTHREADS);
    tc_load_rows<D>(v_s, TM, v + r0 * D, D, rows, tid, NTHREADS);
    tc::cp_async_commit();
    // ---- LN_out and ReLU backward; g_y1 into its tile and out as rows ----
    float m2[2], i2[2];
    tri_ln_out_stats<D>(acc, bias_s, ex_s + 2 * TM * 2, m2, i2, wg, rl,
                        lane, drop.inv1);
    {
      // the cotangent's bf16 pairs (row half pr % 2, columns half + 8 (pr /
      // 2) + cl and the next); gxh2 = g gout is taken from them twice
      uint32_t gp[D / 8];
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int pr = 0; pr < D / 8; ++pr) {
        const int h = pr & 1, c = half + 8 * (pr >> 1) + cl;
        gp[pr] = live[h] ? __ldg(reinterpret_cast<const unsigned int*>(
                               gy + row[h] * D + c))
                         : 0u;
      }
#pragma unroll
      for (int qb = 0; qb < D / 64; ++qb) {    // blocks of four chunks
        float tg[8], tb[8];
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const int q = 4 * qb + qq, c = half + 8 * q + cl;
          tg[2 * qq] = tg[2 * qq + 1] = tb[2 * qq] = tb[2 * qq + 1] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 g2 = tc::unpack_bf16(gp[2 * q + h]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * q + 2 * h + e;
              const float g = e ? g2.y : g2.x;
              const float xh = (fmaxf(acc[i], 0.f) - m2[h]) * i2[h];
              tg[2 * qq + e] = fmaf(g, xh, tg[2 * qq + e]);
              tb[2 * qq + e] += g;
              const float gxh = g * gout_s[c + e];
              s1[h] += gxh;
              s2[h] = fmaf(gxh, xh, s2[h]);
            }
          }
        }
        fold<8>(tg, 16, lane);
        fold<4>(tg, 8, lane);
        fold<2>(tg, 4, lane);
        fold<8>(tb, 16, lane);
        fold<4>(tb, 8, lane);
        fold<2>(tb, 4, lane);
        vgo[qb] += tg[0];
        vbo[qb] += tb[0];
      }
      tri_row_pair_sums(ex_s + 2 * 2 * TM * 2, s1, s2, wg, rl, lane);
#pragma unroll
      for (int pr = 0; pr < D / 8; ++pr) {
        const int h = pr & 1, c = half + 8 * (pr >> 1) + cl;
        const float2 g2 = tc::unpack_bf16(gp[pr]);
        float g1[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * pr + e;
          const float xh = (fmaxf(acc[i], 0.f) - m2[h]) * i2[h];
          const float gxh = (e ? g2.y : g2.x) * gout_s[c + e];
          const float g2v = i2[h] * (gxh - s1[h] * drop.inv1
                                     - xh * s2[h] * drop.inv1);
          g1[e] = acc[i] > 0.f ? g2v : 0.f;
        }
        *reinterpret_cast<uint32_t*>(g1_s + (c >> 6) * TILE_PANEL
                                     + tc::swz(rl + 8 * h, c & 63)) =
            tc::pack_bf16(g1[0], g1[1]);
      }
    }
    tc::cp_async_wait<0>();            // s and v again
    tc::fence_async_smem();
    __syncthreads();                   // the g_y1 tile is whole; s, v too
    tile_rows_out<D>(gy1_rows + r0 * D, g1_s, rows, tid);
    // ---- pass A: g_yd once, a (quarter, group) at a time (groups 2, 0, 1:
    // gxh2 waits in registers for P and Q); the dropout replay, ggin /
    // gbin, the LN_in backward's row sums, P and Q into their rows ---------
    float t1[2] = {0.f, 0.f}, t2[2] = {0.f, 0.f};
    const uint32_t g1a = tc::smem_u32(g1_s);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int base = half + 64 * u;
      float gx2[32];
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const int g = (n + 2) % 3;
        float ac[32];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const int k = S::slot(S::NY1 + 12 * u + 4 * n + kc);
          take(k);
          const uint32_t st = tc::smem_u32(S::slot_ptr(sm, k)) + wg * TILE_PANEL;
          tc::fence();
#pragma unroll
          for (int q = 0; q < 4; ++q)
            tc::mma_ss<64, 0, 0>(
                ac, tc::make_desc(g1a + kc * TILE_PANEL + q * 32, 16),
                tc::make_desc(st + q * 32, 16), kc > 0 || q > 0);
          tc::commit();
          if (kc > 0) {
            tc::wait<1>();
            give(S::slot(S::NY1 + 12 * u + 4 * n + kc - 1));
          }
        }
        tc::wait<0>();
        give(S::slot(S::NY1 + 12 * u + 4 * n + 3));
        tc::fence_regs(ac);
#pragma unroll
        for (int qh = 0; qh < 2; ++qh) {
          float tg[8], tb[8];
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const int q = 4 * qh + qq, c = base + 8 * q + cl;
            const float2 gi = *reinterpret_cast<const float2*>(
                gin_s + g * D + c);
            tg[2 * qq] = tg[2 * qq + 1] = tb[2 * qq] = tb[2 * qq + 1] = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 a = tri_pair(s_s, rl, h, c),
                           b = tri_pair(v_s, rl, h, c);
              const uint32_t bits = kw[g][h][u] >> (4 * q);
              float pq[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * q + 2 * h + e;
                const float sv = e ? a.y : a.x, vv = e ? b.y : b.x;
                const float x = g == 0 ? sv : (g == 1 ? vv : sv * vv);
                const float xh = (x - mean[h]) * istd[h];
                const float km = !drop.on() ? 1.f
                    : ((bits >> e) & 1u ? drop.scale : 0.f);
                const float gyv = ac[i] * km;
                tg[2 * qq + e] = fmaf(gyv, xh, tg[2 * qq + e]);
                tb[2 * qq + e] += gyv;
                const float gxh = gyv * (e ? gi.y : gi.x);
                t1[h] += gxh;
                t2[h] = fmaf(gxh, xh, t2[h]);
                if (g == 2)
                  gx2[i] = gxh;
                else                   // P = gxh0 + gxh2 v, Q = gxh1 + gxh2 s
                  pq[e] = fmaf(gx2[i], g == 0 ? vv : sv, gxh);
              }
              if (g != 2 && live[h])
                *reinterpret_cast<float2*>(pq_rows + row[h] * (2 * D)
                                           + (g == 0 ? 0 : D) + c) =
                    make_float2(pq[0], pq[1]);
            }
          }
          // sums over the eight lanes that hold these columns' other rows
          fold<8>(tg, 16, lane);
          fold<4>(tg, 8, lane);
          fold<2>(tg, 4, lane);
          fold<8>(tb, 16, lane);
          fold<4>(tb, 8, lane);
          fold<2>(tb, 4, lane);
          vgi[g][u][qh] += tg[0];
          vbi[g][u][qh] += tb[0];
        }
      }
    }
    tri_row_pair_sums(ex_s + 3 * 2 * TM * 2, t1, t2, wg, rl, lane);
    // ---- pass B: gs and gv from P and Q into two tiles where g_y1 and
    // slots 7 and 8 were (pass A is done with them), then out as rows ----
    const float m1r[2] = {t1[0] * drop.inv3, t1[1] * drop.inv3};
    const float m2r[2] = {t2[0] * drop.inv3, t2[1] * drop.inv3};
    uint8_t* gs_s = sm + S::O_X;
    uint8_t* gv_s = gs_s + S::TILE;
#pragma unroll
    for (int pr = 0; pr < D / 8; ++pr) {
      const int h = pr & 1, c = half + 8 * (pr >> 1) + cl;
      const float2 a = tri_pair(s_s, rl, h, c), b = tri_pair(v_s, rl, h, c);
      float2 P = make_float2(0.f, 0.f), Q = P;
      if (live[h]) {
        P = *reinterpret_cast<const float2*>(pq_rows + row[h] * (2 * D) + c);
        Q = *reinterpret_cast<const float2*>(pq_rows + row[h] * (2 * D) + D
                                             + c);
      }
      float o[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sv = e ? a.y : a.x, vv = e ? b.y : b.x;
        const float xh0 = (sv - mean[h]) * istd[h];
        const float xh1 = (vv - mean[h]) * istd[h];
        const float xh2 = (sv * vv - mean[h]) * istd[h];
        o[0][e] = istd[h] * ((e ? P.y : P.x) - m1r[h] * (1.f + vv)
                             - m2r[h] * fmaf(xh2, vv, xh0));
        o[1][e] = istd[h] * ((e ? Q.y : Q.x) - m1r[h] * (1.f + sv)
                             - m2r[h] * fmaf(xh2, sv, xh1));
      }
      const int at = (c >> 6) * TILE_PANEL + tc::swz(rl + 8 * h, c & 63);
      *reinterpret_cast<uint32_t*>(gs_s + at) = tc::pack_bf16(o[0][0],
                                                               o[0][1]);
      *reinterpret_cast<uint32_t*>(gv_s + at) = tc::pack_bf16(o[1][0],
                                                               o[1][1]);
    }
    __syncthreads();                   // the gs and gv tiles are whole
    tile_rows_out<D>(gs + r0 * D, gs_s, rows, tid);
    tile_rows_out<D>(gv + r0 * D, gv_s, rows, tid);
  }
  // ---- the block's parameter-vector partials, warps summed in order -----
  __syncthreads();
  float* red = reinterpret_cast<float*>(yd_s);        // [4 warps][NVT]
  {
    // after the folds a lane holds, per group, quarter and column half qh,
    // the sum over its warp's rows of column half + 64 u + 8 (4 qh + 2 b4 +
    // b3) + 2 (lane % 4) + b2
    const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int qh = 0; qh < 2; ++qh) {
          const int c = half + 64 * u + 8 * (4 * qh + 2 * b4 + b3) + cl + b2;
          red[warp * NVT + g * D + c] = vgi[g][u][qh];
          red[warp * NVT + 3 * D + g * D + c] = vbi[g][u][qh];
        }
  }
  {
    // ggout / gbout: block qb of four chunks, column half + 8 (4 qb + 2 b4
    // + b3) + 2 (lane % 4) + b2
    const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
#pragma unroll
    for (int qb = 0; qb < D / 64; ++qb) {
      const int c = half + 8 * (4 * qb + 2 * b4 + b3) + cl + b2;
      red[warp * NVT + 6 * D + c] = vgo[qb];
      red[warp * NVT + 7 * D + c] = vbo[qb];
    }
  }
  __syncthreads();
  for (int k = tid; k < NVT; k += NTHREADS)
    vec_part[static_cast<size_t>(blockIdx.x) * NVT + k] =
        ((red[k] + red[NVT + k]) + red[2 * NVT + k]) + red[3 * NVT + k];
}

// The bf16 backward at D = 64: the main kernel, the weight gradient over the
// bf16 rows it wrote and the fixed-order slot sums.
int launch_tc64(const void* s, const void* v, const float* gin,
                const float* bin, const float* W, const float* bias,
                const float* gout, const void* g, void* gs, void* gv,
                float* gvec, float* gw, void* yd, void* gy1, float* vec_part,
                float* wg_part, long long R, int wg_chunks, Dropout drop,
                cudaStream_t stream) {
  constexpr int D = 64;
  using bf16 = __nv_bfloat16;
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  auto hm = [](void* p) { return static_cast<bf16*>(p); };
  constexpr int smem = Tri64::SMEM;
  cudaError_t err = allow_smem(tri_bridge_bwd_tc64_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // three warpgroups a block, a tile at a time each
  const long long want = (R + Tri64::NWG * TM - 1) / (Tri64::NWG * TM);
  const int sms = sm_count();
  const int blocks = static_cast<int>(want < sms ? want : sms);
  tri_bridge_bwd_tc64_kernel<<<blocks, Tri64::NT, smem, stream>>>(
      h(s), h(v), gin, bin, W, bias, gout, h(g), hm(gs), hm(gv), hm(yd),
      hm(gy1), vec_part, R, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // [gw; gb] (the wrapper lays gb behind gw)
  if ((err = wgrad_tc(h(yd), h(gy1), wg_part, gw, R, 3 * D, D,
                      wg_chunks, stream)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(sum_slots<float>(vec_part, gvec, 1, blocks, 8 * D,
                                           stream));
}

// The bf16 backward at D = 256: W packed into bf16 slabs (in Wp), the
// streamed kernel over them, then the weight gradient and the slot sums as
// at 64.
int launch_tc256(const void* s, const void* v, const float* gin,
                 const float* bin, const float* W, const float* bias,
                 const float* gout, const void* g, void* gs, void* gv,
                 float* gvec, float* gw, void* yd, void* gy1, float* pq,
                 void* Wp, float* vec_part, float* wg_part, long long R,
                 int wg_chunks, Dropout drop, cudaStream_t stream) {
  constexpr int D = 256;
  using bf16 = __nv_bfloat16;
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  auto hm = [](void* p) { return static_cast<bf16*>(p); };
  constexpr int smem = Tri256::SMEM;
  constexpr int chunks = Tri256::PER_TILE * Tri256::SLAB / 16;
  tri_w256_pack_kernel<<<(chunks + NTHREADS - 1) / NTHREADS, NTHREADS, 0,
                         stream>>>(W, hm(Wp));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = allow_smem(tri_bridge_bwd_tc256_kernel, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const long long tiles = (R + TM - 1) / TM;
  const int sms = sm_count();
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  tri_bridge_bwd_tc256_kernel<<<blocks, NTHREADS, smem, stream>>>(
      h(s), h(v), gin, bin, h(Wp), bias, gout, h(g), hm(gs), hm(gv), hm(yd),
      hm(gy1), pq, vec_part, R, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = wgrad_tc(h(yd), h(gy1), wg_part, gw, R, 3 * D, D,
                      wg_chunks, stream)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(sum_slots<float>(vec_part, gvec, 1, blocks, 8 * D,
                                           stream));
}

}  // namespace

// As tri_bridge_bwd (tri_bridge_bwd.cu) at width D = 64 or 256: s, v, g,
// gs, gv R rows of D, all bf16 (is_bf16) or all float32; gin/bin (3D), W
// (3D, D), Wt = W^T (D, 3D), bias, gout (D) float32; when is_bf16 Wt is
// unused (may be NULL); the bf16 kernels round W to bf16, at D = 64 as they
// load it, at D = 256 once a call into wp.
// Outputs, float32: gvec = [ggin (3D); gbin (3D); gb (D); ggout (D); gbout
// (D)] and gw (3D, D); when is_bf16 gvec has no gb and gw has 3D + 1 rows,
// the last is gb.  Scratch (the wrapper's): yd (R, 3D) and gy1 (R, D) in the
// activation type; float32 vec_part (ceil(R / RT), 9D) with RT = 16 at D =
// 256, else 32, and wg_part (wg_chunks, 3D, D), or when is_bf16 vec_part
// (min(ceil(R / 64), SMs), 8D) and wg_part (wg_chunks, 3D + 1, D); pq, when
// is_bf16 at D = 256, (R, 2D) float32 (P and Q of each row), and wp, 2 x 3D
// x D bf16 (W in the layouts the two products read), else unused (may be
// NULL).  Any other D is refused.
// dv: the true width, 4 <= dv <= D with 4 | dv, of inputs zero-padded to D
// (every LN's statistics and the Philox keys, philox.cuh).
extern "C" int tri_bridge_bwd_wide(
    const void* s, const void* v, const void* gin, const void* bin,
    const void* W, const void* Wt, const void* bias, const void* gout,
    const void* g, void* gs, void* gv, void* gvec, void* gw, void* yd,
    void* gy1, void* vec_part, void* wg_part, void* pq, void* wp, long long R,
    int wg_chunks, int d, const unsigned long long* drop_seed,
    unsigned drop_threshold, float drop_scale, int dv, int is_bf16,
    void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop =
      entry_dropout(drop_seed, drop_threshold, drop_scale, dv);
  if (!width_ok(dv, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && d == 64)
    return launch_tc64(s, v, f(gin), f(bin), f(W), f(bias), f(gout), g, gs,
                       gv, fm(gvec), fm(gw), yd, gy1, fm(vec_part),
                       fm(wg_part), R, wg_chunks, drop, st);
  if (is_bf16 && d == 256)
    return launch_tc256(s, v, f(gin), f(bin), f(W), f(bias), f(gout), g, gs,
                        gv, fm(gvec), fm(gw), yd, gy1, fm(pq), wp,
                        fm(vec_part), fm(wg_part), R, wg_chunks, drop, st);
#define TVQA_TRI_WIDE(DD)                                                  \
  return launch<DD>(f(s), f(v), f(gin), f(bin), f(W), f(Wt), f(bias),      \
                    f(gout), f(g), fm(gs), fm(gv), fm(gvec), fm(gw), fm(yd), \
                    fm(gy1), fm(vec_part), fm(wg_part), R, wg_chunks, drop, \
                    st)
  if (d == 64) TVQA_TRI_WIDE(64);
  if (d == 256) TVQA_TRI_WIDE(256);
#undef TVQA_TRI_WIDE
  return static_cast<int>(cudaErrorInvalidValue);
}
