// Fused MLP bridge, backward.
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_bridge.py (_backward
// :159, call :171 / _bwd_kernel :77).  Row-local: for every row it
// recomputes yd = LN_in(x) times the replayed Philox dropout mask, y1 = yd W
// + b, y2 = ReLU(y1) and the LN_out statistics, then with the cotangent g of
// the output:
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
// (~56 us).
//
// Two instantiations.
// * bfloat16: every product on the tensor cores (wgmma, bf16 operands,
//   float32 sums).
//   - mlp_bridge_bwd_tc_kernel: one persistent block an SM walks 64-row
//     tiles; the recompute (LN_in into the bf16 A tile, y1 = yd W through
//     the ring of W stages, LN_out statistics) is mlp_bridge_tc.cuh's,
//     shared with the forward.  The tile's cotangent rows come into
//     shared memory by cp.async once y1 is made; LN_out's backward and the
//     ReLU gate run on y1's accumulators; g_y1, rounded to bf16, replaces
//     yd in the A tile
//     and is the A operand of g_yd = g_y1 W^T, which reads the same W
//     stages K-major (no transposed copy).  g_yd is 64 x Din wide (768:
//     384 accumulators a thread), and LN_in's backward needs each row's
//     sums of g_yd gin xhat and g_yd gin over all Din columns before gx, so
//     g_yd is made twice, 64 columns a W stage (each warpgroup 32): a first
//     pass takes those row sums and the column sums of ggin / gbin, a
//     second writes gx.  That costs a third pass of W from L2 and 2 R Din
//     Dout more operations (18 GFLOP at the subtitle stream), where keeping
//     g_yd in float32 would take 192 KB of shared memory a tile and
//     spilling it 246 MB of device-memory traffic (a per-block spill that
//     L2 could hold was tried: no faster).  The depth loops of
//     the products are unrolled at compile time and no branch on the
//     warpgroup surrounds a wgmma: either makes the compiler serialize
//     them.  The keep bits are drawn
//     once, in the LN_in pass, into a shared bitmap.  yd and g_y1 rows go
//     out in bf16 (zero-padded to Kp and Np columns; ~86 MB at the
//     subtitle stream) for the weight gradient; the Din- and Dout-wide
//     column sums fold over the lanes, then over a warpgroup's four warps
//     in order, into the block's shared partial sums, and go to one slot
//     per block.
//   - mlp_bridge_wgrad_tc_kernel: [gW; gb] from those rows, each block 128
//     columns of yd against all Np columns of g_y1 and one chunk of rows,
//     into fixed-order chunk slots that mlp_bridge_wgrad_sum_kernel adds.
// * float32: the exactness check, CUDA cores: one block per 32-row tile,
//   each warp owns 4 rows.  The tile's yd rows (32 x Din) sit in shared
//   memory for the y1 product and are then overwritten by g_yd, so one
//   Din-wide buffer serves both; y1 and then g_y1 share the 32 x Dout
//   buffer.  W is staged from L2 32 rows at a time (W^T read from W).  gW is
//   its own GEMM over the yd and g_y1 rows that the main kernel writes to
//   float32 scratch, through row-chunk slots.
// The TPU kernel adds every parameter gradient into an output block that
// its sequential grid revisits; blocks here run at once, so each block sums
// its rows column by column in a fixed order into its own slot of a
// scratch buffer, and a second launch adds the slots in order
// (grad_reduce.cuh): gradients are the same bits from run to run.
#include "grad_reduce.cuh"
#include "mlp_bridge.cuh"
#include "mlp_bridge_tc.cuh"

namespace {

using namespace tvqa;

__host__ __device__ inline int smem_floats(int Din, int Dout) {
  return BR_RT * round_kc(Din) + BR_RT * round_kc(Dout) + KC * D + 6 * BR_RT;
}

// one scratch slot: ggin, gbin (Din each), gb, ggout, gbout (Dout each)
__host__ __device__ inline int vec_floats(int Din, int Dout) {
  return 2 * Din + 3 * Dout;
}

__global__ void __launch_bounds__(NTHREADS)
mlp_bridge_bwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ gin,
                      const float* __restrict__ bin,
                      const float* __restrict__ W,
                      const float* __restrict__ bias,
                      const float* __restrict__ gout,
                      const float* __restrict__ gy, float* __restrict__ gx,
                      float* __restrict__ yd_buf, float* __restrict__ g1_buf,
                      float* __restrict__ vec_part, long long R, int Din,
                      int Dout, Dropout drop) {
  drop.load_seed();
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
  bridge_ln_in(x, y_s, st_s, yd_buf, gin, bin, r0, R, Din, ys, drop, warp,
               lane);
  // columns [Dout, os) of o_s stay zero: they are K padding of g_y1 W^T
  for (int i = tid; i < BR_RT * (os - Dout); i += NTHREADS)
    o_s[(i / (os - Dout)) * os + Dout + i % (os - Dout)] = 0.f;
  for (int col0 = 0; col0 < Dout; col0 += D) {
    float acc[BR_RPT][4];
    bridge_gemm<BR_RPT, false>(acc, y_s, ys, Din, W, Dout, Dout, col0, w_s,
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
      const float gxh = gy[row * Dout + c] * gout[c];
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

  // ---- column pass: g_y1 in place of y1, and the Dout-wide sums ---------
  for (int c = tid; c < Dout; c += NTHREADS) {
    const float go = gout[c];
    float ggo = 0.f, gbo = 0.f, gb = 0.f;
    for (int r = 0; r < BR_RT; ++r) {
      const long long row = r0 + r;
      float g1 = 0.f;
      if (row < R) {
        const float y1 = o_s[r * os + c];
        const float xh = (fmaxf(y1, 0.f) - st2_s[4 * r]) * st2_s[4 * r + 1];
        const float g = gy[row * Dout + c];
        ggo = fmaf(g, xh, ggo);
        gbo += g;
        const float g2 = st2_s[4 * r + 1]
                         * (g * go - st2_s[4 * r + 2] - xh * st2_s[4 * r + 3]);
        g1 = y1 > 0.f ? g2 : 0.f;
        gb += g1;
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
    bridge_gemm<BR_RPT, true>(acc, o_s, os, Dout, W, Din, Din, col0, w_s,
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
    const float* xr = x + row * Din;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < Din; c += 32) {
      const float gxh = gr[c] * gin[c];
      s1 += gxh;
      s2 = fmaf(gxh, (xr[c] - mean) * istd, s2);
    }
    const float m1 = warp_sum(s1) / Din;
    const float m2 = warp_sum(s2) / Din;
    for (int c = lane; c < Din; c += 32) {
      const float xh = (xr[c] - mean) * istd;
      gx[row * Din + c] = istd * (gr[c] * gin[c] - m1 - xh * m2);
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
      ggi = fmaf(gyd, (x[row * Din + c] - st_s[2 * r]) * st_s[2 * r + 1], ggi);
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

int launch_f32(const float* x, const float* gin, const float* bin,
               const float* W, const float* bias, const float* gout,
               const float* g, float* gx, float* gvec, float* gw,
               float* yd_buf, float* g1_buf, float* vec_part, float* wg_part,
               long long R, int Din, int Dout, int wg_chunks, Dropout drop,
               cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(Din, Dout);
  cudaError_t err = allow_smem(mlp_bridge_bwd_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((R + BR_RT - 1) / BR_RT);
  mlp_bridge_bwd_kernel<<<blocks, NTHREADS, bytes, stream>>>(
      x, gin, bin, W, bias, gout, g, gx, yd_buf, g1_buf, vec_part, R, Din,
      Dout, drop);
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

// ---- the bfloat16 instantiation: tensor cores ------------------------------

constexpr int BWD_STAGES = 2;
constexpr int BWD_EX = 2 * TM * 2;     // floats of one exchange round

// Byte offsets of the backward's shared memory (after 1024-alignment): the
// A tile (yd, then g_y1 and the cotangent rows g), the ring, the keep bitmap,
// each row's LN_in (mean, 1 / std), three exchange rounds, bias and gout
// (Np), gin (Kp), the block's partial sums ggin, gbin (Kp) and ggout,
// gbout (Np), and the warps' column sums before they are added in order:
// red1 [warpgroup][panel < 3][ggout, gbout][warp][64], red2 [warpgroup]
// [ggin, gbin][warp][32].
struct BwdSmem {
  int g, gs, ring, keep, st, ex, bias, gout, gin, pgi, pbi, pgo, pbo, red1,
      red2, total;
};

inline __host__ __device__ BwdSmem bwd_layout(int Kp, int Np) {
  BwdSmem L;
  // the tile's cotangent rows (gs bytes apart: 16 more than a row, so that
  // eight rows of a column fall in other banks) lie behind g_y1's panels
  // in the A region once y1 is made
  L.g = TM * Np * 2;
  L.gs = 2 * Np + 16;
  const int u = L.g + TM * L.gs;
  L.ring = ((TM * Kp * 2 > u ? TM * Kp * 2 : u) + 1023) / 1024 * 1024;
  L.keep = L.ring + BWD_STAGES * TM * Np * 2;
  L.st = L.keep + TM * BT_KEEP_WORDS * 4;
  L.ex = L.st + TM * 2 * 4;
  L.bias = L.ex + 3 * BWD_EX * 4;
  L.gout = L.bias + Np * 4;
  L.gin = L.gout + Np * 4;
  L.pgi = L.gin + Kp * 4;
  L.pbi = L.pgi + Kp * 4;
  L.pgo = L.pbi + Kp * 4;
  L.pbo = L.pgo + Np * 4;
  L.red1 = L.pbo + Np * 4;
  L.red2 = L.red1 + 2 * 3 * 2 * 4 * 64 * 4;
  L.total = L.red2 + 2 * 2 * 4 * 32 * 4;
  return L;
}

// The first `rows` rows of a bf16 tile (`cols` columns in K-major panels)
// out to dst (row stride cols), 16 bytes a thread: coalesced.
__device__ __forceinline__ void bt_rows_out(__nv_bfloat16* __restrict__ dst,
                                            const uint8_t* tile, int cols,
                                            int rows, int t) {
  const int per = cols / 8;
  for (int i = t; i < rows * per; i += NTHREADS) {
    const int r = i / per, ch = i - r * per;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * cols + ch * 8) =
        *reinterpret_cast<const uint4*>(tile + (ch >> 3) * TILE_PANEL
                                        + tc::swz_chunk(r, ch & 7));
  }
}

// g2 = the tile's g_y1 (A, K-major, Np = 64 NP deep, NP <= 2 NPH) x the
// stage's rows 32 wg .. 32 wg + 31 read K-major (W's rows: g_yd's
// columns): this warpgroup's 32 columns of g_yd in the chunk.  Issued and
// committed; the caller waits.  The depth loop is unrolled at compile time
// (a run-time loop around wgmma makes the compiler serialize them).
template <int NPH>
__device__ __forceinline__ void bt_glnd_mma(float (&g2)[16],
                                            const uint8_t* g1_s,
                                            const uint8_t* st, int NP,
                                            int wg) {
  const uint32_t a0 = tc::smem_u32(g1_s);
  const uint32_t b0 = tc::smem_u32(st) + 32 * wg * tc::ROW_BYTES;
  tc::fence();
#pragma unroll
  for (int p = 0; p < 2 * NPH; ++p) {
    if (p < NP) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int off = p * TILE_PANEL + ks * 32;
        tc::mma_ss<32, 0, 0>(g2, tc::make_desc(a0 + off, 16),
                             tc::make_desc(b0 + off, 16),
                             p > 0 || ks > 0);
      }
    }
  }
  tc::commit();
}

template <typename TX, int NPH>
__global__ void __launch_bounds__(NTHREADS, 1)
mlp_bridge_bwd_tc_kernel(const TX* __restrict__ x,
                         const float* __restrict__ gin,
                         const float* __restrict__ bin,
                         const __nv_bfloat16* __restrict__ W,
                         const float* __restrict__ bias,
                         const float* __restrict__ gout,
                         const __nv_bfloat16* __restrict__ gy,
                         TX* __restrict__ gx,
                         __nv_bfloat16* __restrict__ yd_rows,
                         __nv_bfloat16* __restrict__ g1_rows,
                         float* __restrict__ vec_part, long long R, int Din,
                         int Dout, Dropout drop) {
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  const int Kp = bt_pad64(Din), Np = bt_pad64(Dout);
  const int KC = Kp / 64, NP = Np / 64, stage_bytes = TM * Np * 2;
  const BwdSmem L = bwd_layout(Kp, Np);
  uint8_t* a_s = sm;                   // yd, then g_y1
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(sm + L.keep);
  float* st_s = reinterpret_cast<float*>(sm + L.st);
  float* ex_s = reinterpret_cast<float*>(sm + L.ex);
  float* bias_s = reinterpret_cast<float*>(sm + L.bias);
  float* gout_s = reinterpret_cast<float*>(sm + L.gout);
  float* gin_s = reinterpret_cast<float*>(sm + L.gin);
  float* pgi = reinterpret_cast<float*>(sm + L.pgi);
  float* pbi = reinterpret_cast<float*>(sm + L.pbi);
  float* pgo = reinterpret_cast<float*>(sm + L.pgo);
  float* pbo = reinterpret_cast<float*>(sm + L.pbo);

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5;
  const int lane = tid & 31, t = tid & 127, wq = warp & 3;
  const int rl = 16 * wq + (lane >> 2), cl = 2 * (lane & 3);
  const int p0 = wg ? NP - NPH : 0;
  float* red1 = reinterpret_cast<float*>(sm + L.red1) + wg * 3 * 2 * 4 * 64;
  float* red2 = reinterpret_cast<float*>(sm + L.red2) + wg * 2 * 4 * 32;
  for (int c = tid; c < Np; c += NTHREADS) {
    bias_s[c] = c < Dout ? bias[c] : 0.f;
    gout_s[c] = c < Dout ? gout[c] : 0.f;
    pgo[c] = pbo[c] = 0.f;
  }
  for (int c = tid; c < Kp; c += NTHREADS) {
    gin_s[c] = c < Din ? gin[c] : 0.f;
    pgi[c] = pbi[c] = 0.f;
  }
  const long long tiles = (R + TM - 1) / TM;
  BtRing<BWD_STAGES> ring{sm + L.ring, W, Np, KC, stage_bytes,
                          (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                              * 3 * KC, 0};
  ring.start(tid);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * TM;
    const int rows = static_cast<int>(min(static_cast<long long>(TM),
                                          R - r0));
    __syncthreads();       // the previous tile's bitmap, stats, g_y1 are read
    const long long rn = r0 + static_cast<long long>(gridDim.x) * TM;
    if (rn < R)
      bt_prefetch_l2(x + rn * Din, static_cast<size_t>(min(
                         static_cast<long long>(TM), R - rn)) * Din
                         * sizeof(TX), tid, NTHREADS);
    // ---- recompute: yd = dropout(LN_in(x)) into the A tile and out -------
    bt_ln_in<TX, true>(x, r0, rows, Din, Kp, gin, bin, drop, a_s, keep_s,
                       st_s, warp, lane);
    tc::fence_async_smem();
    __syncthreads();
    bt_rows_out(yd_rows + r0 * Kp, a_s, Kp, rows, tid);
    bool live[2];
    long long row[2];
    float mean[2], istd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      live[h] = rl + 8 * h < rows;
      row[h] = r0 + rl + 8 * h;
      mean[h] = st_s[2 * (rl + 8 * h)];
      istd[h] = st_s[2 * (rl + 8 * h) + 1];
    }
    // ---- y1 = yd W + b; LN_out statistics (exchange round 0) --------------
    float acc[NPH][32], m2[2], i2[2];
    bt_y1<NPH, BWD_STAGES>(acc, ring, a_s, bias_s, ex_s, m2, i2, KC, Dout,
                           p0, wg, rl, tid);
    // the tile's cotangent rows into shared memory (8-byte copies: a bf16
    // row of Dout = 300 is 600 bytes), over yd, whose products are done
    uint8_t* g_s = a_s + L.g;
    {
      const int per = Dout / 4;
      for (int i = tid; i < rows * per; i += NTHREADS) {
        const int r = i / per, ch = i - r * per;
        bt_cp_async8(g_s + r * L.gs + ch * 8, gy + (r0 + r) * Dout + ch * 4);
      }
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncthreads();
    }
    // ---- LN_out backward: its row sums (round 1), ggout and gbout ---------
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int p = 0; p < NPH; ++p) {
      float vg[16], vb[16];
#pragma unroll
      for (int pr = 0; pr < 16; ++pr) {
        const int h = pr & 1, q = pr >> 1;
        const int c = 64 * (p0 + p) + 8 * q + cl;
        const float2 g2 = bt_panel_valid(wg, p0, p, NPH) && live[h]
                          && c < Dout
            ? tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(
                  g_s + (rl + 8 * h) * L.gs + 2 * c))
            : make_float2(0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float g = e ? g2.y : g2.x;
          const float xh = (fmaxf(acc[p][2 * pr + e], 0.f) - m2[h]) * i2[h];
          if (h == 0) {
            vg[2 * q + e] = g * xh;
            vb[2 * q + e] = g;
          } else {
            vg[2 * q + e] = fmaf(g, xh, vg[2 * q + e]);
            vb[2 * q + e] += g;
          }
          const float gg = g * gout_s[c + e];
          s1[h] += gg;
          s2[h] = fmaf(gg, xh, s2[h]);
        }
      }
      const int c = bt_fold_panel(vg, lane);
      bt_fold_panel(vb, lane);
      float* rd = red1 + p * 2 * 4 * 64 + wq * 64 + c;
      rd[0] = vg[0];
      rd[1] = vg[1];
      rd[4 * 64] = vb[0];
      rd[4 * 64 + 1] = vb[1];
    }
    // the warpgroup's four warps' column sums, added in order (one thread a
    // column: the same bits every run)
    tc::bar_sync(1 + wg, 128);
    for (int i = t; i < NPH * 128; i += 128) {
      if (!bt_panel_valid(wg, p0, i >> 7, NPH)) continue;
      const float* rd = red1 + (i >> 6) * 4 * 64 + (i & 63);
      const float v = ((rd[0] + rd[64]) + rd[128]) + rd[192];
      float* part = (i >> 6) & 1 ? pbo : pgo;
      part[64 * (p0 + (i >> 7)) + (i & 63)] += v;
    }
    tri_row_pair_sums(ex_s + BWD_EX, s1, s2, wg, rl, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {      // the two row means
      s1[h] /= Dout;
      s2[h] /= Dout;
    }
    // ---- g_y1 = g_y2 (y1 > 0), rounded to bf16, over yd in the A tile (both
    // warpgroups' products are done: they passed the exchanges) ------------
#pragma unroll
    for (int p = 0; p < NPH; ++p)
#pragma unroll
      for (int pb = 0; pb < 16; pb += 8) {
        // eight pairs' cotangent loads ahead of their stores (which could
        // alias them)
        float2 gp[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int pr = pb + k, h = pr & 1;
          const int c = 64 * (p0 + p) + 8 * (pr >> 1) + cl;
          gp[k] = live[h] && c < Dout
              ? tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(
                    g_s + (rl + 8 * h) * L.gs + 2 * c))
              : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int pr = pb + k, h = pr & 1, q = pr >> 1;
          const int c = 64 * (p0 + p) + 8 * q + cl;
          float g1[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y1 = acc[p][2 * pr + e];
            const float xh = (fmaxf(y1, 0.f) - m2[h]) * i2[h];
            const float gg = (e ? gp[k].y : gp[k].x) * gout_s[c + e];
            g1[e] = live[h] && c < Dout && y1 > 0.f
                ? i2[h] * (gg - s1[h] - xh * s2[h]) : 0.f;
          }
          if (bt_panel_valid(wg, p0, p, NPH))
            *reinterpret_cast<uint32_t*>(a_s + (p0 + p) * TILE_PANEL
                                         + tc::swz(rl + 8 * h, 8 * q + cl))
                = tc::pack_bf16(g1[0], g1[1]);
        }
      }
    tc::fence_async_smem();
    __syncthreads();                   // the g_y1 tile is whole
    bt_rows_out(g1_rows + r0 * Np, a_s, Np, rows, tid);
    // ---- g_yd = (g_y1 W^T) keep, twice: LN_in backward's row sums (round
    // 2) with ggin and gbin, then gx ----------------------------------------
    float t1[2] = {0.f, 0.f}, t2[2] = {0.f, 0.f};
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll 1
      for (int kc = 0; kc < KC; ++kc) {
        float g2[16];
        bt_glnd_mma<NPH>(g2, a_s, ring.next(tid), NP, wg);
        // while the product runs: x of the thread's columns c = 64 kc +
        // 32 wg + acc_col(i) (gin and the keep bits come from shared
        // memory after it)
        const int cb = 64 * kc + 32 * wg;
        float xh[16];
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const int h = (i >> 1) & 1, c = cb + acc_col(i, lane);
          const bool in = live[h] && c < Din;
          const float2 xv = in ? bt_pair(x + row[h] * Din + c)
                               : make_float2(0.f, 0.f);
          xh[i] = in ? (xv.x - mean[h]) * istd[h] : 0.f;
          xh[i + 1] = in ? (xv.y - mean[h]) * istd[h] : 0.f;
        }
        tc::wait_all();
        float gk[16], km[16];
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const int h = (i >> 1) & 1, c = cb + acc_col(i, lane);
          const float2 k2 = bt_keep_pair(keep_s, drop, rl + 8 * h, c);
          gk[i] = gin_s[c];
          gk[i + 1] = gin_s[c + 1];
          km[i] = k2.x;
          km[i + 1] = k2.y;
        }
        if (pass == 0) {
          float vg[8], vb[8];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int h = (i >> 1) & 1, j = 2 * (i >> 2) + (i & 1);
            const float gl = g2[i] * km[i];
            const float gxh = gl * gk[i];
            t1[h] += gxh;
            t2[h] = fmaf(gxh, xh[i], t2[h]);
            if (h == 0) {
              vg[j] = gl * xh[i];
              vb[j] = gl;
            } else {
              vg[j] = fmaf(gl, xh[i], vg[j]);
              vb[j] += gl;
            }
          }
          const int c = bt_fold_half(vg, lane);
          bt_fold_half(vb, lane);
          red2[wq * 32 + c] = vg[0];
          red2[4 * 32 + wq * 32 + c] = vb[0];
          tc::bar_sync(1 + wg, 128);
          if (t < 64) {                // in warp order, as above
            const float* rd = red2 + (t >> 5) * 4 * 32 + (t & 31);
            (t < 32 ? pgi : pbi)[cb + (t & 31)] +=
                ((rd[0] + rd[32]) + rd[64]) + rd[96];
          }
        } else {
#pragma unroll
          for (int i = 0; i < 16; i += 2) {
            const int h = (i >> 1) & 1, c = cb + acc_col(i, lane);
            float o[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              o[e] = istd[h] * (g2[i + e] * km[i + e] * gk[i + e] - t1[h]
                                - xh[i + e] * t2[h]);
            if (live[h] && c < Din) {
              if constexpr (sizeof(TX) == 2)
                *reinterpret_cast<uint32_t*>(gx + row[h] * Din + c) =
                    tc::pack_bf16(o[0], o[1]);
              else
                *reinterpret_cast<float2*>(gx + row[h] * Din + c) =
                    make_float2(o[0], o[1]);
            }
          }
        }
      }
      if (pass == 0) {
        tri_row_pair_sums(ex_s + 2 * BWD_EX, t1, t2, wg, rl, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the two row means
          t1[h] /= Din;
          t2[h] /= Din;
        }
      }
    }
  }
  // ---- the block's slot: [ggin; gbin (Din); ggout; gbout (Dout)] ---------
  __syncthreads();
  float* slot = vec_part + static_cast<size_t>(blockIdx.x) * 2 * (Din + Dout);
  for (int c = tid; c < Din; c += NTHREADS) {
    slot[c] = pgi[c];
    slot[Din + c] = pbi[c];
  }
  for (int c = tid; c < Dout; c += NTHREADS) {
    slot[2 * Din + c] = pgo[c];
    slot[2 * Din + Dout + c] = pbo[c];
  }
  tc::cp_async_wait<0>();
}

// part[chunk] ((Kp + 1) x Np): rows k of yd^T g_y1 over the chunk's rows
// (yd: R x Kp, g_y1: R x Np, both bf16 with zero padding) and, from block
// column 0, the column sums of g_y1 (the bias gradient) as row Kp.  Block
// (x, chunk) owns yd's columns 128 x .. 128 x + 127 (64 a warpgroup; the
// second warpgroup idles where Kp ends first) against all NP panels of
// g_y1: both operands read as they lie in memory (rows = depth: the
// transposed 16-bit operands), 64 rows a step, double-buffered with
// cp.async, pairs of g_y1 panels one n128 product.
template <int NP>
__global__ void __launch_bounds__(NTHREADS, 1)
mlp_bridge_wgrad_tc_kernel(const __nv_bfloat16* __restrict__ X,
                           const __nv_bfloat16* __restrict__ G,
                           float* __restrict__ part, long long R, int Kp,
                           long long rows_per_chunk) {
  constexpr int NPC = 64 * NP;
  constexpr int STAGE = (2 + NP) * TILE_PANEL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int rl = 16 * ((tid >> 5) & 3) + (lane >> 2), cl = 2 * (lane & 3);
  const int k0 = blockIdx.x * 2 * TM;
  const int xcols = min(2 * TM, Kp - k0);
  const bool active = TM * wg < xcols;
  const long long r_begin = blockIdx.y * rows_per_chunk;
  const long long r_end = min(R, r_begin + rows_per_chunk);
  const int steps = r_end > r_begin
      ? static_cast<int>((r_end - r_begin + TM - 1) / TM) : 0;
  float acc[NP][32], gb[2] = {0.f, 0.f};
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  auto load = [&](int step) {
    uint8_t* st = sm + (step & 1) * STAGE;
    const long long r0 = r_begin + static_cast<long long>(step) * TM;
    const int rows = static_cast<int>(min(static_cast<long long>(TM),
                                          r_end - r0));
    const int xper = xcols / 8;
    for (int i = tid; i < TM * xper; i += NTHREADS) {
      const int r = i / xper, ch = i - r * xper;
      uint8_t* d = st + (ch >> 3) * TILE_PANEL + tc::swz_chunk(r, ch & 7);
      if (r < rows)
        tc::cp_async16(d, X + (r0 + r) * Kp + k0 + ch * 8);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = tid; i < TM * NP * 8; i += NTHREADS) {
      const int r = i / (NP * 8), ch = i - r * (NP * 8);
      uint8_t* d = st + (2 + (ch >> 3)) * TILE_PANEL
                   + tc::swz_chunk(r, ch & 7);
      if (r < rows)
        tc::cp_async16(d, G + (r0 + r) * NPC + ch * 8);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
    tc::cp_async_commit();
  };
  if (steps > 0) load(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      load(step + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_async_smem();
    __syncthreads();
    const uint8_t* st = sm + (step & 1) * STAGE;
    {
      // an idle second warpgroup multiplies panel 0 again (no branch on the
      // warpgroup around wgmma: it serializes them) and stores nothing
      const uint32_t s0 = tc::smem_u32(st);
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < TM / 16; ++ks) {
        const int off = ks * 2 * tc::ATOM_BYTES;
        const uint64_t a = tc::make_desc(
            s0 + (active ? wg : 0) * TILE_PANEL + off, TILE_PANEL);
#pragma unroll
        for (int p = 0; p < NP; p += 2) {
          const uint64_t b = tc::make_desc(s0 + (2 + p) * TILE_PANEL + off,
                                           TILE_PANEL);
          if (p + 1 < NP)
            bt_mma_pair<1, 1>(acc[p], acc[p + 1 < NP ? p + 1 : p], a, b, 1);
          else
            tc::mma_ss<64, 1, 1>(acc[p], a, b, 1);
        }
      }
      tc::commit();
    }
    if (blockIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tid + NTHREADS * j;
        if (c >= NPC) continue;
        const uint8_t* gp = st + (2 + (c >> 6)) * TILE_PANEL;
#pragma unroll 8
        for (int r = 0; r < TM; ++r)
          gb[j] += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
              gp + tc::swz(r, c & 63)));
      }
    }
    tc::wait_all();
    __syncthreads();                   // the stage is free for step + 2
  }
  float* slot = part + static_cast<size_t>(blockIdx.y) * (Kp + 1) * NPC;
  if (active) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int pr = 0; pr < 16; ++pr) {
        const int k = k0 + TM * wg + rl + 8 * (pr & 1);
        const int n = 64 * p + 8 * (pr >> 1) + cl;
        *reinterpret_cast<float2*>(slot + static_cast<size_t>(k) * NPC + n) =
            make_float2(acc[p][2 * pr], acc[p][2 * pr + 1]);
      }
  }
  if (blockIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + NTHREADS * j;
      if (c < NPC) slot[static_cast<size_t>(Kp) * NPC + c] = gb[j];
    }
  }
}

// gw (Din x Dout) and gb (Dout) from the slots: the chunks added in order.
__global__ void __launch_bounds__(NTHREADS)
mlp_bridge_wgrad_sum_kernel(const float* __restrict__ part,
                            float* __restrict__ gw, float* __restrict__ gb,
                            int S, int Kp, int Np, int Din, int Dout) {
  const long long idx = static_cast<long long>(blockIdx.x) * NTHREADS
                        + threadIdx.x;
  if (idx >= static_cast<long long>(Din + 1) * Dout) return;
  const int k = static_cast<int>(idx / Dout), n = static_cast<int>(idx % Dout);
  const float* p = part + static_cast<size_t>(k < Din ? k : Kp) * Np + n;
  const size_t stride = static_cast<size_t>(Kp + 1) * Np;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += p[s * stride];
  if (k < Din)
    gw[idx] = acc;
  else
    gb[n] = acc;
}

template <typename TX, int NPH>
int launch_bwd_tc(const void* x, const float* gin, const float* bin,
                  const void* W, const float* bias, const float* gout,
                  const void* g, void* gx, void* yd, void* g1,
                  float* vec_part, long long R, int Din, int Dout,
                  int blocks, Dropout drop, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t bytes = tc::ATOM_BYTES
                       + bwd_layout(bt_pad64(Din), bt_pad64(Dout)).total;
  cudaError_t err = allow_smem(mlp_bridge_bwd_tc_kernel<TX, NPH>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_bridge_bwd_tc_kernel<TX, NPH><<<blocks, NTHREADS, bytes, stream>>>(
      static_cast<const TX*>(x), gin, bin, static_cast<const bf16*>(W), bias,
      gout, static_cast<const bf16*>(g), static_cast<TX*>(gx),
      static_cast<bf16*>(yd), static_cast<bf16*>(g1), vec_part, R, Din, Dout,
      drop);
  return static_cast<int>(cudaGetLastError());
}

template <int NP>
int launch_wgrad_tc(const void* yd, const void* g1, float* wg_part,
                    long long R, int Kp, int chunks, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t bytes = tc::ATOM_BYTES + 2 * (2 + NP) * TILE_PANEL;
  cudaError_t err = allow_smem(mlp_bridge_wgrad_tc_kernel<NP>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per = ((R + chunks - 1) / chunks + TM - 1) / TM * TM;
  mlp_bridge_wgrad_tc_kernel<NP><<<dim3((Kp + 2 * TM - 1) / (2 * TM),
                                        chunks), NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(yd), static_cast<const bf16*>(g1), wg_part, R,
      Kp, per);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX>
int launch_tc(const void* x, const float* gin, const float* bin,
              const void* W, const float* bias, const float* gout,
              const void* g, void* gx, float* gvec, float* gw, float* gb,
              void* yd, void* g1, float* vec_part, float* wg_part,
              long long R, int Din, int Dout, int wg_chunks, Dropout drop,
              cudaStream_t stream) {
  const int Kp = bt_pad64(Din), Np = bt_pad64(Dout), NP = Np / 64;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (R + TM - 1) / TM;
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  int err;
  switch ((NP + 1) / 2) {
    case 1:
      err = launch_bwd_tc<TX, 1>(x, gin, bin, W, bias, gout, g, gx, yd, g1,
                                 vec_part, R, Din, Dout, blocks, drop,
                                 stream);
      break;
    case 2:
      err = launch_bwd_tc<TX, 2>(x, gin, bin, W, bias, gout, g, gx, yd, g1,
                                 vec_part, R, Din, Dout, blocks, drop,
                                 stream);
      break;
    default:
      err = launch_bwd_tc<TX, 3>(x, gin, bin, W, bias, gout, g, gx, yd, g1,
                                 vec_part, R, Din, Dout, blocks, drop,
                                 stream);
  }
  if (err != 0) return err;
  switch (NP) {
    case 1: err = launch_wgrad_tc<1>(yd, g1, wg_part, R, Kp, wg_chunks,
                                     stream); break;
    case 2: err = launch_wgrad_tc<2>(yd, g1, wg_part, R, Kp, wg_chunks,
                                     stream); break;
    case 3: err = launch_wgrad_tc<3>(yd, g1, wg_part, R, Kp, wg_chunks,
                                     stream); break;
    case 4: err = launch_wgrad_tc<4>(yd, g1, wg_part, R, Kp, wg_chunks,
                                     stream); break;
    default: err = launch_wgrad_tc<5>(yd, g1, wg_part, R, Kp, wg_chunks,
                                      stream);
  }
  if (err != 0) return err;
  const long long n = static_cast<long long>(Din + 1) * Dout;
  mlp_bridge_wgrad_sum_kernel<<<static_cast<unsigned>(
                                    (n + NTHREADS - 1) / NTHREADS),
                                NTHREADS, 0, stream>>>(
      wg_part, gw, gb, wg_chunks, Kp, Np, Din, Dout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(sum_slots<float>(vec_part, gvec, 1, blocks,
                                           2 * (Din + Dout), stream));
}

}  // namespace

// x, gx (R, Din): bf16 (x_bf16) or float32; g, the output's cotangent
// (R, Dout): bf16 in the bf16 compute mode (is_bf16, which x_bf16 needs),
// else float32; gin/bin (Din), bias/gout (Dout) float32, 16-byte aligned;
// x and g 16-byte aligned.  Widths as in mlp_bridge_fwd.  bout does not
// enter the backward.
// float32 mode: W (Din, Dout) float32; outputs gvec = [ggin (Din); gbin
// (Din); gb; ggout; gbout (Dout each)] and gw (Din, Dout); gb unused.
// Scratch (float32, the wrapper's): yd (R, Din), g1 (R, Dout), vec_part
// (ceil(R / 32), 2 Din + 3 Dout), wg_part (wg_chunks, Din, Dout).
// bf16 mode: W the packed bf16 (Kp, Np) matrix of mlp_bridge_fwd; outputs
// gvec = [ggin; gbin (Din); ggout; gbout (Dout)], gw (Din, Dout) and gb
// (Dout) float32.  Scratch: yd (R, Kp) and g1 (R, Np) bf16, vec_part
// (min(ceil(R / 64), SMs), 2 Din + 2 Dout) and wg_part (wg_chunks, Kp + 1,
// Np) float32.
extern "C" int mlp_bridge_bwd(const void* x, const void* gin, const void* bin,
                              const void* W, const void* bias,
                              const void* gout, const void* g, void* gx,
                              void* gvec, void* gw, void* gb, void* yd,
                              void* g1, void* vec_part, void* wg_part,
                              long long R, int Din, int Dout, int wg_chunks,
                              const unsigned long long* drop_seed,
                              unsigned drop_threshold, float drop_scale,
                              int x_bf16, int is_bf16, void* stream) {
  if (R < 1 || Din < 4 || Dout < 4 || Din % 4 != 0 || Dout % 4 != 0
      || Din > BT_MAX_DIN || Dout > BT_MAX_DOUT || wg_chunks < 1
      || wg_chunks > 65535 || (x_bf16 && !is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_seed, drop_threshold, drop_scale, 0ull};
  if (x_bf16)
    return launch_tc<__nv_bfloat16>(x, f(gin), f(bin), W, f(bias), f(gout),
                                    g, gx, fm(gvec), fm(gw), fm(gb), yd, g1,
                                    fm(vec_part), fm(wg_part), R, Din, Dout,
                                    wg_chunks, drop, st);
  if (is_bf16)
    return launch_tc<float>(x, f(gin), f(bin), W, f(bias), f(gout), g, gx,
                            fm(gvec), fm(gw), fm(gb), yd, g1, fm(vec_part),
                            fm(wg_part), R, Din, Dout, wg_chunks, drop, st);
  return launch_f32(f(x), f(gin), f(bin), f(W), f(bias), f(gout), f(g),
                    fm(gx), fm(gvec), fm(gw), fm(yd), fm(g1), fm(vec_part),
                    fm(wg_part), R, Din, Dout, wg_chunks, drop, st);
}
