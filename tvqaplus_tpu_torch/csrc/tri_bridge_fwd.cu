// Fused tri-concat MLP bridge, forward, with its dropout.
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_tri_bridge.py
// (fused_tri_bridge -> _forward / _fwd_kernel :92, _bridge_fwd :56-89),
// STAGE's concat_fc.  For every row of the (B, A, Li, Lqa, D) attended
// statements s and v:
//   x    = [s; v; s * v]                         (3D wide, never stored)
//   y    = LN_in(x)        fast variance clipped at 0, float32 stats
//          (training: times the Philox dropout mask of philox.cuh, keyed
//          by the flat index of the (rows, 3D) LN output)
//   out  = LN_out(ReLU(y W + bias))              W: (3D, D)
// out has the activation type of s and v.
//
// D, the hidden width, is 64, 128 or 256 (a template parameter; the C
// entry takes it and refuses any other width); a true width dv < D runs on
// inputs zero-padded to D (the LN statistics and the dropout keys over dv,
// philox.cuh).
//
// What bounds it on the H100: per row it reads 2 x D values, writes D and
// does 2 * 3D * D FLOPs (160,000 rows at the headline eval: ~123 MB in
// bf16 and ~16 GFLOP at D = 128, ~62 MB and ~4 GFLOP at 64, ~246 MB and
// ~63 GFLOP at 256), so at the card's peaks it is bound by bytes at every
// D (~37 us at 128, ~18 us at 64, ~73 us at 256, where operations follow
// close behind at ~64 us).
//
// Two instantiations.
// * bfloat16 (what the main paths run): at D = 128
//   tri_bridge_fwd_tc_kernel<D>, the backward's recompute
//   (tri_bridge_bwd.cu) without the backward, on the same device
//   functions (tri_bridge_tc.cuh); at D = 64 and 256
//   tri_bridge_fwd_tc64_kernel and tri_bridge_fwd_tc256_kernel, designs of
//   their own (the notes at the kernels).  The product is a wgmma on
//   bf16 operands with float32 sums, rounded where the TPU kernel's bf16
//   compute mode rounds (yd and W, pallas_tri_bridge.py:77-79).  At D =
//   128 one persistent block an SM walks 64-row tiles; s and v arrive by
//   cp.async into swizzled panels.  The two warpgroups share a tile and
//   split its columns (D / 2 each): the LN_in statistics over the virtual
//   concat and LN_out's row sums cross them through shared memory.  yd
//   goes into a bf16 tile (the product's A), never to device memory; y1 =
//   yd W stays in registers through bias, ReLU and LN_out, and the output
//   is stored once in bf16.  Rows past R (a ragged last tile) are zero and
//   masked, at every D.
//   - D = 128: W resident (rounded to bf16 as each block loads it, 96 KB,
//     read MN-major), so W is read once a block, not once a tile; s and v
//     double-buffered, the next tile's rows loading while this one
//     computes.  150 registers a thread, 0 bytes of spill; 215.5 KB of
//     shared memory.
//   - D = 64: each of three warpgroups a block on 64-row tiles of its own
//     at all 64 columns (no exchange, no barrier a tile), yd from
//     registers, W resident (read MN-major), s and v read once.
//   - D = 256: W (384 KB in bf16) cannot stay resident: rounded once a
//     call into bf16 slabs, it comes through the copy engine's ring, and
//     each of the two warpgroups takes 64 rows of its own at all 256
//     columns, so a pass of W serves 128 rows; yd goes to the product
//     from registers.
// * float32: the exactness check, CUDA cores: one block per tile of 32 rows,
//   each warp 4 rows; the tile's normalised 32 x 3D input in shared memory
//   is multiplied by W, staged 32 rows at a time from L2; a warp's lanes
//   hold a row's D outputs (D / 32 a lane), so LN_out is a warp reduction
//   in registers.
#include "common.cuh"
#include "philox.cuh"
#include "tri_bridge_tc.cuh"

namespace {

using namespace tvqa;

constexpr int RPT = 4;
constexpr int RT = RPT * NWARPS;        // 32 rows per block

template <int D>
constexpr int SMEM_FLOATS = RT * 3 * D + KC * D;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
tri_bridge_fwd_kernel(const float* __restrict__ s, const float* __restrict__ v,
                      const float* __restrict__ gin,
                      const float* __restrict__ bin,
                      const float* __restrict__ W,
                      const float* __restrict__ bias,
                      const float* __restrict__ gout,
                      const float* __restrict__ bout, float* __restrict__ out,
                      long long R, Dropout drop) {
  constexpr int VPL = D / 32;            // values of a row a lane
  drop.load_seed();
  extern __shared__ float4 smem4[];
  float* y_s = reinterpret_cast<float*>(smem4);
  float* w_s = y_s + RT * 3 * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * RT;

#pragma unroll 1
  for (int jj = 0; jj < RPT; ++jj) {
    const int r = warp * RPT + jj;
    const long long row = r0 + r;
    const bool live = row < R;
    float x[3][VPL], sum = 0.f, ss = 0.f;
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int d = lane + 32 * q;
      const float a = live ? s[row * D + d] : 0.f;
      const float c = live ? v[row * D + d] : 0.f;
      x[0][q] = a;
      x[1][q] = c;
      x[2][q] = a * c;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        sum += x[g][q];
        ss = fmaf(x[g][q], x[g][q], ss);
      }
    }
    sum = warp_sum(sum);
    ss = warp_sum(ss);
    const float mean = sum * drop.inv3;
    const float var = fmaxf(ss * drop.inv3 - mean * mean, 0.f);
    const float istd = rsqrtf(var + LN_EPS);
    float* yr = y_s + r * 3 * D;
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int q = 0; q < VPL; ++q) {
        const int k = g * D + lane + 32 * q;
        yr[k] = (x[g][q] - mean) * istd * gin[k] + bin[k];
      }
    if (drop.on() && live) {
      __syncwarp();
#pragma unroll
      for (int g = 0; g < 3; ++g)
        for (int i4 = lane; i4 < D / 4; i4 += 32) {
          float km[4];
          const int k0 = g * D + 4 * i4;
          keep4(drop.seed, drop.key3(row, g, 4 * i4),
                drop.threshold, drop.scale, km);
#pragma unroll
          for (int t = 0; t < 4; ++t) yr[k0 + t] *= km[t];
        }
    }
  }

  constexpr int CPL = D / 32;            // output columns a lane
  float acc[RPT][CPL];
  gemm_staged<RPT, D>(acc, y_s, 3 * D, 3 * D, W, w_s, warp * RPT,
                      lane * CPL);

  const int c0 = lane * CPL;
  float bv[CPL], gv[CPL], ov[CPL];
  ld_cols<CPL>(bv, bias + c0);
  ld_cols<CPL>(gv, gout + c0);
  ld_cols<CPL>(ov, bout + c0);
#pragma unroll
  for (int jj = 0; jj < RPT; ++jj) {
    const long long row = r0 + warp * RPT + jj;
    float h[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) h[t] = fmaxf(acc[jj][t] + bv[t], 0.f);
    // sums in the order of h0 + h1 + ... and h0 h0 + h1 h1 + ...
    float hs = h[0] + h[1], hq = h[0] * h[0] + h[1] * h[1];
#pragma unroll
    for (int t = 2; t < CPL; ++t) {
      hs = hs + h[t];
      hq = hq + h[t] * h[t];
    }
    const float sum = warp_sum(hs);
    const float ss = warp_sum(hq);
    const float mean = sum * drop.inv1;
    const float var = fmaxf(ss * drop.inv1 - mean * mean, 0.f);
    const float istd = rsqrtf(var + LN_EPS);
    float o[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) o[t] = (h[t] - mean) * istd * gv[t] + ov[t];
    if (row < R) store_n<float, CPL>(out + row * D + c0, o);
  }
}

template <int D>
int launch_f32(const float* s, const float* v, const float* gin,
               const float* bin, const float* W, const float* bias,
               const float* gout, const float* bout, float* out, long long R,
               Dropout drop, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * SMEM_FLOATS<D>;
  cudaError_t err = allow_smem(tri_bridge_fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((R + RT - 1) / RT);
  tri_bridge_fwd_kernel<D><<<blocks, NTHREADS, bytes, stream>>>(
      s, v, gin, bin, W, bias, gout, bout, out, R, drop);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bfloat16 instantiation: tensor cores ------------------------------

// Shared-memory layout at width D = 128: W resident; the s and v
// tiles, double-buffered ([2 buffers][s, v]); yd (64 x 3D); [2][wg][row][2]
// sums; gin, bin, bias, gout, bout.
template <int D>
struct TriTc {
  static_assert(D == 128, "D = 64 and 256 have designs of their own");
  static constexpr int O_SV = Shapes<D>::W_BYTES;
  static constexpr int O_YD = O_SV + 2 * 2 * Shapes<D>::TILE_BYTES;
  static constexpr int O_EX = O_YD + 3 * (D / 64) * TILE_PANEL;
  static constexpr int O_PV = O_EX + 2 * 2 * TM * 2 * 4;
  static constexpr int SMEM = O_PV + 9 * D * 4 + tc::ATOM_BYTES;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
tri_bridge_fwd_tc_kernel(const __nv_bfloat16* __restrict__ s,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ gin,
                         const float* __restrict__ bin,
                         const float* __restrict__ W,
                         const float* __restrict__ bias,
                         const float* __restrict__ gout,
                         const float* __restrict__ bout,
                         __nv_bfloat16* __restrict__ out, long long R,
                         Dropout drop) {
  using S = TriTc<D>;
  constexpr int TILE_BYTES = Shapes<D>::TILE_BYTES;
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  uint8_t* w_s = sm;                    // W
  uint8_t* yd_s = sm + S::O_YD;
  float* ex_s = reinterpret_cast<float*>(sm + S::O_EX);
  float* gin_s = reinterpret_cast<float*>(sm + S::O_PV);
  float* bin_s = gin_s + 3 * D;
  float* bias_s = bin_s + 3 * D;
  float* gout_s = bias_s + D;
  float* bout_s = gout_s + D;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int rl = 16 * warp + (lane >> 2);
  const int cl = 2 * (lane & 3);
  const int half = D / 2 * wg;
  for (int k = tid; k < 3 * D; k += NTHREADS) {
    gin_s[k] = gin[k];
    bin_s[k] = bin[k];
  }
  if (tid < D) {                        // D <= NTHREADS
    bias_s[tid] = bias[tid];
    gout_s[tid] = gout[tid];
    bout_s[tid] = bout[tid];
  }
  tc_store_rows_f32<D>(w_s, Shapes<D>::W_ROWS, W, D, tid, NTHREADS);
  const long long tiles = (R + TM - 1) / TM;
  // cp.async of the s and v rows of `tile` into buffer `buf` (rows past R
  // zeroed)
  auto load_sv = [&](long long tile, int buf) {
    const long long r0 = tile * TM;
    const int rows = static_cast<int>(min(static_cast<long long>(TM),
                                          R - r0));
    uint8_t* dst = sm + S::O_SV + buf * 2 * TILE_BYTES;
    tc_load_rows<D>(dst, TM, s + r0 * D, D, rows, tid, NTHREADS);
    tc_load_rows<D>(dst + TILE_BYTES, TM, v + r0 * D, D, rows, tid,
                    NTHREADS);
  };
  if (blockIdx.x < tiles) load_sv(blockIdx.x, 0);
  tc::cp_async_commit();

  int buf = 0;
  for (long long tile = blockIdx.x; tile < tiles;
       tile += gridDim.x, buf ^= 1) {
    const long long r0 = tile * TM;
    const int rows = static_cast<int>(min(static_cast<long long>(TM),
                                          R - r0));
    // the other buffer was read by the previous tile, which every thread
    // has finished (its LN_out exchange is a block barrier)
    if (tile + gridDim.x < tiles) load_sv(tile + gridDim.x, buf ^ 1);
    tc::cp_async_commit();
    bool live[2];
    long long row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      live[h] = rl + 8 * h < rows;
      row[h] = r0 + (live[h] ? rl + 8 * h : 0);
    }
    uint32_t kw[3][2][(D / 16 + 7) / 8];
    tri_keep_bits<D>(drop, row, lane, half, kw);
    tc::cp_async_wait<1>();            // this tile's s and v
    tc::fence_async_smem();            // W (first tile) is read by wgmma
    __syncthreads();
    const uint8_t* s_s = sm + S::O_SV + buf * 2 * TILE_BYTES;
    const uint8_t* v_s = s_s + TILE_BYTES;
    float mean[2], istd[2];
    tri_ln_in_stats<D>(s_s, v_s, ex_s, mean, istd, wg, rl, lane, drop.inv3);
    tri_yd_tile<false, D>(s_s, v_s, yd_s, kw, drop, mean, istd, gin_s,
                          bin_s, nullptr, live, row, wg, rl, lane);
    tc::fence_async_smem();
    __syncthreads();                   // the yd tile is whole
    float acc[D / 4], m2[2], i2[2];
    tri_y1_mma<D>(acc, yd_s, w_s, wg);
    tri_ln_out_stats<D>(acc, bias_s, ex_s + 2 * TM * 2, m2, i2, wg, rl,
                        lane, drop.inv1);
#pragma unroll
    for (int pr = 0; pr < D / 8; ++pr) {
      const int h = pr & 1, c = half + 8 * (pr >> 1) + cl;
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[e] = (fmaxf(acc[2 * pr + e], 0.f) - m2[h]) * i2[h] * gout_s[c + e]
               + bout_s[c + e];
      if (live[h])
        *reinterpret_cast<uint32_t*>(out + row[h] * D + c) =
            tc::pack_bf16(o[0], o[1]);
    }
  }
}

template <int D>
int launch_tc(const void* s, const void* v, const float* gin,
              const float* bin, const float* W, const float* bias,
              const float* gout, const float* bout, void* out, long long R,
              Dropout drop, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  constexpr int smem = TriTc<D>::SMEM;
  cudaError_t err = allow_smem(tri_bridge_fwd_tc_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (R + TM - 1) / TM;
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  tri_bridge_fwd_tc_kernel<D><<<blocks, NTHREADS, smem, stream>>>(
      h(s), h(v), gin, bin, W, bias, gout, bout, static_cast<bf16*>(out), R,
      drop);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bfloat16 instantiation at D = 64: warpgroups on tiles of their own
//
// At D = 64 a thread's share of a 64-row tile at all 64 columns is 32
// accumulator values and its 16 pairs of s and of v, so the SM takes three
// warpgroups (384 threads at 168 registers), each walking 64-row tiles of
// its own (warpgroup w of block b takes tiles 3 b + w, 3 b + w + 3 G, ...
// over a grid of G blocks), as the backward at this width does.  What the
// design does about the card:
// * A warpgroup owns all 64 columns of its rows, so the product is a wgmma
//   of N = 64 and LN_in's and LN_out's row sums are a quad's shuffles: no
//   exchange between warpgroups and no barrier of any kind a tile.  Each
//   warp copies, reads, stages and stores only its own 16 rows (its lanes
//   meet at __syncwarp), so the warps of a warpgroup meet only in the
//   products.
// * s and v are read from shared memory once: the thread's 16 pairs of
//   each, packed, give LN_in's statistics and then yd.
// * yd never forms a tile: the product takes its A from registers (mma_rs),
//   each group's four depth steps built while the group before runs (two
//   groups' fragments in flight).  W stays resident in bf16 (24 KB, rounded
//   as each block loads it, read MN-major).
// * Two slots of s and v a warpgroup: the next tile's rows are copied
//   (cp.async) into the other slot before this tile's product; the output
//   goes in bf16 through this tile's s rows (read by then), then out as
//   whole 128-byte rows.
// * DROP false (serving) holds no Philox code; DROP true draws the keep
//   bits of the thread's 3 x 32 values at the start of a tile, before any
//   accumulator is live (philox.cuh key3).
// Shared memory: W, the parameter vectors, three rooms of two slots:
// 126,976 bytes.
struct TriFwd64 {
  static constexpr int D = 64;
  static constexpr int NWG = 3;                       // warpgroups a block
  static constexpr int NT = 128 * NWG;                // threads a block
  static constexpr int TILE = TILE_PANEL;             // 64 x 64 bf16
  static constexpr int O_W = 0;                       // W (3D x D) bf16
  static constexpr int O_PV = O_W + 3 * D * tc::ROW_BYTES;  // gin .. bout
  static constexpr int A = tc::ATOM_BYTES;
  static constexpr int O_ROOM = (O_PV + 9 * D * 4 + A - 1) / A * A;
  // a warpgroup's room: two slots of a tile's s and v
  static constexpr int SLOT = 2 * TILE;
  static constexpr int ROOM = 2 * SLOT;
  static constexpr int SMEM = O_ROOM + NWG * ROOM + tc::ATOM_BYTES;
  static_assert(SMEM <= 232448, "shared memory of a block");
};

template <bool DROP>
__global__ void __launch_bounds__(TriFwd64::NT, 1)
tri_bridge_fwd_tc64_kernel(const __nv_bfloat16* __restrict__ s,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ gin,
                           const float* __restrict__ bin,
                           const float* __restrict__ W,
                           const float* __restrict__ bias,
                           const float* __restrict__ gout,
                           const float* __restrict__ bout,
                           __nv_bfloat16* __restrict__ out, long long R,
                           Dropout drop) {
  using S = TriFwd64;
  constexpr int D = S::D, NPR = D / 4;       // the thread's pairs a tile
  if (DROP) drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int rl = 16 * warp + (lane >> 2), cl = 2 * (lane & 3);
  float* gin_s = reinterpret_cast<float*>(sm + S::O_PV);
  float* bin_s = gin_s + 3 * D;
  float* bias_s = bin_s + 3 * D;
  float* gout_s = bias_s + D;
  float* bout_s = gout_s + D;
  uint8_t* room = sm + S::O_ROOM + wg * S::ROOM;
  const uint32_t w_a = tc::smem_u32(sm + S::O_W);
  // the warpgroup's tiles: w0, w0 + nw, ..; tile j's rows in slot j % 2
  const long long tiles = (R + TM - 1) / TM;
  const long long nw = static_cast<long long>(S::NWG) * gridDim.x;
  const long long w0 = static_cast<long long>(S::NWG) * blockIdx.x + wg;
  const int n = w0 < tiles ? static_cast<int>((tiles - 1 - w0) / nw) + 1 : 0;
  auto rows_of = [&](long long tile) {
    return static_cast<int>(min(static_cast<long long>(TM), R - tile * TM));
  };
  // the warp's 16 rows of s and v of the walk's tile j into slot j % 2 by
  // cp.async (rows past R zeroed)
  auto load = [&](int j) {
    const long long r0 = (w0 + j * nw) * TM;
    const int rows = rows_of(w0 + j * nw);
    uint8_t* sl = room + (j & 1) * S::SLOT;
    for (int c = lane; c < 2 * 16 * 8; c += 32) {
      const int which = c >> 7, r = 16 * warp + ((c >> 3) & 15), ch = c & 7;
      uint8_t* d = sl + which * S::TILE + tc::swz_chunk(r, ch);
      if (r < rows)
        tc::cp_async16(d, (which ? v : s) + (r0 + r) * D + ch * 8);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
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
    bout_s[tid] = bout[tid];
  }
  tc::fence_async_smem();              // W is read by wgmma
  __syncthreads();                     // W, the parameters

  for (int j = 0; j < n; ++j) {
    const long long r0 = (w0 + j * nw) * TM;
    const int rows = rows_of(w0 + j * nw);
    if (j + 1 < n) load(j + 1);        // the other slot: read last tile
    tc::cp_async_commit();
    // the keep bits of the three groups (row[h]: the rows' keys, those
    // past R keyed as row 0), while the rows land
    uint32_t kw[3][2];
    if constexpr (DROP) {
      long long row[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        row[h] = rl + 8 * h < rows ? r0 + rl + 8 * h : 0;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        uint32_t k2[2][1];
        tc_keep_bits<D / 8, true>(
            drop, drop.key3((lane & 1) ? row[1] : row[0], g, 0), lane, k2);
        kw[g][0] = k2[0][0];
        kw[g][1] = k2[1][0];
      }
    }
    tc::cp_async_wait<1>();            // this tile's rows
    __syncwarp();
    uint8_t* s_s = room + (j & 1) * S::SLOT;
    const uint8_t* v_s = s_s + S::TILE;
    // ---- LN_in statistics over [s; v; s * v], the pairs read once --------
    uint32_t sp[NPR], vp[NPR];
    float mean[2] = {0.f, 0.f}, istd[2] = {0.f, 0.f};
#pragma unroll
    for (int pr = 0; pr < NPR; ++pr) {
      const int h = pr & 1, at = tc::swz(rl + 8 * h, 8 * (pr >> 1) + cl);
      sp[pr] = *reinterpret_cast<const uint32_t*>(s_s + at);
      vp[pr] = *reinterpret_cast<const uint32_t*>(v_s + at);
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
    // yd's A fragments of group g: depth step kk's four registers hold the
    // pairs at (row, k), (row + 8, k), (row, k + 8), (row + 8, k + 8), k =
    // 16 kk + 2 (lane % 4): the thread's pairs 4 kk .. 4 kk + 3
    auto build = [&](int g, uint32_t (&f)[4][4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pr = 4 * kk + u, h = u & 1, q = pr >> 1, c = 8 * q + cl;
          const float2 a = tc::unpack_bf16(sp[pr]);
          const float2 b = tc::unpack_bf16(vp[pr]);
          const float x0 = g == 0 ? a.x : (g == 1 ? b.x : a.x * b.x);
          const float x1 = g == 0 ? a.y : (g == 1 ? b.y : a.y * b.y);
          const float2 gi = *reinterpret_cast<const float2*>(gin_s + g * D
                                                             + c);
          const float2 bi = *reinterpret_cast<const float2*>(bin_s + g * D
                                                             + c);
          float k0 = 1.f, k1 = 1.f;
          if constexpr (DROP) {
            const uint32_t bits = kw[g][h] >> (4 * q);
            k0 = bits & 1u ? drop.scale : 0.f;
            k1 = bits & 2u ? drop.scale : 0.f;
          }
          f[kk][u] = tc::pack_bf16(
              ((x0 - mean[h]) * istd[h] * gi.x + bi.x) * k0,
              ((x1 - mean[h]) * istd[h] * gi.y + bi.y) * k1);
        }
    };
    float acc[D / 2];
    auto issue = [&](int g, const uint32_t (&f)[4][4]) {
      tc::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::mma_rs<D, 1>(
            acc, f[kk],
            tc::make_desc(w_a + (4 * g + kk) * 2 * tc::ATOM_BYTES,
                          Shapes<D>::W_PANEL),
            g > 0 || kk > 0);
      tc::commit();
    };
    // ---- y1 = yd W, a group's fragments built while the one before runs --
    uint32_t fa[2][4][4];
    build(0, fa[0]);
    issue(0, fa[0]);
    build(1, fa[1]);
    issue(1, fa[1]);
    tc::wait<1>();                     // group 0 is done: its registers free
    build(2, fa[0]);
    issue(2, fa[0]);
    tc::wait<0>();
    tc::fence_regs(acc);
    // ---- bias, ReLU, LN_out (the row's sums a quad's) ----------------------
    float m2[2] = {0.f, 0.f}, i2[2] = {0.f, 0.f};
#pragma unroll
    for (int pr = 0; pr < NPR; ++pr) {
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
    // ---- out in bf16 through the warp's rows of the s slot, then whole
    // rows out (8 lanes a row) ----------------------------------------------
#pragma unroll
    for (int pr = 0; pr < NPR; ++pr) {
      const int h = pr & 1, c = 8 * (pr >> 1) + cl;
      const float2 go = *reinterpret_cast<const float2*>(gout_s + c);
      const float2 bo = *reinterpret_cast<const float2*>(bout_s + c);
      *reinterpret_cast<uint32_t*>(s_s + tc::swz(rl + 8 * h, c)) =
          tc::pack_bf16(
              (fmaxf(acc[2 * pr], 0.f) - m2[h]) * i2[h] * go.x + bo.x,
              (fmaxf(acc[2 * pr + 1], 0.f) - m2[h]) * i2[h] * go.y + bo.y);
    }
    __syncwarp();
    for (int q = lane; q < 16 * 8; q += 32) {
      const int r = 16 * warp + (q >> 3), ch = q & 7;
      if (r < rows)
        *reinterpret_cast<uint4*>(out + (r0 + r) * D + 8 * ch) =
            *reinterpret_cast<const uint4*>(s_s + tc::swz_chunk(r, ch));
    }
    __syncwarp();                      // the slot is read: it may refill
  }
}

// The bf16 forward at D = 64: blocks of three warpgroups, as many as the
// tiles need, one an SM at most.
int launch_tc64(const void* s, const void* v, const float* gin,
                const float* bin, const float* W, const float* bias,
                const float* gout, const float* bout, void* out, long long R,
                Dropout drop, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  using S = TriFwd64;
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  auto kern = drop.threshold != 0u ? tri_bridge_fwd_tc64_kernel<true>
                                   : tri_bridge_fwd_tc64_kernel<false>;
  cudaError_t err = allow_smem(kern, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (R + S::NWG * TM - 1) / (S::NWG * TM);
  const int blocks = static_cast<int>(want < sms ? want : sms);
  kern<<<blocks, S::NT, S::SMEM, stream>>>(h(s), h(v), gin, bin, W, bias,
                                           gout, bout,
                                           static_cast<bf16*>(out), R, drop);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bfloat16 instantiation at D = 256: W in bf16 slabs, 128 rows a
// pass ---------------------------------------------------------------------
//
// W (768 x 256, 384 KB in bf16) cannot stay resident, so it comes once a
// pass through a ring, and the design makes a pass of W serve as many rows
// as the SM holds: each of the block's two warpgroups takes 64 rows of its
// own at all 256 columns (a thread's 128 float32 accumulators, two n128
// halves), so a pass of W serves 128 rows, and LN_out's row sums are a
// quad's (no exchange between the warpgroups).
// * W is rounded to bf16 once a call, into 24 slabs of 32 rows laid out as
//   in shared memory (the C entry's w_slab_pack_kernel, wgmma.cuh); the
//   copy engine brings them (cp.async.bulk) through five slots with full /
//   empty mbarriers (TriRing), which both warpgroups read: 393 KB of W a
//   pass of 128 rows, where streaming float32 W once a 64-row tile reads
//   786 KB a tile.
// * yd never forms a tile (128 x 768 bf16 would take 192 KB): the product
//   takes its A from registers, each thread building its fragments of a
//   slab's 32 K columns from s, v, the row's LN_in statistics, gin / bin
//   and its keep bits while the previous slab's products run.
// * s and v of a warpgroup's 64 rows (64 KB) arrive by cp.async into
//   swizzled panels; once the last fragments are built, the s tile takes
//   the output rows in bf16 (so that a warp stores whole rows: written
//   from the accumulator layout, the stores took a fifth of the kernel),
//   and then the next tile's rows load, under the other warpgroup's work.
// * DROP false (serving) holds no Philox code; DROP true draws the keep
//   bits of the thread's 2 x 768 values at the start of a tile, before any
//   accumulator is live (philox.cuh key3: the stream of the other widths).
// 223,328 bytes of shared memory.
struct TriFwd256 {
  static constexpr int D = 256;
  static constexpr int PER = 3 * D / SLAB_ROWS;       // slabs of W a pass
  static constexpr int NSLOT = 5;
  static constexpr int TILE = Shapes<D>::TILE_BYTES;  // 64 x 256 bf16
  static constexpr int O_SV = 0;                      // [wg][s, v]
  static constexpr int O_RING = O_SV + 2 * 2 * TILE;
  static constexpr int O_BAR = O_RING + NSLOT * SLAB_BYTES;  // full, empty
  static constexpr int O_FETCH = O_BAR + 2 * NSLOT * 8;      // slabs issued
  static constexpr int O_PV = O_FETCH + 16;  // gin, bin, bias, gout, bout
  static constexpr int SMEM = O_PV + 9 * D * 4 + tc::ATOM_BYTES;
  static_assert(O_RING % tc::ATOM_BYTES == 0, "slots on 1024-byte bounds");
};

// The slabs of W through NSLOT slots that the block's two warpgroups share:
// both walk the same sequence of slabs (PER a pass), slab j landing in
// slot j % NSLOT for the (j / NSLOT)-th time, on that slot's full barrier;
// each of the eight warps arrives on the slot's empty barrier once its
// products have read it.  Lane 0 of any warp issues the next slabs
// whenever their slots are free (pump: the count of slabs issued lives in
// shared memory and a slab is claimed by compare-and-swap), so the last
// warp to give a slot back refills it, whatever the other warpgroup is
// doing; every warp sleeps on a slab's barrier (try_wait).  (A warp of
// each warpgroup polling the barrier and pumping took issue slots from the
// fragments: 0.53 against 0.47 ms at the headline on the card.)
template <int NSLOT, int PER>
struct TriRing {
  uint8_t* slots;
  uint64_t* full;
  uint64_t* empty;
  int* fetched;
  const uint8_t* w;
  int total, taken, given;

  // Thread 0 initialises the barriers and the count; the caller then
  // syncs the block.
  __device__ __forceinline__ void init(uint8_t* slots_, uint64_t* bars,
                                       int* fetched_, const void* w_,
                                       int total_) {
    slots = slots_;
    full = bars;
    empty = bars + NSLOT;
    fetched = fetched_;
    w = static_cast<const uint8_t*>(w_);
    total = total_;
    taken = given = 0;
    if (threadIdx.x == 0) {
      for (int k = 0; k < NSLOT; ++k) {
        tc::mbar_init(full + k, 1);
        tc::mbar_init(empty + k, NWARPS);
      }
      *fetched = 0;
      tc::mbar_fence_init();
    }
  }
  __device__ __forceinline__ void pump() {
    if ((threadIdx.x & 31) != 0) return;
    for (;;) {
      const int f = *reinterpret_cast<volatile int*>(fetched);
      if (f >= total) return;
      const int k = f % NSLOT;
      if (!tc::mbar_test(empty + k, ((f / NSLOT) & 1) ^ 1)) return;
      if (atomicCAS(fetched, f, f + 1) != f) continue;
      tc::mbar_expect_tx(full + k, SLAB_BYTES);
      tc::bulk_g2s(slots + k * SLAB_BYTES,
                   w + static_cast<size_t>(f % PER) * SLAB_BYTES, SLAB_BYTES,
                   full + k);
    }
  }
  // The shared address of the next slab, once it has landed.
  __device__ __forceinline__ uint32_t take() {
    const int k = taken % NSLOT;
    const uint32_t parity = (taken / NSLOT) & 1;
    while (!tc::mbar_try(full + k, parity)) {
    }
    __syncwarp();
    ++taken;
    return tc::smem_u32(slots + k * SLAB_BYTES);
  }
  // The warp's products have read the oldest slab not given back.
  __device__ __forceinline__ void give(int lane) {
    const int k = given % NSLOT;
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(empty + k);
    ++given;
    pump();
    __syncwarp();
  }
};

template <bool DROP>
__global__ void __launch_bounds__(NTHREADS, 1)
tri_bridge_fwd_tc256_kernel(const __nv_bfloat16* __restrict__ s,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ gin,
                            const float* __restrict__ bin,
                            const __nv_bfloat16* __restrict__ wp,
                            const float* __restrict__ bias,
                            const float* __restrict__ gout,
                            const float* __restrict__ bout,
                            __nv_bfloat16* __restrict__ out, long long R,
                            Dropout drop) {
  using S = TriFwd256;
  constexpr int D = S::D, PER = S::PER;
  if (DROP) drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int rl = 16 * warp + (lane >> 2), cl = 2 * (lane & 3);
  uint8_t* s_s = sm + S::O_SV + wg * 2 * S::TILE;
  uint8_t* v_s = s_s + S::TILE;
  float* gin_s = reinterpret_cast<float*>(sm + S::O_PV);
  float* bin_s = gin_s + 3 * D;
  float* bias_s = bin_s + 3 * D;
  float* gout_s = bias_s + D;
  float* bout_s = gout_s + D;
  for (int k = tid; k < 3 * D; k += NTHREADS) {
    gin_s[k] = gin[k];
    bin_s[k] = bin[k];
  }
  for (int k = tid; k < D; k += NTHREADS) {
    bias_s[k] = bias[k];
    gout_s[k] = gout[k];
    bout_s[k] = bout[k];
  }
  // pass j: warpgroup w takes tile 2 (blockIdx.x + j gridDim.x) + w (none
  // past the last: then its rows are zero and nothing is written)
  const long long tiles = (R + TM - 1) / TM, pairs = (tiles + 1) / 2;
  const int passes = pairs > blockIdx.x
      ? static_cast<int>((pairs - 1 - blockIdx.x) / gridDim.x) + 1 : 0;
  TriRing<S::NSLOT, PER> ring;
  ring.init(sm + S::O_RING, reinterpret_cast<uint64_t*>(sm + S::O_BAR),
            reinterpret_cast<int*>(sm + S::O_FETCH), wp, passes * PER);
  auto tile_of = [&](int j) {
    return 2 * (blockIdx.x + static_cast<long long>(j) * gridDim.x) + wg;
  };
  auto rows_of = [&](long long tile) {
    return static_cast<int>(max(0ll, min(static_cast<long long>(TM),
                                         R - tile * TM)));
  };
  // cp.async of the s and v rows of `tile` (rows past R zeroed); the
  // warpgroup's threads
  auto load_sv = [&](long long tile) {
    const long long r0 = tile * TM;
    const int rows = rows_of(tile);
    tc_load_rows<D>(s_s, TM, s + r0 * D, D, rows, t, 128);
    tc_load_rows<D>(v_s, TM, v + r0 * D, D, rows, t, 128);
  };
  if (passes > 0) load_sv(tile_of(0));
  tc::cp_async_commit();
  __syncthreads();                     // the barriers, the parameters
  ring.pump();
  __syncwarp();

  for (int j = 0; j < passes; ++j) {
    const long long tile = tile_of(j), r0 = tile * TM;
    const int rows = rows_of(tile);
    // the keep bits of the thread's values of the three groups, drawn
    // while no accumulator is live (row[h]: the thread's rows, those past
    // R keyed as row 0)
    uint32_t kw[3][2][4];
    if constexpr (DROP) {
      long long row[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        row[h] = rl + 8 * h < rows ? r0 + rl + 8 * h : 0;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        tc_keep_bits<32, true>(drop,
                               drop.key3((lane & 1) ? row[1] : row[0], g, 0),
                               lane, kw[g]);
    }
    tc::cp_async_wait<0>();
    tc::bar_sync(1 + wg, 128);         // this tile's s and v
    // LN_in statistics of the thread's two rows over [s; v; s * v] (fast
    // variance, clipped at 0)
    float mean[2] = {0.f, 0.f}, istd[2] = {0.f, 0.f};
#pragma unroll
    for (int pr = 0; pr < D / 4; ++pr) {
      const int h = pr & 1, c = 8 * (pr >> 1) + cl;
      const float2 a = tri_pair(s_s, rl, h, c), b = tri_pair(v_s, rl, h, c);
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
    // the A fragments of slab p (K columns 32 p ..: group p / 8): depth
    // step q's four registers hold yd's pairs at (row, k), (row + 8, k),
    // (row, k + 8), (row + 8, k + 8), k = 16 q + 2 (lane % 4)
    auto build = [&](int p, uint32_t (&fa)[2][4]) {
      const int g = p / 8;
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int h = u & 1, c = 32 * (p % 8) + 16 * q + 8 * (u >> 1) + cl;
          float x0, x1;
          if (g == 0) {
            const float2 a = tri_pair(s_s, rl, h, c);
            x0 = a.x;
            x1 = a.y;
          } else if (g == 1) {
            const float2 b = tri_pair(v_s, rl, h, c);
            x0 = b.x;
            x1 = b.y;
          } else {
            const float2 a = tri_pair(s_s, rl, h, c);
            const float2 b = tri_pair(v_s, rl, h, c);
            x0 = a.x * b.x;
            x1 = a.y * b.y;
          }
          const int k = g * D + c;
          const float2 g2 = *reinterpret_cast<const float2*>(gin_s + k);
          const float2 b2 = *reinterpret_cast<const float2*>(bin_s + k);
          float k0 = 1.f, k1 = 1.f;
          if constexpr (DROP) {
            const uint32_t bits = kw[g][h][c >> 6] >> (4 * ((c >> 3) & 7));
            k0 = bits & 1u ? drop.scale : 0.f;
            k1 = bits & 2u ? drop.scale : 0.f;
          }
          fa[q][u] = tc::pack_bf16(
              ((x0 - mean[h]) * istd[h] * g2.x + b2.x) * k0,
              ((x1 - mean[h]) * istd[h] * g2.y + b2.y) * k1);
        }
    };
    // y1 = yd W: slab p's two depth steps on both n128 halves, the next
    // slab's fragments built while they run; the slab goes back as soon as
    // they are done (a slot is held one slab, so four are in flight)
    float acc[2][64];
    uint32_t fa[2][2][4];
    build(0, fa[0]);
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const uint32_t st = ring.take();
      tc::fence();
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          tc::mma_rs<128, 1>(
              acc[hf], fa[p & 1][q],
              tc::make_desc(st + 2 * hf * SLAB_PANEL
                                + q * 2 * tc::ATOM_BYTES, SLAB_PANEL),
              p > 0 || q > 0);
      tc::commit();
      if (p + 1 < PER) {
        build(p + 1, fa[(p + 1) & 1]);
      } else {
        tc::bar_sync(1 + wg, 128);     // every fragment built: s, v read
      }
      tc::wait<0>();                   // slab p's products are done
      ring.give(lane);
    }
    tc::fence_regs(acc[0]);
    tc::fence_regs(acc[1]);
    // bias, ReLU, LN_out (the row's sums a quad's), out in bf16
    float m2[2] = {0.f, 0.f}, i2[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int h = (i >> 1) & 1;
        acc[hf][i] += bias_s[128 * hf + acc_col(i, lane)];
        const float y2 = fmaxf(acc[hf][i], 0.f);
        m2[h] += y2;
        i2[h] = fmaf(y2, y2, i2[h]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m2[h] = quad_sum(m2[h]) * drop.inv1;
      i2[h] = rsqrtf(fmaxf(quad_sum(i2[h]) * drop.inv1 - m2[h] * m2[h],
                           0.f) + LN_EPS);
    }
    // out in bf16 through the s tile (swizzled), then its live rows out
    // whole (a warp stores 512 contiguous bytes); then the next tile's s
    // and v may load
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int pr = 0; pr < 32; ++pr) {
        const int h = pr & 1, c = 128 * hf + 8 * (pr >> 1) + cl;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[e] = (fmaxf(acc[hf][2 * pr + e], 0.f) - m2[h]) * i2[h]
                 * gout_s[c + e] + bout_s[c + e];
        *reinterpret_cast<uint32_t*>(s_s + (c >> 6) * TILE_PANEL
                                     + tc::swz(rl + 8 * h, c & 63)) =
            tc::pack_bf16(o[0], o[1]);
      }
    tc::bar_sync(1 + wg, 128);         // the output tile is whole
    for (int q = t; q < rows * (D / 8); q += 128) {
      const int r = q / (D / 8), ch = q % (D / 8);
      *reinterpret_cast<uint4*>(out + (r0 + r) * D + 8 * ch) =
          *reinterpret_cast<const uint4*>(s_s + (ch >> 3) * TILE_PANEL
                                          + tc::swz_chunk(r, ch & 7));
    }
    tc::bar_sync(1 + wg, 128);         // the output tile is read
    if (j + 1 < passes) load_sv(tile_of(j + 1));
    tc::cp_async_commit();
  }
}

// The bf16 forward at D = 256: W rounded into its slabs at wp, then the
// persistent grid (a block a pair of 64-row tiles at a time).
int launch_tc256(const void* s, const void* v, const float* gin,
                 const float* bin, const float* W, void* wp,
                 const float* bias, const float* gout, const float* bout,
                 void* out, long long R, Dropout drop, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  using S = TriFwd256;
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  if (wp == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = drop.threshold != 0u ? tri_bridge_fwd_tc256_kernel<true>
                        : tri_bridge_fwd_tc256_kernel<false>;
  cudaError_t err = allow_smem(kern, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  w_slab_pack_kernel<S::D><<<dim3(3 * S::D * S::D / 8 / NTHREADS, 1),
                             NTHREADS, 0, stream>>>(W, W, 3 * S::D,
                                                    static_cast<bf16*>(wp));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long pairs = ((R + TM - 1) / TM + 1) / 2;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = static_cast<int>(pairs < sms ? pairs : sms);
  kern<<<blocks, NTHREADS, S::SMEM, stream>>>(
      h(s), h(v), gin, bin, static_cast<const bf16*>(wp), bias, gout, bout,
      static_cast<bf16*>(out), R, drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_width(const void* s, const void* v, const float* gin,
                 const float* bin, const float* W, void* wp,
                 const float* bias, const float* gout, const float* bout,
                 void* out, long long R, Dropout drop, int is_bf16,
                 cudaStream_t st) {
  if (is_bf16) {
    if constexpr (D == 256)
      return launch_tc256(s, v, gin, bin, W, wp, bias, gout, bout, out, R,
                          drop, st);
    else if constexpr (D == 64)
      return launch_tc64(s, v, gin, bin, W, bias, gout, bout, out, R, drop,
                         st);
    else
      return launch_tc<D>(s, v, gin, bin, W, bias, gout, bout, out, R,
                          drop, st);
  }
  return launch_f32<D>(static_cast<const float*>(s),
                       static_cast<const float*>(v), gin, bin, W, bias, gout,
                       bout, static_cast<float*>(out), R, drop, st);
}

}  // namespace

// s, v, out: R rows of D (64, 128 or 256), all bf16 (is_bf16) or all
// float32; gin/bin (3D), W (3D, D), bias/gout/bout (D) float32, 16-byte
// aligned; bf16 s and v are 16-byte aligned.  wp: 3D x D bf16 scratch that
// the bf16 kernel at D = 256 rounds W into (its slabs; NULL otherwise).
// Dropout on the LN_in output when drop_threshold > 0 (philox.cuh).
// dv: the true width, 4 <= dv <= D with 4 | dv, of inputs zero-padded to D
// (every LN's statistics and the Philox keys, philox.cuh).
extern "C" int tri_bridge_fwd(const void* s, const void* v, const void* gin,
                              const void* bin, const void* W, void* wp,
                              const void* bias, const void* gout,
                              const void* bout, void* out, long long R, int D,
                              const unsigned long long* drop_seed,
                              unsigned drop_threshold, float drop_scale, int dv,
                              int is_bf16, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop =
      entry_dropout(drop_seed, drop_threshold, drop_scale, dv);
  if (!width_ok(dv, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (R < 1) return static_cast<int>(cudaErrorInvalidValue);
#define TVQA_TRI_FWD(DD)                                                     \
  case DD:                                                                   \
    return launch_width<DD>(s, v, f(gin), f(bin), f(W), wp, f(bias),        \
                            f(gout), f(bout), out, R, drop, is_bf16, st);
  switch (D) {
    TVQA_TRI_FWD(64)
    TVQA_TRI_FWD(128)
    TVQA_TRI_FWD(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TVQA_TRI_FWD
}
