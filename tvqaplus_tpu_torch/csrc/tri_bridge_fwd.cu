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
// * bfloat16 (what the main paths run): tri_bridge_fwd_tc_kernel<D>, the
//   backward's recompute (tri_bridge_bwd.cu) without the backward, on the
//   same device functions (tri_bridge_tc.cuh).  The product is a wgmma on
//   bf16 operands with float32 sums, rounded where the TPU kernel's bf16
//   compute mode rounds (yd and W, pallas_tri_bridge.py:77-79).  One
//   persistent block an SM walks 64-row tiles; s and v arrive by cp.async
//   into swizzled panels.  The two warpgroups share a tile and split its
//   columns (D / 2 each): the LN_in statistics over the virtual concat and
//   LN_out's row sums cross them through shared memory.  yd goes into a
//   bf16 tile (the product's A), never to device memory; y1 = yd W stays
//   in registers through bias, ReLU and LN_out, and the output is stored
//   once in bf16.  Rows past R (a ragged last tile) are zero and masked.
//   - D = 128: W resident (rounded to bf16 as each block loads it, 96 KB,
//     read MN-major), so W is read once a block, not once a tile; s and v
//     double-buffered, the next tile's rows loading while this one
//     computes.  150 registers a thread, 0 bytes of spill; 215.5 KB of
//     shared memory.
//   - D = 64: the same at half width, W resident transposed (a warpgroup's
//     32 columns start inside a swizzled row, where an MN-major operand
//     cannot start, so W^T is read K-major); 158 registers, 85 KB.
//   - D = 256: W (384 KB in bf16) cannot stay resident; it streams from L2
//     through two stages of 32 rows (mma_streamed_w, wgmma.cuh), once a
//     tile.  s and v take one buffer: the next tile's rows load during the
//     product, once yd holds what this tile needs of them.  A warpgroup's
//     128 columns keep its accumulator at 64 registers a thread; 168
//     registers, 0 bytes of spill; 204 KB of shared memory.
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

// Shared-memory layout at width D: W resident (D <= 128) or its two
// streamed stages (D = 256); the s and v tiles, double-buffered at D <= 128
// ([2 buffers][s, v]) and single at D = 256, where the next tile's rows
// load during the product; yd (64 x 3D); [2][wg][row][2] sums; gin, bin,
// bias, gout, bout.
template <int D>
struct TriTc {
  static constexpr bool WIDE = D == 256;
  static constexpr int KP = 32;                     // W rows a stage
  static constexpr int O_SV = WIDE ? 2 * stream_stage_bytes<D, KP>()
                                   : Shapes<D>::W_BYTES;
  static constexpr int O_YD = O_SV + (WIDE ? 1 : 2) * 2
                                         * Shapes<D>::TILE_BYTES;
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
  uint8_t* w_s = sm;                    // W, or its stages at D = 256
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
  if constexpr (D == 128)
    tc_store_rows_f32<D>(w_s, Shapes<D>::W_ROWS, W, D, tid, NTHREADS);
  else if constexpr (D == 64)
    tri_store_wt<D>(w_s, W, tid);
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
       tile += gridDim.x, buf ^= (S::WIDE ? 0 : 1)) {
    const long long r0 = tile * TM;
    const int rows = static_cast<int>(min(static_cast<long long>(TM),
                                          R - r0));
    if constexpr (!S::WIDE) {
      // the other buffer was read by the previous tile, which every thread
      // has finished (its LN_out exchange is a block barrier)
      if (tile + gridDim.x < tiles) load_sv(tile + gridDim.x, buf ^ 1);
      tc::cp_async_commit();
    }
    bool live[2];
    long long row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      live[h] = rl + 8 * h < rows;
      row[h] = r0 + (live[h] ? rl + 8 * h : 0);
    }
    uint32_t kw[3][2][(D / 16 + 7) / 8];
    tri_keep_bits<D>(drop, row, lane, half, kw);
    if constexpr (S::WIDE)
      tc::cp_async_wait<0>();          // this tile's s and v
    else
      tc::cp_async_wait<1>();
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
    if constexpr (S::WIDE) {
      // s and v are read: the next tile's rows load during the product
      if (tile + gridDim.x < tiles) load_sv(tile + gridDim.x, 0);
      tc::cp_async_commit();
      mma_streamed_w<D, 3 * D, S::KP>(acc, tc::smem_u32(yd_s), W, w_s, wg);
    } else {
      tri_y1_mma<D>(acc, yd_s, w_s, wg);
    }
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

template <int D>
int launch_width(const void* s, const void* v, const float* gin,
                 const float* bin, const float* W, const float* bias,
                 const float* gout, const float* bout, void* out, long long R,
                 Dropout drop, int is_bf16, cudaStream_t st) {
  if (is_bf16)
    return launch_tc<D>(s, v, gin, bin, W, bias, gout, bout, out, R, drop,
                        st);
  return launch_f32<D>(static_cast<const float*>(s),
                       static_cast<const float*>(v), gin, bin, W, bias, gout,
                       bout, static_cast<float*>(out), R, drop, st);
}

}  // namespace

// s, v, out: R rows of D (64, 128 or 256), all bf16 (is_bf16) or all
// float32; gin/bin (3D), W (3D, D), bias/gout/bout (D) float32, 16-byte
// aligned; bf16 s and v are 16-byte aligned.  Dropout on the LN_in output
// when drop_threshold > 0 (philox.cuh).
// dv: the true width, 4 <= dv <= D with 4 | dv, of inputs zero-padded to D
// (every LN's statistics and the Philox keys, philox.cuh).
extern "C" int tri_bridge_fwd(const void* s, const void* v, const void* gin,
                              const void* bin, const void* W,
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
    return launch_width<DD>(s, v, f(gin), f(bin), f(W), f(bias), f(gout),    \
                            f(bout), out, R, drop, is_bf16, st);
  switch (D) {
    TVQA_TRI_FWD(64)
    TVQA_TRI_FWD(128)
    TVQA_TRI_FWD(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TVQA_TRI_FWD
}
