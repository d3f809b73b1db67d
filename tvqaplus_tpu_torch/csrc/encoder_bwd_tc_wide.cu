// Fused QANet encoder block, backward, at the hidden widths D = 64 and 256
// in bfloat16 on the tensor cores, in the forward's two modes
// (encoder_bwd.cu is the same design at D = 128; encoder_bwd_wide.cu the
// float32 kernels at these widths).  A source of its own so that no kernel
// source takes much longer than the others to build.
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_encoder.py (_backward
// :493) at this width: the two passes of encoder_bwd.cu's header, every
// product a wgmma on bf16 operands with float32 sums, rounded where the TPU
// kernel's bf16 compute mode rounds (c, pw, g_y; pallas_encoder.py:199-201,
// :221-226); the depthwise weight gradient reads the LN output rounded to
// bf16, as the TPU kernel's bf16 stash ln_d is.
//
// What bounds it on the H100: at the headline train shapes (4,000
// sequences of 40) it reads x and writes gx (~20 MB at D = 64, ~82 MB at
// 256) and does ~9 and ~148 GFLOP (three D x D products per layer: the two
// recomputes, g_c and gpw), so the bytes bind at D = 64 (~6 us) and the
// operations at 256 (~0.15 ms).
#include "bwd_wide.cuh"
#include "encoder_tc.cuh"

namespace {

using namespace tvqa;

constexpr int MAX_K = ENC_MAX_K;

// parameter-vector layout of one scratch slot, as encoder_bwd.cu
template <int D>
__host__ __device__ inline int vec_floats(int k) {
  return 2 * (4 + k) * D + 2 * D;
}

// ---- the bfloat16 instantiations: tensor cores -----------------------------
//
// encoder_bwd.cu's encoder_bwd_tc_kernel at D = 64 and 256, with the
// forward's column split (encoder_fwd_tc_wide_kernel): one resident block
// an SM walks tiles of 64 rows holding 64 / L whole sequences (one of 40 or
// 50: 62% and 78% of the rows); both warpgroups take all 64 rows and
// warpgroup w owns columns [D / 2 w, D / 2 (w + 1)), so a thread holds D / 4
// values of two rows (at D = 256 what it holds at D = 128) and a row's
// LayerNorm sums cross the warpgroups through shared memory
// (tri_row_pair_sums).  g_y pw^T runs over both warpgroups' columns, so its
// A, g_y, is a tile of its own.  At D = 256 pw streams: through two stages
// of 32 rows for c pw (mma_streamed_w) and through one slab of its 256
// rows x 64 columns at a time for g_y pw^T.  At D = 64 pw and pw^T of both
// layers stay resident, both read K-major (a warpgroup's 32 columns start
// inside a swizzled row, where an MN-major operand cannot start).  R1 (64 x
// D float32) holds the LN output, then g_c; R2 the c tile, then t in bf16;
// the h stash and the running parameter sums sit in the block's scratch in
// L2, as at D = 128.  166 KB of shared memory at D = 256, 66 KB at 64.
template <int D>
struct EncTcW {
  static constexpr int NV = D / 4;             // a thread's values
  static constexpr int NPR = NV / 2;           // ... as pairs
  static constexpr int NQ = NPR / 2;           // ... as 8-column blocks
  static constexpr int NPART = NTHREADS / D;   // threads of a column pass
  static constexpr int ACC_LN = NWARPS * 6 * D;   // [warp][ln0_s .. lnf_b][D]
  // + [part][layer][tap 0 .. MAX_K, dwb][D]
  static constexpr int ACC = ACC_LN + NPART * 2 * (MAX_K + 1) * D;
  static constexpr int H = NV * NTHREADS;      // the h stash
  static constexpr int O_R1 = 0;               // 64 x D float32
  static constexpr int O_R2 = O_R1 + TM * D * 4;  // 64 x D bf16: c, then t
  static constexpr int O_GY = O_R2 + TM * D * 2;  // 64 x D bf16: g_y
  // pw's stages or its slab (256); pw0, pw1, pw0^T, pw1^T (64): 32 KB
  static constexpr int O_W = O_GY + TM * D * 2;
  static constexpr int W_ROOM = 32768;
  static constexpr int O_RV = O_W + W_ROOM;    // v, m
  static constexpr int O_EX = O_RV + 2 * TM * 4;  // [2][wg][row][2]
  static constexpr int SMEM = O_EX + 2 * 2 * TM * 2 * 4 + tc::ATOM_BYTES;
  static_assert(D == 64 || D == 256, "the widths of this source");
  static_assert(2 * stream_stage_bytes<256, 32>() <= W_ROOM
                && 256 * tc::ROW_BYTES <= W_ROOM
                && 4 * 64 * tc::ROW_BYTES <= W_ROOM, "pw's room");
};

struct TcWideBufs {
  __nv_bfloat16 *c[2], *gy[2];         // (N*L, D): gpw's operands
  float* vec_part;   // (gridDim.x, vec_floats), then (gridDim.x, ACC)
                     // running sums, then (gridDim.x, H) h stashes
};

// y = c pw_i on the warpgroup's D / 2 columns, c the R2 tile (complete
// and fenced): at D = 256 pw_i streams (mma_streamed_w), at 64 pw_i^T is
// resident at panel 2 + i of w_s, read K-major.  Every thread calls it.
template <int D>
__device__ __forceinline__ void enc_fwd_mma(float (&acc)[D / 4],
                                            const uint8_t* r2,
                                            const __nv_bfloat16* pw_i,
                                            uint8_t* w_s, int wg, int i) {
  if constexpr (D == 256) {
    mma_streamed_w<D, D, 32>(acc, tc::smem_u32(r2), pw_i, w_s, wg);
  } else {
    constexpr int PW = D * tc::ROW_BYTES;
    tc::fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::mma_ss<D / 2, 0, 0>(
          acc, tc::make_desc(tc::smem_u32(r2) + ks * 32, 16),
          tc::make_desc(tc::smem_u32(w_s) + (2 + i) * PW
                            + D / 2 * wg * tc::ROW_BYTES + ks * 32, 16),
          ks > 0);
    tc::commit();
    tc::wait_all();
  }
  tc::fence_regs(acc);
}

// acc = g_y pw_i^T on the warpgroup's D / 2 columns, g_y the gy tile (its
// writes fenced): at D = 256 pw_i's columns stream in four slabs of 64, at
// 64 pw_i is resident at panel i of w_s; both read K-major.  Every thread
// calls it.
template <int D>
__device__ __forceinline__ void enc_bwd_mma(float (&acc)[D / 4],
                                            const uint8_t* gy_s,
                                            const __nv_bfloat16* pw_i,
                                            uint8_t* w_s, int wg, int i) {
  const int cb = D / 2 * wg;
  if constexpr (D == 256) {
#pragma unroll 1
    for (int kc = 0; kc < D / 64; ++kc) {
      __syncthreads();                 // g_y whole; the slab's readers done
      tc_load_rows<64>(w_s, D, pw_i + 64 * kc, D, D, threadIdx.x, NTHREADS);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      tc::fence_async_smem();
      __syncthreads();
      tc::fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        tc::mma_ss<D / 2, 0, 0>(
            acc,
            tc::make_desc(tc::smem_u32(gy_s) + kc * TILE_PANEL + s * 32, 16),
            tc::make_desc(tc::smem_u32(w_s) + cb * tc::ROW_BYTES + s * 32,
                          16),
            kc > 0 || s > 0);
      tc::commit();
      tc::wait_all();
    }
  } else {
    constexpr int PW = D * tc::ROW_BYTES;
    __syncthreads();                   // g_y is whole
    tc::fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      tc::mma_ss<D / 2, 0, 0>(
          acc, tc::make_desc(tc::smem_u32(gy_s) + ks * 32, 16),
          tc::make_desc(tc::smem_u32(w_s) + i * PW + cb * tc::ROW_BYTES
                            + ks * 32, 16),
          ks > 0);
    tc::commit();
    tc::wait_all();
  }
  tc::fence_regs(acc);
}

template <int K, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
encoder_bwd_tc_wide_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ pe,
                           const float* __restrict__ packed,
                           const __nv_bfloat16* __restrict__ pw,
                           const float* __restrict__ mask,
                           const float* __restrict__ zmask,
                           const __nv_bfloat16* __restrict__ gout,
                           __nv_bfloat16* __restrict__ gx, TcWideBufs bufs,
                           int N, int G, int L, int k, int nseq,
                           Dropout drop) {
  using S = EncTcW<D>;
  constexpr int NV = S::NV, NPR = S::NPR, NQ = S::NQ, NSG = (NV + 31) / 32;
  constexpr int pad = K / 2;
  constexpr int PW = D * tc::ROW_BYTES;   // a resident pw panel (D = 64)
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  float* r1 = reinterpret_cast<float*>(sm + S::O_R1);
  uint8_t* r2 = sm + S::O_R2;
  uint8_t* gy_s = sm + S::O_GY;
  uint8_t* w_s = sm + S::O_W;
  float* v_s = reinterpret_cast<float*>(sm + S::O_RV);
  float* m_s = v_s + TM;
  float* ex_s = reinterpret_cast<float*>(sm + S::O_EX);
  const bool reduce = mask != nullptr;
  const TcParams<K, D> P{packed};
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int cb = D / 2 * wg;                         // the warpgroup's columns
  const int cl = cb + 2 * (lane & 3);
  int row[2];                                        // the thread's rows
#pragma unroll
  for (int h = 0; h < 2; ++h) row[h] = 16 * warp + (lane >> 2) + 8 * h;
  const int NVF = vec_floats<D>(k);
  float* sums = bufs.vec_part + static_cast<size_t>(gridDim.x) * NVF
                + static_cast<size_t>(blockIdx.x) * S::ACC;
  float* ln_sums = sums + (tid >> 5) * 6 * D;         // this warp's
  float2* r3 = reinterpret_cast<float2*>(    // the h stash, [NPR][NTHREADS]
      bufs.vec_part + static_cast<size_t>(gridDim.x) * (NVF + S::ACC)
      + static_cast<size_t>(blockIdx.x) * S::H);
  for (int idx = tid; idx < S::ACC; idx += NTHREADS) sums[idx] = 0.f;
  if constexpr (D == 64) {   // pw_i, and pw_i^T at 2 + i, for good
    for (int i = 0; i < 2; ++i)
      tc_load_rows<D>(w_s + i * PW, D, pw + i * D * D, D, D, tid, NTHREADS);
    tc::cp_async_commit();
    for (int idx = tid; idx < 2 * D * D; idx += NTHREADS) {
      const int i = idx / (D * D), kk = idx / D % D, n = idx % D;
      *reinterpret_cast<__nv_bfloat16*>(w_s + (2 + i) * PW + tc::swz(n, kk))
          = pw[idx];
    }
    tc::cp_async_wait<0>();
    tc::fence_async_smem();            // read by wgmma after a barrier
  }
  int xround = 0;
  // full-row sums of both warpgroups' columns (two exchange buffers in turn)
  auto row_sums = [&](float (&a)[2], float (&b)[2]) {
    tri_row_pair_sums(ex_s + (xround & 1) * 2 * TM * 2, a, b, wg, row[0],
                      lane);
    ++xround;
  };

  const int tiles = (N + nseq - 1) / nseq;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile * nseq, rows = min(nseq, N - n0) * L;
    const long long R0 = static_cast<long long>(n0) * L;
    bool valid[2];
    int lrow[2];
    long long grow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      valid[h] = row[h] < rows;
      lrow[h] = row[h] % L;
      grow[h] = R0 + (valid[h] ? row[h] : 0);
    }
    __syncthreads();                   // the previous tile is done
    if (tid < TM) {
      const bool ok = tid < rows;
      const int n = n0 + tid / L, l = tid % L;
      v_s[tid] = !ok ? 0.f
          : (zmask != nullptr ? zmask[static_cast<size_t>(n % G) * L + l]
                              : 1.f);
      m_s[tid] = ok && reduce ? mask[static_cast<size_t>(n) * L + l] : 0.f;
    }
    // conv 0's dropout: keep bits of the thread's values, drawn once
    uint32_t kw[2][(NQ + 7) / 8];
#pragma unroll
    for (int w = 0; w < (NQ + 7) / 8; ++w) kw[0][w] = kw[1][w] = ~0u;
    if (drop.on())
      tc_keep_bits<NQ, true>(drop,
                             drop.row_key((lane & 1) ? grow[1] : grow[0]) + cb,
                             lane, kw);
    auto keep = [&](int h, int q, int e) {
      return !drop.on() ? 1.f
          : ((kw[h][q >> 3] >> (4 * (q & 7) + e)) & 1u ? drop.scale : 0.f);
    };
    __syncthreads();

    // h0 = x + pe of the thread's values
    auto load_h0 = [&](float (&hv)[NV]) {
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        float2 a = make_float2(0.f, 0.f);
        if (valid[h]) {
          a = tc::unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(
              x + grow[h] * D + c)));
          const float2 p = ldg2(pe + lrow[h] * D + c);
          a.x += p.x;
          a.y += p.y;
        }
        hv[2 * pr] = a.x;
        hv[2 * pr + 1] = a.y;
      }
    };
    // row statistics over both warpgroups' columns (fast variance, clipped)
    auto stats = [&](const float (&hv)[NV], float (&mean)[2],
                     float (&istd)[2]) {
      mean[0] = mean[1] = istd[0] = istd[1] = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        mean[(j >> 1) & 1] += hv[j];
        istd[(j >> 1) & 1] = fmaf(hv[j], hv[j], istd[(j >> 1) & 1]);
      }
      row_sums(mean, istd);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mean[h] *= drop.inv1;
        istd[h] = rsqrtf(fmaxf(istd[h] * drop.inv1 - mean[h] * mean[h], 0.f)
                         + LN_EPS);
      }
    };
    // LN_i(hv) (times conv 0's dropout on layer 0; the final LN for i = 2)
    // into R1
    auto ln_to_r1 = [&](const float (&hv)[NV], const float* sc,
                        const float* bi, bool drop0) {
      float mean[2], istd[2];
      stats(hv, mean, istd);
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = 8 * q + cl;
        const float2 s2 = ldg2(sc + c), b2 = ldg2(bi + c);
        float y0 = (hv[2 * pr] - mean[h]) * istd[h] * s2.x + b2.x;
        float y1 = (hv[2 * pr + 1] - mean[h]) * istd[h] * s2.y + b2.y;
        if (drop0) {
          y0 *= keep(h, q, 0);
          y1 *= keep(h, q, 1);
        }
        *reinterpret_cast<float2*>(r1 + r1_at<D>(row[h], c)) =
            make_float2(y0, y1);
      }
    };
    // c = depthwise_i(t of R1 times v) rounded to bf16: the A tile in R2,
    // and out as rows when c_rows is not NULL
    auto conv = [&](int i, __nv_bfloat16* c_rows) {
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        const float2 a = enc_conv_pair<K, D>(r1, v_s, P.dw(i), P.dwb(i), row,
                                             lrow, valid, L, h, c);
        const uint32_t p = tc::pack_bf16(a.x, a.y);
        *reinterpret_cast<uint32_t*>(r2 + (c >> 6) * TILE_PANEL
                                     + tc::swz(row[h], c & 63)) = p;
        if (c_rows != nullptr && valid[h])
          *reinterpret_cast<uint32_t*>(c_rows + grow[h] * D + c) = p;
      }
    };
    // y = c pw_i + pwb_i on the warpgroup's columns in acc, and its ReLU
    // sign bits (bit j % 32 of sg[j / 32] for value j)
    auto fwd = [&](int i, float (&acc)[NV], uint32_t (&sg)[NSG]) {
      tc::fence_async_smem();
      __syncthreads();                 // the c tile is whole
      enc_fwd_mma<D>(acc, r2, pw + i * D * D, w_s, wg, i);
#pragma unroll
      for (int w = 0; w < NSG; ++w) sg[w] = 0u;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        acc[j] += __ldg(P.pwb(i) + cb + acc_col(j, lane));
        if (acc[j] > 0.f) sg[j >> 5] |= 1u << (j & 31);
      }
    };
    // g_y = g (y > 0) rounded to bf16 (its tile, rows out), then acc = g_y
    // pw_i^T on the warpgroup's columns, pw's columns in four slabs of 64
    auto bwd = [&](int i, const float (&g)[NV], const uint32_t (&sg)[NSG],
                   __nv_bfloat16* gy_rows, float (&acc)[NV]) {
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        const uint32_t bits = sg[pr >> 4] >> (2 * (pr & 15));
        const uint32_t f = tc::pack_bf16(bits & 1u ? g[2 * pr] : 0.f,
                                         bits & 2u ? g[2 * pr + 1] : 0.f);
        *reinterpret_cast<uint32_t*>(gy_s + (c >> 6) * TILE_PANEL
                                     + tc::swz(row[h], c & 63)) = f;
        if (valid[h])
          *reinterpret_cast<uint32_t*>(gy_rows + grow[h] * D + c) = f;
      }
      tc::fence_async_smem();
      enc_bwd_mma<D>(acc, gy_s, pw + i * D * D, w_s, wg, i);
    };
    // the LN output t of R1 in bf16 into R2 (the thread's values), for the
    // depthwise weight gradient; R2's readers must be done
    auto t_to_r2 = [&]() {
      __syncthreads();
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        const float2 tt = *reinterpret_cast<const float2*>(
            r1 + r1_at<D>(row[h], c));
        *reinterpret_cast<uint32_t*>(r2 + (c >> 6) * TILE_PANEL
                                     + tc::swz(row[h], c & 63)) =
            tc::pack_bf16(tt.x, tt.y);
      }
    };
    // acc (g_c) into R1; after a barrier the depthwise weight gradients
    // (column tid over the tile's rows, R1 and R2's bf16 t, into the
    // running sums) and acc = g_t, the gradient of the conv input (times
    // the dropout mask on layer 0)
    auto conv_bwd = [&](int i, float (&acc)[NV]) {
      __syncthreads();                 // R1's readers (the conv) are done
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        *reinterpret_cast<float2*>(r1 + r1_at<D>(row[h], c)) =
            make_float2(acc[2 * pr], acc[2 * pr + 1]);
      }
      __syncthreads();
      // column cd over the tile's sequences, rows [lb, le) of each by part
      const int cd = tid % D, part = tid / D;
      const int lb = L * part / S::NPART, le = L * (part + 1) / S::NPART;
      float gdw[K], gdwb = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) gdw[j] = 0.f;
      auto tv = [&](int r) {           // t v of tile row r, column cd
        return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                   r2 + (cd >> 6) * TILE_PANEL + tc::swz(r, cd & 63)))
               * v_s[r];
      };
      for (int base = 0; base < rows; base += L) {
        float win[K];                  // win[j] = t v of row l + j - pad
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) {
          const int l = lb + j - pad;
          win[j + 1] = l >= 0 && l < L ? tv(base + l) : 0.f;
        }
        for (int l = lb; l < le; ++l) {
#pragma unroll
          for (int j = 0; j + 1 < K; ++j) win[j] = win[j + 1];
          win[K - 1] = l + pad < L ? tv(base + l + pad) : 0.f;
          const float gc = r1[r1_at<D>(base + l, cd)];
          gdwb += gc;
#pragma unroll
          for (int j = 0; j < K; ++j) gdw[j] = fmaf(win[j], gc, gdw[j]);
        }
      }
      float* dsum = sums + S::ACC_LN + (part * 2 + i) * (MAX_K + 1) * D
                    + cd;
#pragma unroll
      for (int j = 0; j < K; ++j) dsum[j * D] += gdw[j];
      dsum[MAX_K * D] += gdwb;
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = 8 * q + cl;
        float2 a = make_float2(0.f, 0.f);
        if (valid[h]) {
          const int base = row[h] - lrow[h];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int rr = lrow[h] - j + pad;
            if (rr < 0 || rr >= L) continue;
            const float2 gc = *reinterpret_cast<const float2*>(
                r1 + r1_at<D>(base + rr, c));
            const float2 w = ldg2(P.dw(i) + j * D + c);
            a.x = fmaf(w.x, gc.x, a.x);
            a.y = fmaf(w.y, gc.y, a.y);
          }
          const float vv = v_s[row[h]];
          a.x *= vv;
          a.y *= vv;
          if (i == 0) {
            a.x *= keep(h, q, 0);
            a.y *= keep(h, q, 1);
          }
        }
        acc[2 * pr] = a.x;
        acc[2 * pr + 1] = a.y;
      }
    };
    // LayerNorm backward of the thread's values (fetch(pr): the LN input's
    // pair pr; g: the upstream gradient, float[NV], replaced by d LN / d
    // input); the scale and bias gradients into the warp's running sums
    // gacc[0 .. D), gacc[D .. 2D).  (g is a generic parameter: spelled
    // float (&)[NV] in this generic lambda, nvcc 12.9's front end crashed.)
    auto ln_bwd = [&](auto fetch, auto& g, const float* scale,
                      float* gacc) {
      float mean[2] = {0.f, 0.f}, istd[2] = {0.f, 0.f};
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const float2 xv = fetch(pr);
        mean[pr & 1] += xv.x + xv.y;
        istd[pr & 1] = fmaf(xv.x, xv.x, fmaf(xv.y, xv.y, istd[pr & 1]));
      }
      row_sums(mean, istd);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mean[h] *= drop.inv1;
        istd[h] = rsqrtf(fmaxf(istd[h] * drop.inv1 - mean[h] * mean[h], 0.f)
                         + LN_EPS);
      }
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int qb = 0; qb < NQ / 4; ++qb) {
        float ts[8], tb[8];
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const int q = 4 * qb + qq;
          const float2 sc = ldg2(scale + 8 * q + cl);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int pr = 2 * q + h;
            const float2 xv = fetch(pr);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 2 * pr + e, j = 2 * qq + e;
              const float xh = ((e ? xv.y : xv.x) - mean[h]) * istd[h];
              const float gv = g[i];
              ts[j] = h ? fmaf(gv, xh, ts[j]) : gv * xh;
              tb[j] = h ? tb[j] + gv : gv;
              const float gxh = gv * (e ? sc.y : sc.x);
              g[i] = gxh;
              s1[h] += gxh;
              s2[h] = fmaf(gxh, xh, s2[h]);
            }
          }
        }
        const int col = cb + fold8_col(qb, lane);
        gacc[col] += fold8(ts, lane);
        gacc[D + col] += fold8(tb, lane);
      }
      row_sums(s1, s2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s1[h] *= drop.inv1;
        s2[h] *= drop.inv1;
      }
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1;
        const float2 xv = fetch(pr);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * pr + e;
          const float xh = ((e ? xv.y : xv.x) - mean[h]) * istd[h];
          g[i] = istd[h] * (g[i] - s1[h] - xh * s2[h]);
        }
      }
    };
    auto from_r3 = [&](int pr) { return r3[pr * NTHREADS + tid]; };

    float hv[NV], acc[NV], ga[NV];
    uint32_t sg[NSG];
    // ---- pass A: layer 0 for h1, layer 1 with its stash -----------------
    load_h0(hv);
    ln_to_r1(hv, P.ln_s(0), P.ln_b(0), true);
    __syncthreads();
    conv(0, nullptr);
    fwd(0, acc, sg);
#pragma unroll
    for (int j = 0; j < NV; ++j) hv[j] += fmaxf(acc[j], 0.f);     // h1
#pragma unroll
    for (int pr = 0; pr < NPR; ++pr)
      r3[pr * NTHREADS + tid] = make_float2(hv[2 * pr], hv[2 * pr + 1]);
    __syncthreads();                   // R1's readers (the conv) are done
    ln_to_r1(hv, P.ln_s(1), P.ln_b(1), false);
    __syncthreads();
    conv(1, bufs.c[1]);
    fwd(1, acc, sg);
#pragma unroll
    for (int j = 0; j < NV; ++j) hv[j] += fmaxf(acc[j], 0.f);     // h2
    t_to_r2();
    // ---- the output's cotangent (reduce mode: final LN and masked-max
    // backward), final-LN backward -------------------------------------
    if (reduce) {
      ln_to_r1(hv, P.lnf_s(), P.lnf_b(), false);
      __syncthreads();
      for (int idx = tid; idx < rows / L * D; idx += NTHREADS) {
        const int sq = idx / D, d = idx % D, base = sq * L;
        float mx = -CUDART_INF_F;
        for (int l = 0; l < L; ++l) {
          const float m = m_s[base + l];
          mx = fmaxf(mx, r1[r1_at<D>(base + l, d)] * m + (m - 1.f) * 1e10f);
        }
        float cnt = 0.f;
        for (int l = 0; l < L; ++l) {
          const float m = m_s[base + l];
          cnt += (r1[r1_at<D>(base + l, d)] * m + (m - 1.f) * 1e10f) == mx
                     ? 1.f : 0.f;
        }
        const float g = __bfloat162float(
            gout[static_cast<size_t>(n0 + sq) * D + d]);
        for (int l = 0; l < L; ++l) {
          const float m = m_s[base + l];
          float& o = r1[r1_at<D>(base + l, d)];
          const bool eq = (o * m + (m - 1.f) * 1e10f) == mx;
          o = (eq ? g : 0.f) / cnt * m;
        }
      }
      __syncthreads();
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        const float2 g2 = valid[h]
            ? *reinterpret_cast<const float2*>(r1 + r1_at<D>(row[h], c))
            : make_float2(0.f, 0.f);
        ga[2 * pr] = g2.x;
        ga[2 * pr + 1] = g2.y;
      }
    } else {
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        const float2 g2 = valid[h]
            ? tc::unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(
                  gout + grow[h] * D + c)))
            : make_float2(0.f, 0.f);
        ga[2 * pr] = g2.x;
        ga[2 * pr + 1] = g2.y;
      }
    }
    ln_bwd([&](int pr) { return make_float2(hv[2 * pr], hv[2 * pr + 1]); },
           ga, P.lnf_s(), ln_sums + 4 * D);
    // ---- layer 1 backward -----------------------------------------------
    bwd(1, ga, sg, bufs.gy[1], acc);
    conv_bwd(1, acc);
    ln_bwd(from_r3, acc, P.ln_s(1), ln_sums + 2 * D);
#pragma unroll
    for (int j = 0; j < NV; ++j) ga[j] += acc[j];                 // g_h1
    __syncthreads();                   // R1 (g_c1) and R2 (t1) are read
    // ---- pass B: recompute layer 0 (dropout replayed), its backward -----
    load_h0(hv);
#pragma unroll
    for (int pr = 0; pr < NPR; ++pr)
      r3[pr * NTHREADS + tid] = make_float2(hv[2 * pr], hv[2 * pr + 1]);
    ln_to_r1(hv, P.ln_s(0), P.ln_b(0), true);
    __syncthreads();
    conv(0, bufs.c[0]);
    fwd(0, acc, sg);
    t_to_r2();
    bwd(0, ga, sg, bufs.gy[0], acc);
    conv_bwd(0, acc);
    ln_bwd(from_r3, acc, P.ln_s(0), ln_sums);
#pragma unroll
    for (int pr = 0; pr < NPR; ++pr) {  // d(x + pe)/dx = 1
      const int h = pr & 1, c = 8 * (pr >> 1) + cl;
      if (valid[h])
        *reinterpret_cast<uint32_t*>(gx + grow[h] * D + c) = tc::pack_bf16(
            acc[2 * pr] + ga[2 * pr], acc[2 * pr + 1] + ga[2 * pr + 1]);
    }
  }

  // ---- the block's parameter-vector partials, summed in a fixed order --
  __syncthreads();                     // every running sum is final
  float* out = bufs.vec_part + static_cast<size_t>(blockIdx.x) * NVF;
  for (int idx = tid; idx < 6 * D; idx += NTHREADS) {
    const int s = idx / D, d = idx % D;            // s: ln0_s .. lnf_b
    float acc_s = 0.f;
    for (int wp = 0; wp < NWARPS; ++wp) acc_s += sums[(wp * 6 + s) * D + d];
    const int off = s < 4 ? (s / 2) * (4 + k) * D + (s % 2) * D
                          : 2 * (4 + k) * D + (s - 4) * D;
    out[off + d] = acc_s;
  }
  for (int idx = tid; idx < 2 * (k + 2) * D; idx += NTHREADS) {
    const int s = idx / D, d = idx % D;
    const int i = s / (k + 2), j = s % (k + 2);    // j: taps, dwb, pwb
    const int jj = j < k ? j : MAX_K;
    float acc_s = 0.f;
    for (int p = 0; p < S::NPART; ++p)
      acc_s += sums[S::ACC_LN + (p * 2 + i) * (MAX_K + 1) * D + jj * D + d];
    out[i * (4 + k) * D + (2 + j) * D + d] =
        j == k + 1 ? 0.f : acc_s;                  // pwb: wgrad_tc's
  }
}

// The bf16 backward at width D: the main kernel, the two layers' weight
// gradients over the bf16 rows it wrote, and the fixed-order slot sum.
template <int D>
int launch_tc_wide(const void* x, const float* pe, const float* packed,
                   const void* pw, const float* mask, const float* zmask,
                   const void* g, void* gx, TcWideBufs bufs, float* gvec,
                   float* wg_part, float* gpw, int N, int G, int L, int k,
                   int wg_chunks, Dropout drop, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int smem = EncTcW<D>::SMEM;
  auto kern = encoder_bwd_tc_wide_kernel<1, D>;
  switch (k) {
    case 3: kern = encoder_bwd_tc_wide_kernel<3, D>; break;
    case 5: kern = encoder_bwd_tc_wide_kernel<5, D>; break;
    case 7: kern = encoder_bwd_tc_wide_kernel<7, D>; break;
    case 9: kern = encoder_bwd_tc_wide_kernel<9, D>; break;
    default: break;
  }
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  const int nseq = TM / L, tiles = (N + nseq - 1) / nseq;
  const int blocks = tiles < sms ? tiles : sms;
  kern<<<blocks, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(x), pe, packed, static_cast<const bf16*>(pw),
      mask, zmask, static_cast<const bf16*>(g), static_cast<bf16*>(gx), bufs,
      N, G, L, k, nseq, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(N) * L;
  for (int i = 0; i < 2; ++i)
    if ((err = wgrad_tc(bufs.c[i], bufs.gy[i], wg_part,
                        gpw + i * (D + 1) * D, rows, D, D, wg_chunks,
                        stream)) != cudaSuccess)
      return static_cast<int>(err);
  return static_cast<int>(sum_slots<float>(bufs.vec_part, gvec, 1, blocks,
                                           vec_floats<D>(k), stream));
}

// The C entries' common part: checks, then launch_tc_wide.
int launch_entry(const void* x, const void* pe, const void* packed,
                 const void* pw, const void* mask, const void* zmask,
                 const void* g, void* gx, void* gvec, void* gpw, void* c0,
                 void* c1, void* gy0, void* gy1, void* vec_part,
                 void* wg_part, int N, int G, int L, int k, int d,
                 int wg_chunks, const unsigned long long* drop_seed,
                 unsigned drop_threshold, float drop_scale, int dv,
                 const int* gmap, int g_glob, int is_bf16, void* stream,
                 bool shapes_ok) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  auto h = [](void* p) { return static_cast<__nv_bfloat16*>(p); };
  if (!shapes_ok || (d != 64 && d != 256) || !is_bf16 || k % 2 == 0
      || k > MAX_K || L < 1 || L > TM)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop = entry_dropout(
      drop_seed, drop_threshold, drop_scale, dv, gmap, G, g_glob, L);
  if (!width_ok(dv, d)) return static_cast<int>(cudaErrorInvalidValue);
  const TcWideBufs bufs{{h(c0), h(c1)}, {h(gy0), h(gy1)}, fm(vec_part)};
  auto st = static_cast<cudaStream_t>(stream);
  return d == 64
      ? launch_tc_wide<64>(x, f(pe), f(packed), pw, f(mask), f(zmask), g, gx,
                           bufs, fm(gvec), fm(wg_part), fm(gpw), N, G, L, k,
                           wg_chunks, drop, st)
      : launch_tc_wide<256>(x, f(pe), f(packed), pw, f(mask), f(zmask), g,
                            gx, bufs, fm(gvec), fm(wg_part), fm(gpw), N, G,
                            L, k, wg_chunks, drop, st);
}

}  // namespace

// As encoder_reduce_bwd_wide (encoder_bwd_wide.cu) at D = 64 or 256 in
// bf16, with the same arguments: x, g, gx bf16; pwT is [pw0; pw1] (2, D,
// D) bf16 as they lie; gpw (2, D + 1, D), each layer's gpwb as its last row
// (gvec's pwb entries are 0); c0, c1, gy0, gy1 bf16; vec_part (min(ceil(N
// / (64 / L)), SMs), 2 (4 + k) D + 2 D + EncTcW<D>::ACC + EncTcW<D>::H)
// float32; wg_part (wg_chunks, D + 1, D); work unused (may be NULL).
// is_bf16 must be set.
// dv: the true width, 4 <= dv <= D with 4 | dv, of inputs zero-padded to D
// (every LN's statistics and the Philox keys, philox.cuh); gmap / g_glob the
// group map of the full-output mode (Dropout::row_key; NULL / 1 for none).
extern "C" int encoder_reduce_bwd_tc_wide(
    const void* x, const void* pe, const void* packed, const void* pw,
    const void* mask, const void* g, void* gx, void* gvec, void* gpw,
    void* c0, void* c1, void* gy0, void* gy1, void* vec_part, void* work,
    void* wg_part, int N, int L, int k, int d, int wg_chunks,
    const unsigned long long* drop_seed, unsigned drop_threshold,
    float drop_scale, int dv, const int* gmap, int g_glob, int is_bf16,
    void* stream) {
  return launch_entry(x, pe, packed, pw, mask, nullptr, g, gx, gvec, gpw, c0,
                      c1, gy0, gy1, vec_part, wg_part, N, 1, L, k, d,
                      wg_chunks, drop_seed, drop_threshold, drop_scale, dv,
                          gmap, g_glob,
                          is_bf16, stream, mask != nullptr);
}

// Full-output mode: g (N, L, D) is the cotangent of the block output;
// zmask (G, L) float32 or NULL, sequence n uses its row n % G.  Everything
// else as encoder_reduce_bwd_tc_wide.
extern "C" int encoder_block_bwd_tc_wide(
    const void* x, const void* pe, const void* packed, const void* pw,
    const void* zmask, const void* g, void* gx, void* gvec, void* gpw,
    void* c0, void* c1, void* gy0, void* gy1, void* vec_part, void* work,
    void* wg_part, int N, int G, int L, int k, int d, int wg_chunks,
    const unsigned long long* drop_seed, unsigned drop_threshold,
    float drop_scale, int dv, const int* gmap, int g_glob, int is_bf16,
    void* stream) {
  return launch_entry(x, pe, packed, pw, nullptr, zmask, g, gx, gvec, gpw,
                      c0, c1, gy0, gy1, vec_part, wg_part, N, G, L, k, d,
                      wg_chunks, drop_seed, drop_threshold, drop_scale, dv,
                          gmap, g_glob,
                          is_bf16, stream, G >= 1 && N % G == 0);
}
