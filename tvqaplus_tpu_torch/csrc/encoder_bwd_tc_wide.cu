// Fused QANet encoder block, backward, at the hidden widths D = 64 and 256
// in bfloat16 on the tensor cores, in the forward's two modes
// (encoder_bwd.cu is the same function at D = 128; encoder_bwd_wide.cu the
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
//
// Two designs: encoder_bwd_tc_wide_kernel at D = 64 (pw resident, the
// running sums and the h stash in the block's scratch in L2) and
// its overload without k at D = 256 (pw streamed through a ring, every
// per-tile state on the SM, the depthwise passes column by column); the
// notes at the kernels.
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

// ---- the bfloat16 instantiation at D = 64: tensor cores -------------------
//
// encoder_bwd.cu's encoder_bwd_tc_kernel at D = 64, with the forward's
// column split (encoder_fwd_tc_wide_kernel): one resident block an SM
// walks tiles of 64 rows holding 64 / L whole sequences; both warpgroups
// take all 64 rows and warpgroup w owns columns [D / 2 w, D / 2 (w + 1)),
// so a thread holds D / 4 values of two rows and a row's LayerNorm sums
// cross the warpgroups through shared memory (tri_row_pair_sums).  g_y
// pw^T runs over both warpgroups' columns, so its A, g_y, is a tile of its
// own.  pw and pw^T of both layers stay resident, both read K-major (a
// warpgroup's 32 columns start inside a swizzled row, where an MN-major
// operand cannot start).  R1 (64 x D float32) holds the LN output, then
// g_c; R2 the c tile, then t in bf16; the h stash and the running
// parameter sums sit in the block's scratch in L2, as at D = 128.  66 KB of
// shared memory.
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
  // pw0, pw1, pw0^T, pw1^T: 32 KB
  static constexpr int O_W = O_GY + TM * D * 2;
  static constexpr int W_ROOM = 32768;
  static constexpr int O_RV = O_W + W_ROOM;    // v, m
  static constexpr int O_EX = O_RV + 2 * TM * 4;  // [2][wg][row][2]
  static constexpr int SMEM = O_EX + 2 * 2 * TM * 2 * 4 + tc::ATOM_BYTES;
  static_assert(D == 64, "the width of this design");
  static_assert(4 * 64 * tc::ROW_BYTES <= W_ROOM, "pw's room");
};

struct TcWideBufs {
  __nv_bfloat16 *c[2], *gy[2];         // (N*L, D): gpw's operands
  float* vec_part;   // (gridDim.x, vec_floats); at D = 64 then
                     // (gridDim.x, ACC) running sums, (gridDim.x, H) h
                     // stashes
};

// y = c pw_i on the warpgroup's D / 2 columns, c the R2 tile (complete
// and fenced), pw_i^T resident at panel 2 + i of w_s, read K-major.  Every
// thread calls it.
template <int D>
__device__ __forceinline__ void enc_fwd_mma(float (&acc)[D / 4],
                                            const uint8_t* r2,
                                            const __nv_bfloat16* pw_i,
                                            uint8_t* w_s, int wg, int i) {
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
  tc::fence_regs(acc);
}

// acc = g_y pw_i^T on the warpgroup's D / 2 columns, g_y the gy tile (its
// writes fenced), pw_i resident at panel i of w_s, read K-major.  Every
// thread calls it.
template <int D>
__device__ __forceinline__ void enc_bwd_mma(float (&acc)[D / 4],
                                            const uint8_t* gy_s,
                                            const __nv_bfloat16* pw_i,
                                            uint8_t* w_s, int wg, int i) {
  const int cb = D / 2 * wg;
  constexpr int PW = D * tc::ROW_BYTES;
  __syncthreads();                     // g_y is whole
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
  {                          // pw_i, and pw_i^T at 2 + i, for good
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

// ---- the bfloat16 instantiation at D = 256: tensor cores -----------------
//
// One resident block an SM walks tiles of 64 rows holding 64 / L whole
// sequences; both warpgroups take all 64 rows and warpgroup w owns columns
// [128 w, 128 w + 128), so a thread holds 64 values of two rows in the
// accumulator layout and a row's LayerNorm sums cross the warpgroups
// through shared memory (tri_row_pair_sums).  What the design does about
// the card:
// * pw streams through a ring of NST stages of KP rows (MN-major, the
//   forward's stage format), NST - 1 stages ahead of the tensor cores, one
//   barrier a stage.  The ring lives in R1, which no product needs: the
//   LN output t is copied in bf16 to T before a layer's products (the
//   depthwise weight gradient reads it there), the c and g_y tiles share
//   R2.  The wrapper packs [pw0; pw1; pw0^T; pw1^T], so both products of a
//   layer read rows as they lie.
// * Nothing of a tile goes to L2 but its outputs: h0 and h1 (pass A) and
//   g_h1 (pass B) wait in shared memory (H), and half of g_h2 in R2
//   through layer 1's depthwise and LN passes; the LN parameter sums of a
//   tile are summed over the warps in a fixed order (staged in R2 or T)
//   into running sums in shared memory, the depthwise sums into the
//   column owner's slots beside them; all are written once, at the end.
// * The depthwise conv and its backward run column by column: thread t
//   owns column t and walks the tile's rows with a window of K taps, so
//   each value is read once (the forward's conv; g_t written over g_c in
//   place, the taps' sums beside it).
// * At most two of the thread's 64-value arrays are live at a time (h
//   goes to H before the products that hold g).  ptxas still spills 52 to
//   124 bytes a thread (by K): values of g_h2 and of the row indices that
//   outlive layer 1's product beside its accumulator.
// * The thread's addresses into R1 (rows padded by 8 floats: the
//   accumulator layout's float2 accesses 2-way at most, a row's columns
//   conflict-free) and into the swizzled bf16 tiles are made afresh from
//   two bases at each pass (opaque), not held for the kernel's life.
// Shared memory: R1 (64 x D float32: t, the final LN output, g_c, g_t;
// the ring during products), H (64 x D float32), R2 (bf16: c, then g_y;
// the LN sums' staging between), T (bf16: t), the running sums: 224 KB.
struct Enc256 {
  static constexpr int D = 256;
  static constexpr int KP = 32;                 // pw rows a stage
  static constexpr int STAGE = KP * D * 2;      // 16 KB
  static constexpr int NST = TM * D * 4 / STAGE;  // stages: R1 holds 4
  static constexpr int R1S = D + 8;             // R1's row stride (floats)
  static constexpr int O_R1 = 0;                // 64 x D float32; the ring
  static constexpr int O_H = O_R1 + TM * R1S * 4;  // [pair][thread] float2
  static constexpr int O_R2 = O_H + TM * D * 4;   // 64 x D bf16
  static constexpr int O_T = O_R2 + TM * D * 2;   // 64 x D bf16
  static constexpr int O_DW = O_T + TM * D * 2;   // [layer][tap, dwb][D]
  static constexpr int O_LN = O_DW + 2 * (MAX_K + 1) * D * 4;  // [6][D]
  static constexpr int O_RV = O_LN + 6 * D * 4;        // v, m
  static constexpr int O_EX = O_RV + 2 * TM * 4;       // [2][wg][row][2]
  static constexpr int SMEM = O_EX + 2 * 2 * TM * 2 * 4 + tc::ATOM_BYTES;
  static_assert(O_R2 % tc::ATOM_BYTES == 0 && O_T % tc::ATOM_BYTES == 0
                && STAGE % tc::ATOM_BYTES == 0,
                "panels on 1024-byte boundaries");
  static_assert(NST * STAGE <= O_H - O_R1, "the ring in R1");
  static_assert(2 * NWARPS * 128 * 4 <= TM * D * 2, "the LN staging");
  static_assert(TM * D / 2 * 4 <= TM * D * 2, "half of g_h2 in R2");
};

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
                         int N, int G, int L, int nseq, Dropout drop) {
  using S = Enc256;
  static_assert(D == S::D, "the width of this design");
  constexpr int NV = D / 4, NPR = NV / 2, NQ = NPR / 2;
  constexpr int NSG = NV / 32, KP = S::KP, NST = S::NST;
  constexpr int PANEL = KP * tc::ROW_BYTES;      // a stage's panel
  constexpr int pad = K / 2;
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  float* r1 = reinterpret_cast<float*>(sm + S::O_R1);
  uint8_t* ring = sm + S::O_R1;
  float2* hs = reinterpret_cast<float2*>(sm + S::O_H);
  uint8_t* r2 = sm + S::O_R2;
  float2* r2f = reinterpret_cast<float2*>(sm + S::O_R2);  // g_h2's upper half
  uint8_t* t_s = sm + S::O_T;
  float* dw_run = reinterpret_cast<float*>(sm + S::O_DW);
  float* ln_run = reinterpret_cast<float*>(sm + S::O_LN);
  float* v_s = reinterpret_cast<float*>(sm + S::O_RV);
  float* m_s = v_s + TM;
  float* ex_s = reinterpret_cast<float*>(sm + S::O_EX);
  const bool reduce = mask != nullptr;
  const TcParams<K, D> P{packed};
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31, wid = tid >> 5;
  const int cb = 128 * wg;                           // the warpgroup's columns
  const int cl = cb + 2 * (lane & 3);
  int row[2];                                        // the thread's rows
#pragma unroll
  for (int h = 0; h < 2; ++h) row[h] = 16 * warp + (lane >> 2) + 8 * h;
  constexpr int R1S = S::R1S;
  // The thread's bases, made afresh at each pass through a value the
  // compiler cannot see through (held for the kernel's life, its 32
  // addresses of each kind spilled): R1's float offset of row half h at
  // column cl (pair (h, q) at + 8 q), and a swizzled bf16 tile's byte
  // offset of row half h at column cl with the row's chunk swizzle.
  auto opaque = [](int v) {
    asm volatile("" : "+r"(v));
    return v;
  };
  auto r1_base = [&](int h) { return opaque(row[h] * R1S + cl); };
  auto tile_at = [&](int h, int q) {
    const int b = opaque((cb >> 6) * TILE_PANEL + row[h] * tc::ROW_BYTES
                         + (cl & 7) * 2);
    return b + (q >> 3) * TILE_PANEL + ((((q & 7) ^ row[h]) & 7) << 4);
  };
  for (int idx = tid; idx < 6 * D; idx += NTHREADS) ln_run[idx] = 0.f;
  for (int idx = tid; idx < 2 * (MAX_K + 1) * D; idx += NTHREADS)
    dw_run[idx] = 0.f;

  // ---- the ring in R1: stage s of W (D x D bf16, rows as they lie) into
  // slot s % NST (an empty group past the last stage: one group a stage) --
  auto fetch_stage = [&](const __nv_bfloat16* w, int s) {
    if (s < D / KP)
      tc_load_rows<D>(ring + (s % NST) * S::STAGE, KP, w + s * KP * D, D,
                      KP, tid, NTHREADS);
    tc::cp_async_commit();
  };
  // acc = A W on the warpgroup's 128 columns, A the 64 x D tile at a_addr
  // (K-major, written by every thread), W streamed.  R1's readers done, the
  // first NST - 1 stages go out; then each stage: its copies waited for
  // (the newer NST - 2 stay in flight), a barrier (the stage whole; the
  // previous one's products done in both warpgroups, so its slot takes
  // stage + NST - 1), the product.  R1 is free again on return.
  auto product = [&](float (&acc)[NV], uint32_t a_addr,
                     const __nv_bfloat16* w) {
    tc::fence_async_smem();
    __syncthreads();
#pragma unroll
    for (int s = 0; s < NST - 1; ++s) fetch_stage(w, s);
#pragma unroll 1
    for (int s = 0; s < D / KP; ++s) {
      tc::cp_async_wait<NST - 2>();
      tc::fence_async_smem();
      __syncthreads();
      fetch_stage(w, s + NST - 1);
      const uint32_t st = tc::smem_u32(ring + (s % NST) * S::STAGE);
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < KP / 16; ++ks) {
        const int kk = s * (KP / 16) + ks;     // the depth step of 16
        tc::mma_ss<128, 0, 1>(
            acc, tc::make_desc(a_addr + (kk / 4) * TILE_PANEL + (kk % 4) * 32,
                               16),
            tc::make_desc(st + 2 * wg * PANEL + ks * 2 * tc::ATOM_BYTES,
                          PANEL), s > 0 || ks > 0);
      }
      tc::commit();
      tc::wait_all();
    }
    tc::fence_regs(acc);
    __syncthreads();
  };
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
    // LN_i(hv) (times conv 0's dropout when drop0; the final LN for lnf)
    // into R1, its row statistics over both warpgroups' columns (fast
    // variance, clipped)
    auto ln_to_r1 = [&](const float (&hv)[NV], const float* sc,
                        const float* bi, bool drop0) {
      float mean[2] = {0.f, 0.f}, istd[2] = {0.f, 0.f};
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
      const int rb[2] = {r1_base(0), r1_base(1)};
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
        *reinterpret_cast<float2*>(r1 + rb[h] + 8 * q) = make_float2(y0, y1);
      }
    };
    // c = depthwise_i(t v) + dwb of R1's t, rounded to bf16, into R2 (and
    // out as rows when c_rows is not NULL): column tid, a window of the K
    // taps' t v walking each sequence; rows past the sequences get dwb.
    // R1 must be whole.
    auto conv = [&](int i, __nv_bfloat16* c_rows) {
      const int cd = tid;
      float w[K];
#pragma unroll
      for (int j = 0; j < K; ++j) w[j] = __ldg(P.dw(i) + j * D + cd);
      const float bias = __ldg(P.dwb(i) + cd);
      uint8_t* col = r2 + (cd >> 6) * TILE_PANEL;
      auto tv = [&](int r) { return r1[r * R1S + cd] * v_s[r]; };
      auto put = [&](int r, float a) {
        const __nv_bfloat16 b = __float2bfloat16(a);
        *reinterpret_cast<__nv_bfloat16*>(col + tc::swz(r, cd & 63)) = b;
        if (c_rows != nullptr) c_rows[(R0 + r) * D + cd] = b;
      };
      for (int base = 0; base < rows; base += L) {
        float win[K];                  // win[j] = t v of row l + j - pad
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) {
          const int l = j - pad;
          win[j + 1] = l >= 0 && l < L ? tv(base + l) : 0.f;
        }
        for (int l = 0; l < L; ++l) {
#pragma unroll
          for (int j = 0; j + 1 < K; ++j) win[j] = win[j + 1];
          win[K - 1] = l + pad < L ? tv(base + l + pad) : 0.f;
          float a = bias;
#pragma unroll
          for (int j = 0; j < K; ++j) a = fmaf(w[j], win[j], a);
          put(base + l, a);
        }
      }
      const __nv_bfloat16 b = __float2bfloat16(bias);
      for (int r = rows; r < TM; ++r)
        *reinterpret_cast<__nv_bfloat16*>(col + tc::swz(r, cd & 63)) = b;
    };
    // y = c pw_i + pwb_i on the warpgroup's columns in acc (c the R2
    // tile), and its ReLU sign bits (bit j % 32 of sg[j / 32] for value j)
    auto fwd = [&](int i, float (&acc)[NV], uint32_t (&sg)[NSG]) {
      product(acc, tc::smem_u32(r2), pw + i * D * D);
#pragma unroll
      for (int w = 0; w < NSG; ++w) sg[w] = 0u;
      const float* pb = P.pwb(i) + cl;  // value j: column cl + 8 (j / 4) + j % 2
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float2 b2 = ldg2(pb + 8 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * q + e;
          acc[j] += e & 1 ? b2.y : b2.x;
          if (acc[j] > 0.f) sg[j >> 5] |= 1u << (j & 31);
        }
      }
    };
    // g_y = g (y > 0) rounded to bf16 (its tile in R2, rows out; gpair(pr)
    // gives g's pair pr), then acc = g_y pw_i^T on the warpgroup's columns
    // (sg and acc spelled auto& in this generic lambda, as ln_bwd's g)
    auto bwd = [&](int i, auto gpair, const auto& sg, __nv_bfloat16* gy_rows,
                   auto& acc) {
      __syncthreads();                 // the LN sums' staging is read
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        const uint32_t bits = sg[pr >> 4] >> (2 * (pr & 15));
        const float2 g2 = gpair(pr);
        const uint32_t f = tc::pack_bf16(bits & 1u ? g2.x : 0.f,
                                         bits & 2u ? g2.y : 0.f);
        *reinterpret_cast<uint32_t*>(r2 + tile_at(h, pr >> 1)) = f;
        if (valid[h])
          *reinterpret_cast<uint32_t*>(gy_rows + grow[h] * D + c) = f;
      }
      product(acc, tc::smem_u32(r2), pw + (2 + i) * D * D);
    };
    // the LN output t of R1 (the thread's values) in bf16 into T, for the
    // depthwise weight gradient, before the layer's products take R1; T's
    // last readers are a few barriers back
    auto t_copy = [&]() {
      const int rb[2] = {r1_base(0), r1_base(1)};
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1, q = pr >> 1;
        const float2 tt = *reinterpret_cast<const float2*>(r1 + rb[h] + 8 * q);
        *reinterpret_cast<uint32_t*>(t_s + tile_at(h, q)) =
            tc::pack_bf16(tt.x, tt.y);
      }
    };
    // acc (g_c) into R1; then column tid walks each sequence: the depthwise
    // weight gradients (T's bf16 t times v against g_c) into layer i's
    // running sums, and g_t = v sum_j dw[j] g_c[l - j + pad] written over
    // g_c (row l's g_c is in the window by then); then acc = g_t (times the
    // dropout mask on layer 0)
    auto conv_bwd = [&](int i, float (&acc)[NV]) {
      __syncthreads();                 // R1's readers are done
      {
        const int rb[2] = {r1_base(0), r1_base(1)};
#pragma unroll
        for (int pr = 0; pr < NPR; ++pr)
          *reinterpret_cast<float2*>(r1 + rb[pr & 1] + 8 * (pr >> 1)) =
              make_float2(acc[2 * pr], acc[2 * pr + 1]);
      }
      __syncthreads();
      const int cd = tid;
      float w[K], gdw[K], gdwb = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        w[j] = __ldg(P.dw(i) + j * D + cd);
        gdw[j] = 0.f;
      }
      const uint8_t* tcol = t_s + (cd >> 6) * TILE_PANEL;
      auto tv = [&](int r) {           // t v of tile row r, column cd
        return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                   tcol + tc::swz(r, cd & 63)))
               * v_s[r];
      };
      auto gc = [&](int r) -> float& { return r1[r * R1S + cd]; };
      for (int base = 0; base < rows; base += L) {
        float win[K], gq[K];           // rows l + j - pad: t v and g_c
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) {
          const int l = j - pad;
          const bool in = l >= 0 && l < L;
          win[j + 1] = in ? tv(base + l) : 0.f;
          gq[j + 1] = in ? gc(base + l) : 0.f;
        }
        for (int l = 0; l < L; ++l) {
#pragma unroll
          for (int j = 0; j + 1 < K; ++j) {
            win[j] = win[j + 1];
            gq[j] = gq[j + 1];
          }
          const bool in = l + pad < L;
          win[K - 1] = in ? tv(base + l + pad) : 0.f;
          gq[K - 1] = in ? gc(base + l + pad) : 0.f;
          const float g = gq[pad];
          gdwb += g;
#pragma unroll
          for (int j = 0; j < K; ++j) gdw[j] = fmaf(win[j], g, gdw[j]);
          float a = 0.f;
#pragma unroll
          for (int j = 0; j < K; ++j) a = fmaf(w[j], gq[K - 1 - j], a);
          gc(base + l) = a * v_s[base + l];
        }
      }
      float* run = dw_run + i * (MAX_K + 1) * D + cd;
#pragma unroll
      for (int j = 0; j < K; ++j) run[j * D] += gdw[j];
      run[MAX_K * D] += gdwb;
      __syncthreads();                 // g_t is whole
      const int rb[2] = {r1_base(0), r1_base(1)};
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1, q = pr >> 1;
        float2 a = make_float2(0.f, 0.f);
        if (valid[h]) {
          a = *reinterpret_cast<const float2*>(r1 + rb[h] + 8 * q);
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
    // input); the tile's scale and bias gradients of LN li summed over the
    // warps in order into the running sums, staged at stg ([warp][2][128]:
    // R2 for the final LN, whose g_y is consumed and whose readers bwd
    // waits for; T for the layers' LNs, whose t the depthwise pass read).  (g is a
    // generic parameter: spelled float (&)[NV] in this generic lambda,
    // nvcc 12.9's front end crashed.)
    auto ln_bwd = [&](auto fetch, auto& g, const float* scale, int li,
                      float* stg) {
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
        const int col = fold8_col(qb, lane);
        stg[(wid * 2) * 128 + col] = fold8(ts, lane);
        stg[(wid * 2 + 1) * 128 + col] = fold8(tb, lane);
      }
      row_sums(s1, s2);                // a barrier: the staging is whole
      for (int e = tid; e < 2 * D; e += NTHREADS) {
        const int v = e / D, c = e % D, w = c >> 7, lc = c & 127;
        float sum = 0.f;
#pragma unroll
        for (int wp = 0; wp < 4; ++wp)
          sum += stg[((4 * w + wp) * 2 + v) * 128 + lc];
        ln_run[(2 * li + v) * D + c] += sum;
      }
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
    auto from_h = [&](int pr) { return hs[pr * NTHREADS + tid]; };
    auto to_h = [&](const float (&hv)[NV]) {
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr)
        hs[pr * NTHREADS + tid] = make_float2(hv[2 * pr], hv[2 * pr + 1]);
    };

    // hv += relu(acc), the old hv from H (a product holds only acc)
    auto add_relu = [&](float (&hv)[NV], const float (&acc)[NV]) {
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const float2 h = from_h(pr);
        hv[2 * pr] = h.x + fmaxf(acc[2 * pr], 0.f);
        hv[2 * pr + 1] = h.y + fmaxf(acc[2 * pr + 1], 0.f);
      }
    };

    float hv[NV], acc[NV], ga[NV];
    uint32_t sg[NSG];
    // ---- pass A: layer 0 for h1, layer 1 for h2; h0, then h1 wait in H --
    load_h0(hv);
    to_h(hv);
    ln_to_r1(hv, P.ln_s(0), P.ln_b(0), true);
    __syncthreads();                   // R1 is whole
    conv(0, nullptr);
    fwd(0, acc, sg);
    add_relu(hv, acc);                                            // h1
    to_h(hv);
    ln_to_r1(hv, P.ln_s(1), P.ln_b(1), false);
    __syncthreads();
    conv(1, bufs.c[1]);
    t_copy();
    fwd(1, acc, sg);
    add_relu(hv, acc);                                            // h2
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
          mx = fmaxf(mx, r1[(base + l) * R1S + d] * m + (m - 1.f) * 1e10f);
        }
        float cnt = 0.f;
        for (int l = 0; l < L; ++l) {
          const float m = m_s[base + l];
          cnt += (r1[(base + l) * R1S + d] * m + (m - 1.f) * 1e10f) == mx
                     ? 1.f : 0.f;
        }
        const float g = __bfloat162float(
            gout[static_cast<size_t>(n0 + sq) * D + d]);
        for (int l = 0; l < L; ++l) {
          const float m = m_s[base + l];
          float& o = r1[(base + l) * R1S + d];
          const bool eq = (o * m + (m - 1.f) * 1e10f) == mx;
          o = (eq ? g : 0.f) / cnt * m;
        }
      }
      __syncthreads();
      const int rb[2] = {r1_base(0), r1_base(1)};
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1;
        const float2 g2 = valid[h]
            ? *reinterpret_cast<const float2*>(r1 + rb[h] + 8 * (pr >> 1))
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
           ga, P.lnf_s(), 2, reinterpret_cast<float*>(r2));
    // ---- layer 1 backward; the upper half of g_h2 waits in R2 (free once
    // the product has read g_y1) through the depthwise and LN passes ------
    bwd(1, [&](int pr) { return make_float2(ga[2 * pr], ga[2 * pr + 1]); },
        sg, bufs.gy[1], acc);
#pragma unroll
    for (int pr = NPR / 2; pr < NPR; ++pr)
      r2f[(pr - NPR / 2) * NTHREADS + tid] =
          make_float2(ga[2 * pr], ga[2 * pr + 1]);
    conv_bwd(1, acc);
    ln_bwd(from_h, acc, P.ln_s(1), 1, reinterpret_cast<float*>(t_s));
    // g_h1 = g_h2 + LN1's backward, into H for pass B
#pragma unroll
    for (int pr = 0; pr < NPR; ++pr) {
      const float2 g2 = pr < NPR / 2
          ? make_float2(ga[2 * pr], ga[2 * pr + 1])
          : r2f[(pr - NPR / 2) * NTHREADS + tid];
      hs[pr * NTHREADS + tid] =
          make_float2(g2.x + acc[2 * pr], g2.y + acc[2 * pr + 1]);
    }
    // ---- pass B: recompute layer 0 (dropout replayed), its backward; g_h1
    // waits in H, h0 is read again for LN0's backward ----------------------
    load_h0(hv);
    ln_to_r1(hv, P.ln_s(0), P.ln_b(0), true);
    __syncthreads();
    conv(0, bufs.c[0]);
    t_copy();
    fwd(0, acc, sg);
    bwd(0, from_h, sg, bufs.gy[0], acc);
    conv_bwd(0, acc);
    load_h0(hv);
    ln_bwd([&](int pr) { return make_float2(hv[2 * pr], hv[2 * pr + 1]); },
           acc, P.ln_s(0), 0, reinterpret_cast<float*>(t_s));
#pragma unroll
    for (int pr = 0; pr < NPR; ++pr) {  // d(x + pe)/dx = 1
      const int h = pr & 1, c = 8 * (pr >> 1) + cl;
      const float2 g1 = from_h(pr);
      if (valid[h])
        *reinterpret_cast<uint32_t*>(gx + grow[h] * D + c) = tc::pack_bf16(
            acc[2 * pr] + g1.x, acc[2 * pr + 1] + g1.y);
    }
  }
  // ---- the block's parameter-vector partials, written once ------------
  __syncthreads();                     // every running sum is final
  float* out = bufs.vec_part + static_cast<size_t>(blockIdx.x)
                               * vec_floats<D>(K);
  for (int idx = tid; idx < 6 * D; idx += NTHREADS) {
    const int s = idx / D, d = idx % D;            // s: ln0_s .. lnf_b
    const int off = s < 4 ? (s / 2) * (4 + K) * D + (s % 2) * D
                          : 2 * (4 + K) * D + (s - 4) * D;
    out[off + d] = ln_run[idx];
  }
  for (int i = 0; i < 2; ++i) {
    float* o = out + i * (4 + K) * D + 2 * D + tid;
    const float* run = dw_run + i * (MAX_K + 1) * D + tid;
    for (int j = 0; j < K; ++j) o[j * D] = run[j * D];
    o[K * D] = run[MAX_K * D];                     // dwb
    o[(K + 1) * D] = 0.f;                          // pwb: wgrad_tc's
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
  const int sms = sm_count();
  const int nseq = TM / L, tiles = (N + nseq - 1) / nseq;
  const int blocks = tiles < sms ? tiles : sms;
  cudaError_t err;
  if constexpr (D == 256) {   // the overload without k
    void (*kern)(const bf16*, const float*, const float*, const bf16*,
                 const float*, const float*, const bf16*, bf16*, TcWideBufs,
                 int, int, int, int, Dropout) =
        encoder_bwd_tc_wide_kernel<1, D>;
    switch (k) {
      case 3: kern = encoder_bwd_tc_wide_kernel<3, D>; break;
      case 5: kern = encoder_bwd_tc_wide_kernel<5, D>; break;
      case 7: kern = encoder_bwd_tc_wide_kernel<7, D>; break;
      case 9: kern = encoder_bwd_tc_wide_kernel<9, D>; break;
      default: break;
    }
    if ((err = allow_smem(kern, Enc256::SMEM)) != cudaSuccess)
      return static_cast<int>(err);
    kern<<<blocks, NTHREADS, Enc256::SMEM, stream>>>(
        static_cast<const bf16*>(x), pe, packed,
        static_cast<const bf16*>(pw), mask, zmask, static_cast<const bf16*>(g),
        static_cast<bf16*>(gx), bufs, N, G, L, nseq, drop);
  } else {
    constexpr int smem = EncTcW<D>::SMEM;
    void (*kern)(const bf16*, const float*, const float*, const bf16*,
                 const float*, const float*, const bf16*, bf16*, TcWideBufs,
                 int, int, int, int, int, Dropout) =
        encoder_bwd_tc_wide_kernel<1, D>;
    switch (k) {
      case 3: kern = encoder_bwd_tc_wide_kernel<3, D>; break;
      case 5: kern = encoder_bwd_tc_wide_kernel<5, D>; break;
      case 7: kern = encoder_bwd_tc_wide_kernel<7, D>; break;
      case 9: kern = encoder_bwd_tc_wide_kernel<9, D>; break;
      default: break;
    }
    if ((err = allow_smem(kern, smem)) != cudaSuccess)
      return static_cast<int>(err);
    kern<<<blocks, NTHREADS, smem, stream>>>(
        static_cast<const bf16*>(x), pe, packed,
        static_cast<const bf16*>(pw), mask, zmask, static_cast<const bf16*>(g),
        static_cast<bf16*>(gx), bufs, N, G, L, k, nseq, drop);
  }
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
// bf16, with the same arguments: x, g, gx bf16; pw is [pw0; pw1] (2, D, D)
// bf16 as they lie at D = 64, [pw0; pw1; pw0^T; pw1^T] (4, D, D) at 256;
// gpw (2, D + 1, D), each layer's gpwb as its last row (gvec's pwb entries
// are 0); c0, c1, gy0, gy1 bf16; vec_part (min(ceil(N / (64 / L)), SMs),
// 2 (4 + k) D + 2 D, + EncTcW<64>::ACC + EncTcW<64>::H at D = 64) float32;
// wg_part (wg_chunks, D + 1, D); work unused (may be NULL).  is_bf16 must
// be set.
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
