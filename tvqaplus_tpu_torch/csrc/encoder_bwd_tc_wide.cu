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
// Two designs, every per-tile state on the SM in both:
// encoder_bwd_tc64_kernel at D = 64 (pw resident, the two warpgroups on
// tiles of their own) and encoder_bwd_tc_wide_kernel at D = 256 (pw
// streamed through a ring, the warpgroups splitting a tile's columns, the
// depthwise passes column by column); the notes at the kernels.
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

struct TcWideBufs {
  __nv_bfloat16 *c[2], *gy[2];         // (N*L, D): gpw's operands
  float* vec_part;                     // (gridDim.x, vec_floats)
};

// ---- the bfloat16 instantiation at D = 64: tensor cores -------------------
//
// One resident block an SM; each of its two warpgroups walks 64-row tiles
// of its own, 64 / L whole sequences each (warpgroup w of block b takes
// tiles 2 b + w, 2 b + w + 2 G, ... over a grid of G blocks), at all 64
// columns: a thread holds 32 values of two rows in the m64n64 accumulator
// layout, so a row's LayerNorm sums are its own and its quad's (no
// exchange between the warpgroups), and a warpgroup waits only on its own
// named barrier (bar.sync 1 + w, 128): the SM has two tiles in flight, and
// one warpgroup's barriers and tensor-core waits lie under the other's row
// passes.  What the design does about the card:
// * pw0 and pw1 stay resident in bf16 as they lie (16 KB): c pw reads them
//   MN-major, g_y pw^T K-major with g_y from registers (its tile never
//   exists).
// * The depthwise conv and its backward run column by column: two threads
//   a column (each half of every sequence's rows) slide a window of the K
//   taps down it, so each value is read once (the row by row passes read
//   it K times and ran a third of the kernel's time on the card); c goes
//   to a bf16 tile (the product's A), g_t to a float32 tile beside g_c, the
//   taps' weight gradients in the same pass.
// * Every per-tile state stays on the SM: a warpgroup's R1 (64 x 64
//   float32: the LN output t, the final LN's output and its cotangent,
//   then g_c), G (g_t), C (the c tile, bf16), T (t in bf16, for the
//   depthwise weight gradient), H (h1 in pass A, h0 in pass B, for the LN
//   backwards), v and m; the LN parameter sums run in a slot of each warp, the depthwise
//   sums in a slot of each column-pass thread, all in shared memory, and
//   go out once a block.
// * The row passes run over live rows only: a warp whose 16 rows all lie
//   past the tile's sequences (rows L..63 at L <= 48) skips them; it only
//   takes its part in the products and the barriers (rows are independent
//   through every product, and no conv tap or max leaves a sequence).
// * The masked max of the reduce mode takes two lanes a column, each over
//   half the sequence's rows: one pass for the max and the count of its
//   ties (the pair's combined by a shuffle), one for the gradient.
// * pw is rounded to bf16 as each block loads it (from the packed
//   float32 parameters): the wrapper casts nothing.
// Shared memory: pw (16 KB), two warpgroup rooms of 65 KB, the sums (32
// KB): 179 KB.
struct Enc64 {
  static constexpr int D = 64;
  static constexpr int NV = D / 2;                  // a thread's values
  static constexpr int PW = D * tc::ROW_BYTES;      // a resident pw
  // a warpgroup's room: C and T (bf16 tiles), R1, G and H (float32), v
  // and m
  static constexpr int R_C = 0;
  static constexpr int R_T = R_C + TM * D * 2;
  static constexpr int R_R1 = R_T + TM * D * 2;
  static constexpr int R_G = R_R1 + TM * D * 4;
  static constexpr int R_H = R_G + TM * D * 4;
  static constexpr int R_VM = R_H + TM * D * 4;
  static constexpr int A = tc::ATOM_BYTES;
  static constexpr int ROOM = (R_VM + 2 * TM * 4 + A - 1) / A * A;
  static constexpr int O_PW = 0;
  static constexpr int O_ROOM = O_PW + 2 * PW;
  // the LN sums [warp][ln0_s, ln0_b, ln1_s, ln1_b, lnf_s, lnf_b][D], then
  // the depthwise sums [wg][part][layer][tap 0 .. MAX_K - 1, dwb][D]
  static constexpr int NPART = 128 / D;             // threads of a column
  static constexpr int O_LN = O_ROOM + 2 * ROOM;
  static constexpr int O_DW = O_LN + NWARPS * 6 * D * 4;
  static constexpr int O_END = O_DW + 2 * NPART * 2 * (MAX_K + 1) * D * 4;
  static constexpr int SMEM = O_END + tc::ATOM_BYTES;
  static_assert(ROOM % tc::ATOM_BYTES == 0 && O_ROOM % tc::ATOM_BYTES == 0,
                "C and T on 1024-byte boundaries");
};

template <int K>
__global__ void __launch_bounds__(NTHREADS, 1)
encoder_bwd_tc64_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ pe,
                        const float* __restrict__ packed,
                        const __nv_bfloat16* __restrict__ pw,
                        const float* __restrict__ mask,
                        const float* __restrict__ zmask,
                        const __nv_bfloat16* __restrict__ gout,
                        __nv_bfloat16* __restrict__ gx, TcWideBufs bufs,
                        int N, int G, int L, int nseq, Dropout drop) {
  using S = Enc64;
  constexpr int D = S::D, NV = S::NV, NPR = NV / 2, NQ = NPR / 2;
  constexpr int pad = K / 2;
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31, wid = tid >> 5;
  const int cl = 2 * (lane & 3);
  uint8_t* room = sm + S::O_ROOM + wg * S::ROOM;
  uint8_t* c_s = room + S::R_C;
  uint8_t* t_s = room + S::R_T;
  float* r1 = reinterpret_cast<float*>(room + S::R_R1);
  float* g_s = reinterpret_cast<float*>(room + S::R_G);
  float2* hs = reinterpret_cast<float2*>(room + S::R_H);   // [pair][t]
  float* v_s = reinterpret_cast<float*>(room + S::R_VM);
  float* m_s = v_s + TM;
  float* ln_sums = reinterpret_cast<float*>(sm + S::O_LN) + wid * 6 * D;
  float* dw_sums = reinterpret_cast<float*>(sm + S::O_DW);
  const uint32_t pw_s = tc::smem_u32(sm + S::O_PW);
  const bool reduce = mask != nullptr;
  const TcParams<K, D> P{packed};
  int row[2];                                        // the thread's rows
#pragma unroll
  for (int h = 0; h < 2; ++h) row[h] = 16 * warp + (lane >> 2) + 8 * h;
  auto wg_sync = [&]() { tc::bar_sync(1 + wg, 128); };
  for (int i = 0; i < 2; ++i)         // pw_i rounded to bf16 as it lies
    tc_store_rows_f32<D>(sm + S::O_PW + i * S::PW, D, P.pw(i), D, tid,
                         NTHREADS);
  {
    float* sums = reinterpret_cast<float*>(sm + S::O_LN);
    for (int idx = tid; idx < (S::O_DW - S::O_LN) / 4
                              + 2 * S::NPART * 2 * (MAX_K + 1) * D;
         idx += NTHREADS)
      sums[idx] = 0.f;
  }
  tc::fence_async_smem();              // pw is read by wgmma
  __syncthreads();

  const int tiles = (N + nseq - 1) / nseq;
  for (int tile = 2 * blockIdx.x + wg; tile < tiles; tile += 2 * gridDim.x) {
    const int n0 = tile * nseq, rows = min(nseq, N - n0) * L;
    const long long R0 = static_cast<long long>(n0) * L;
    const bool wlive = 16 * warp < rows;     // a row of this warp is live
    bool valid[2];
    int lrow[2];
    long long grow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      valid[h] = row[h] < rows;
      lrow[h] = row[h] % L;
      grow[h] = R0 + (valid[h] ? row[h] : 0);
    }
    if (t < TM) {                      // (its readers end at a barrier)
      const bool ok = t < rows;
      const int n = n0 + t / L, l = t % L;
      v_s[t] = !ok ? 0.f
          : (zmask != nullptr ? zmask[static_cast<size_t>(n % G) * L + l]
                              : 1.f);
      m_s[t] = ok && reduce ? mask[static_cast<size_t>(n) * L + l] : 0.f;
    }
    // conv 0's dropout: keep bits of the thread's values, drawn once
    uint32_t kw[2][1] = {{~0u}, {~0u}};
    if (drop.on() && wlive)
      tc_keep_bits<NQ, true>(drop,
                             drop.row_key((lane & 1) ? grow[1] : grow[0]),
                             lane, kw);
    auto keep = [&](int h, int q, int e) {
      return !drop.on() ? 1.f
          : ((kw[h][0] >> (4 * q + e)) & 1u ? drop.scale : 0.f);
    };
    wg_sync();                         // v and m

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
    // LN_i(hv) (times conv 0's dropout on layer 0; the final LN for lnf)
    // into R1, and in bf16 into T when t2 (the depthwise weight gradient's
    // t); its row statistics the thread's and its quad's (fast variance,
    // clipped)
    auto ln_to_r1 = [&](const float (&hv)[NV], const float* sc,
                        const float* bi, bool drop0, bool t2) {
      float mean[2] = {0.f, 0.f}, istd[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        mean[(j >> 1) & 1] += hv[j];
        istd[(j >> 1) & 1] = fmaf(hv[j], hv[j], istd[(j >> 1) & 1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mean[h] = quad_sum(mean[h]) * drop.inv1;
        istd[h] = rsqrtf(fmaxf(quad_sum(istd[h]) * drop.inv1
                               - mean[h] * mean[h], 0.f) + LN_EPS);
      }
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
        if (t2)
          *reinterpret_cast<uint32_t*>(t_s + tc::swz(row[h], c)) =
              tc::pack_bf16(y0, y1);
      }
    };
    // two threads a column: column cd, the rows [lb, le) of every
    // sequence
    const int cd = t & (D - 1), hf = t / D;
    const int lb = hf ? (L + 1) / 2 : 0, le = hf ? L : (L + 1) / 2;
    // c = depthwise_i(t of R1 times v) + dwb rounded to bf16 into C (the
    // product's A), and out as rows when c_rows is not NULL: a window of
    // the K taps' t v slides down the column; rows past the sequences get
    // dwb.  R1 must be whole.
    auto conv = [&](int i, __nv_bfloat16* c_rows) {
      float w[K];
#pragma unroll
      for (int j = 0; j < K; ++j) w[j] = __ldg(P.dw(i) + j * D + cd);
      const float bias = __ldg(P.dwb(i) + cd);
      auto tv = [&](int r) { return r1[r1_at<D>(r, cd)] * v_s[r]; };
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
          float a = bias;
#pragma unroll
          for (int j = 0; j < K; ++j) a = fmaf(w[j], win[j], a);
          const __nv_bfloat16 cb = __float2bfloat16(a);
          *reinterpret_cast<__nv_bfloat16*>(c_s + tc::swz(base + l, cd)) = cb;
          if (c_rows != nullptr) c_rows[(R0 + base + l) * D + cd] = cb;
        }
      }
      if (hf == 0)
        for (int r = rows; r < TM; ++r)
          *reinterpret_cast<__nv_bfloat16*>(c_s + tc::swz(r, cd)) =
              __float2bfloat16(bias);
    };
    // y = c pw_i + pwb_i in acc (c the C tile, complete and fenced), and
    // its ReLU sign bits (bit j of sg for value j)
    auto fwd = [&](int i, float (&acc)[NV], uint32_t& sg) {
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        tc::mma_ss<64, 0, 1>(
            acc, tc::make_desc(tc::smem_u32(c_s) + ks * 32, 16),
            tc::make_desc(pw_s + i * S::PW + ks * 2 * tc::ATOM_BYTES, S::PW),
            ks > 0);
      tc::commit();
      tc::wait_all();
      tc::fence_regs(acc);
      sg = 0u;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        acc[j] += __ldg(P.pwb(i) + acc_col(j, lane));
        if (acc[j] > 0.f) sg |= 1u << j;
      }
    };
    // g_y = g (y > 0) rounded to bf16 (A from registers, rows out), then
    // acc = g_y pw_i^T
    auto bwd = [&](int i, const float (&g)[NV], uint32_t sg,
                   __nv_bfloat16* gy_rows, float (&acc)[NV]) {
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t f[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pr = 4 * ks + u, h = pr & 1, c = 8 * (pr >> 1) + cl;
          const uint32_t bits = sg >> (2 * pr);
          f[u] = tc::pack_bf16(bits & 1u ? g[2 * pr] : 0.f,
                               bits & 2u ? g[2 * pr + 1] : 0.f);
          if (valid[h])
            *reinterpret_cast<uint32_t*>(gy_rows + grow[h] * D + c) = f[u];
        }
        tc::mma_rs<64, 0>(
            acc, f, tc::make_desc(pw_s + i * S::PW + ks * 32, 16), ks > 0);
      }
      tc::commit();
      tc::wait_all();
      tc::fence_regs(acc);
    };
    // acc (g_c) into R1; after a barrier the column pass: a window of the
    // K taps' t v (T's bf16 t) and one of g_c slide down the column, giving
    // the depthwise weight gradients (into the thread's running sums) and
    // g_t = v sum_j dw[j] g_c[l - j + pad] into G; after a barrier acc =
    // g_t (times the dropout mask on layer 0)
    auto conv_bwd = [&](int i, float (&acc)[NV]) {
      if (wlive) {
#pragma unroll
        for (int pr = 0; pr < NPR; ++pr) {
          const int h = pr & 1, c = 8 * (pr >> 1) + cl;
          *reinterpret_cast<float2*>(r1 + r1_at<D>(row[h], c)) =
              make_float2(acc[2 * pr], acc[2 * pr + 1]);
        }
      }
      wg_sync();                       // g_c is whole
      float w[K], gdw[K], gdwb = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        w[j] = __ldg(P.dw(i) + j * D + cd);
        gdw[j] = 0.f;
      }
      auto tv = [&](int r) {           // t v of tile row r, column cd
        return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                   t_s + tc::swz(r, cd)))
               * v_s[r];
      };
      auto gc = [&](int r) { return r1[r1_at<D>(r, cd)]; };
      for (int base = 0; base < rows; base += L) {
        float win[K], gq[K];           // rows l + j - pad: t v and g_c
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) {
          const int l = lb + j - pad;
          const bool in = l >= 0 && l < L;
          win[j + 1] = in ? tv(base + l) : 0.f;
          gq[j + 1] = in ? gc(base + l) : 0.f;
        }
        for (int l = lb; l < le; ++l) {
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
          g_s[r1_at<D>(base + l, cd)] = a * v_s[base + l];
        }
      }
      float* dsum = dw_sums
                    + ((wg * S::NPART + hf) * 2 + i) * (MAX_K + 1) * D + cd;
#pragma unroll
      for (int j = 0; j < K; ++j) dsum[j * D] += gdw[j];
      dsum[MAX_K * D] += gdwb;
      wg_sync();                       // g_t is whole
      if (!wlive) return;
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = 8 * q + cl;
        float2 a = make_float2(0.f, 0.f);
        if (valid[h]) {
          a = *reinterpret_cast<const float2*>(g_s + r1_at<D>(row[h], c));
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
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mean[h] = quad_sum(mean[h]) * drop.inv1;
        istd[h] = rsqrtf(fmaxf(quad_sum(istd[h]) * drop.inv1
                               - mean[h] * mean[h], 0.f) + LN_EPS);
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
        gacc[col] += fold8(ts, lane);
        gacc[D + col] += fold8(tb, lane);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s1[h] = quad_sum(s1[h]) * drop.inv1;
        s2[h] = quad_sum(s2[h]) * drop.inv1;
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
    auto from_h = [&](int pr) { return hs[pr * 128 + t]; };
    auto to_h = [&](const float (&hv)[NV]) {
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr)
        hs[pr * 128 + t] = make_float2(hv[2 * pr], hv[2 * pr + 1]);
    };

    float hv[NV], acc[NV], ga[NV];
    uint32_t sg = 0u;
    // ---- pass A: layer 0 for h1, layer 1 with its stash -----------------
    if (wlive) {
      load_h0(hv);
      ln_to_r1(hv, P.ln_s(0), P.ln_b(0), true, false);
    }
    wg_sync();                         // R1 is whole
    conv(0, nullptr);
    tc::fence_async_smem();
    wg_sync();                         // C is whole; R1's taps are read
    fwd(0, acc, sg);
    if (wlive) {
#pragma unroll
      for (int j = 0; j < NV; ++j) hv[j] += fmaxf(acc[j], 0.f);   // h1
      to_h(hv);
      ln_to_r1(hv, P.ln_s(1), P.ln_b(1), false, true);
    }
    wg_sync();
    conv(1, bufs.c[1]);
    tc::fence_async_smem();
    wg_sync();
    fwd(1, acc, sg);
    if (wlive) {
#pragma unroll
      for (int j = 0; j < NV; ++j) hv[j] += fmaxf(acc[j], 0.f);   // h2
    }
    // ---- the output's cotangent (reduce mode: final LN and masked-max
    // backward), final-LN backward -------------------------------------
    if (reduce) {
      if (wlive) ln_to_r1(hv, P.lnf_s(), P.lnf_b(), false, false);
      wg_sync();
      // two neighbouring lanes a column of a sequence, each over half its
      // rows: the max and the count of its ties, then the pair's
      for (int idx = t; idx < rows / L * 2 * D; idx += 128) {
        const int sq = idx / (2 * D), d = idx % (2 * D) >> 1, base = sq * L;
        const int lb = idx & 1 ? (L + 1) / 2 : 0;
        const int le = idx & 1 ? L : (L + 1) / 2;
        float mx = -CUDART_INF_F, cnt = 0.f;
        for (int l = lb; l < le; ++l) {
          const float m = m_s[base + l];
          const float o = r1[r1_at<D>(base + l, d)] * m + (m - 1.f) * 1e10f;
          cnt = o > mx ? 1.f : (o == mx ? cnt + 1.f : cnt);
          mx = fmaxf(mx, o);
        }
        const float omx = __shfl_xor_sync(0xffffffffu, mx, 1);
        const float ocnt = __shfl_xor_sync(0xffffffffu, cnt, 1);
        cnt = mx > omx ? cnt : (mx < omx ? ocnt : cnt + ocnt);
        mx = fmaxf(mx, omx);
        const float g = __bfloat162float(
            gout[static_cast<size_t>(n0 + sq) * D + d]);
        for (int l = lb; l < le; ++l) {
          const float m = m_s[base + l];
          float& o = r1[r1_at<D>(base + l, d)];
          const bool eq = (o * m + (m - 1.f) * 1e10f) == mx;
          o = (eq ? g : 0.f) / cnt * m;
        }
      }
      wg_sync();
      if (wlive) {
#pragma unroll
        for (int pr = 0; pr < NPR; ++pr) {
          const int h = pr & 1, c = 8 * (pr >> 1) + cl;
          const float2 g2 = valid[h]
              ? *reinterpret_cast<const float2*>(r1 + r1_at<D>(row[h], c))
              : make_float2(0.f, 0.f);
          ga[2 * pr] = g2.x;
          ga[2 * pr + 1] = g2.y;
        }
      }
    } else if (wlive) {
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
    if (wlive) {
      ln_bwd([&](int pr) { return make_float2(hv[2 * pr], hv[2 * pr + 1]); },
             ga, P.lnf_s(), ln_sums + 4 * D);
    } else {
#pragma unroll
      for (int j = 0; j < NV; ++j) ga[j] = 0.f;
    }
    // ---- layer 1 backward -----------------------------------------------
    bwd(1, ga, sg, bufs.gy[1], acc);
    conv_bwd(1, acc);
    if (wlive) {
      ln_bwd(from_h, acc, P.ln_s(1), ln_sums + 2 * D);
#pragma unroll
      for (int j = 0; j < NV; ++j) ga[j] += acc[j];               // g_h1
    }
    // ---- pass B: recompute layer 0 (dropout replayed), its backward
    // (R1's and T's readers of layer 1 end at conv_bwd's last barrier) --
    if (wlive) {
      load_h0(hv);
      to_h(hv);
      ln_to_r1(hv, P.ln_s(0), P.ln_b(0), true, true);
    }
    wg_sync();
    conv(0, bufs.c[0]);
    tc::fence_async_smem();
    wg_sync();
    fwd(0, acc, sg);
    bwd(0, ga, sg, bufs.gy[0], acc);
    conv_bwd(0, acc);
    if (wlive) {
      ln_bwd(from_h, acc, P.ln_s(0), ln_sums);
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {  // d(x + pe)/dx = 1
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        if (valid[h])
          *reinterpret_cast<uint32_t*>(gx + grow[h] * D + c) =
              tc::pack_bf16(acc[2 * pr] + ga[2 * pr],
                            acc[2 * pr + 1] + ga[2 * pr + 1]);
      }
    }
  }

  // ---- the block's parameter-vector partials, written once: the warps'
  // and the column parts' sums in a fixed order ------------------------
  __syncthreads();                     // every running sum is final
  const float* lns = reinterpret_cast<const float*>(sm + S::O_LN);
  float* out = bufs.vec_part + static_cast<size_t>(blockIdx.x)
                               * vec_floats<D>(K);
  for (int idx = tid; idx < 6 * D; idx += NTHREADS) {
    const int s = idx / D, d = idx % D;            // s: ln0_s .. lnf_b
    float acc_s = 0.f;
    for (int wp = 0; wp < NWARPS; ++wp) acc_s += lns[(wp * 6 + s) * D + d];
    const int off = s < 4 ? (s / 2) * (4 + K) * D + (s % 2) * D
                          : 2 * (4 + K) * D + (s - 4) * D;
    out[off + d] = acc_s;
  }
  for (int idx = tid; idx < 2 * (K + 2) * D; idx += NTHREADS) {
    const int s = idx / D, d = idx % D;
    const int i = s / (K + 2), j = s % (K + 2);    // j: taps, dwb, pwb
    const int jj = j < K ? j : MAX_K;
    float acc_s = 0.f;
    for (int p = 0; p < 2 * S::NPART; ++p)
      acc_s += dw_sums[(p * 2 + i) * (MAX_K + 1) * D + jj * D + d];
    out[i * (4 + K) * D + (2 + j) * D + d] =
        j == K + 1 ? 0.f : acc_s;                  // pwb: wgrad_tc's
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
  // D = 64: two warpgroups a block, each on tiles of its own
  const int units = D == 64 ? (tiles + 1) / 2 : tiles;
  const int blocks = units < sms ? units : sms;
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
  } else {    // D = 64: a block's two warpgroups take tiles of their own
    void (*kern)(const bf16*, const float*, const float*, const bf16*,
                 const float*, const float*, const bf16*, bf16*, TcWideBufs,
                 int, int, int, int, Dropout) = encoder_bwd_tc64_kernel<1>;
    switch (k) {
      case 3: kern = encoder_bwd_tc64_kernel<3>; break;
      case 5: kern = encoder_bwd_tc64_kernel<5>; break;
      case 7: kern = encoder_bwd_tc64_kernel<7>; break;
      case 9: kern = encoder_bwd_tc64_kernel<9>; break;
      default: break;
    }
    if ((err = allow_smem(kern, Enc64::SMEM)) != cudaSuccess)
      return static_cast<int>(err);
    kern<<<blocks, NTHREADS, Enc64::SMEM, stream>>>(
        static_cast<const bf16*>(x), pe, packed,
        static_cast<const bf16*>(pw), mask, zmask, static_cast<const bf16*>(g),
        static_cast<bf16*>(gx), bufs, N, G, L, nseq, drop);
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
// bf16, with the same arguments: x, g, gx bf16; pw is unused at D = 64
// (may be NULL: the kernel rounds pw0 and pw1 from packed) and
// [pw0; pw1; pw0^T; pw1^T] (4, D, D) bf16 at 256;
// gpw (2, D + 1, D), each layer's gpwb as its last row (gvec's pwb entries
// are 0); c0, c1, gy0, gy1 bf16; vec_part (min(ceil(N / (64 / L)), SMs),
// 2 (4 + k) D + 2 D) float32 (at D = 64 min(ceil(tiles / 2), SMs) rows: a
// block's two warpgroups take tiles of their own);
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
