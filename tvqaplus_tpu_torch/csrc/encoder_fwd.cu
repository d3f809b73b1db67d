// Fused QANet encoder block, forward, with conv 0's dropout, in two modes:
// with the masked word-max folded in (reduce_mask), and with the full block
// output and an optional zero mask (the merged input encoder).
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_encoder.py
// (fused_encoder_block -> _forward / _fwd_kernel, :288; _block_fwd :251,
// _masked_max :279): reduce_mask mode is STAGE's cls_encoder, zero_mask /
// full-output mode its input_encoder over the merged qa/sub/vid streams.
// For each of the N = B*G sequences x (L x D), with v the sequence's row of
// the (G, L) zero mask (all ones without one):
//   h = x + pe
//   2 x [ t = LN_i(h) (training, i = 0: times the Philox dropout mask of
//         philox.cuh, keyed by the flat index of the (B*G*L, D) LN output,
//         over the true width and the group map, Dropout::row_key);
//         c = dwb_i + depthwise_k(t * v) zero-padded inside the sequence;
//         h = h + ReLU(c pw_i + pwb_i) ]
//   o = LN_f(h)                 (every LN: fast variance clipped at 0)
//   reduce mode: out[d] = max_l (o[l, d] * m[l] + (m[l] - 1) * 1e10)
//   full mode:   out[l, d] = o[l, d]
// In reduce mode a sequence whose mask is all zero gives -1e10 in every
// channel, out is (B, G, D) and the (B, G, L, D) block output is never
// written.  In full mode out is (B, G, L, D); rows where v is 0 are computed
// (finite) and are the caller's to slice away.  out has the activation type.
//
// D, the hidden width, is 64, 128 or 256 (a template parameter; the C
// entries take it and refuse any other width); a true width dv < D runs on
// inputs zero-padded to D (the LN statistics and the dropout keys over dv,
// philox.cuh).
//
// What bounds it on the H100: per sequence it reads L x D inputs (2 bytes
// each in bf16) and does the two pointwise D x D products, 4 * L * D * D
// FLOPs.  At the headline eval (4,000 sequences of 40) that is ~43 MB and
// ~10 GFLOP at D = 128, bound by bytes (~13 us); ~22 MB and ~2.6 GFLOP at
// D = 64, bytes (~7 us); ~83 MB and ~42 GFLOP at D = 256, operations
// (~42 us).  The full mode also writes L x D per sequence (1,680 sequences
// of 50 at the merged headline shapes: bound by bytes at every D, ~13 us at
// D = 128, ~6 us at 64, ~26 us at 256).  chip_smoke.py's kernel rows give
// the exact bounds beside the times.
//
// Two instantiations.
// * bfloat16 (what the main paths run), D = 128:
//   encoder_fwd_tc_kernel<D, k>, the backward's pass A (encoder_bwd.cu)
//   without the backward, on the same device functions (encoder_tc.cuh).
//   Both products are wgmma on bf16
//   operands with float32 sums, rounded where the TPU kernel's bf16 compute
//   mode rounds (c and pw, pallas_encoder.py:199-201); h and every LN
//   statistic stay float32.  A persistent block walks tiles of whole
//   sequences; each warpgroup owns 64 rows and all D columns, so a row's
//   LayerNorm is a sum over the thread's values and its quad, on the
//   accumulator registers, and the residual h never leaves them.  pw0 and
//   pw1 stay resident in shared memory (rounded to bf16 as each block loads
//   them from the float32 parameters, read MN-major); the LN output
//   t goes through the float32 tile R1 because the depthwise taps cross
//   rows (taps unrolled on the template K); c feeds its product from
//   registers.  Reduce mode puts the final LN output in R1 and takes each
//   (sequence, column)'s masked max in a column pass, since a sequence of
//   40 rows straddles the warpgroups; full mode stores bf16 rows from the
//   registers.  A tile has 128 rows (3 sequences of 40 use 94% of them, 2 of
//   50 78%) on two warpgroups, one block an SM; the next tile's x arrives
//   by cp.async while this one computes.  64-row tiles on one warpgroup at
//   two blocks an SM (x read straight from L2) took 0.41 ms at L 40, k 5
//   and 0.20 ms at L 50, k 7 against 0.26 and 0.18 ms here (PERF.md PR 6).
//   254-255 registers a thread, 0 bytes of spill (k 3..9); 163 KB of shared
//   memory.
// * bfloat16, D = 64: encoder_fwd_tc64_kernel<k, DROP>, the same rounding
//   sites and keys on a design of its own (the notes at the kernel): four
//   warpgroups a block, each on 64-row tiles of its own with named barriers
//   only, the conv by column into a bf16 tile, the masked max from
//   registers, full output through shared memory; DROP false, the serving
//   instantiation, holds no Philox code.
// * bfloat16, D = 256: encoder_fwd_tc_wide_kernel<k>.  The D = 128 design
//   does not fit: a warpgroup's 64 x 256 accumulator and residual would
//   take 256 registers a thread, and pw0 + pw1 (256 KB in bf16) with a
//   128-row float32 R1 (128 KB) are over the 227 KB a block may hold.  So a
//   tile is 64 rows (64 / L whole sequences) on both warpgroups, which
//   split its columns (128 each: 64 accumulator and 64 residual registers a
//   thread); a row's LayerNorm statistics are summed over both halves
//   through shared memory; c goes to a bf16 tile (the product's A, all 256
//   columns; its room holds the next tile's x in between).  pw0 and pw1
//   are rounded to bf16 once a call, into 16 slabs of 32 rows laid out as
//   in shared memory (w_slab_pack_kernel, wgmma.cuh), and come through the
//   copy engine's ring of seven slots (SlabRing: full / empty barriers, no
//   block barrier a slab; the next product's first slabs arrive during
//   this one's last).  Two CTAs on neighbouring SMs (a
//   cluster) take a pair of tiles and share every slab by multicast, so one
//   pass of W (256 KB from L2) serves two tiles: at the reduce headline
//   2,000 passes, 0.52 GB, where streaming pw in float32 once a tile read
//   2.1 GB.  216,176 bytes of shared memory.
// * float32: the exactness check, CUDA cores: one resident block per SM
//   walks the sequences (grid-stride).  At D <= 128 both pointwise matrices
//   and the sequence's h, t and c (3 x L x D) sit in shared memory, so
//   nothing but x in and the output touches device memory; at D = 256 the
//   matrices (2 x 256 KB) do not fit and each product stages its pw from L2
//   32 rows at a time (gemm_staged).  The products are float32 FMAs out of
//   shared memory (gemm_chunk), the taps read only rows 0..L-1 of t.
#include "encoder.cuh"
#include "encoder_tc.cuh"

namespace {

using namespace tvqa;

__host__ __device__ inline int rows_padded(int rpt) { return rpt * NWARPS; }

// float32: pw0 and pw1 stay resident in shared memory at D <= 128; at
// D = 256 (2 x 256 KB) each product stages its pw from L2, KC rows at a
// time.
template <int D>
constexpr bool F32_RESIDENT = D <= 128;

template <int D>
__host__ __device__ inline int smem_floats(int L, int k, int rpt) {
  return (F32_RESIDENT<D> ? 2 * D * D : KC * D) + 3 * rows_padded(rpt) * D
         + 2 * k * D + 2 * round4(L);
}

template <int D, int RPT>
__global__ void __launch_bounds__(NTHREADS)
encoder_fwd_kernel(const float* __restrict__ x, const float* __restrict__ pe,
                   const float* __restrict__ packed,
                   const float* __restrict__ mask,
                   const float* __restrict__ zmask, float* __restrict__ out,
                   int N, int G, int L, int k, Dropout drop) {
  constexpr bool RES = F32_RESIDENT<D>;
  constexpr int CPL = D / 32;            // GEMM output columns a lane
  drop.load_seed();
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // 2 x D x D, or KC x D
  const int LP = rows_padded(RPT);
  float* h_s = w_s + (RES ? 2 * D * D : KC * D);  // LP x D
  float* t_s = h_s + LP * D;
  float* c_s = t_s + LP * D;
  float* dw_s = c_s + LP * D;                         // 2 x k x D
  float* m_s = dw_s + 2 * k * D;                      // L (reduce mode)
  float* v_s = m_s + round4(L);                       // L
  const bool reduce = mask != nullptr;
  const EncParams<D> P(packed, k);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = 0; i < 2; ++i) {
    if (RES) {
      const float4* src = reinterpret_cast<const float4*>(P.pw[i]);
      float4* dst = reinterpret_cast<float4*>(w_s + i * D * D);
      for (int idx = tid; idx < D * D / 4; idx += NTHREADS)
        dst[idx] = src[idx];
    }
    for (int idx = tid; idx < k * D; idx += NTHREADS)
      dw_s[i * k * D + idx] = P.dw[i][idx];
  }
  // rows L..LP-1 of c are read by the GEMM and never written
  for (int idx = L * D + tid; idx < LP * D; idx += NTHREADS) c_s[idx] = 0.f;

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const size_t base = static_cast<size_t>(n) * L * D;
    for (int idx = tid; idx < L * D; idx += NTHREADS)
      h_s[idx] = x[base + idx] + pe[idx];
    if (reduce)
      for (int l = tid; l < L; l += NTHREADS)
        m_s[l] = mask[static_cast<size_t>(n) * L + l];
    load_zmask_row(v_s, zmask, n, G, L);
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < 2; ++i) {
      ln_rows<D>(h_s, t_s, L, P.ln_s[i], P.ln_b[i], warp, lane, drop.inv1);
      __syncthreads();
      if (i == 0 && drop.on()) {
        dropout_rows<D>(t_s, L, n, drop);
        __syncthreads();
      }
      dwconv_rows<D>(t_s, c_s, L, k, dw_s + i * k * D, P.dwb[i], v_s);
      __syncthreads();
      float acc[RPT][CPL];
      if constexpr (RES) {
#pragma unroll
        for (int j = 0; j < RPT; ++j)
#pragma unroll
          for (int t = 0; t < CPL; ++t) acc[j][t] = 0.f;
        gemm_chunk<RPT, D>(acc, c_s, D, 0, w_s + i * D * D, D, warp * RPT,
                           lane * CPL);
      } else {
        gemm_staged<RPT, D>(acc, c_s, D, D, P.pw[i], w_s, warp * RPT,
                            lane * CPL);
      }
      float bb[CPL];
      ld_cols<CPL>(bb, P.pwb[i] + lane * CPL);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = warp * RPT + j;
        if (r >= L) continue;
#pragma unroll
        for (int t = 0; t < CPL; ++t)
          h_s[r * D + lane * CPL + t] += fmaxf(acc[j][t] + bb[t], 0.f);
      }
      __syncthreads();
    }
    ln_rows<D>(h_s, t_s, L, P.lnf_s, P.lnf_b, warp, lane, drop.inv1);
    __syncthreads();
    if (reduce) {
      for (int d = tid; d < D; d += NTHREADS) {
        float mx = -CUDART_INF_F;
        for (int l = 0; l < L; ++l) {
          const float m = m_s[l];
          mx = fmaxf(mx, t_s[l * D + d] * m + (m - 1.f) * 1e10f);
        }
        out[static_cast<size_t>(n) * D + d] = mx;
      }
    } else {
      for (int idx = tid; idx < L * D; idx += NTHREADS)
        out[base + idx] = t_s[idx];
    }
    __syncthreads();                   // h_s / t_s / m_s / v_s reused next
  }
}

template <int D, int RPT>
int launch_rpt(const float* x, const float* pe, const float* packed,
               const float* mask, const float* zmask, float* out, int N,
               int G, int L, int k, Dropout drop, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<D>(L, k, RPT);
  auto kern = encoder_fwd_kernel<D, RPT>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = N < sms ? N : sms;
  kern<<<blocks, NTHREADS, bytes, stream>>>(x, pe, packed, mask, zmask, out,
                                            N, G, L, k, drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const float* x, const float* pe, const float* packed,
               const float* mask, const float* zmask, float* out, int N,
               int G, int L, int k, Dropout drop, cudaStream_t stream) {
#define TVQA_ENC_FWD(R)                                                      \
  case R:                                                                    \
    return launch_rpt<D, R>(x, pe, packed, mask, zmask, out, N, G, L, k,     \
                            drop, stream);
  switch ((L + NWARPS - 1) / NWARPS) {   // rows per warp in the GEMM
    TVQA_ENC_FWD(1)
    TVQA_ENC_FWD(2)
    TVQA_ENC_FWD(3)
    TVQA_ENC_FWD(4)
    TVQA_ENC_FWD(5)
    TVQA_ENC_FWD(6)
    TVQA_ENC_FWD(7)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TVQA_ENC_FWD
}

// ---- the bfloat16 instantiation: tensor cores, D = 64 and 128 --------------

constexpr int TR = 2 * TM;                          // rows of a tile
constexpr int X_PANEL = TR * tc::ROW_BYTES;

// Shared-memory layout: pw0, pw1 (bf16 panels); R1 (TR x D float32); the x
// tile being prefetched (bf16 panels); v and m of each row, twice (the
// tile's parity), so that a tile's rows are filled while the previous
// tile's column pass still reads its own.
template <int D>
struct EncTc {
  static_assert(D == 128, "D = 64 and 256 have designs of their own");
  static constexpr int PW_PANEL = D * tc::ROW_BYTES;  // panel of pw (D rows)
  static constexpr int PW_BYTES = (D / 64) * PW_PANEL;  // D x D bf16
  static constexpr int O_R1 = 2 * PW_BYTES;
  static constexpr int O_X = O_R1 + TR * D * 4;
  static constexpr int O_RV = O_X + (D / 64) * X_PANEL;
  static constexpr int SMEM = O_RV + 2 * 2 * TR * 4 + tc::ATOM_BYTES;
};

// A persistent block walks tiles of TR rows holding nseq whole sequences;
// warpgroup w owns rows [64 w, 64 w + 64) and all D columns.  K = k, the
// depthwise width, so that the taps unroll.
template <int D, int K>
__global__ void __launch_bounds__(NTHREADS, 1)
encoder_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ pe,
                      const float* __restrict__ packed,
                      const float* __restrict__ mask,
                      const float* __restrict__ zmask,
                      __nv_bfloat16* __restrict__ out, int N, int G, int L,
                      int nseq, Dropout drop) {
  using S = EncTc<D>;
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  float* r1 = reinterpret_cast<float*>(sm + S::O_R1);
  uint8_t* xs = sm + S::O_X;
  const bool reduce = mask != nullptr;
  const TcParams<K, D> P{packed};
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int cl = 2 * (lane & 3);
  int row[2];                                        // the thread's rows
#pragma unroll
  for (int h = 0; h < 2; ++h)
    row[h] = TM * wg + 16 * warp + (lane >> 2) + 8 * h;
  for (int i = 0; i < 2; ++i)
    tc_store_rows_f32<D>(sm + i * S::PW_BYTES, D, P.pw(i), D, tid,
                         NTHREADS);
  const int tiles = (N + nseq - 1) / nseq;
  // cp.async of the x rows of `tile` into the x tile (rows past its
  // sequences zeroed)
  auto load_x = [&](int tile) {
    const int n0 = tile * nseq;
    tc_load_rows<D>(xs, TR, x + static_cast<size_t>(n0) * L * D, D,
                    min(nseq, N - n0) * L, tid, NTHREADS);
  };
  if (static_cast<int>(blockIdx.x) < tiles) load_x(blockIdx.x);
  tc::cp_async_commit();

  int parity = 0;
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
    float* v_s = reinterpret_cast<float*>(sm + S::O_RV) + parity * 2 * TR;
    float* m_s = v_s + TR;
    parity ^= 1;
    if (tid < TR) {
      const bool ok = tid < rows;
      const int n = n0 + tid / L, l = tid % L;
      v_s[tid] = !ok ? 0.f
          : (zmask != nullptr ? zmask[static_cast<size_t>(n % G) * L + l]
                              : 1.f);
      m_s[tid] = ok && reduce ? mask[static_cast<size_t>(n) * L + l] : 0.f;
    }
    // conv 0's dropout: keep bits of the thread's D / 2 values, drawn once
    uint32_t kw[2][D / 64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int w = 0; w < D / 64; ++w) kw[h][w] = ~0u;
    if (drop.on())
      tc_keep_bits<D / 8, true>(drop,
                                drop.row_key((lane & 1) ? grow[1] : grow[0]),
                                lane, kw);
    tc::cp_async_wait<0>();            // this tile's x
    tc::fence_async_smem();            // pw (first tile) is read by wgmma
    __syncthreads();                   // ... and v, m of every row

    float hv[D / 2];
    enc_load_h0<D>(hv, [&](int h, int c) {
      return tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(
          xs + (c >> 6) * X_PANEL + tc::swz(row[h], c & 63)));
    }, pe, valid, lrow, cl);
    enc_ln_to_r1<D>(hv, P.ln_s(0), P.ln_b(0), true, kw, drop, r1, row, cl);
    __syncthreads();                   // R1 whole; the x tile read
    if (tile + static_cast<int>(gridDim.x) < tiles) load_x(tile + gridDim.x);
    tc::cp_async_commit();
#pragma unroll 1
    for (int i = 0; i < 2; ++i) {
      if (i == 1) {
        enc_ln_to_r1<D>(hv, P.ln_s(1), P.ln_b(1), false, kw, drop, r1, row,
                        cl);
        __syncthreads();               // R1 whole
      }
      // c = depthwise_i(t v) rounded to bf16, packed as wgmma's register A
      // fragments (depth step ks holds pairs 4 ks .. 4 ks + 3)
      uint32_t cf[D / 4];
#pragma unroll
      for (int pr = 0; pr < D / 4; ++pr) {
        const float2 a = enc_conv_pair<K, D>(r1, v_s, P.dw(i), P.dwb(i), row,
                                             lrow, valid, L, pr & 1,
                                             8 * (pr >> 1) + cl);
        cf[pr] = tc::pack_bf16(a.x, a.y);
      }
      float acc[D / 2];
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t a4[4] = {cf[4 * ks], cf[4 * ks + 1], cf[4 * ks + 2],
                                cf[4 * ks + 3]};
        tc::mma_rs<D, 1>(
            acc, a4,
            tc::make_desc(tc::smem_u32(sm) + i * S::PW_BYTES
                              + ks * 2 * tc::ATOM_BYTES, S::PW_PANEL),
            ks > 0);
      }
      tc::commit();
      __syncthreads();                 // every tap of R1 is read
      tc::wait_all();
#pragma unroll
      for (int j = 0; j < D / 2; ++j)
        hv[j] += fmaxf(acc[j] + __ldg(P.pwb(i) + acc_col(j, lane)), 0.f);
    }
    // ---- the final LN, then the masked max or the bf16 rows ---------------
    if (reduce) {
      enc_ln_to_r1<D>(hv, P.lnf_s(), P.lnf_b(), false, kw, drop, r1, row,
                      cl);
      __syncthreads();
      for (int idx = tid; idx < rows / L * D; idx += NTHREADS) {
        const int s = idx / D, d = idx % D, base = s * L;
        float mx = -CUDART_INF_F;
        for (int l = 0; l < L; ++l) {
          const float m = m_s[base + l];
          mx = fmaxf(mx, r1[r1_at<D>(base + l, d)] * m + (m - 1.f) * 1e10f);
        }
        out[static_cast<size_t>(n0 + s) * D + d] = __float2bfloat16(mx);
      }
    } else {
      enc_ln<D>(hv, P.lnf_s(), P.lnf_b(), false, kw, drop, cl,
                [&](int pr, float2 o) {
                  const int h = pr & 1;
                  if (valid[h])
                    *reinterpret_cast<uint32_t*>(out + grow[h] * D
                                                 + 8 * (pr >> 1) + cl) =
                        tc::pack_bf16(o.x, o.y);
                });
    }
  }
}

// ---- the bfloat16 instantiation at D = 64: warpgroups on tiles of their own
//
// At half width a thread holds 32 values of h and 32 of the accumulator, so
// the SM takes four warpgroups (512 threads at 128 registers; only K = 9
// spills, 20-28 bytes; three at 168 registers took 0.092 ms a reduce call
// against 0.082), and each walks 64-row tiles of its own (warpgroup w of
// block b takes tiles 4 b + w, 4 b + w + 4 G, ... over a grid of G
// blocks), 64 / L whole sequences each, at all 64 columns.  What the
// design does about the card:
// * No block barrier a tile: a row's LayerNorm sums are the thread's and
//   its quad's, and everything a tile shares lies in the warpgroup's room,
//   behind its named barrier (bar.sync 1 + w, 128), five a tile.  One
//   warpgroup's barriers and tensor-core waits lie under the others' row
//   passes.
// * The depthwise conv runs column by column: four threads a pair of
//   columns (warp w takes quarter w of every sequence's rows, lane l
//   columns 2 l and 2 l + 1) slide a window of the K taps of t v (t from
//   R1, float32, a float2 a row) down it, so each value is read once, and
//   write c in bf16 into the C tile, the product's A.  The sums keep
//   enc_conv_pair's order.  (Two threads a column, a float a row, as the
//   backward at this width has it, took 0.100 ms a reduce call against
//   0.093 with three warpgroups.)
// * Rows past the tile's sequences cost little in the row passes: a warp
//   whose 16 rows all lie past them (rows 48..63 at L 40) skips the loads,
//   the LayerNorms, the residual and the max, and takes part only in the
//   products and the barriers; the conv writes no c row past them (a
//   product's row reads only its own row of C, and those rows are never
//   stored).
// * The masked max from registers: each thread's values in its two rows,
//   a segmented suffix max over the warp's 16 rows by shuffles (a row takes
//   a partner's only inside its own sequence), so the first row of each
//   sequence's rows in the warp holds their max; it goes to H, and after
//   the warpgroup's barrier a (sequence, column) takes the max of its at
//   most four pieces.  No LN output tile and no 40-long chain of loads.
// * Full output through the C tile (read by the last product by then),
//   then whole 128-byte rows out, 16 bytes a thread.
// * The next tile's x comes by cp.async into X as soon as this tile's h0
//   is read, and its v and m into the other parity of their slots.
// * DROP false (serving) holds no Philox code; DROP true draws conv 0's
//   keep bits of the thread's values at the start of a tile.
// pw0 and pw1 stay resident in bf16 (rounded as each block loads them,
// read MN-major).  Shared memory: pw, then four rooms of 49 KB: 218,112
// bytes.
struct EncFwd64 {
  static constexpr int D = 64;
  static constexpr int NWG = 4;                       // warpgroups a block
  static constexpr int NT = 128 * NWG;                // threads a block
  static constexpr int PW = D * tc::ROW_BYTES;        // a resident pw
  static constexpr int O_PW = 0;                      // pw0, pw1 in bf16
  static constexpr int O_ROOM = O_PW + 2 * PW;
  // a warpgroup's room: C (the c tile in bf16; the output rows' staging),
  // X (the next tile's x), R1 (t, float32), H (the max's pieces, float32),
  // v and m of both parities
  static constexpr int R_C = 0;
  static constexpr int R_X = R_C + TILE_PANEL;
  static constexpr int R_R1 = R_X + TILE_PANEL;
  static constexpr int R_H = R_R1 + TM * D * 4;
  static constexpr int R_VM = R_H + TM * D * 4;
  static constexpr int A = tc::ATOM_BYTES;
  static constexpr int ROOM = (R_VM + 2 * 2 * TM * 4 + A - 1) / A * A;
  static constexpr int SMEM = O_ROOM + NWG * ROOM + tc::ATOM_BYTES;
  static_assert(ROOM % tc::ATOM_BYTES == 0 && O_ROOM % tc::ATOM_BYTES == 0,
                "C and X on 1024-byte boundaries");
  static_assert(SMEM <= 232448, "shared memory of a block");
};

template <int K, bool DROP>
__global__ void __launch_bounds__(EncFwd64::NT, 1)
encoder_fwd_tc64_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ pe,
                        const float* __restrict__ packed,
                        const float* __restrict__ mask,
                        const float* __restrict__ zmask,
                        __nv_bfloat16* __restrict__ out, int N, int G, int L,
                        int nseq, Dropout drop) {
  using S = EncFwd64;
  constexpr int D = S::D, NV = D / 2, NPR = NV / 2;
  constexpr int pad = K / 2;
  if (DROP) drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31, g8 = lane >> 2;
  const int cl = 2 * (lane & 3);
  uint8_t* room = sm + S::O_ROOM + wg * S::ROOM;
  uint8_t* c_s = room + S::R_C;
  uint8_t* x_s = room + S::R_X;
  float* r1 = reinterpret_cast<float*>(room + S::R_R1);
  float* h_s = reinterpret_cast<float*>(room + S::R_H);
  float* vm = reinterpret_cast<float*>(room + S::R_VM);  // [parity][v, m]
  const uint32_t pw_s = tc::smem_u32(sm + S::O_PW);
  const bool reduce = mask != nullptr;
  const TcParams<K, D> P{packed};
  int row[2];                                        // the thread's rows
#pragma unroll
  for (int h = 0; h < 2; ++h) row[h] = 16 * warp + g8 + 8 * h;
  auto wg_sync = [&]() { tc::bar_sync(1 + wg, 128); };
  // the warpgroup's tiles: w0, w0 + nw, ..
  const int tiles = (N + nseq - 1) / nseq;
  const int nw = S::NWG * gridDim.x, w0 = S::NWG * blockIdx.x + wg;
  auto rows_of = [&](int tile) { return min(nseq, N - tile * nseq) * L; };
  // the x rows of `tile` into X by cp.async (rows past its sequences
  // zeroed), the v and m of its rows into parity `par`
  auto load = [&](int tile, int par) {
    const int rows = rows_of(tile);
    tc_load_rows<D>(x_s, TM, x + static_cast<size_t>(tile) * nseq * L * D,
                    D, rows, t, 128);
    if (t < TM) {
      const bool ok = t < rows;
      const int n = tile * nseq + t / L, l = t % L;
      float* v_s = vm + par * 2 * TM;
      v_s[t] = !ok ? 0.f
          : (zmask != nullptr ? zmask[static_cast<size_t>(n % G) * L + l]
                              : 1.f);
      v_s[TM + t] = ok && reduce ? mask[static_cast<size_t>(n) * L + l]
                                 : 0.f;
    }
  };
  for (int i = 0; i < 2; ++i)         // pw_i rounded to bf16 as it lies
    tc_store_rows_f32<D>(sm + S::O_PW + i * S::PW, D, P.pw(i), D, tid,
                         S::NT);
  if (w0 < tiles) load(w0, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  tc::fence_async_smem();              // pw is read by wgmma
  __syncthreads();                     // pw; the first tile's x, v, m

  // the conv's share: column pair cp (columns 2 cp, 2 cp + 1), the rows
  // [lb, le) of every sequence (its quarter `warp`)
  const int cp = lane;
  const int lb = warp * L / 4, le = (warp + 1) * L / 4;
  int par = 0;
  for (int tile = w0; tile < tiles; tile += nw, par ^= 1) {
    const int n0 = tile * nseq, rows = rows_of(tile);
    const long long R0 = static_cast<long long>(n0) * L;
    const bool wlive = 16 * warp < rows;     // a row of this warp is live
    const float* v_s = vm + par * 2 * TM;
    const float* m_s = v_s + TM;
    bool valid[2];
    int lrow[2];
    long long grow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      valid[h] = row[h] < rows;
      lrow[h] = row[h] % L;
      grow[h] = R0 + (valid[h] ? row[h] : 0);
    }
    // conv 0's dropout: keep bits of the thread's values, drawn once
    uint32_t kw[2][1] = {{~0u}, {~0u}};
    if (DROP && wlive)
      tc_keep_bits<D / 8, true>(drop,
                                drop.row_key((lane & 1) ? grow[1] : grow[0]),
                                lane, kw);
    auto to_r1 = [&](int pr, float2 y) {
      *reinterpret_cast<float2*>(r1 + r1_at<D>(row[pr & 1],
                                               8 * (pr >> 1) + cl)) = y;
    };
    // c = depthwise_i(t of R1 times v) + dwb rounded to bf16 into C: a
    // window of the K taps' t v slides down the column pair (R1 whole)
    auto conv = [&](int i) {
      float2 w[K];
#pragma unroll
      for (int j = 0; j < K; ++j) w[j] = ldg2(P.dw(i) + j * D + 2 * cp);
      const float2 bias = ldg2(P.dwb(i) + 2 * cp);
      auto tv = [&](int r) {
        const float2 a = *reinterpret_cast<const float2*>(
            r1 + r1_at<D>(r, 2 * cp));
        const float vv = v_s[r];
        return make_float2(a.x * vv, a.y * vv);
      };
      for (int base = 0; base < rows; base += L) {
        float2 win[K];                 // win[j] = t v of row l + j - pad
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) {
          const int l = lb + j - pad;
          win[j + 1] = l >= 0 && l < L ? tv(base + l)
                                       : make_float2(0.f, 0.f);
        }
        for (int l = lb; l < le; ++l) {
#pragma unroll
          for (int j = 0; j + 1 < K; ++j) win[j] = win[j + 1];
          win[K - 1] = l + pad < L ? tv(base + l + pad)
                                   : make_float2(0.f, 0.f);
          float2 a = bias;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            a.x = fmaf(w[j].x, win[j].x, a.x);
            a.y = fmaf(w[j].y, win[j].y, a.y);
          }
          *reinterpret_cast<uint32_t*>(c_s + tc::swz(base + l, 2 * cp)) =
              tc::pack_bf16(a.x, a.y);
        }
      }
      tc::fence_async_smem();
    };
    // h += ReLU(c pw_i + pwb_i), c the C tile (whole); every warp takes
    // part in the product
    float hv[NV];
    auto layer = [&](int i) {
      float acc[NV];
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        tc::mma_ss<D, 0, 1>(
            acc, tc::make_desc(tc::smem_u32(c_s) + ks * 32, 16),
            tc::make_desc(pw_s + i * S::PW + ks * 2 * tc::ATOM_BYTES, S::PW),
            ks > 0);
      tc::commit();
      tc::wait_all();
      tc::fence_regs(acc);
      if (!wlive) return;
#pragma unroll
      for (int pr = 0; pr < NPR; ++pr) {
        const float2 b = ldg2(P.pwb(i) + 8 * (pr >> 1) + cl);
        hv[2 * pr] += fmaxf(acc[2 * pr] + b.x, 0.f);
        hv[2 * pr + 1] += fmaxf(acc[2 * pr + 1] + b.y, 0.f);
      }
    };

    // ---- layer 0: h0 = x + pe, LN_0 (times the dropout) into R1 --------
    if (wlive) {
      enc_load_h0<D>(hv, [&](int h, int c) {
        return tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(
            x_s + tc::swz(row[h], c)));
      }, pe, valid, lrow, cl);
      enc_ln<D>(hv, P.ln_s(0), P.ln_b(0), DROP, kw, drop, cl, to_r1);
    } else {
#pragma unroll
      for (int j = 0; j < NV; ++j) hv[j] = 0.f;
    }
    wg_sync();                         // R1 is whole; X is read
    if (tile + nw < tiles) load(tile + nw, par ^ 1);
    tc::cp_async_commit();
    conv(0);
    wg_sync();                         // C is whole; R1's taps are read
    layer(0);
    // ---- layer 1 ---------------------------------------------------------
    if (wlive) enc_ln<D>(hv, P.ln_s(1), P.ln_b(1), false, kw, drop, cl, to_r1);
    wg_sync();                         // R1 is whole
    conv(1);
    wg_sync();                         // C is whole
    layer(1);
    // ---- the final LN, then the masked max or the bf16 rows -------------
    if (reduce) {
      if (wlive) {
        // the masked values o m + (m - 1) 1e10 of the thread's two rows
        const float mr[2] = {m_s[row[0]], m_s[row[1]]};
        float val[NV];
        enc_ln<D>(hv, P.lnf_s(), P.lnf_b(), false, kw, drop, cl,
                  [&](int pr, float2 o) {
                    const float m = mr[pr & 1];
                    val[2 * pr] = o.x * m + (m - 1.f) * 1e10f;
                    val[2 * pr + 1] = o.y * m + (m - 1.f) * 1e10f;
                  });
        // a row's max over the rows after it in its sequence and in the
        // warp: first within each row half (lanes g8 + o), then half 0's
        // rows take half 1's first row (16 warp + 8) when it is theirs
        int last[2];                   // the last row of the row's sequence
#pragma unroll
        for (int h = 0; h < 2; ++h)
          last[h] = min(row[h] - lrow[h] + L, rows) - 1;
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int h = (j >> 1) & 1;
            const float p = __shfl_down_sync(0xffffffffu, val[j], 4 * o);
            if (g8 + o < 8 && row[h] + o <= last[h]) val[j] = fmaxf(val[j], p);
          }
        }
        const bool join = 16 * warp + 8 <= last[0];
#pragma unroll
        for (int j = 0; j < NV; j += 4) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = __shfl_sync(0xffffffffu, val[j + 2 + e], lane & 3);
            if (join) val[j + e] = fmaxf(val[j + e], p);
          }
        }
        // the first row of a sequence's rows in the warp keeps their max
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!valid[h] || (lrow[h] != 0 && (h == 1 || g8 != 0))) continue;
#pragma unroll
          for (int q = 0; q < NPR / 2; ++q)
            *reinterpret_cast<float2*>(h_s + row[h] * D + 8 * q + cl) =
                make_float2(val[4 * q + 2 * h], val[4 * q + 2 * h + 1]);
        }
      }
      tc::cp_async_wait<0>();          // the next tile's x
      wg_sync();                       // H holds every piece
      // a sequence's pieces start at its first row and at each warp's
      // first row after it
      for (int idx = t; idx < rows / L * D; idx += 128) {
        const int sq = idx / D, d = idx % D, first = sq * L;
        float mx = h_s[first * D + d];
        for (int r = (first / 16 + 1) * 16; r < first + L; r += 16)
          mx = fmaxf(mx, h_s[r * D + d]);
        out[static_cast<size_t>(n0 + sq) * D + d] = __float2bfloat16(mx);
      }
    } else {
      if (wlive)
        enc_ln<D>(hv, P.lnf_s(), P.lnf_b(), false, kw, drop, cl,
                  [&](int pr, float2 o) {
                    *reinterpret_cast<uint32_t*>(
                        c_s + tc::swz(row[pr & 1], 8 * (pr >> 1) + cl)) =
                        tc::pack_bf16(o.x, o.y);
                  });
      tc::cp_async_wait<0>();          // the next tile's x
      wg_sync();                       // the output tile is whole
      for (int q = t; q < rows * (D / 8); q += 128) {
        const int r = q >> 3, ch = q & 7;
        *reinterpret_cast<uint4*>(out + (R0 + r) * D + 8 * ch) =
            *reinterpret_cast<const uint4*>(c_s + tc::swz_chunk(r, ch));
      }
    }
  }
}

// ---- the bfloat16 instantiation at D = 256: pw through a ring, in pairs --
//
// A warpgroup's 64 x 256 float32 accumulator would take 128 registers a
// thread beside the residual's 128, and pw0 + pw1 (256 KB in bf16) do not
// fit in shared memory.  So a tile is 64 rows (nseq = 64 / L sequences) on
// both warpgroups, which split its columns: warpgroup wg owns columns
// [128 wg, 128 wg + 128), the residual h (64 values a thread) stays in its
// registers, and a row's LayerNorm sums both halves through shared memory
// (tri_row_pair_sums).  c goes to a bf16 tile (the product's A, all 256
// columns), whose room holds the next tile's x in between (its cp.async
// starts once the last product has read c).  pw0 and pw1 come rounded to
// bf16 once a call (the C entry's w_slab_pack_kernel: 16 slabs of 32 rows)
// through the copy engine's ring (SlabRing, wgmma.cuh; seven slots, no
// block barrier a slab).  Two CTAs on
// neighbouring SMs form a cluster and walk pairs of tiles, tile 2 p + rank,
// so one pass of W serves two tiles (two sequences at L 40 or 50): CTA 0
// copies every slab into both (multicast), halving W's L2 reads.  A CTA
// whose pair has no second tile runs an empty one (no rows), so that both
// take the same slabs.

constexpr int WD = 256;
struct EncWide {
  static constexpr int NSLOT = 7;                     // ring slots
  static constexpr int PER = 2 * WD / SLAB_ROWS;      // slabs a tile: 16
  static constexpr int O_R1 = 0;                      // 64 x 256 float32
  static constexpr int O_C = O_R1 + TM * WD * 4;      // c tile; x tile
  static constexpr int O_RING = O_C + (WD / 64) * TILE_PANEL;
  static constexpr int O_BAR = O_RING + NSLOT * SLAB_BYTES;  // full, empty
  static constexpr int O_EX = O_BAR + 2 * NSLOT * 8;  // [wg][row][2] sums
  static constexpr int O_RV = O_EX + 2 * TM * 2 * 4;  // v, m twice
  static constexpr int SMEM = O_RV + 2 * 2 * TM * 4 + tc::ATOM_BYTES;
  static_assert(O_RING % tc::ATOM_BYTES == 0, "slots on atoms");
  static_assert(SMEM <= 232448, "shared memory of a block");
  static_assert(WD == NTHREADS, "the conv: a column a thread");
};
using EncRing = SlabRing<EncWide::NSLOT, EncWide::PER, 2>;

template <int K>
__global__ void __launch_bounds__(NTHREADS, 1)
encoder_fwd_tc_wide_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ pe,
                           const float* __restrict__ packed,
                           const __nv_bfloat16* __restrict__ wp,
                           const float* __restrict__ mask,
                           const float* __restrict__ zmask,
                           __nv_bfloat16* __restrict__ out, int N, int G,
                           int L, int nseq, Dropout drop) {
  constexpr int D = WD;
  using S = EncWide;
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  float* r1 = reinterpret_cast<float*>(sm + S::O_R1);
  uint8_t* cs = sm + S::O_C;           // the x tile until conv 0
  float* ex = reinterpret_cast<float*>(sm + S::O_EX);
  const bool reduce = mask != nullptr;
  const TcParams<K, D> P{packed};
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int rl = 16 * warp + (lane >> 2);
  const int cl = 128 * wg + 2 * (lane & 3);         // the thread's columns
  const int row[2] = {rl, rl + 8};
  // the cluster walks pairs cid, cid + ncl, ..; this CTA tile 2 pair + rank
  const int rank = static_cast<int>(tc::cluster_rank());
  const int cid = static_cast<int>(tc::cluster_id());
  const int ncl = static_cast<int>(tc::cluster_count());
  const int tiles = (N + nseq - 1) / nseq, pairs = (tiles + 1) / 2;
  const int walk = (pairs - cid + ncl - 1) / ncl;
  EncRing ring;
  ring.init(sm + S::O_RING, reinterpret_cast<uint64_t*>(sm + S::O_BAR), wp,
            walk * S::PER);
  // the sequences of tile `tile`: n0 and the count (0 past the last tile)
  auto seqs = [&](int tile) { return max(0, min(nseq, N - tile * nseq)); };
  auto load_x = [&](int tile) {
    tc_load_rows<D>(cs, TM, x + static_cast<size_t>(tile) * nseq * L * D, D,
                    seqs(tile) * L, tid, NTHREADS);
  };
  // mean and 1 / std of the thread's rows over both warpgroups' columns
  // (one exchange: a block barrier)
  auto stats = [&](const float (&hv)[64], float (&mean)[2],
                   float (&istd)[2]) {
    mean[0] = mean[1] = istd[0] = istd[1] = 0.f;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      mean[(j >> 1) & 1] += hv[j];
      istd[(j >> 1) & 1] = fmaf(hv[j], hv[j], istd[(j >> 1) & 1]);
    }
    tri_row_pair_sums(ex, mean, istd, wg, rl, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] *= drop.inv1;
      istd[h] = rsqrtf(fmaxf(istd[h] * drop.inv1 - mean[h] * mean[h], 0.f)
                       + LN_EPS);
    }
  };
  auto to_r1 = [&](int pr, float2 y) {
    *reinterpret_cast<float2*>(r1 + r1_at<D>(row[pr & 1],
                                             8 * (pr >> 1) + cl)) = y;
  };
  load_x(2 * cid + rank);
  tc::cp_async_commit();
  tc::cluster_sync();                  // both CTAs' barriers are initialised
  ring.refill();

  int parity = 0;
  for (int it = 0, pair = cid; it < walk; ++it, pair += ncl) {
    const int tile = 2 * pair + rank;
    const int n0 = tile * nseq, rows = seqs(tile) * L;
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
    float* v_s = reinterpret_cast<float*>(sm + S::O_RV) + parity * 2 * TM;
    float* m_s = v_s + TM;
    parity ^= 1;
    if (tid < TM) {
      const bool ok = tid < rows;
      const int n = n0 + tid / L, l = tid % L;
      v_s[tid] = !ok ? 0.f
          : (zmask != nullptr ? zmask[static_cast<size_t>(n % G) * L + l]
                              : 1.f);
      m_s[tid] = ok && reduce ? mask[static_cast<size_t>(n) * L + l] : 0.f;
    }
    uint32_t kw[2][2] = {{~0u, ~0u}, {~0u, ~0u}};
    if (drop.on())
      tc_keep_bits<16, true>(
          drop, drop.row_key((lane & 1) ? grow[1] : grow[0]) + 128 * wg, lane,
                             kw);
    tc::cp_async_wait<0>();            // this tile's x
    __syncthreads();                   // ... and v, m of every row

    float hv[64], mean[2], istd[2];
    enc_load_h0<D>(hv, [&](int h, int c) {
      return tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(
          cs + (c >> 6) * TILE_PANEL + tc::swz(row[h], c & 63)));
    }, pe, valid, lrow, cl);
    stats(hv, mean, istd);
    enc_ln_apply(hv, mean, istd, P.ln_s(0), P.ln_b(0), true, kw, drop, cl,
                 to_r1);
    __syncthreads();                   // R1 whole; the x tile read
#pragma unroll 1
    for (int i = 0; i < 2; ++i) {
      if (i == 1) {
        stats(hv, mean, istd);
        enc_ln_apply(hv, mean, istd, P.ln_s(1), P.ln_b(1), false, kw, drop,
                     cl, to_r1);
        __syncthreads();               // R1 whole
      }
      // c = depthwise_i(t v) rounded to bf16 into the c tile, a column a
      // thread (D = NTHREADS)
      enc_conv_column<K, D>(cs, r1, v_s, P.dw(i), P.dwb(i), tid, rows, L);
      tc::fence_async_smem();
      __syncthreads();                 // the c tile whole; R1's taps read
      float acc[64];
      mma_ring_w<S::PER / 2>(acc, tc::smem_u32(cs), ring, wg, lane);
#pragma unroll
      for (int j = 0; j < 64; ++j)
        hv[j] += fmaxf(acc[j] + __ldg(P.pwb(i) + 128 * wg
                                      + acc_col(j, lane)), 0.f);
    }
    // ---- the final LN, then the masked max or the bf16 rows ---------------
    stats(hv, mean, istd);             // its barrier: c is read
    if (it + 1 < walk) load_x(2 * (pair + ncl) + rank);
    tc::cp_async_commit();
    if (reduce) {
      enc_ln_apply(hv, mean, istd, P.lnf_s(), P.lnf_b(), false, kw, drop, cl,
                   to_r1);
      __syncthreads();
      for (int idx = tid; idx < rows / L * D; idx += NTHREADS) {
        const int s = idx / D, d = idx % D, base = s * L;
        float mx = -CUDART_INF_F;
        for (int l = 0; l < L; ++l) {
          const float m = m_s[base + l];
          mx = fmaxf(mx, r1[r1_at<D>(base + l, d)] * m + (m - 1.f) * 1e10f);
        }
        out[static_cast<size_t>(n0 + s) * D + d] = __float2bfloat16(mx);
      }
    } else {
      enc_ln_apply(hv, mean, istd, P.lnf_s(), P.lnf_b(), false, kw, drop, cl,
                   [&](int pr, float2 o) {
                     const int h = pr & 1;
                     if (valid[h])
                       *reinterpret_cast<uint32_t*>(out + grow[h] * D
                                                    + 8 * (pr >> 1) + cl) =
                           tc::pack_bf16(o.x, o.y);
                   });
    }
  }
  tc::cluster_sync();                  // no CTA leaves while its pair copies
}

template <int D, int K>
int launch_tc_k(const void* x, const float* pe, const float* packed,
                const float* mask, const float* zmask, void* out, void* wp,
                int N, int G, int L, Dropout drop, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if constexpr (D == WD) {
    // pw0, pw1 rounded into their slabs, then clusters of two CTAs over
    // pairs of 64-row tiles, at most as many as the card holds at once
    auto kern = encoder_fwd_tc_wide_kernel<K>;
    static int most = 0;
    cudaError_t err = allow_smem(kern, EncWide::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (most == 0) most = pair_clusters(kern, EncWide::SMEM);
    if (most == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int layer = (4 + K) * D + D * D, pw0 = (3 + K) * D;
    w_slab_pack_kernel<D><<<dim3(D * D / 8 / NTHREADS, 2), NTHREADS, 0,
                            stream>>>(packed + pw0, packed + layer + pw0, D,
                                      static_cast<bf16*>(wp));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nseq = TM / L, pairs = ((N + nseq - 1) / nseq + 1) / 2;
    return static_cast<int>(launch_pairs(
        kern, pairs < most ? pairs : most, EncWide::SMEM, stream,
        static_cast<const bf16*>(x), pe, packed,
        static_cast<const bf16*>(wp), mask, zmask, static_cast<bf16*>(out),
        N, G, L, nseq, drop));
  } else if constexpr (D == 64) {
    // blocks of four warpgroups, each on 64-row tiles of its own; as many
    // as the tiles need, one an SM at most
    using S = EncFwd64;
    auto kern = drop.threshold != 0u ? encoder_fwd_tc64_kernel<K, true>
                                     : encoder_fwd_tc64_kernel<K, false>;
    cudaError_t err = allow_smem(kern, S::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int nseq = TM / L, tiles = (N + nseq - 1) / nseq;
    const int want = (tiles + S::NWG - 1) / S::NWG;
    kern<<<want < sms ? want : sms, S::NT, S::SMEM, stream>>>(
        static_cast<const bf16*>(x), pe, packed, mask, zmask,
        static_cast<bf16*>(out), N, G, L, nseq, drop);
    return static_cast<int>(cudaGetLastError());
  } else {
    // one persistent block an SM over tiles of TR rows
    auto kern = encoder_fwd_tc_kernel<D, K>;
    cudaError_t err = allow_smem(kern, EncTc<D>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int nseq = TR / L, tiles = (N + nseq - 1) / nseq;
    const int blocks = tiles < sms ? tiles : sms;
    kern<<<blocks, NTHREADS, EncTc<D>::SMEM, stream>>>(
        static_cast<const bf16*>(x), pe, packed, mask, zmask,
        static_cast<bf16*>(out), N, G, L, nseq, drop);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int D>
int launch_tc(const void* x, const float* pe, const float* packed,
              const float* mask, const float* zmask, void* out, void* wp,
              int N, int G, int L, int k, Dropout drop, cudaStream_t stream) {
#define TVQA_ENC_FWD_TC(KK)                                                  \
  case KK:                                                                   \
    return launch_tc_k<D, KK>(x, pe, packed, mask, zmask, out, wp, N, G, L,  \
                              drop, stream);
  switch (k) {
    TVQA_ENC_FWD_TC(1)
    TVQA_ENC_FWD_TC(3)
    TVQA_ENC_FWD_TC(5)
    TVQA_ENC_FWD_TC(7)
    TVQA_ENC_FWD_TC(9)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TVQA_ENC_FWD_TC
}

template <int D>
int launch_width(const void* x, const float* pe, const float* packed,
                 const float* mask, const float* zmask, void* out, void* wp,
                 int N, int G, int L, int k, Dropout drop, int is_bf16,
                 cudaStream_t st) {
  // the bf16 tile holds whole sequences: TR rows at D = 128, TM at 64 and
  // 256
  if (L > (D == 128 ? TR : TM)) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && D == WD && wp == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch_tc<D>(x, pe, packed, mask, zmask, out, wp, N, G, L, k,
                        drop, st);
  return launch_f32<D>(static_cast<const float*>(x), pe, packed, mask, zmask,
                       static_cast<float*>(out), N, G, L, k, drop, st);
}

int launch_any(const void* x, const void* pe, const void* packed,
               const void* mask, const void* zmask, void* out, void* wp,
               int N, int G, int L, int k, int D,
               const unsigned long long* drop_seed,
               unsigned drop_threshold, float drop_scale, int dv,
               const int* gmap, int g_glob, int is_bf16, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop = entry_dropout(
      drop_seed, drop_threshold, drop_scale, dv, gmap, G, g_glob, L);
  if (!width_ok(dv, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (k % 2 == 0 || k > ENC_MAX_K || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return launch_width<64>(x, f(pe), f(packed), f(mask), f(zmask), out,
                              wp, N, G, L, k, drop, is_bf16, st);
    case 128:
      return launch_width<128>(x, f(pe), f(packed), f(mask), f(zmask), out,
                               wp, N, G, L, k, drop, is_bf16, st);
    case 256:
      return launch_width<256>(x, f(pe), f(packed), f(mask), f(zmask), out,
                               wp, N, G, L, k, drop, is_bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: N = B*G sequences of L x D (bf16 when is_bf16, else float32), D one of
// 64, 128, 256; pe (L, D), packed parameters (ops/encoder.py PARAM_KEYS
// order) and mask (N, L) float32 (16-byte aligned); out (N, D) in x's type.
// wp: scratch for pw0 and pw1 in bf16 slabs (2 D D bf16, 16-byte aligned)
// of the bf16 kernel at D = 256, NULL otherwise.
// L <= 56, odd k <= 9.  Conv 0's dropout when drop_threshold > 0
// (philox.cuh).  bf16 x is 16-byte aligned.
// dv: the true width, 4 <= dv <= D with 4 | dv, of inputs zero-padded to D
// (every LN's statistics and the Philox keys, philox.cuh); gmap / g_glob the
// group map of the full-output mode (Dropout::row_key; NULL / 1 for none).
extern "C" int encoder_reduce_fwd(const void* x, const void* pe,
                                  const void* packed, const void* mask,
                                  void* out, void* wp, int N, int L, int k,
                                  int D, const unsigned long long* drop_seed,
                                  unsigned drop_threshold, float drop_scale,
                                  int dv, const int* gmap, int g_glob,
                                  int is_bf16, void* stream) {
  if (mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(x, pe, packed, mask, nullptr, out, wp, N, 1, L, k, D,
  drop_seed, drop_threshold, drop_scale, dv, gmap, g_glob,
  is_bf16, stream);
}

// The full block output: out (N, L, D) in x's type.  zmask (G, L) float32
// or NULL; sequence n uses its row n % G (N is a multiple of G).  Everything
// else as encoder_reduce_fwd.
extern "C" int encoder_block_fwd(const void* x, const void* pe,
                                 const void* packed, const void* zmask,
                                 void* out, void* wp, int N, int G, int L,
                                 int k, int D,
                                 const unsigned long long* drop_seed,
                                 unsigned drop_threshold, float drop_scale,
                                 int dv, const int* gmap, int g_glob,
                                 int is_bf16, void* stream) {
  if (G < 1 || N % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(x, pe, packed, nullptr, zmask, out, wp, N, G, L, k, D,
  drop_seed, drop_threshold, drop_scale, dv, gmap, g_glob,
  is_bf16, stream);
}
