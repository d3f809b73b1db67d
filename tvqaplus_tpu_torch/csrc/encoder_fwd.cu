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
//         philox.cuh, keyed by the flat index of the (B*G*L, D) LN output);
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
// What bounds it on the H100: per sequence it reads L x D inputs (2 bytes
// each in bf16) and does the two pointwise D x D products, 4 * L * D * D
// FLOPs (~43 MB and ~10 GFLOP at the headline eval, 4,000 sequences of 40),
// so at the card's peaks it is bound by bytes (~13 us); the full mode also
// writes L x D per sequence (1,680 sequences of 50 at the merged headline
// shapes: ~43 MB, ~5.5 GFLOP, bound by bytes too, ~13 us).
//
// Two instantiations.
// * bfloat16 (what the main paths run): encoder_fwd_tc_kernel, the
//   backward's pass A (encoder_bwd.cu) without the backward, on the same
//   device functions (encoder_tc.cuh).  Both products are wgmma on bf16
//   operands with float32 sums, rounded where the TPU kernel's bf16 compute
//   mode rounds (c and pw, pallas_encoder.py:199-201); h and every LN
//   statistic stay float32.  A persistent block walks tiles of whole
//   sequences; each warpgroup owns 64 rows and all 128 columns, so a row's
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
//   254-255 registers a thread, 0 bytes of spill (every k); 163 KB of
//   shared memory.
// * float32: the exactness check, CUDA cores: one resident block per SM
//   walks the sequences (grid-stride).  Both pointwise matrices (2 x 64 KB)
//   and the sequence's h, t and c (3 x L x D) sit in shared memory, so
//   nothing but x in and the output touches device memory; the products are
//   float32 FMAs out of shared memory (gemm_chunk), the taps read only rows
//   0..L-1 of t.
#include "encoder.cuh"
#include "encoder_tc.cuh"

namespace {

using namespace tvqa;

__host__ __device__ inline int rows_padded(int rpt) { return rpt * NWARPS; }

__host__ __device__ inline int smem_floats(int L, int k, int rpt) {
  return 2 * D * D + 3 * rows_padded(rpt) * D + 2 * k * D + 2 * round4(L);
}

template <int RPT>
__global__ void __launch_bounds__(NTHREADS)
encoder_fwd_kernel(const float* __restrict__ x, const float* __restrict__ pe,
                   const float* __restrict__ packed,
                   const float* __restrict__ mask,
                   const float* __restrict__ zmask, float* __restrict__ out,
                   int N, int G, int L, int k, Dropout drop) {
  drop.load_seed();
  extern __shared__ float4 smem4[];
  float* pw_s = reinterpret_cast<float*>(smem4);     // 2 x D x D
  const int LP = rows_padded(RPT);
  float* h_s = pw_s + 2 * D * D;                      // LP x D
  float* t_s = h_s + LP * D;
  float* c_s = t_s + LP * D;
  float* dw_s = c_s + LP * D;                         // 2 x k x D
  float* m_s = dw_s + 2 * k * D;                      // L (reduce mode)
  float* v_s = m_s + round4(L);                       // L
  const bool reduce = mask != nullptr;
  const EncParams P(packed, k);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = 0; i < 2; ++i) {
    const float4* src = reinterpret_cast<const float4*>(P.pw[i]);
    float4* dst = reinterpret_cast<float4*>(pw_s + i * D * D);
    for (int idx = tid; idx < D * D / 4; idx += NTHREADS) dst[idx] = src[idx];
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
      ln_rows(h_s, t_s, L, P.ln_s[i], P.ln_b[i], warp, lane);
      __syncthreads();
      if (i == 0 && drop.on()) {
        dropout_rows(t_s, L, n, drop);
        __syncthreads();
      }
      dwconv_rows(t_s, c_s, L, k, dw_s + i * k * D, P.dwb[i], v_s);
      __syncthreads();
      float acc[RPT][4];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      gemm_chunk<RPT>(acc, c_s, D, 0, pw_s + i * D * D, D, warp * RPT,
                      lane * 4);
      const float4 bv = *reinterpret_cast<const float4*>(P.pwb[i] + lane * 4);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = warp * RPT + j;
        if (r >= L) continue;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          h_s[r * D + lane * 4 + t] += fmaxf(acc[j][t] + bb[t], 0.f);
      }
      __syncthreads();
    }
    ln_rows(h_s, t_s, L, P.lnf_s, P.lnf_b, warp, lane);
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

template <int RPT>
int launch_rpt(const float* x, const float* pe, const float* packed,
               const float* mask, const float* zmask, float* out, int N,
               int G, int L, int k, Dropout drop, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(L, k, RPT);
  auto kern = encoder_fwd_kernel<RPT>;
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

int launch_f32(const float* x, const float* pe, const float* packed,
               const float* mask, const float* zmask, float* out, int N,
               int G, int L, int k, Dropout drop, cudaStream_t stream) {
#define TVQA_ENC_FWD(R)                                                      \
  case R:                                                                    \
    return launch_rpt<R>(x, pe, packed, mask, zmask, out, N, G, L, k, drop,  \
                         stream);
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

// ---- the bfloat16 instantiation: tensor cores ------------------------------

constexpr int PW_PANEL = D * tc::ROW_BYTES;         // panel of pw (D rows)
constexpr int PW_BYTES = 2 * PW_PANEL;              // D x D bf16

constexpr int TR = 2 * TM;                          // rows of a tile
constexpr int X_PANEL = TR * tc::ROW_BYTES;
// Shared-memory layout: pw0, pw1 (bf16 panels); R1 (TR x D float32); the x
// tile being prefetched (bf16 panels); v and m of each row, twice (the
// tile's parity), so that a tile's rows are filled while the previous
// tile's column pass still reads its own.
constexpr int O_R1 = 2 * PW_BYTES;
constexpr int O_X = O_R1 + TR * D * 4;
constexpr int O_RV = O_X + 2 * X_PANEL;
constexpr int TC_SMEM = O_RV + 2 * 2 * TR * 4 + tc::ATOM_BYTES;

// A persistent block walks tiles of TR rows holding nseq whole sequences;
// warpgroup w owns rows [64 w, 64 w + 64) and all D columns.  K = k, the
// depthwise width, so that the taps unroll.
template <int K>
__global__ void __launch_bounds__(NTHREADS, 1)
encoder_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ pe,
                      const float* __restrict__ packed,
                      const float* __restrict__ mask,
                      const float* __restrict__ zmask,
                      __nv_bfloat16* __restrict__ out, int N, int G, int L,
                      int nseq, Dropout drop) {
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  float* r1 = reinterpret_cast<float*>(sm + O_R1);
  uint8_t* xs = sm + O_X;
  const bool reduce = mask != nullptr;
  const TcParams<K> P{packed};
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int cl = 2 * (lane & 3);
  int row[2];                                        // the thread's rows
#pragma unroll
  for (int h = 0; h < 2; ++h)
    row[h] = TM * wg + 16 * warp + (lane >> 2) + 8 * h;
  for (int i = 0; i < 2; ++i)
    tc_store_rows_f32(sm + i * PW_BYTES, D, P.pw(i), D, tid, NTHREADS);
  const int tiles = (N + nseq - 1) / nseq;
  // cp.async of the x rows of `tile` into the x tile (rows past its
  // sequences zeroed)
  auto load_x = [&](int tile) {
    const int n0 = tile * nseq;
    tc_load_rows(xs, TR, x + static_cast<size_t>(n0) * L * D, D,
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
    float* v_s = reinterpret_cast<float*>(sm + O_RV) + parity * 2 * TR;
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
    // conv 0's dropout: keep bits of the thread's 64 values, drawn once
    uint32_t kw[2][2] = {{~0u, ~0u}, {~0u, ~0u}};
    if (drop.on())
      tc_keep_bits<16, true>(drop, ((lane & 1) ? grow[1] : grow[0]) * D,
                             lane, kw);
    tc::cp_async_wait<0>();            // this tile's x
    tc::fence_async_smem();            // pw (first tile) is read by wgmma
    __syncthreads();                   // ... and v, m of every row

    float hv[64];
    enc_load_h0(hv, [&](int h, int c) {
      return tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(
          xs + (c >> 6) * X_PANEL + tc::swz(row[h], c & 63)));
    }, pe, valid, lrow, cl);
    enc_ln_to_r1(hv, P.ln_s(0), P.ln_b(0), true, kw, drop, r1, row, cl);
    __syncthreads();                   // R1 whole; the x tile read
    if (tile + static_cast<int>(gridDim.x) < tiles) load_x(tile + gridDim.x);
    tc::cp_async_commit();
#pragma unroll 1
    for (int i = 0; i < 2; ++i) {
      if (i == 1) {
        enc_ln_to_r1(hv, P.ln_s(1), P.ln_b(1), false, kw, drop, r1, row, cl);
        __syncthreads();               // R1 whole
      }
      // c = depthwise_i(t v) rounded to bf16, packed as wgmma's register A
      // fragments (depth step ks holds pairs 4 ks .. 4 ks + 3)
      uint32_t cf[32];
#pragma unroll
      for (int pr = 0; pr < 32; ++pr) {
        const float2 a = enc_conv_pair<K>(r1, v_s, P.dw(i), P.dwb(i), row,
                                          lrow, valid, L, pr & 1,
                                          8 * (pr >> 1) + cl);
        cf[pr] = tc::pack_bf16(a.x, a.y);
      }
      float acc[64];
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t a4[4] = {cf[4 * ks], cf[4 * ks + 1], cf[4 * ks + 2],
                                cf[4 * ks + 3]};
        tc::mma_rs<128, 1>(
            acc, a4,
            tc::make_desc(tc::smem_u32(sm) + i * PW_BYTES
                              + ks * 2 * tc::ATOM_BYTES, PW_PANEL),
            ks > 0);
      }
      tc::commit();
      __syncthreads();                 // every tap of R1 is read
      tc::wait_all();
#pragma unroll
      for (int j = 0; j < 64; ++j)
        hv[j] += fmaxf(acc[j] + __ldg(P.pwb(i) + acc_col(j, lane)), 0.f);
    }
    // ---- the final LN, then the masked max or the bf16 rows ---------------
    if (reduce) {
      enc_ln_to_r1(hv, P.lnf_s(), P.lnf_b(), false, kw, drop, r1, row, cl);
      __syncthreads();
      for (int idx = tid; idx < rows / L * D; idx += NTHREADS) {
        const int s = idx / D, d = idx % D, base = s * L;
        float mx = -CUDART_INF_F;
        for (int l = 0; l < L; ++l) {
          const float m = m_s[base + l];
          mx = fmaxf(mx, r1[r1_at(base + l, d)] * m + (m - 1.f) * 1e10f);
        }
        out[static_cast<size_t>(n0 + s) * D + d] = __float2bfloat16(mx);
      }
    } else {
      enc_ln(hv, P.lnf_s(), P.lnf_b(), false, kw, drop, cl,
             [&](int pr, float2 o) {
               const int h = pr & 1;
               if (valid[h])
                 *reinterpret_cast<uint32_t*>(out + grow[h] * D + 8 * (pr >> 1)
                                              + cl) = tc::pack_bf16(o.x, o.y);
             });
    }
  }
}

template <int K>
int launch_tc_k(const void* x, const float* pe, const float* packed,
                const float* mask, const float* zmask, void* out, int N,
                int G, int L, Dropout drop, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kern = encoder_fwd_tc_kernel<K>;
  cudaError_t err = allow_smem(kern, TC_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int nseq = TR / L, tiles = (N + nseq - 1) / nseq;
  const int blocks = tiles < sms ? tiles : sms;
  kern<<<blocks, NTHREADS, TC_SMEM, stream>>>(
      static_cast<const bf16*>(x), pe, packed, mask, zmask,
      static_cast<bf16*>(out), N, G, L, nseq, drop);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const void* x, const float* pe, const float* packed,
              const float* mask, const float* zmask, void* out, int N, int G,
              int L, int k, Dropout drop, cudaStream_t stream) {
#define TVQA_ENC_FWD_TC(KK)                                                  \
  case KK:                                                                   \
    return launch_tc_k<KK>(x, pe, packed, mask, zmask, out, N, G, L, drop,   \
                           stream);
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

int launch_any(const void* x, const void* pe, const void* packed,
               const void* mask, const void* zmask, void* out, int N, int G, int L, int k,
               const unsigned long long* drop_seed, unsigned drop_threshold,
               float drop_scale, int is_bf16, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_seed, drop_threshold, drop_scale, 0ull};
  if (k % 2 == 0 || k > ENC_MAX_K || L < 1 || L > TR)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch_tc(x, f(pe), f(packed), f(mask), f(zmask), out, N, G, L, k,
                     drop, st);
  return launch_f32(f(x), f(pe), f(packed), f(mask), f(zmask),
                    static_cast<float*>(out), N, G, L, k, drop, st);
}

}  // namespace

// x: N = B*G sequences of L x D (bf16 when is_bf16, else float32); pe (L, D),
// packed parameters (ops/encoder.py PARAM_KEYS order) and mask (N, L)
// float32 (16-byte aligned); out (N, D) in x's type.  L <= 56, odd k <= 9.
// Conv 0's dropout when drop_threshold > 0 (philox.cuh).  bf16 x is 16-byte
// aligned.
extern "C" int encoder_reduce_fwd(const void* x, const void* pe,
                                  const void* packed, const void* mask,
                                  void* out, int N, int L, int k,
                                  const unsigned long long* drop_seed,
                                  unsigned drop_threshold, float drop_scale,
                                  int is_bf16, void* stream) {
  if (mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(x, pe, packed, mask, nullptr, out, N, 1, L, k,
                    drop_seed, drop_threshold, drop_scale, is_bf16, stream);
}

// The full block output: out (N, L, D) in x's type.  zmask (G, L) float32
// or NULL; sequence n uses its row n % G (N is a multiple of G).  Everything
// else as encoder_reduce_fwd.
extern "C" int encoder_block_fwd(const void* x, const void* pe,
                                 const void* packed, const void* zmask,
                                 void* out, int N, int G, int L, int k,
                                 const unsigned long long* drop_seed,
                                 unsigned drop_threshold, float drop_scale,
                                 int is_bf16, void* stream) {
  if (G < 1 || N % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(x, pe, packed, nullptr, zmask, out, N, G, L, k,
                    drop_seed, drop_threshold, drop_scale, is_bf16, stream);
}
