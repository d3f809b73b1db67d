// Fused QANet encoder block, backward, at the hidden widths D = 64 and 256,
// in the forward's two modes (encoder_bwd.cu is the same function at D =
// 128): with the masked word-max folded in (reduce_mask), and with the full
// block output and an optional zero mask (the merged input encoder).
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_encoder.py (_backward
// :493), which reads D from its operands and so runs at any width.  Per
// sequence, the two passes of encoder_bwd.cu's header: pass A recomputes
// layer 0 for h1 and layer 1 with its stash, then the output's cotangent
// (reduce mode: final LN and the masked-max backward, a tie's gradient
// split equally; full mode: read as it is), the final-LN backward and
// layer 1's backward; pass B recomputes layer 0 with its Philox dropout
// replayed (keyed by the flat index of the (B*G*L, D) LN output, as the
// forward drew it) and runs its backward.
//
// What bounds it on the H100: at the headline train shapes (4,000
// sequences of 40) it reads x and writes gx (~20 MB in bf16 at D = 64, ~82
// MB at 256) and does ~9 and ~148 GFLOP (three D x D products per layer:
// the two recomputes, g_c and gpw), so the operations bind at D = 256
// (~0.15 ms) and the bytes at D = 64 (~6 us).
//
// Here the float32 kernels at these widths, the exactness check (bf16 runs
// on the tensor cores: encoder_bwd_tc_wide.cu), on CUDA cores.  One
// resident block per SM walks the sequences (grid-stride), as
// encoder_bwd.cu's float32 kernel does.  Seven L x D float32 buffers (h0,
// h1, t, c, two gradient buffers, the ReLU sign / g_y) hold a sequence: in
// shared memory at D = 64 (113 KB at L = 56), and at D = 256, where they
// would take 401 KB, in a per-block scratch in device memory (the
// wrapper's, 401 KB a block at L = 56: 53 MB for 132 blocks, read back from
// L1 and L2 within the sequence).  The pointwise matrices and their
// transposes stage from L2 32 rows at a time; the depthwise taps and the LN
// and parameter sums run on the rows (encoder.cuh, the forward's own
// recompute).  The LN and depthwise parameter grads accumulate in registers
// across the block's sequences and go to one scratch slot per block; the c
// and g_y rows go out for the weight gradient (grad_reduce.cuh wgrad); all
// sums across blocks are fixed-order second passes: the same bits from run
// to run.
#include "bwd_wide.cuh"
#include "encoder.cuh"

namespace {

using namespace tvqa;

constexpr int MAX_K = 9;
constexpr int MAX_LEN = 56;

// the sequence's seven buffers live in device memory (the wrapper's
// per-block scratch) at D = 256, in shared memory below
template <int D>
__host__ __device__ constexpr bool in_scratch() { return D == 256; }

__host__ __device__ inline int rows_padded(int rpt) { return rpt * NWARPS; }

// rows per warp in the GEMMs for sequences of L: three instantiations (the
// padded rows are zero), so that the source builds in about the time of
// the others
inline int rpt_for(int L) { return L <= 16 ? 2 : (L <= 40 ? 5 : 7); }

template <int D>
__host__ __device__ inline int smem_floats(int L, int k, int rpt) {
  return (in_scratch<D>() ? 0 : 7 * rows_padded(rpt) * D) + KC * D
         + 2 * k * D + 2 * round4(L);
}

// parameter-vector layout of one scratch slot, as encoder_bwd.cu: per layer
// i at i (4 + k) D: ln_s, ln_b (D), dw (k D), dwb, pwb (D); then lnf_s,
// lnf_b
template <int D>
__host__ __device__ inline int vec_floats(int k) {
  return 2 * (4 + k) * D + 2 * D;
}

struct WideBufs {
  float *c[2], *gy[2];                 // (N*L, D): gpw's operands
  float* vec_part;                     // (gridDim.x, vec_floats(k))
  float* work;                         // (gridDim.x, 7 LP D) at D = 256
};

template <int D, int RPT>
__global__ void __launch_bounds__(NTHREADS)
encoder_bwd_wide_kernel(const float* __restrict__ x,
                        const float* __restrict__ pe,
                        const float* __restrict__ packed,
                        const float* __restrict__ pwT,
                        const float* __restrict__ mask,
                        const float* __restrict__ zmask,
                        const float* __restrict__ gout,
                        float* __restrict__ gx, WideBufs bufs, int N, int G,
                        int L, int k,
                        Dropout drop) {
  constexpr int CPL = D / 32, VPL = D / 32, NH = NTHREADS / D;
  drop.load_seed();
  extern __shared__ float4 smem4[];
  const int LP = rows_padded(RPT);
  float* smem = reinterpret_cast<float*>(smem4);
  float* h0_s = in_scratch<D>()
      ? bufs.work + static_cast<size_t>(blockIdx.x) * 7 * LP * D : smem;
  float* h1_s = h0_s + LP * D;
  float* t_s = h1_s + LP * D;
  float* c_s = t_s + LP * D;
  float* ga_s = c_s + LP * D;
  float* gb_s = ga_s + LP * D;         // h2, then g_c
  float* sg_s = gb_s + LP * D;         // ReLU sign, then g_y
  float* w_s = in_scratch<D>() ? smem : sg_s + LP * D;       // KC x D
  float* dw_s = w_s + KC * D;          // 2 x k x D
  float* m_s = dw_s + 2 * k * D;       // L (reduce mode)
  float* v_s = m_s + round4(L);        // L
  const bool reduce = mask != nullptr;
  const EncParams<D> P(packed, k);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = lane * CPL, pad = k / 2;
  const int cd = tid % D, part = tid / D;      // column-pass owner

  for (int i = 0; i < 2; ++i)
    for (int idx = tid; idx < k * D; idx += NTHREADS)
      dw_s[i * k * D + idx] = P.dw[i][idx];
  // rows L..LP-1 of the GEMM operands c and g_y are read, never written
  for (int idx = L * D + tid; idx < LP * D; idx += NTHREADS)
    c_s[idx] = sg_s[idx] = 0.f;

  float gls[3][VPL], glb[3][VPL];      // ln0, ln1, lnf: lane + 32 q
  float gdw[2][MAX_K], gdwb[2], gpwb[2];  // channel cd, rows l = part mod NH
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int q = 0; q < VPL; ++q) gls[i][q] = glb[i][q] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    gdwb[i] = gpwb[i] = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) gdw[i][j] = 0.f;
  }

  // layer i forward from src: t = LN (dropout on layer 0), c = depthwise,
  // acc = c pw_i (the thread's rows); writes c rows to bufs.c[i] if asked
  auto layer_fwd = [&](const float* src, int i, unsigned long long n,
                       bool save_c, float (&acc)[RPT][CPL]) {
    ln_rows<D>(src, t_s, L, P.ln_s[i], P.ln_b[i], warp, lane, drop.inv1);
    __syncthreads();
    if (i == 0 && drop.on()) {
      dropout_rows<D>(t_s, L, n, drop);
      __syncthreads();
    }
    dwconv_rows<D>(t_s, c_s, L, k, dw_s + i * k * D, P.dwb[i], v_s);
    __syncthreads();
    if (save_c)
      for (int idx = tid; idx < L * D; idx += NTHREADS)
        bufs.c[i][n * L * D + idx] = c_s[idx];
    gemm_staged<RPT, D>(acc, c_s, D, D, P.pw[i], w_s, warp * RPT, c0);
  };

  // layer i backward: sg_s holds the ReLU sign, ga_s the gradient of the
  // layer's output.  Leaves the gradient of the LN output in c_s.
  auto layer_bwd = [&](int i, unsigned long long n) {
    for (int idx = tid; idx < L * D; idx += NTHREADS) {
      const float v = ga_s[idx] * sg_s[idx];
      sg_s[idx] = v;
      bufs.gy[i][n * L * D + idx] = v;
    }
    float acc[RPT][CPL];
    gemm_staged<RPT, D>(acc, sg_s, D, D, pwT + i * D * D, w_s, warp * RPT,
                        c0);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = warp * RPT + j;
      if (r < L)
#pragma unroll
        for (int t = 0; t < CPL; ++t) gb_s[r * D + c0 + t] = acc[j][t];
    }
    __syncthreads();
    const float* dw = dw_s + i * k * D;
    for (int l = part; l < L; l += NH) {
      const float gc = gb_s[l * D + cd];
      gdwb[i] += gc;
      gpwb[i] += sg_s[l * D + cd];
#pragma unroll
      for (int j = 0; j < MAX_K; ++j) {
        const int rr = l + j - pad;
        if (j < k && rr >= 0 && rr < L)
          gdw[i][j] = fmaf(t_s[rr * D + cd] * v_s[rr], gc, gdw[i][j]);
      }
    }
    for (int i4 = tid; i4 < L * D / 4; i4 += NTHREADS) {
      const int l = (4 * i4) / D, d0 = (4 * i4) % D;
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float acc_t = 0.f;
        for (int j = 0; j < k; ++j) {
          const int r = l - j + pad;
          if (r >= 0 && r < L)
            acc_t = fmaf(dw[j * D + d0 + t], gb_s[r * D + d0 + t], acc_t);
        }
        v[t] = acc_t * v_s[l];
      }
      if (i == 0 && drop.on()) {
        float km[4];
        keep4(drop.seed,
              drop.row_key(static_cast<long long>(n) * L + 4 * i4 / D)
                  + (4 * i4) % D,
              drop.threshold, drop.scale, km);
#pragma unroll
        for (int t = 0; t < 4; ++t) v[t] *= km[t];
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) c_s[4 * i4 + t] = v[t];
    }
    __syncthreads();
  };

  // acc + bias of the thread's rows: f(r, column, value) for r < L
  auto rows_out = [&](const float (&acc)[RPT][CPL], const float* bias,
                      auto&& f) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = warp * RPT + j;
      if (r >= L) continue;
#pragma unroll
      for (int t = 0; t < CPL; ++t)
        f(r, c0 + t, acc[j][t] + bias[c0 + t]);
    }
  };

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const unsigned long long nn = static_cast<unsigned long long>(n);
    for (int idx = tid; idx < L * D; idx += NTHREADS)
      h0_s[idx] = x[nn * L * D + idx] + pe[idx];
    if (reduce)
      for (int l = tid; l < L; l += NTHREADS) m_s[l] = mask[nn * L + l];
    load_zmask_row(v_s, zmask, n, G, L);
    __syncthreads();
    // ---- pass A: layer 0 for h1, layer 1 with its stash ----------------
    float acc[RPT][CPL];
    layer_fwd(h0_s, 0, nn, false, acc);
    rows_out(acc, P.pwb[0], [&](int r, int c, float y) {
      h1_s[r * D + c] = h0_s[r * D + c] + fmaxf(y, 0.f);
    });
    __syncthreads();
    layer_fwd(h1_s, 1, nn, true, acc);
    rows_out(acc, P.pwb[1], [&](int r, int c, float y) {
      sg_s[r * D + c] = y > 0.f ? 1.f : 0.f;
      gb_s[r * D + c] = h1_s[r * D + c] + fmaxf(y, 0.f);
    });
    __syncthreads();
    // ---- the output's cotangent (reduce mode: final LN and masked-max
    // backward), final-LN backward -------------------------------------
    if (!reduce) {
      for (int idx = tid; idx < L * D; idx += NTHREADS)
        ga_s[idx] = gout[nn * L * D + idx];
    } else {
      ln_rows<D>(gb_s, ga_s, L, P.lnf_s, P.lnf_b, warp, lane, drop.inv1);
      __syncthreads();
    }
    if (reduce && tid < D) {
      const int d = tid;
      float mx = -CUDART_INF_F;
      for (int l = 0; l < L; ++l) {
        const float m = m_s[l];
        mx = fmaxf(mx, ga_s[l * D + d] * m + (m - 1.f) * 1e10f);
      }
      float cnt = 0.f;
      for (int l = 0; l < L; ++l) {
        const float m = m_s[l];
        cnt += (ga_s[l * D + d] * m + (m - 1.f) * 1e10f) == mx ? 1.f : 0.f;
      }
      const float g = gout[nn * D + d];
      for (int l = 0; l < L; ++l) {
        const float m = m_s[l];
        const bool eq = (ga_s[l * D + d] * m + (m - 1.f) * 1e10f) == mx;
        ga_s[l * D + d] = (eq ? g : 0.f) / cnt * m;
      }
    }
    __syncthreads();
    ln_bwd_rows<D>(gb_s, ga_s, nullptr, ga_s, L, P.lnf_s, gls[2], glb[2],
                     warp, lane, drop.inv1);
    __syncthreads();
    // ---- layer 1 backward ------------------------------------------------
    layer_bwd(1, nn);
    ln_bwd_rows<D>(h1_s, c_s, ga_s, ga_s, L, P.ln_s[1], gls[1], glb[1],
                     warp, lane, drop.inv1);
    __syncthreads();
    // ---- pass B: recompute layer 0 (dropout replayed), its backward -----
    layer_fwd(h0_s, 0, nn, true, acc);
    rows_out(acc, P.pwb[0], [&](int r, int c, float y) {
      sg_s[r * D + c] = y > 0.f ? 1.f : 0.f;
    });
    __syncthreads();
    layer_bwd(0, nn);
    ln_bwd_rows<D>(h0_s, c_s, ga_s, c_s, L, P.ln_s[0], gls[0], glb[0],
                     warp, lane, drop.inv1);
    __syncthreads();
    for (int idx = tid; idx < L * D; idx += NTHREADS)
      gx[nn * L * D + idx] = c_s[idx];   // d(x + pe)/dx = 1
    __syncthreads();
  }

  // ---- the block's parameter-vector partials, summed in a fixed order --
  // (red spans h0_s .. sg_s and, in shared memory, w_s and dw_s behind
  // them: at least 6 D NWARPS and NH 2 (k + 2) D floats)
  const int NV = vec_floats<D>(k);
  float* out = bufs.vec_part + static_cast<size_t>(blockIdx.x) * NV;
  float* red = h0_s;
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      red[(warp * 6 + 2 * s) * D + lane + 32 * q] = gls[s][q];
      red[(warp * 6 + 2 * s + 1) * D + lane + 32 * q] = glb[s][q];
    }
  __syncthreads();
  for (int idx = tid; idx < 6 * D; idx += NTHREADS) {
    const int s = idx / D, d = idx % D;            // s: ln0_s .. lnf_b
    float acc = 0.f;
    for (int wp = 0; wp < NWARPS; ++wp) acc += red[(wp * 6 + s) * D + d];
    const int off = s < 4 ? (s / 2) * (4 + k) * D + (s % 2) * D
                          : 2 * (4 + k) * D + (s - 4) * D;
    out[off + d] = acc;
  }
  __syncthreads();
  const int per_part = 2 * (k + 2);    // per layer: dw (k), dwb, pwb
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < k; ++j)
      red[(part * per_part + i * (k + 2) + j) * D + cd] = gdw[i][j];
    red[(part * per_part + i * (k + 2) + k) * D + cd] = gdwb[i];
    red[(part * per_part + i * (k + 2) + k + 1) * D + cd] = gpwb[i];
  }
  __syncthreads();
  for (int idx = tid; idx < per_part * D; idx += NTHREADS) {
    const int s = idx / D, d = idx % D;
    const int i = s / (k + 2), j = s % (k + 2);
    float acc = 0.f;
    for (int p = 0; p < NH; ++p) acc += red[(p * per_part + s) * D + d];
    out[i * (4 + k) * D + (2 + j) * D + d] = acc;
  }
}

template <int D, int RPT>
int launch_rpt(const float* x, const float* pe, const float* packed,
               const float* pwT, const float* mask, const float* zmask,
               const float* g, float* gx, WideBufs bufs, float* gvec,
               float* wg_part, float* gpw, int N, int G, int L, int k,
               int wg_chunks, Dropout drop, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<D>(L, k, RPT);
  auto kern = encoder_bwd_wide_kernel<D, RPT>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  const int blocks = N < sms ? N : sms;
  kern<<<blocks, NTHREADS, bytes, stream>>>(x, pe, packed, pwT, mask, zmask,
                                            g, gx, bufs, N, G, L, k, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(N) * L;
  for (int i = 0; i < 2; ++i)
    if ((err = wgrad(bufs.c[i], bufs.gy[i], wg_part, gpw + i * D * D,
                     rows, D, D, wg_chunks, stream)) != cudaSuccess)
      return static_cast<int>(err);
  return static_cast<int>(sum_slots<float>(bufs.vec_part, gvec, 1, blocks,
                                           vec_floats<D>(k), stream));
}

template <int D>
int launch(const float* x, const float* pe, const float* packed,
           const float* pwT, const float* mask, const float* zmask,
           const float* g, float* gx, WideBufs bufs, float* gvec,
           float* wg_part, float* gpw, int N, int G, int L, int k,
           int wg_chunks, Dropout drop, cudaStream_t stream) {
#define TVQA_ENC_WIDE(R)                                                   \
  case R:                                                                  \
    return launch_rpt<D, R>(x, pe, packed, pwT, mask, zmask, g, gx, bufs,  \
                            gvec, wg_part, gpw, N, G, L, k, wg_chunks, drop, \
                            stream);
  switch (rpt_for(L)) {
    TVQA_ENC_WIDE(2)
    TVQA_ENC_WIDE(5)
    TVQA_ENC_WIDE(7)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TVQA_ENC_WIDE
}

int launch_any(const void* x, const void* pe, const void* packed,
               const void* pwT, const void* mask, const void* zmask,
               const void* g, void* gx, void* gvec, void* gpw, void* c0,
               void* c1, void* gy0, void* gy1, void* vec_part, void* work,
               void* wg_part, int N, int G, int L, int k, int d,
               int wg_chunks, const unsigned long long* drop_seed,
               unsigned drop_threshold, float drop_scale, int dv,
               const int* gmap, int g_glob, int is_bf16, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop = entry_dropout(
      drop_seed, drop_threshold, drop_scale, dv, gmap, G, g_glob, L);
  if (!width_ok(dv, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (k % 2 == 0 || k > MAX_K || L < 1 || L > MAX_LEN)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((d != 64 && d != 256) || is_bf16)   // bf16: encoder_bwd_tc_wide.cu
    return static_cast<int>(cudaErrorInvalidValue);
  const WideBufs bufs{{fm(c0), fm(c1)}, {fm(gy0), fm(gy1)}, fm(vec_part),
                      fm(work)};
  return d == 64
      ? launch<64>(f(x), f(pe), f(packed), f(pwT), f(mask), f(zmask), f(g),
                   fm(gx), bufs, fm(gvec), fm(wg_part), fm(gpw), N, G, L, k,
                   wg_chunks, drop, st)
      : launch<256>(f(x), f(pe), f(packed), f(pwT), f(mask), f(zmask), f(g),
                    fm(gx), bufs, fm(gvec), fm(wg_part), fm(gpw), N, G, L, k,
                    wg_chunks, drop, st);
}

}  // namespace

// As encoder_reduce_bwd (encoder_bwd.cu) at width D = 64 or 256 in float32:
// x, N = B*G sequences of L x D; pe (L, D), the packed parameters
// (ops/encoder.py PARAM_KEYS order), pwT (2, D, D) = [pw0^T; pw1^T], mask
// (N, L); g (N, D) the cotangent of the reduced output, gx (N, L, D).
// Outputs gvec (2 (4 + k) D + 2 D) and gpw (2, D, D).  Scratch (the
// wrapper's): c0, c1, gy0, gy1 (N*L, D); vec_part (min(N, SMs), 2 (4 + k) D
// + 2 D); work (min(N, SMs), 7 LP D) at D = 256 (LP = 8 rpt_for(L); unused,
// may be NULL, at 64); wg_part (wg_chunks, D, D).  All float32; L <= 56,
// odd k <= 9; conv 0's dropout replayed when drop_threshold > 0.  Any other
// D, and is_bf16, is refused.
// dv: the true width, 4 <= dv <= D with 4 | dv, of inputs zero-padded to D
// (every LN's statistics and the Philox keys, philox.cuh); gmap / g_glob the
// group map of the full-output mode (Dropout::row_key; NULL / 1 for none).
extern "C" int encoder_reduce_bwd_wide(
    const void* x, const void* pe, const void* packed, const void* pwT,
    const void* mask, const void* g, void* gx, void* gvec, void* gpw,
    void* c0, void* c1, void* gy0, void* gy1, void* vec_part, void* work,
    void* wg_part, int N, int L, int k, int d, int wg_chunks,
    const unsigned long long* drop_seed, unsigned drop_threshold,
    float drop_scale, int dv, const int* gmap, int g_glob, int is_bf16,
    void* stream) {
  if (mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(x, pe, packed, pwT, mask, nullptr, g, gx, gvec, gpw, c0,
                    c1, gy0, gy1, vec_part, work, wg_part, N, 1, L, k, d,
                    wg_chunks, drop_seed, drop_threshold, drop_scale, dv,
                        gmap, g_glob,
                        is_bf16, stream);
}

// Full-output mode: g (N, L, D) is the cotangent of the block output;
// zmask (G, L) float32 or NULL, sequence n uses its row n % G.  Everything
// else as encoder_reduce_bwd_wide.
extern "C" int encoder_block_bwd_wide(
    const void* x, const void* pe, const void* packed, const void* pwT,
    const void* zmask, const void* g, void* gx, void* gvec, void* gpw,
    void* c0, void* c1, void* gy0, void* gy1, void* vec_part, void* work,
    void* wg_part, int N, int G, int L, int k, int d, int wg_chunks,
    const unsigned long long* drop_seed, unsigned drop_threshold,
    float drop_scale, int dv, const int* gmap, int g_glob, int is_bf16,
    void* stream) {
  if (G < 1 || N % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(x, pe, packed, pwT, nullptr, zmask, g, gx, gvec, gpw, c0,
                    c1, gy0, gy1, vec_part, work, wg_part, N, G, L, k, d,
                    wg_chunks, drop_seed, drop_threshold, drop_scale, dv,
                        gmap, g_glob,
                        is_bf16, stream);
}
