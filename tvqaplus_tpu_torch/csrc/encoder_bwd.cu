// Fused QANet encoder block, backward, in the forward's two modes: with the
// masked word-max folded in (reduce_mask), and with the full block output
// and an optional zero mask (the merged input encoder).
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_encoder.py (_backward /
// _bwd_kernel).  Per sequence, two passes as there, so only one conv
// layer's saved values are live at once:
//   pass A: h0 = x + pe; layer 0 forward (LN, replayed Philox dropout,
//           depthwise, pointwise, ReLU, residual) for its output h1 only;
//           layer 1 forward keeping t1, c1 and the ReLU sign; reduce mode:
//           final LN and masked-max backward (the gradient of each
//           channel's max is split equally among its ties in L,
//           pallas_encoder.py:367-375, then times the mask: an all-masked
//           group, every L tied at -1e10, gets 0); full mode: the (L x D)
//           cotangent is read as it is; final-LN backward; layer 1 backward.
//   pass B: recompute layer 0 with the dropout replayed; layer 0 backward.
// A conv layer's backward: g_y = g_h (y > 0); gpwb = sum g_y;
// gpw = c^T g_y; g_c = g_y pw^T; with v the sequence's zero-mask row (all
// ones without one): gdw[j] = sum_l v[l + j - pad] t[l + j - pad] g_c[l];
// gdwb = sum g_c; g_t[l] = v[l] sum_j dw[j] g_c[l - j + pad] (inside the
// sequence only: the in-sequence bounds move with the gradient, the
// zero-mask factor belongs to the position it zeroed); times the dropout
// mask on layer 0; LN backward; plus the residual.  gx (B, G, L, D) comes
// out in the activation type; in reduce mode the forward never wrote the
// (B, G, L, D) block output and the backward never reads it.
//
// What bounds it on the H100: at the headline train shapes (4,000
// sequences of 40) it reads x (~41 MB bf16) and writes gx (~41 MB) and does
// ~37 GFLOP (three D x D products per layer: the two recomputes, g_c and
// gpw), so at the card's peaks the operations bound it (~37 us).  On the
// float32 CUDA cores it uses, the products bound it; the c and g_y rows
// written for the gpw pass add ~330 MB of traffic.  The merged input
// encoder (1,680 sequences of 50, k = 7) is about half of that work.
// Design: one resident block per SM walks the sequences (grid-stride), as
// in the forward.  Seven L x D float32 buffers (h0, h1, t, c, two gradient
// buffers, the ReLU sign / g_y) hold a sequence in shared memory; the
// pointwise matrices and their transposes are staged from L2 32 rows at a
// time (four 64 KB matrices do not fit beside the buffers).  The LN and
// depthwise parameter grads accumulate in registers across the block's
// sequences and go to one scratch slot per block; gpw is its own GEMM over
// the c and g_y rows; both are summed in a fixed order (grad_reduce.cuh).
#include "encoder.cuh"
#include "grad_reduce.cuh"

namespace {

using namespace tvqa;

constexpr int MAX_K = 9;

__host__ __device__ inline int rows_padded(int rpt) { return rpt * NWARPS; }

__host__ __device__ inline int smem_floats(int L, int k, int rpt) {
  return 7 * rows_padded(rpt) * D + KC * D + 2 * k * D + 2 * round4(L);
}

// parameter-vector layout of one scratch slot: per layer i at i * (4 + k) D:
// ln_s, ln_b (D), dw (k D), dwb, pwb (D); then lnf_s, lnf_b
__host__ __device__ inline int vec_floats(int k) {
  return 2 * (4 + k) * D + 2 * D;
}

struct Bufs {
  float *c[2], *gy[2];                 // (N*L, D): gpw's operands
  float* vec_part;                     // (gridDim.x, vec_floats(k))
};

template <typename T, int RPT>
__global__ void __launch_bounds__(NTHREADS)
encoder_bwd_kernel(const T* __restrict__ x, const float* __restrict__ pe,
                   const float* __restrict__ packed,
                   const float* __restrict__ pwT,
                   const float* __restrict__ mask,
                   const float* __restrict__ zmask,
                   const T* __restrict__ gout, T* __restrict__ gx, Bufs bufs,
                   int N, int G, int L, int k, Dropout drop) {
  extern __shared__ float4 smem4[];
  const int LP = rows_padded(RPT);
  float* h0_s = reinterpret_cast<float*>(smem4);
  float* h1_s = h0_s + LP * D;
  float* t_s = h1_s + LP * D;
  float* c_s = t_s + LP * D;
  float* ga_s = c_s + LP * D;
  float* gb_s = ga_s + LP * D;         // h2, then g_c
  float* sg_s = gb_s + LP * D;         // ReLU sign, then g_y
  float* w_s = sg_s + LP * D;          // KC x D
  float* dw_s = w_s + KC * D;          // 2 x k x D
  float* m_s = dw_s + 2 * k * D;       // L (reduce mode)
  float* v_s = m_s + round4(L);        // L
  const bool reduce = mask != nullptr;
  const EncParams P(packed, k);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = lane * 4, pad = k / 2;
  const int cd = tid & (D - 1), half = tid >> 7;     // column-pass owner

  for (int i = 0; i < 2; ++i)
    for (int idx = tid; idx < k * D; idx += NTHREADS)
      dw_s[i * k * D + idx] = P.dw[i][idx];
  // rows L..LP-1 of the GEMM operands c and g_y are read, never written
  for (int idx = L * D + tid; idx < LP * D; idx += NTHREADS)
    c_s[idx] = sg_s[idx] = 0.f;

  float gls[3][4], glb[3][4];          // ln0, ln1, lnf: lane + 32 q channels
  float gdw[2][MAX_K], gdwb[2], gpwb[2];  // channel cd, rows l = half mod 2
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) gls[i][q] = glb[i][q] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    gdwb[i] = gpwb[i] = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) gdw[i][j] = 0.f;
  }

  // layer i forward from src: t = LN (dropout on layer 0), c = depthwise,
  // acc = c pw_i (the thread's rows); writes c rows to bufs.c[i] if asked
  auto layer_fwd = [&](const float* src, int i, unsigned long long n,
                       bool save_c, float (&acc)[RPT][4]) {
    ln_rows(src, t_s, L, P.ln_s[i], P.ln_b[i], warp, lane);
    __syncthreads();
    if (i == 0 && drop.on()) {
      dropout_rows(t_s, L, n, drop);
      __syncthreads();
    }
    dwconv_rows(t_s, c_s, L, k, dw_s + i * k * D, P.dwb[i], v_s);
    __syncthreads();
    if (save_c)
      for (int idx = tid; idx < L * D; idx += NTHREADS)
        bufs.c[i][n * L * D + idx] = c_s[idx];
    gemm_staged<RPT>(acc, c_s, D, D, P.pw[i], w_s, warp * RPT, c0);
  };

  // layer i backward: sg_s holds the ReLU sign, ga_s the gradient of the
  // layer's output.  Leaves the gradient of the LN output in c_s.
  auto layer_bwd = [&](int i, unsigned long long n) {
    for (int idx = tid; idx < L * D; idx += NTHREADS) {
      const float v = ga_s[idx] * sg_s[idx];
      sg_s[idx] = v;
      bufs.gy[i][n * L * D + idx] = v;
    }
    float acc[RPT][4];
    gemm_staged<RPT>(acc, sg_s, D, D, pwT + i * D * D, w_s, warp * RPT, c0);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = warp * RPT + j;
      if (r < L)
        *reinterpret_cast<float4*>(gb_s + r * D + c0) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
    __syncthreads();
    const float* dw = dw_s + i * k * D;
    for (int l = half; l < L; l += 2) {
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
        keep4(drop.seed, n * L * D + 4ull * i4, drop.threshold, drop.scale,
              km);
#pragma unroll
        for (int t = 0; t < 4; ++t) v[t] *= km[t];
      }
      *reinterpret_cast<float4*>(c_s + 4 * i4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
  };

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const unsigned long long nn = static_cast<unsigned long long>(n);
    for (int idx = tid; idx < L * D; idx += NTHREADS)
      h0_s[idx] = to_f(x[nn * L * D + idx]) + pe[idx];
    if (reduce)
      for (int l = tid; l < L; l += NTHREADS) m_s[l] = mask[nn * L + l];
    load_zmask_row(v_s, zmask, n, G, L);
    __syncthreads();
    // ---- pass A: layer 0 for h1, layer 1 with its stash ----------------
    float acc[RPT][4];
    layer_fwd(h0_s, 0, nn, false, acc);
    {
      const float4 bv = *reinterpret_cast<const float4*>(P.pwb[0] + c0);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = warp * RPT + j;
        if (r >= L) continue;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          h1_s[r * D + c0 + t] =
              h0_s[r * D + c0 + t] + fmaxf(acc[j][t] + bb[t], 0.f);
      }
    }
    __syncthreads();
    layer_fwd(h1_s, 1, nn, true, acc);
    {
      const float4 bv = *reinterpret_cast<const float4*>(P.pwb[1] + c0);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = warp * RPT + j;
        if (r >= L) continue;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float y = acc[j][t] + bb[t];
          sg_s[r * D + c0 + t] = y > 0.f ? 1.f : 0.f;
          gb_s[r * D + c0 + t] = h1_s[r * D + c0 + t] + fmaxf(y, 0.f);
        }
      }
    }
    __syncthreads();
    // ---- the output's cotangent (reduce mode: final LN and masked-max
    // backward), final-LN backward -------------------------------------
    if (!reduce) {
      for (int idx = tid; idx < L * D; idx += NTHREADS)
        ga_s[idx] = to_f(gout[nn * L * D + idx]);
    } else {
      ln_rows(gb_s, ga_s, L, P.lnf_s, P.lnf_b, warp, lane);
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
      const float g = to_f(gout[nn * D + d]);
      for (int l = 0; l < L; ++l) {
        const float m = m_s[l];
        const bool eq = (ga_s[l * D + d] * m + (m - 1.f) * 1e10f) == mx;
        ga_s[l * D + d] = (eq ? g : 0.f) / cnt * m;
      }
    }
    __syncthreads();
    ln_bwd_rows(gb_s, ga_s, nullptr, ga_s, L, P.lnf_s, gls[2], glb[2], warp,
                lane);
    __syncthreads();
    // ---- layer 1 backward ------------------------------------------------
    layer_bwd(1, nn);
    ln_bwd_rows(h1_s, c_s, ga_s, ga_s, L, P.ln_s[1], gls[1], glb[1], warp,
                lane);
    __syncthreads();
    // ---- pass B: recompute layer 0 (dropout replayed), its backward -----
    layer_fwd(h0_s, 0, nn, true, acc);
    {
      const float4 bv = *reinterpret_cast<const float4*>(P.pwb[0] + c0);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = warp * RPT + j;
        if (r >= L) continue;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          sg_s[r * D + c0 + t] = acc[j][t] + bb[t] > 0.f ? 1.f : 0.f;
      }
    }
    __syncthreads();
    layer_bwd(0, nn);
    ln_bwd_rows(h0_s, c_s, ga_s, c_s, L, P.ln_s[0], gls[0], glb[0], warp,
                lane);
    __syncthreads();
    for (int idx = tid; idx < L * D; idx += NTHREADS)
      gx[nn * L * D + idx] = from_f<T>(c_s[idx]);   // d(x + pe)/dx = 1
    __syncthreads();
  }

  // ---- the block's parameter-vector partials, summed in a fixed order --
  const int NV = vec_floats(k);
  float* out = bufs.vec_part + static_cast<size_t>(blockIdx.x) * NV;
  float* red = h0_s;                   // 7 LP D >= 6 D NWARPS floats
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
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
  const int per_half = 2 * (k + 2);    // per layer: dw (k), dwb, pwb
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < k; ++j)
      red[(half * per_half + i * (k + 2) + j) * D + cd] = gdw[i][j];
    red[(half * per_half + i * (k + 2) + k) * D + cd] = gdwb[i];
    red[(half * per_half + i * (k + 2) + k + 1) * D + cd] = gpwb[i];
  }
  __syncthreads();
  for (int idx = tid; idx < per_half * D; idx += NTHREADS) {
    const int s = idx / D, d = idx % D;
    const int i = s / (k + 2), j = s % (k + 2);
    out[i * (4 + k) * D + (2 + j) * D + d] =
        red[s * D + d] + red[(per_half + s) * D + d];
  }
}

template <typename T, int RPT>
int launch_rpt(const void* x, const float* pe, const float* packed,
               const float* pwT, const float* mask, const float* zmask,
               const void* g, void* gx, Bufs bufs, float* gvec,
               float* wg_part, float* gpw, int N, int G, int L, int k,
               int wg_chunks, Dropout drop, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(L, k, RPT);
  auto kern = encoder_bwd_kernel<T, RPT>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = N < sms ? N : sms;
  kern<<<blocks, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(x), pe, packed, pwT, mask, zmask,
      static_cast<const T*>(g), static_cast<T*>(gx), bufs, N, G, L, k, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(N) * L;
  for (int i = 0; i < 2; ++i)
    if ((err = wgrad(bufs.c[i], bufs.gy[i], wg_part, gpw + i * D * D, rows,
                     D, wg_chunks, stream)) != cudaSuccess)
      return static_cast<int>(err);
  return static_cast<int>(sum_slots<float>(bufs.vec_part, gvec, 1, blocks,
                                           vec_floats(k), stream));
}

template <typename T>
int launch(const void* x, const float* pe, const float* packed,
           const float* pwT, const float* mask, const float* zmask,
           const void* g, void* gx, Bufs bufs, float* gvec, float* wg_part,
           float* gpw, int N, int G, int L, int k, int wg_chunks,
           Dropout drop, cudaStream_t stream) {
  if (k % 2 == 0 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
#define TVQA_ENC_BWD(R)                                                    \
  case R:                                                                  \
    return launch_rpt<T, R>(x, pe, packed, pwT, mask, zmask, g, gx, bufs,  \
                            gvec, wg_part, gpw, N, G, L, k, wg_chunks, drop,  \
                            stream);
  switch ((L + NWARPS - 1) / NWARPS) {   // rows per warp in the GEMMs
    TVQA_ENC_BWD(1)
    TVQA_ENC_BWD(2)
    TVQA_ENC_BWD(3)
    TVQA_ENC_BWD(4)
    TVQA_ENC_BWD(5)
    TVQA_ENC_BWD(6)
    TVQA_ENC_BWD(7)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TVQA_ENC_BWD
}

int launch_any(const void* x, const void* pe, const void* packed,
               const void* pwT, const void* mask, const void* zmask,
               const void* g, void* gx, void* gvec, void* gpw, void* c0,
               void* c1, void* gy0, void* gy1, void* vec_part, void* wg_part,
               int N, int G, int L, int k, int wg_chunks,
               unsigned long long drop_seed, unsigned drop_threshold,
               float drop_scale, int is_bf16, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_seed, drop_threshold, drop_scale};
  const Bufs bufs{{fm(c0), fm(c1)}, {fm(gy0), fm(gy1)}, fm(vec_part)};
  if (is_bf16)
    return launch<__nv_bfloat16>(x, f(pe), f(packed), f(pwT), f(mask),
                                 f(zmask), g, gx, bufs, fm(gvec),
                                 fm(wg_part), fm(gpw), N, G, L, k, wg_chunks,
                                 drop, st);
  return launch<float>(x, f(pe), f(packed), f(pwT), f(mask), f(zmask), g, gx,
                       bufs, fm(gvec), fm(wg_part), fm(gpw), N, G, L, k,
                       wg_chunks, drop, st);
}

}  // namespace

// x: N = B*G sequences of L x D (bf16 when is_bf16, else float32); pe
// (L, D), the packed parameters (ops/encoder.py PARAM_KEYS order), pwT
// (2, D, D) = [pw0^T; pw1^T], mask (N, L) float32; g (N, D) the cotangent
// of the reduced output, gx (N, L, D), both in x's type.  Outputs gvec
// (2 (4 + k) D + 2 D, layout in vec_floats) and gpw (2, D, D) float32.
// Scratch (float32, the wrapper's): c0, c1, gy0, gy1 (N*L, D); vec_part
// (min(N, SMs), vec_floats); wg_part (wg_chunks, D, D).  L <= 56, odd
// k <= 9.  Conv 0's dropout replayed when drop_threshold > 0.
extern "C" int encoder_reduce_bwd(
    const void* x, const void* pe, const void* packed, const void* pwT,
    const void* mask, const void* g, void* gx, void* gvec, void* gpw,
    void* c0, void* c1, void* gy0, void* gy1, void* vec_part, void* wg_part,
    int N, int L, int k, int wg_chunks, unsigned long long drop_seed,
    unsigned drop_threshold, float drop_scale, int is_bf16, void* stream) {
  if (mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(x, pe, packed, pwT, mask, nullptr, g, gx, gvec, gpw, c0,
                    c1, gy0, gy1, vec_part, wg_part, N, 1, L, k, wg_chunks,
                    drop_seed, drop_threshold, drop_scale, is_bf16, stream);
}

// Full-output mode: g (N, L, D) is the cotangent of the block output;
// zmask (G, L) float32 or NULL, sequence n uses its row n % G.  Everything
// else as encoder_reduce_bwd.
extern "C" int encoder_block_bwd(
    const void* x, const void* pe, const void* packed, const void* pwT,
    const void* zmask, const void* g, void* gx, void* gvec, void* gpw,
    void* c0, void* c1, void* gy0, void* gy1, void* vec_part, void* wg_part,
    int N, int G, int L, int k, int wg_chunks, unsigned long long drop_seed,
    unsigned drop_threshold, float drop_scale, int is_bf16, void* stream) {
  if (G < 1 || N % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(x, pe, packed, pwT, nullptr, zmask, g, gx, gvec, gpw, c0,
                    c1, gy0, gy1, vec_part, wg_part, N, G, L, k, wg_chunks,
                    drop_seed, drop_threshold, drop_scale, is_bf16, stream);
}
