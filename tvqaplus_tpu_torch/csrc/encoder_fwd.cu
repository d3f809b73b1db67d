// Fused QANet encoder block, forward, with conv 0's dropout, in two modes:
// with the masked word-max folded in (reduce_mask), and with the full block
// output and an optional zero mask (the merged input encoder).
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_encoder.py
// (fused_encoder_block -> _forward / _fwd_kernel): reduce_mask mode is
// STAGE's cls_encoder, zero_mask / full-output mode its input_encoder over
// the merged qa/sub/vid streams.  For each of the N = B*G sequences x
// (L x D), with v the sequence's row of the (G, L) zero mask (all ones
// without one):
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
// FLOPs (~43 MB and ~10 GFLOP at the headline eval), so at the card's
// peaks it is bound by bytes (~13 us); the full mode also writes L x D per
// sequence (1,680 sequences of 50 at the merged headline shapes: ~43 MB,
// ~5.5 GFLOP, bound by bytes too).  On the float32 CUDA cores it uses, the
// products bound it.
// Design: one resident block per SM walks the sequences (grid-stride).  Both
// pointwise matrices (2 x 64 KB float32) are loaded into shared memory once
// per block and reused for every sequence; the sequence's running state h,
// the LN output t and the conv output c (3 x L x D float32) sit beside them,
// so nothing but x in and the D-wide maximum out touches device memory.  The
// depthwise taps read only rows 0..L-1 of t (zero padding at both ends).
#include "encoder.cuh"

namespace {

using namespace tvqa;

__host__ __device__ inline int rows_padded(int rpt) { return rpt * NWARPS; }

__host__ __device__ inline int smem_floats(int L, int k, int rpt) {
  return 2 * D * D + 3 * rows_padded(rpt) * D + 2 * k * D + 2 * round4(L);
}

template <typename T, int RPT>
__global__ void __launch_bounds__(NTHREADS)
encoder_fwd_kernel(const T* __restrict__ x, const float* __restrict__ pe,
                   const float* __restrict__ packed,
                   const float* __restrict__ mask,
                   const float* __restrict__ zmask, T* __restrict__ out,
                   int N, int G, int L, int k, Dropout drop) {
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
      h_s[idx] = to_f(x[base + idx]) + pe[idx];
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
        out[static_cast<size_t>(n) * D + d] = from_f<T>(mx);
      }
    } else {
      for (int idx = tid; idx < L * D; idx += NTHREADS)
        out[base + idx] = from_f<T>(t_s[idx]);
    }
    __syncthreads();                   // h_s / t_s / m_s / v_s reused next
  }
}

template <typename T, int RPT>
int launch_rpt(const void* x, const float* pe, const float* packed,
               const float* mask, const float* zmask, void* out, int N, int G,
               int L, int k, Dropout drop, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(L, k, RPT);
  auto kern = encoder_fwd_kernel<T, RPT>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = N < sms ? N : sms;
  kern<<<blocks, NTHREADS, bytes, stream>>>(static_cast<const T*>(x), pe,
                                            packed, mask, zmask,
                                            static_cast<T*>(out), N, G, L, k,
                                            drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const float* pe, const float* packed,
           const float* mask, const float* zmask, void* out, int N, int G,
           int L, int k, Dropout drop, cudaStream_t stream) {
#define TVQA_ENC_FWD(R)                                                      \
  case R:                                                                    \
    return launch_rpt<T, R>(x, pe, packed, mask, zmask, out, N, G, L, k,     \
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

int launch_any(const void* x, const void* pe, const void* packed,
               const void* mask, const void* zmask, void* out, int N, int G,
               int L, int k, unsigned long long drop_seed,
               unsigned drop_threshold, float drop_scale, int is_bf16,
               void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_seed, drop_threshold, drop_scale};
  if (is_bf16)
    return launch<__nv_bfloat16>(x, f(pe), f(packed), f(mask), f(zmask), out,
                                 N, G, L, k, drop, st);
  return launch<float>(x, f(pe), f(packed), f(mask), f(zmask), out, N, G, L,
                       k, drop, st);
}

}  // namespace

// x: N = B*G sequences of L x D (bf16 when is_bf16, else float32); pe (L, D),
// packed parameters and mask (N, L) float32; out (N, D) in x's type.
// L <= 56, k odd.  Conv 0's dropout when drop_threshold > 0 (philox.cuh).
extern "C" int encoder_reduce_fwd(const void* x, const void* pe,
                                  const void* packed, const void* mask,
                                  void* out, int N, int L, int k,
                                  unsigned long long drop_seed,
                                  unsigned drop_threshold, float drop_scale,
                                  int is_bf16, void* stream) {
  if (mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(x, pe, packed, mask, nullptr, out, N, 1, L, k, drop_seed,
                    drop_threshold, drop_scale, is_bf16, stream);
}

// The full block output: out (N, L, D) in x's type.  zmask (G, L) float32
// or NULL; sequence n uses its row n % G (N is a multiple of G).
extern "C" int encoder_block_fwd(const void* x, const void* pe,
                                 const void* packed, const void* zmask,
                                 void* out, int N, int G, int L, int k,
                                 unsigned long long drop_seed,
                                 unsigned drop_threshold, float drop_scale,
                                 int is_bf16, void* stream) {
  if (G < 1 || N % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(x, pe, packed, nullptr, zmask, out, N, G, L, k, drop_seed,
                    drop_threshold, drop_scale, is_bf16, stream);
}
