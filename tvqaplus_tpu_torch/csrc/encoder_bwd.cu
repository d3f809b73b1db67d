// Fused QANet encoder block, backward, at the hidden width D = 128 (D = 64
// and 256: encoder_bwd_wide.cu), in the forward's two modes: with the
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
// gpw), so at the card's peaks the operations bound it (~37 us).  The
// merged input encoder (1,680 sequences of 50, k = 7) is about half of
// that work.
//
// Two instantiations.
// * bfloat16 (what the main paths run): every product a wgmma on bf16
//   operands with float32 sums, rounded where the TPU kernel's bf16 compute
//   mode rounds (c, pw, g_y; pallas_encoder.py:199-201, :221-226); the
//   depthwise weight gradient reads the LN output rounded to bf16, as the
//   TPU kernel's bf16 stash ln_d is, while its other stash, xhat, is
//   recomputed in float32.
//   - encoder_bwd_tc_kernel: one resident block per SM walks tiles of 128
//     rows that hold whole sequences (128 / L of them: 3 of 40 fill 94%, 2
//     of 50 78%, where one sequence per 64-row wgmma tile would fill 62%
//     and 78%); each warpgroup owns 64 rows and all 128 columns, so a
//     row's LayerNorm is a sum over the thread's values and its quad, on
//     the accumulator registers.  pw0 and pw1 (bf16, 2 x 32 KB) stay in
//     shared memory for the block's life, read MN-major for c pw and
//     K-major for g_y pw^T; g_y feeds its product from registers.  The
//     depthwise taps cross rows and go through shared memory: the LN
//     output t in float32 (the conv input), then in bf16 beside g_c in
//     float32 (the weight and input gradients); h1 and h0 wait in a
//     private stash per thread in L2.  165,888 bytes of shared memory.
//     The c and g_y rows go out in bf16 (4 x 41 MB at the headline
//     shapes).  Its recompute of the forward (load_h0, stats, ln_to_r1,
//     conv) computes what encoder_tc.cuh's functions compute for the
//     forward kernel, as lambdas: moved onto those functions, the kernel
//     spilled 1,068 bytes instead of 980 at k 5 and ran 0.7% (dropout 0)
//     and 1.2% (0.1) slower, beyond the parent's own turn-to-turn spread
//     (PERF.md PR 6), so it keeps them; card tests hold both kernels
//     against the same plain version.
//   - wgrad_tc_kernel (wgrad_tc.cuh): gpw and gpwb of each layer from those
//     rows.
//   The LN and depthwise parameter gradients run as sums in the block's
//   scratch (each entry added to by one thread, tile after tile: no
//   registers held across tiles, which spilled 1.1 KB a thread when they
//   were), then one slot per block summed in a fixed order
//   (grad_reduce.cuh).
// * float32: the exactness check, CUDA cores: one resident block per SM
//   walks the sequences (grid-stride), as in the forward.  Seven L x D
//   float32 buffers (h0, h1, t, c, two gradient buffers, the ReLU sign /
//   g_y) hold a sequence in shared memory; the pointwise matrices and their
//   transposes are staged from L2 32 rows at a time.  The LN and depthwise
//   parameter grads accumulate in registers across the block's sequences
//   and go to one scratch slot per block; gpw is grad_reduce.cuh's GEMM
//   over the float32 c and g_y rows.
// Both sum across blocks in a fixed order: the same bits from run to run.
#include "encoder_tc.cuh"
#include "grad_reduce.cuh"
#include "wgrad_tc.cuh"

namespace {

using namespace tvqa;

constexpr int MAX_K = ENC_MAX_K;

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
  drop.load_seed();
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
    ln_rows(src, t_s, L, P.ln_s[i], P.ln_b[i], warp, lane, drop.inv1);
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
        keep4(drop.seed,
              drop.row_key(static_cast<long long>(n) * L + 4 * i4 / D)
                  + (4 * i4) % D,
              drop.threshold, drop.scale, km);
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
      ln_rows(gb_s, ga_s, L, P.lnf_s, P.lnf_b, warp, lane, drop.inv1);
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
                lane, drop.inv1);
    __syncthreads();
    // ---- layer 1 backward ------------------------------------------------
    layer_bwd(1, nn);
    ln_bwd_rows(h1_s, c_s, ga_s, ga_s, L, P.ln_s[1], gls[1], glb[1], warp,
                lane, drop.inv1);
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
                lane, drop.inv1);
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
                     D, D, wg_chunks, stream)) != cudaSuccess)
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

// ---- the bfloat16 instantiation: tensor cores ------------------------------

constexpr int TR = 2 * TM;                          // rows of a block tile
constexpr int PW_PANEL = D * tc::ROW_BYTES;         // panel of pw (D rows)
constexpr int PW_BYTES = 2 * PW_PANEL;              // D x D bf16
constexpr int R2_PANEL = TR * tc::ROW_BYTES;
constexpr int O_R1 = 2 * PW_BYTES;                  // TR x D float32
constexpr int O_R2 = O_R1 + TR * D * 4;             // TR x D bf16 panels
constexpr int O_RV = O_R2 + TR * D * 2;             // v, m of each row
constexpr int TC_SMEM = O_RV + 2 * TR * 4 + tc::ATOM_BYTES;

// The block's running parameter-gradient sums, behind its vec_part slots:
// the LN scale and bias sums of each warp ([warp][ln0_s .. lnf_b][D]), and
// the depthwise tap and bias sums of each column-pass half
// ([half][layer][tap 0 .. MAX_K, dwb][D]).  Each entry is owned by one
// thread, which adds into it tile after tile (no registers held across
// tiles, no atomics).
// Then the block's stash of h1 (and later h0), the LN inputs of the
// backward: 64 floats a thread, [value pair][thread] so that a warp's
// accesses are contiguous; it stays in L2.  In shared memory it cost the
// SM its L1 (227 KB of shared memory leave 28 KB), so the spilled
// registers and the parameter loads went to L2.
constexpr int ACC_LN = NWARPS * 6 * D;
constexpr int ACC_FLOATS = ACC_LN + 2 * 2 * (MAX_K + 1) * D;
constexpr int H_FLOATS = 64 * NTHREADS;

struct TcBufs {
  __nv_bfloat16 *c[2], *gy[2];         // (N*L, D): gpw's operands
  float* vec_part;   // (gridDim.x, vec_floats(k)), then (gridDim.x,
                     // ACC_FLOATS) running sums, then (gridDim.x,
                     // H_FLOATS) h stashes
};

// LayerNorm backward of the thread's two rows in the accumulator layout (64
// values, pair pr = values 2 pr, 2 pr + 1 at row half pr % 2, columns
// 8 (pr / 2) + 2 (lane % 4) + {0, 1}): fetch(pr) gives the LN input's pair,
// g the upstream gradient, replaced by d LN / d input.  The scale and bias
// gradients of the columns (summed over the rows, fold8) are added into
// the warp's running sums gacc[0 .. D) and gacc[D .. 2D), each entry owned
// by one lane (fold8_col).
template <typename F>
__device__ __forceinline__ void ln_bwd_tile(F fetch, float (&g)[64],
                                            const float* __restrict__ scale,
                                            float* gacc, int lane,
                                            float inv) {
  const int cl = 2 * (lane & 3);
  float mean[2] = {0.f, 0.f}, istd[2] = {0.f, 0.f};
#pragma unroll
  for (int pr = 0; pr < 32; ++pr) {
    const float2 x = fetch(pr);
    mean[pr & 1] += x.x + x.y;
    istd[pr & 1] = fmaf(x.x, x.x, fmaf(x.y, x.y, istd[pr & 1]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean[h] = quad_sum(mean[h]) * inv;
    istd[h] = rsqrtf(fmaxf(quad_sum(istd[h]) * inv - mean[h] * mean[h],
                           0.f) + LN_EPS);
  }
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int qb = 0; qb < 4; ++qb) {
    float ts[8], tb[8];
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int q = 4 * qb + qq;
      const float2 sc = ldg2(scale + 8 * q + cl);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pr = 2 * q + h;
        const float2 x = fetch(pr);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * pr + e, j = 2 * qq + e;
          const float xh = ((e ? x.y : x.x) - mean[h]) * istd[h];
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
    s1[h] = quad_sum(s1[h]) * inv;
    s2[h] = quad_sum(s2[h]) * inv;
  }
#pragma unroll
  for (int pr = 0; pr < 32; ++pr) {
    const int h = pr & 1;
    const float2 x = fetch(pr);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * pr + e;
      const float xh = ((e ? x.y : x.x) - mean[h]) * istd[h];
      g[i] = istd[h] * (g[i] - s1[h] - xh * s2[h]);
    }
  }
}

// One block per SM walks tiles of TR rows holding nseq whole sequences;
// warpgroup w owns rows [64 w, 64 w + 64) of a tile and all D columns.
// K = k, the depthwise width, so that the taps unroll.
template <int K>
__global__ void __launch_bounds__(NTHREADS, 1)
encoder_bwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ pe,
                      const float* __restrict__ packed,
                      const __nv_bfloat16* __restrict__ pw,
                      const float* __restrict__ mask,
                      const float* __restrict__ zmask,
                      const __nv_bfloat16* __restrict__ gout,
                      __nv_bfloat16* __restrict__ gx, TcBufs bufs, int N,
                      int G, int L, int k, int nseq, Dropout drop) {
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  float* r1 = reinterpret_cast<float*>(sm + O_R1);
  uint8_t* r2 = sm + O_R2;
  float* v_s = reinterpret_cast<float*>(sm + O_RV);
  float* m_s = v_s + TR;
  const bool reduce = mask != nullptr;
  const TcParams<K> P{packed};
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int cl = 2 * (lane & 3);
  constexpr int pad = K / 2;
  const int cd = tid & (D - 1), hf = tid >> 7;       // column-pass owner
  int row[2];                                        // the thread's rows
#pragma unroll
  for (int h = 0; h < 2; ++h)
    row[h] = TM * wg + 16 * warp + (lane >> 2) + 8 * h;
  tc_load_rows(sm, D, pw, D, D, tid, NTHREADS);
  tc_load_rows(sm + PW_BYTES, D, pw + D * D, D, D, tid, NTHREADS);
  tc::cp_async_commit();
  const int NV = vec_floats(k);
  float* sums = bufs.vec_part + static_cast<size_t>(gridDim.x) * NV
                + static_cast<size_t>(blockIdx.x) * ACC_FLOATS;
  float* ln_sums = sums + (tid >> 5) * 6 * D;         // this warp's
  float2* r3 = reinterpret_cast<float2*>(    // the h stash, [32][NTHREADS]
      bufs.vec_part + static_cast<size_t>(gridDim.x) * (NV + ACC_FLOATS)
      + static_cast<size_t>(blockIdx.x) * H_FLOATS);
  for (int idx = tid; idx < ACC_FLOATS; idx += NTHREADS) sums[idx] = 0.f;

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
      tc_keep_bits<16, true>(drop, drop.row_key((lane & 1) ? grow[1] : grow[0]),
                             lane, kw);
    auto keep = [&](int h, int q, int e) {
      return !drop.on() ? 1.f
          : ((kw[h][q >> 3] >> (4 * (q & 7) + e)) & 1u ? drop.scale : 0.f);
    };
    tc::cp_async_wait<0>();            // pw (first tile)
    tc::fence_async_smem();
    __syncthreads();

    // h0 = x + pe of the thread's values
    auto load_h0 = [&](float (&hv)[64]) {
#pragma unroll
      for (int pr = 0; pr < 32; ++pr) {
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
    // row statistics of the thread's two rows (fast variance, clipped)
    auto stats = [&](const float (&hv)[64], float (&mean)[2],
                     float (&istd)[2]) {
      mean[0] = mean[1] = istd[0] = istd[1] = 0.f;
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        mean[(j >> 1) & 1] += hv[j];
        istd[(j >> 1) & 1] = fmaf(hv[j], hv[j], istd[(j >> 1) & 1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mean[h] = quad_sum(mean[h]) * drop.inv1;
        istd[h] = rsqrtf(fmaxf(quad_sum(istd[h]) * drop.inv1
                               - mean[h] * mean[h], 0.f) + LN_EPS);
      }
    };
    // LN_i(hv) (times conv 0's dropout on layer 0; the final LN for i = 2)
    // into R1
    auto ln_to_r1 = [&](const float (&hv)[64], const float* sc,
                        const float* bi, bool drop0) {
      float mean[2], istd[2];
      stats(hv, mean, istd);
#pragma unroll
      for (int pr = 0; pr < 32; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = 8 * q + cl;
        const float2 s2 = ldg2(sc + c), b2 = ldg2(bi + c);
        float y0 = (hv[2 * pr] - mean[h]) * istd[h] * s2.x + b2.x;
        float y1 = (hv[2 * pr + 1] - mean[h]) * istd[h] * s2.y + b2.y;
        if (drop0) {
          y0 *= keep(h, q, 0);
          y1 *= keep(h, q, 1);
        }
        *reinterpret_cast<float2*>(r1 + r1_at(row[h], c)) =
            make_float2(y0, y1);
      }
    };
    // c = depthwise_i(t of R1 times v) rounded to bf16: the A tile in R2,
    // and out as rows when c_rows is not NULL
    auto conv = [&](int i, __nv_bfloat16* c_rows) {
#pragma unroll
      for (int pr = 0; pr < 32; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        float2 a = ldg2(P.dwb(i) + c);
        if (valid[h]) {
          const int base = row[h] - lrow[h];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int rr = lrow[h] + j - pad;
            if (rr < 0 || rr >= L) continue;
            const float vv = v_s[base + rr];
            const float2 tt = *reinterpret_cast<const float2*>(
                r1 + r1_at(base + rr, c));
            const float2 w = ldg2(P.dw(i) + j * D + c);
            a.x = fmaf(w.x, tt.x * vv, a.x);
            a.y = fmaf(w.y, tt.y * vv, a.y);
          }
        }
        const uint32_t p = tc::pack_bf16(a.x, a.y);
        *reinterpret_cast<uint32_t*>(r2 + (c >> 6) * R2_PANEL
                                     + tc::swz(row[h], c & 63)) = p;
        if (c_rows != nullptr && valid[h])
          *reinterpret_cast<uint32_t*>(c_rows + grow[h] * D + c) = p;
      }
    };
    // acc = c (R2, the warpgroup's 64 rows) pw_i
    auto fwd_mma = [&](int i, float (&acc)[64]) {
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        tc::mma_ss<128, 0, 1>(
            acc,
            tc::make_desc(tc::smem_u32(r2) + (ks / 4) * R2_PANEL
                              + wg * TM * tc::ROW_BYTES + (ks % 4) * 32, 16),
            tc::make_desc(tc::smem_u32(sm) + i * PW_BYTES
                              + ks * 2 * tc::ATOM_BYTES, PW_PANEL),
            ks > 0);
      tc::commit();
      tc::wait_all();
    };
    // g_y = g (y > 0) rounded to bf16 (A from registers, rows out), then
    // acc = g_y pw_i^T
    auto bwd_mma = [&](int i, const float (&g)[64], const uint32_t (&sg)[2],
                       __nv_bfloat16* gy_rows, float (&acc)[64]) {
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t f[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pr = 4 * ks + u, h = pr & 1, c = 8 * (pr >> 1) + cl;
          const uint32_t bits = sg[pr >> 4] >> (2 * (pr & 15));
          f[u] = tc::pack_bf16(bits & 1u ? g[2 * pr] : 0.f,
                               bits & 2u ? g[2 * pr + 1] : 0.f);
          if (valid[h])
            *reinterpret_cast<uint32_t*>(gy_rows + grow[h] * D + c) = f[u];
        }
        tc::mma_rs<128, 0>(
            acc, f,
            tc::make_desc(tc::smem_u32(sm) + i * PW_BYTES
                              + (ks / 4) * PW_PANEL + (ks % 4) * 32, 16),
            ks > 0);
      }
      tc::commit();
      tc::wait_all();
    };
    // y = acc + pwb_i in acc, and its ReLU sign bits (bit j % 32 of
    // sg[j / 32] for value j)
    auto relu_sign = [&](int i, float (&acc)[64], uint32_t (&sg)[2]) {
      sg[0] = sg[1] = 0u;
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        acc[j] += __ldg(P.pwb(i) + acc_col(j, lane));
        if (acc[j] > 0.f) sg[j >> 5] |= 1u << (j & 31);
      }
    };
    // the LN output t of R1 in bf16 into R2 (the thread's values), for the
    // depthwise weight gradient
    auto t_to_r2 = [&]() {
#pragma unroll
      for (int pr = 0; pr < 32; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        const float2 tt = *reinterpret_cast<const float2*>(
            r1 + r1_at(row[h], c));
        *reinterpret_cast<uint32_t*>(r2 + (c >> 6) * R2_PANEL
                                     + tc::swz(row[h], c & 63)) =
            tc::pack_bf16(tt.x, tt.y);
      }
    };
    // acc (g_c) into R1; after a barrier the depthwise weight gradients
    // (column pass over R1 and R2's bf16 t, into the running sums) and
    // acc = g_t, the gradient of the conv input (times the dropout mask on
    // layer 0)
    auto conv_bwd = [&](int i, float (&acc)[64]) {
#pragma unroll
      for (int pr = 0; pr < 32; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        *reinterpret_cast<float2*>(r1 + r1_at(row[h], c)) =
            make_float2(acc[2 * pr], acc[2 * pr + 1]);
      }
      __syncthreads();
      // column cd over the tile's sequences, rows [0, L / 2) or [L / 2, L)
      // of each by half hf, with the taps' inputs t v in a sliding window
      float gdw[K], gdwb = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) gdw[j] = 0.f;
      auto tv = [&](int r) {           // t v of tile row r, column cd
        return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                   r2 + (cd >> 6) * R2_PANEL + tc::swz(r, cd & 63)))
               * v_s[r];
      };
      const int lb = hf ? (L + 1) / 2 : 0, le = hf ? L : (L + 1) / 2;
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
          const float gc = r1[r1_at(base + l, cd)];
          gdwb += gc;
#pragma unroll
          for (int j = 0; j < K; ++j) gdw[j] = fmaf(win[j], gc, gdw[j]);
        }
      }
      float* dsum = sums + ACC_LN + (hf * 2 + i) * (MAX_K + 1) * D + cd;
#pragma unroll
      for (int j = 0; j < K; ++j) dsum[j * D] += gdw[j];
      dsum[MAX_K * D] += gdwb;
#pragma unroll
      for (int pr = 0; pr < 32; ++pr) {
        const int h = pr & 1, q = pr >> 1, c = 8 * q + cl;
        float2 a = make_float2(0.f, 0.f);
        if (valid[h]) {
          const int base = row[h] - lrow[h];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int rr = lrow[h] - j + pad;
            if (rr < 0 || rr >= L) continue;
            const float2 gc = *reinterpret_cast<const float2*>(
                r1 + r1_at(base + rr, c));
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
    auto from_r3 = [&](int pr) { return r3[pr * NTHREADS + tid]; };

    float hv[64], acc[64], ga[64];
    uint32_t sg[2];
    // ---- pass A: layer 0 for h1, layer 1 with its stash -----------------
    load_h0(hv);
    ln_to_r1(hv, P.ln_s(0), P.ln_b(0), true);
    __syncthreads();
    conv(0, nullptr);
    tc::fence_async_smem();
    __syncthreads();
    fwd_mma(0, acc);
    relu_sign(0, acc, sg);
#pragma unroll
    for (int j = 0; j < 64; ++j) hv[j] += fmaxf(acc[j], 0.f);     // h1
#pragma unroll
    for (int pr = 0; pr < 32; ++pr)
      r3[pr * NTHREADS + tid] = make_float2(hv[2 * pr], hv[2 * pr + 1]);
    ln_to_r1(hv, P.ln_s(1), P.ln_b(1), false);
    __syncthreads();
    conv(1, bufs.c[1]);
    tc::fence_async_smem();
    __syncthreads();
    fwd_mma(1, acc);
    relu_sign(1, acc, sg);
#pragma unroll
    for (int j = 0; j < 64; ++j) hv[j] += fmaxf(acc[j], 0.f);     // h2
    t_to_r2();
    // ---- the output's cotangent (reduce mode: final LN and masked-max
    // backward), final-LN backward -------------------------------------
    if (reduce) {
      ln_to_r1(hv, P.lnf_s(), P.lnf_b(), false);
      __syncthreads();
      for (int idx = tid; idx < rows / L * D; idx += NTHREADS) {
        const int s = idx / D, d = idx % D, base = s * L;
        float mx = -CUDART_INF_F;
        for (int l = 0; l < L; ++l) {
          const float m = m_s[base + l];
          mx = fmaxf(mx, r1[r1_at(base + l, d)] * m + (m - 1.f) * 1e10f);
        }
        float cnt = 0.f;
        for (int l = 0; l < L; ++l) {
          const float m = m_s[base + l];
          cnt += (r1[r1_at(base + l, d)] * m + (m - 1.f) * 1e10f) == mx
                     ? 1.f : 0.f;
        }
        const float g = __bfloat162float(
            gout[static_cast<size_t>(n0 + s) * D + d]);
        for (int l = 0; l < L; ++l) {
          const float m = m_s[base + l];
          float& o = r1[r1_at(base + l, d)];
          const bool eq = (o * m + (m - 1.f) * 1e10f) == mx;
          o = (eq ? g : 0.f) / cnt * m;
        }
      }
      __syncthreads();
#pragma unroll
      for (int pr = 0; pr < 32; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        const float2 g2 = valid[h]
            ? *reinterpret_cast<const float2*>(r1 + r1_at(row[h], c))
            : make_float2(0.f, 0.f);
        ga[2 * pr] = g2.x;
        ga[2 * pr + 1] = g2.y;
      }
    } else {
#pragma unroll
      for (int pr = 0; pr < 32; ++pr) {
        const int h = pr & 1, c = 8 * (pr >> 1) + cl;
        const float2 g2 = valid[h]
            ? tc::unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(
                  gout + grow[h] * D + c)))
            : make_float2(0.f, 0.f);
        ga[2 * pr] = g2.x;
        ga[2 * pr + 1] = g2.y;
      }
    }
    ln_bwd_tile([&](int pr) {
                  return make_float2(hv[2 * pr], hv[2 * pr + 1]);
                }, ga, P.lnf_s(), ln_sums + 4 * D, lane, drop.inv1);
    // ---- layer 1 backward -----------------------------------------------
    bwd_mma(1, ga, sg, bufs.gy[1], acc);
    conv_bwd(1, acc);
    ln_bwd_tile(from_r3, acc, P.ln_s(1), ln_sums + 2 * D, lane, drop.inv1);
#pragma unroll
    for (int j = 0; j < 64; ++j) ga[j] += acc[j];                 // g_h1
    __syncthreads();                   // R1 (g_c1) and R2 (t1) are read
    // ---- pass B: recompute layer 0 (dropout replayed), its backward -----
    load_h0(hv);
#pragma unroll
    for (int pr = 0; pr < 32; ++pr)
      r3[pr * NTHREADS + tid] = make_float2(hv[2 * pr], hv[2 * pr + 1]);
    ln_to_r1(hv, P.ln_s(0), P.ln_b(0), true);
    __syncthreads();
    conv(0, bufs.c[0]);
    tc::fence_async_smem();
    __syncthreads();
    fwd_mma(0, acc);
    relu_sign(0, acc, sg);
    t_to_r2();
    bwd_mma(0, ga, sg, bufs.gy[0], acc);
    conv_bwd(0, acc);
    ln_bwd_tile(from_r3, acc, P.ln_s(0), ln_sums, lane, drop.inv1);
#pragma unroll
    for (int pr = 0; pr < 32; ++pr) {  // d(x + pe)/dx = 1
      const int h = pr & 1, c = 8 * (pr >> 1) + cl;
      if (valid[h])
        *reinterpret_cast<uint32_t*>(gx + grow[h] * D + c) = tc::pack_bf16(
            acc[2 * pr] + ga[2 * pr], acc[2 * pr + 1] + ga[2 * pr + 1]);
    }
  }

  // ---- the block's parameter-vector partials, summed in a fixed order --
  __syncthreads();                     // every running sum is final
  float* out = bufs.vec_part + static_cast<size_t>(blockIdx.x) * NV;
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
    const float* src = sums + ACC_LN + i * (MAX_K + 1) * D + d;
    const int jj = j < k ? j : MAX_K;
    out[i * (4 + k) * D + (2 + j) * D + d] = j == k + 1
        ? 0.f                                      // pwb: wgrad_tc's
        : src[jj * D] + src[2 * (MAX_K + 1) * D + jj * D];
  }
}


// The bf16 backward: the main kernel, the two layers' weight gradients over
// the bf16 rows it wrote, and the fixed-order slot sum.
int launch_tc(const void* x, const float* pe, const float* packed,
              const void* pw, const float* mask, const float* zmask,
              const void* g, void* gx, TcBufs bufs, float* gvec,
              float* wg_part, float* gpw, int N, int G, int L, int k,
              int wg_chunks, Dropout drop, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kern = encoder_bwd_tc_kernel<1>;
  switch (k) {
    case 3: kern = encoder_bwd_tc_kernel<3>; break;
    case 5: kern = encoder_bwd_tc_kernel<5>; break;
    case 7: kern = encoder_bwd_tc_kernel<7>; break;
    case 9: kern = encoder_bwd_tc_kernel<9>; break;
    default: break;
  }
  cudaError_t err = allow_smem(kern, TC_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int nseq = TR / L, tiles = (N + nseq - 1) / nseq;
  const int blocks = tiles < sms ? tiles : sms;
  kern<<<blocks, NTHREADS, TC_SMEM, stream>>>(
      static_cast<const bf16*>(x), pe, packed, static_cast<const bf16*>(pw),
      mask, zmask, static_cast<const bf16*>(g), static_cast<bf16*>(gx), bufs,
      N, G, L, k, nseq, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(N) * L;
  for (int i = 0; i < 2; ++i)
    if ((err = wgrad_tc(bufs.c[i], bufs.gy[i], wg_part,
                        gpw + i * (D + 1) * D, rows, D, D, wg_chunks,
                        stream))
        != cudaSuccess)
      return static_cast<int>(err);
  return static_cast<int>(sum_slots<float>(bufs.vec_part, gvec, 1, blocks,
                                           vec_floats(k), stream));
}

int launch_any(const void* x, const void* pe, const void* packed,
               const void* pwT, const void* mask, const void* zmask,
               const void* g, void* gx, void* gvec, void* gpw, void* c0,
               void* c1, void* gy0, void* gy1, void* vec_part, void* wg_part,
               int N, int G, int L, int k, int wg_chunks,
               const unsigned long long* drop_seed, unsigned drop_threshold,
               float drop_scale, int dv, const int* gmap, int g_glob,
               int is_bf16, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop = entry_dropout(
      drop_seed, drop_threshold, drop_scale, dv, gmap, G, g_glob, L);
  if (!width_ok(dv, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (k % 2 == 0 || k > MAX_K || L < 1 || L > TR)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    auto h = [](void* p) { return static_cast<__nv_bfloat16*>(p); };
    const TcBufs bufs{{h(c0), h(c1)}, {h(gy0), h(gy1)}, fm(vec_part)};
    return launch_tc(x, f(pe), f(packed), pwT, f(mask), f(zmask), g, gx,
                     bufs, fm(gvec), fm(wg_part), fm(gpw), N, G, L, k,
                     wg_chunks, drop, st);
  }
  const Bufs bufs{{fm(c0), fm(c1)}, {fm(gy0), fm(gy1)}, fm(vec_part)};
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
// When is_bf16: pwT is [pw0; pw1] (2, D, D) bfloat16 as they lie; gpw is
// (2, D + 1, D), each layer's gpw with its gpwb as the last row (gvec's
// pwb entries are 0); c0, c1, gy0, gy1 are bfloat16; vec_part is
// min(N, SMs) x (vec_floats + ACC_FLOATS + H_FLOATS) floats; wg_part is
// (wg_chunks, D + 1, D).
// dv: the true width, 4 <= dv <= D with 4 | dv, of inputs zero-padded to D
// (every LN's statistics and the Philox keys, philox.cuh); gmap / g_glob the
// group map of the full-output mode (Dropout::row_key; NULL / 1 for none).
extern "C" int encoder_reduce_bwd(
    const void* x, const void* pe, const void* packed, const void* pwT,
    const void* mask, const void* g, void* gx, void* gvec, void* gpw,
    void* c0, void* c1, void* gy0, void* gy1, void* vec_part, void* wg_part,
    int N, int L, int k, int wg_chunks, const unsigned long long* drop_seed,
    unsigned drop_threshold, float drop_scale, int dv, const int* gmap,
    int g_glob, int is_bf16, void* stream) {
  if (mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(x, pe, packed, pwT, mask, nullptr, g, gx, gvec, gpw, c0,
                    c1, gy0, gy1, vec_part, wg_part, N, 1, L, k, wg_chunks,
                    drop_seed, drop_threshold, drop_scale, dv, gmap, g_glob,
                    is_bf16, stream);
}

// Full-output mode: g (N, L, D) is the cotangent of the block output;
// zmask (G, L) float32 or NULL, sequence n uses its row n % G.  Everything
// else as encoder_reduce_bwd.
extern "C" int encoder_block_bwd(
    const void* x, const void* pe, const void* packed, const void* pwT,
    const void* zmask, const void* g, void* gx, void* gvec, void* gpw,
    void* c0, void* c1, void* gy0, void* gy1, void* vec_part, void* wg_part,
    int N, int G, int L, int k, int wg_chunks,
    const unsigned long long* drop_seed, unsigned drop_threshold,
    float drop_scale, int dv, const int* gmap, int g_glob, int is_bf16,
    void* stream) {
  if (G < 1 || N % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(x, pe, packed, pwT, nullptr, zmask, g, gx, gvec, gpw, c0,
                    c1, gy0, gy1, vec_part, wg_part, N, G, L, k, wg_chunks,
                    drop_seed, drop_threshold, drop_scale, dv, gmap, g_glob,
                    is_bf16, stream);
}
