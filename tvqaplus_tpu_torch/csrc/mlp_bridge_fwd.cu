// Fused MLP bridge, forward, with its dropout.
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_bridge.py
// (fused_mlp_bridge -> _forward / _fwd_kernel): the MLPBridge recipe of
// STAGE's bert_word_encoding_fc (768 -> 300) and vid_fc (300 -> 300).  For
// every row of x (R x Din):
//   y   = LN_in(x)       fast variance clipped at 0, float32 stats
//         (training: times the Philox dropout mask of philox.cuh, keyed by
//         the flat index of the (R, Din) LN output)
//   out = LN_out(ReLU(y W + bias))                 W: (Din, Dout)
// out (R x Dout) has the compute type: float32, or bfloat16 for the bf16
// compute mode, which reads x as float32 or bfloat16 and rounds y and W to
// bf16 before the product (float32 sums), as the TPU kernel's bf16 mode
// does; y, y1, the LNs and their statistics stay float32.
//
// What bounds it on the H100: per row it reads Din values, writes Dout and
// does 2 * Din * Dout FLOPs (the subtitle stream's 40,000 rows of 768 in
// bf16: ~85 MB, ~18 GFLOP), so at the card's peaks it is bound by bytes
// (~26 us); on the float32 CUDA cores it uses, the product bounds it.
// Design: one block per tile of 32 rows; each warp owns 4 rows.  The tile's
// normalised rows sit in shared memory (32 x Din float32, 96 KB at 768).  W
// (0.9 MB at 768 x 300) cannot: it is staged from L2 32 rows at a time, one
// 128-wide column tile of the output after the other with a guarded tail
// (300 = 128 + 128 + 44).  The pre-LN outputs go to a 32 x Dout shared
// buffer, so LN_out is a warp reduction over the warp's own rows and the
// output is written once.
#include <type_traits>

#include "mlp_bridge.cuh"

namespace {

using namespace tvqa;

__host__ __device__ inline int smem_floats(int Din, int Dout) {
  return BR_RT * round_kc(Din) + BR_RT * Dout + KC * D;
}

template <typename TX, typename TO>
__global__ void __launch_bounds__(NTHREADS)
mlp_bridge_fwd_kernel(const TX* __restrict__ x, const float* __restrict__ gin,
                      const float* __restrict__ bin,
                      const float* __restrict__ W,
                      const float* __restrict__ bias,
                      const float* __restrict__ gout,
                      const float* __restrict__ bout, TO* __restrict__ out,
                      long long R, int Din, int Dout, Dropout drop) {
  drop.load_seed();
  constexpr bool RND = std::is_same<TO, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  const int ys = round_kc(Din);
  float* y_s = reinterpret_cast<float*>(smem4);       // BR_RT x ys
  float* o_s = y_s + BR_RT * ys;                       // BR_RT x Dout
  float* w_s = o_s + BR_RT * Dout;                     // KC x D
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = lane * 4;
  const long long r0 = static_cast<long long>(blockIdx.x) * BR_RT;

  bridge_ln_in<TX, RND>(x, y_s, nullptr, nullptr, gin, bin, r0, R, Din, ys,
                        drop, warp, lane);

  for (int col0 = 0; col0 < Dout; col0 += D) {
    float acc[BR_RPT][4];
    bridge_gemm<BR_RPT, RND>(acc, y_s, ys, Din, W, Dout, Dout, col0, w_s,
                             warp * BR_RPT, c0);
    const int col = col0 + c0;
    if (col < Dout) {
      const float4 bv = *reinterpret_cast<const float4*>(bias + col);
#pragma unroll
      for (int jj = 0; jj < BR_RPT; ++jj)
        *reinterpret_cast<float4*>(o_s + (warp * BR_RPT + jj) * Dout + col) =
            make_float4(fmaxf(acc[jj][0] + bv.x, 0.f),
                        fmaxf(acc[jj][1] + bv.y, 0.f),
                        fmaxf(acc[jj][2] + bv.z, 0.f),
                        fmaxf(acc[jj][3] + bv.w, 0.f));
    }
  }
  __syncwarp();                        // a warp reads back its own rows only

  for (int jj = 0; jj < BR_RPT; ++jj) {
    const int r = warp * BR_RPT + jj;
    const long long row = r0 + r;
    if (row >= R) continue;
    const float* hr = o_s + r * Dout;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < Dout; c += 32) {
      const float h = hr[c];
      s += h;
      ss = fmaf(h, h, ss);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / Dout;
    const float istd = rsqrtf(fmaxf(ss / Dout - mean * mean, 0.f) + LN_EPS);
    for (int c = lane; c < Dout; c += 32)
      out[row * Dout + c] =
          from_f<TO>((hr[c] - mean) * istd * gout[c] + bout[c]);
  }
}

template <typename TX, typename TO>
int launch(const void* x, const float* gin, const float* bin, const float* W,
           const float* bias, const float* gout, const float* bout, void* out,
           long long R, int Din, int Dout, Dropout drop,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(Din, Dout);
  cudaError_t err = allow_smem(mlp_bridge_fwd_kernel<TX, TO>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((R + BR_RT - 1) / BR_RT);
  mlp_bridge_fwd_kernel<TX, TO><<<blocks, NTHREADS, bytes, stream>>>(
      static_cast<const TX*>(x), gin, bin, W, bias, gout, bout,
      static_cast<TO*>(out), R, Din, Dout, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (R, Din) bf16 (x_bf16) or float32; out (R, Dout) bf16 in the bf16
// compute mode (is_bf16), else float32 (then x is float32 too); gin/bin
// (Din), W (Din, Dout), bias/gout/bout (Dout) float32, 16-byte aligned.
// Din and Dout are multiples of 4 and 32 * (round32(Din) + Dout + 128)
// floats fit a block's shared memory.  Dropout on the LN_in output when
// drop_threshold > 0 (philox.cuh).
extern "C" int mlp_bridge_fwd(const void* x, const void* gin, const void* bin,
                              const void* W, const void* bias,
                              const void* gout, const void* bout, void* out,
                              long long R, int Din, int Dout,
                              const unsigned long long* drop_seed,
                              unsigned drop_threshold, float drop_scale,
                              int x_bf16, int is_bf16, void* stream) {
  if (R < 1 || Din < 4 || Dout < 4 || Din % 4 != 0 || Dout % 4 != 0
      || (x_bf16 && !is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_seed, drop_threshold, drop_scale, 0ull};
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    return launch<bf16, bf16>(x, f(gin), f(bin), f(W), f(bias), f(gout),
                              f(bout), out, R, Din, Dout, drop, st);
  if (is_bf16)
    return launch<float, bf16>(x, f(gin), f(bin), f(W), f(bias), f(gout),
                               f(bout), out, R, Din, Dout, drop, st);
  return launch<float, float>(x, f(gin), f(bin), f(W), f(bias), f(gout),
                              f(bout), out, R, Din, Dout, drop, st);
}
