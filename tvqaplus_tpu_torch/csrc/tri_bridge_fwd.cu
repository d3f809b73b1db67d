// Fused tri-concat MLP bridge, forward, with its dropout.
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_tri_bridge.py
// (fused_tri_bridge -> _forward / _fwd_kernel), STAGE's concat_fc.  For
// every row of the (B, A, Li, Lqa, D) attended statements s and v:
//   x    = [s; v; s * v]                         (3D wide, never stored)
//   y    = LN_in(x)        fast variance clipped at 0, float32 stats
//          (training: times the Philox dropout mask of philox.cuh, keyed
//          by the flat index of the (rows, 3D) LN output)
//   out  = LN_out(ReLU(y W + bias))              W: (3D, D)
// out has the activation type of s and v.
//
// What bounds it on the H100: per row it reads 2 x D values, writes D and
// does 2 * 3D * D FLOPs (160,000 rows at the headline eval: ~123 MB, ~16
// GFLOP), so at the card's peaks it is bound by bytes (~37 us); on the
// float32 CUDA cores it uses, the 3D x D product bounds it.
// Design: one block per tile of 32 rows; each warp owns 4 rows.  The LN_in
// statistics over the virtual concat are three partial sums per lane, so
// the 3D-wide input exists only as the tile's normalised 32 x 3D buffer in
// shared memory.  The block multiplies it by W, which is staged 32 rows at
// a time through shared memory from L2 (every block reads the same 196 KB).
// A warp's 32 lanes hold a row's 128 outputs (4 each), so LN_out is a warp
// reduction in registers, and the output is written once.
#include "common.cuh"
#include "philox.cuh"

namespace {

using namespace tvqa;

constexpr int RPT = 4;
constexpr int RT = RPT * NWARPS;        // 32 rows per block
constexpr int SMEM_FLOATS = RT * 3 * D + KC * D;

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
tri_bridge_fwd_kernel(const T* __restrict__ s, const T* __restrict__ v,
                      const float* __restrict__ gin,
                      const float* __restrict__ bin,
                      const float* __restrict__ W,
                      const float* __restrict__ bias,
                      const float* __restrict__ gout,
                      const float* __restrict__ bout, T* __restrict__ out,
                      long long R, Dropout drop) {
  extern __shared__ float4 smem4[];
  float* y_s = reinterpret_cast<float*>(smem4);
  float* w_s = y_s + RT * 3 * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * RT;

#pragma unroll 1
  for (int jj = 0; jj < RPT; ++jj) {
    const int r = warp * RPT + jj;
    const long long row = r0 + r;
    const bool live = row < R;
    float x[3][4], sum = 0.f, ss = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = lane + 32 * q;
      const float a = live ? to_f(s[row * D + d]) : 0.f;
      const float c = live ? to_f(v[row * D + d]) : 0.f;
      x[0][q] = a;
      x[1][q] = c;
      x[2][q] = a * c;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        sum += x[g][q];
        ss = fmaf(x[g][q], x[g][q], ss);
      }
    }
    sum = warp_sum(sum);
    ss = warp_sum(ss);
    const float mean = sum * (1.f / (3 * D));
    const float var = fmaxf(ss * (1.f / (3 * D)) - mean * mean, 0.f);
    const float istd = rsqrtf(var + LN_EPS);
    float* yr = y_s + r * 3 * D;
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = g * D + lane + 32 * q;
        yr[k] = (x[g][q] - mean) * istd * gin[k] + bin[k];
      }
    if (drop.on() && live) {
      __syncwarp();
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float km[4];
        const int k0 = g * D + lane * 4;
        keep4(drop.seed, static_cast<unsigned long long>(row) * (3 * D) + k0,
              drop.threshold, drop.scale, km);
#pragma unroll
        for (int t = 0; t < 4; ++t) yr[k0 + t] *= km[t];
      }
    }
  }

  float acc[RPT][4];
  gemm_staged<RPT>(acc, y_s, 3 * D, 3 * D, W, w_s, warp * RPT, lane * 4);

  const int c0 = lane * 4;
  const float4 bv = *reinterpret_cast<const float4*>(bias + c0);
  const float4 gv = *reinterpret_cast<const float4*>(gout + c0);
  const float4 ov = *reinterpret_cast<const float4*>(bout + c0);
#pragma unroll
  for (int jj = 0; jj < RPT; ++jj) {
    const long long row = r0 + warp * RPT + jj;
    const float h0 = fmaxf(acc[jj][0] + bv.x, 0.f);
    const float h1 = fmaxf(acc[jj][1] + bv.y, 0.f);
    const float h2 = fmaxf(acc[jj][2] + bv.z, 0.f);
    const float h3 = fmaxf(acc[jj][3] + bv.w, 0.f);
    const float sum = warp_sum(h0 + h1 + h2 + h3);
    const float ss = warp_sum(h0 * h0 + h1 * h1 + h2 * h2 + h3 * h3);
    const float mean = sum * (1.f / D);
    const float var = fmaxf(ss * (1.f / D) - mean * mean, 0.f);
    const float istd = rsqrtf(var + LN_EPS);
    if (row < R)
      store4<T>(out + row * D + c0, (h0 - mean) * istd * gv.x + ov.x,
                (h1 - mean) * istd * gv.y + ov.y,
                (h2 - mean) * istd * gv.z + ov.z,
                (h3 - mean) * istd * gv.w + ov.w);
  }
}

template <typename T>
int launch(const void* s, const void* v, const float* gin, const float* bin,
           const float* W, const float* bias, const float* gout,
           const float* bout, void* out, long long R, Dropout drop,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * SMEM_FLOATS;
  cudaError_t err = allow_smem(tri_bridge_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((R + RT - 1) / RT);
  tri_bridge_fwd_kernel<T><<<blocks, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(v), gin, bin, W, bias,
      gout, bout, static_cast<T*>(out), R, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s, v, out: R rows of D, all bf16 (is_bf16) or all float32; gin/bin (3D),
// W (3D, D), bias/gout/bout (D) float32.  Dropout on the LN_in output when
// drop_threshold > 0 (philox.cuh).
extern "C" int tri_bridge_fwd(const void* s, const void* v, const void* gin,
                              const void* bin, const void* W,
                              const void* bias, const void* gout,
                              const void* bout, void* out, long long R,
                              unsigned long long drop_seed,
                              unsigned drop_threshold, float drop_scale,
                              int is_bf16, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_seed, drop_threshold, drop_scale};
  if (is_bf16)
    return launch<__nv_bfloat16>(s, v, f(gin), f(bin), f(W), f(bias),
                                 f(gout), f(bout), out, R, drop, st);
  return launch<float>(s, v, f(gin), f(bin), f(W), f(bias), f(gout), f(bout),
                       out, R, drop, st);
}
