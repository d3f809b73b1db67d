// Fused MLP bridge, forward, with its dropout.
//
// Replaces the TPU kernel tvqaplus_tpu/ops/pallas_bridge.py
// (fused_mlp_bridge -> _forward :137, call :149 / _fwd_kernel :61): the
// MLPBridge recipe of STAGE's bert_word_encoding_fc (768 -> 300) and vid_fc
// (300 -> 300).  For every row of x (R x Din):
//   y   = LN_in(x)       fast variance clipped at 0, float32 stats
//         (training: times the Philox dropout mask of philox.cuh, keyed by
//         the flat index of the (R, Din) LN output)
//   out = LN_out(ReLU(y W + bias))                 W: (Din, Dout)
// out (R x Dout) has the compute type: float32, or bfloat16 for the bf16
// compute mode, which reads x as float32 or bfloat16 and rounds y and W to
// bf16 before the product (float32 sums), as the TPU kernel's bf16 mode
// does (pallas_bridge.py:52-54); y1, the LNs and their statistics stay
// float32.
//
// What bounds it on the H100: per row it reads Din values, writes Dout and
// does 2 * Din * Dout FLOPs (the subtitle stream's 40,000 rows of 768 in
// bf16: ~85 MB, ~18 GFLOP), so at the card's peaks it is bound by bytes
// (~26 us).
//
// Two instantiations.
// * bfloat16: mlp_bridge_fwd_tc_kernel, on mlp_bridge_tc.cuh's device code
//   (shared with the backward's recompute).  One persistent block an SM
//   walks 64-row tiles (the wgmma M; 64 rows keep 50 blocks busy at the
//   smallest STAGE site, qas_bert's 3,200 rows, where 128-row tiles would
//   leave 25, and a 128-row A tile at Din 768 would not fit beside the W
//   stages).  Its eight warps take the tile's LN_in four rows at a time
//   and write yd in bf16 as the K-major A operand (96 KB at Din 768); W,
//   cast to bf16 once a call by the wrapper and zero-padded to (Kp, Np),
//   streams from L2 64 rows at a time through a ring of three cp.async
//   stages that runs on across tiles, so the next tile's first chunks load
//   during this tile's epilogue and LN.  Its bytes from L2 are those of W
//   once a tile (~300 MB at the subtitle stream, against ~1.15 GB for the
//   CUDA-core kernel's 32-row tiles), and their rate from L2 bounds the
//   products more than the tensor cores do.  The two warpgroups take three of
//   y1's five column panels each (the middle one twice where NP is odd,
//   one copy unused) and multiply on the tensor cores (wgmma, bf16
//   operands, float32 sums, pairs of panels one n128 product); bias, ReLU
//   and LN_out run on the accumulators, their row sums crossing the
//   warpgroups through shared memory, and the output is stored once in
//   bf16.  The next tile's x is prefetched into L2 while this one
//   multiplies.  The LN pass and the products run one after the other:
//   a third warpgroup making the next tile's A tile while these multiply
//   was slower (its LN pass, on four warps, became the critical path), and
//   so were these warps slicing the next tile's LN pass into the windows
//   between a chunk's wgmma and its wait.
// * float32: the exactness check, CUDA cores: one block per tile of 32
//   rows; each warp owns 4 rows.  The tile's normalised rows sit in shared
//   memory (32 x Din float32, 96 KB at 768); W is staged from L2 32 rows at
//   a time, one 128-wide column tile of the output after the other with a
//   guarded tail (300 = 128 + 128 + 44).  The pre-LN outputs go to a 32 x
//   Dout shared buffer, so LN_out is a warp reduction over the warp's own
//   rows and the output is written once.
#include "mlp_bridge.cuh"
#include "mlp_bridge_tc.cuh"

namespace {

using namespace tvqa;

__host__ __device__ inline int smem_floats(int Din, int Dout) {
  return BR_RT * round_kc(Din) + BR_RT * Dout + KC * D;
}

__global__ void __launch_bounds__(NTHREADS)
mlp_bridge_fwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ gin,
                      const float* __restrict__ bin,
                      const float* __restrict__ W,
                      const float* __restrict__ bias,
                      const float* __restrict__ gout,
                      const float* __restrict__ bout, float* __restrict__ out,
                      long long R, int Din, int Dout, Dropout drop) {
  drop.load_seed();
  extern __shared__ float4 smem4[];
  const int ys = round_kc(Din);
  float* y_s = reinterpret_cast<float*>(smem4);       // BR_RT x ys
  float* o_s = y_s + BR_RT * ys;                       // BR_RT x Dout
  float* w_s = o_s + BR_RT * Dout;                     // KC x D
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = lane * 4;
  const long long r0 = static_cast<long long>(blockIdx.x) * BR_RT;

  bridge_ln_in(x, y_s, nullptr, nullptr, gin, bin, r0, R, Din, ys, drop,
               warp, lane);

  for (int col0 = 0; col0 < Dout; col0 += D) {
    float acc[BR_RPT][4];
    bridge_gemm<BR_RPT, false>(acc, y_s, ys, Din, W, Dout, Dout, col0, w_s,
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
      out[row * Dout + c] = (hr[c] - mean) * istd * gout[c] + bout[c];
  }
}

int launch_f32(const float* x, const float* gin, const float* bin,
               const float* W, const float* bias, const float* gout,
               const float* bout, float* out, long long R, int Din, int Dout,
               Dropout drop, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(Din, Dout);
  cudaError_t err = allow_smem(mlp_bridge_fwd_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((R + BR_RT - 1) / BR_RT);
  mlp_bridge_fwd_kernel<<<blocks, NTHREADS, bytes, stream>>>(
      x, gin, bin, W, bias, gout, bout, out, R, Din, Dout, drop);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bfloat16 instantiation: tensor cores ------------------------------

constexpr int FWD_STAGES = 3;

// [A tile: TM x Kp bf16][ring: FWD_STAGES x TM x Np bf16][bias, gout, bout:
// Np floats each][exchange: 2 warpgroups x TM rows x 2 floats]
inline size_t fwd_tc_smem(int Kp, int Np) {
  return tc::ATOM_BYTES + static_cast<size_t>(TM) * Kp * 2
         + static_cast<size_t>(FWD_STAGES) * TM * Np * 2 + 3 * Np * 4
         + 2 * TM * 2 * 4;
}

// NPH = ceil(Np / 128): the y1 panels of each warpgroup (bt_panel_valid).
template <typename TX, int NPH>
__global__ void __launch_bounds__(NTHREADS, 1)
mlp_bridge_fwd_tc_kernel(const TX* __restrict__ x,
                         const float* __restrict__ gin,
                         const float* __restrict__ bin,
                         const __nv_bfloat16* __restrict__ W,
                         const float* __restrict__ bias,
                         const float* __restrict__ gout,
                         const float* __restrict__ bout,
                         __nv_bfloat16* __restrict__ out, long long R,
                         int Din, int Dout, Dropout drop) {
  drop.load_seed();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_smem(smem_raw);
  const int Kp = bt_pad64(Din), Np = bt_pad64(Dout);
  const int KC = Kp / 64, NP = Np / 64, stage_bytes = TM * Np * 2;
  uint8_t* a_s = sm;
  uint8_t* ring_s = a_s + TM * Kp * 2;
  float* bias_s = reinterpret_cast<float*>(ring_s + FWD_STAGES * stage_bytes);
  float* gout_s = bias_s + Np;
  float* bout_s = gout_s + Np;
  float* ex_s = bout_s + Np;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5;
  const int lane = tid & 31;
  const int rl = 16 * (warp & 3) + (lane >> 2), cl = 2 * (lane & 3);
  const int p0 = wg ? NP - NPH : 0;
  for (int c = tid; c < Np; c += NTHREADS) {
    const bool in = c < Dout;
    bias_s[c] = in ? bias[c] : 0.f;
    gout_s[c] = in ? gout[c] : 0.f;
    bout_s[c] = in ? bout[c] : 0.f;
  }
  const long long tiles = (R + TM - 1) / TM;
  BtRing<FWD_STAGES> ring{ring_s, W, Np, KC, stage_bytes,
                          (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                              * KC, 0};
  ring.start(tid);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * TM;
    const int rows = static_cast<int>(min(static_cast<long long>(TM),
                                          R - r0));
    const long long rn = r0 + static_cast<long long>(gridDim.x) * TM;
    if (rn < R)
      bt_prefetch_l2(x + rn * Din, static_cast<size_t>(min(
                         static_cast<long long>(TM), R - rn)) * Din
                         * sizeof(TX), tid, NTHREADS);
    // the A tile: the previous tile's products have all been waited for
    // before its LN_out exchange (a block barrier)
    bt_ln_in<TX, false>(x, r0, rows, Din, Kp, gin, bin, drop, a_s, nullptr,
                        nullptr, warp, lane);
    float acc[NPH][32], m2[2], i2[2];
    bt_y1<NPH, FWD_STAGES>(acc, ring, a_s, bias_s, ex_s, m2, i2, KC, Dout,
                           p0, wg, rl, tid);
#pragma unroll
    for (int p = 0; p < NPH; ++p) {
#pragma unroll
      for (int pr = 0; pr < 16; ++pr) {
        const int h = pr & 1;
        const int c = 64 * (p0 + p) + 8 * (pr >> 1) + cl;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[e] = (fmaxf(acc[p][2 * pr + e], 0.f) - m2[h]) * i2[h]
                 * gout_s[c + e] + bout_s[c + e];
        if (bt_panel_valid(wg, p0, p, NPH) && rl + 8 * h < rows
            && c < Dout)
          *reinterpret_cast<uint32_t*>(out + (r0 + rl + 8 * h) * Dout + c) =
              tc::pack_bf16(o[0], o[1]);
      }
    }
  }
  tc::cp_async_wait<0>();              // no copy outlives the block
}

template <typename TX, int NPH>
int launch_tc_n(const void* x, const float* gin, const float* bin,
                const void* W, const float* bias, const float* gout,
                const float* bout, void* out, long long R, int Din, int Dout,
                Dropout drop, cudaStream_t stream) {
  const size_t bytes = fwd_tc_smem(bt_pad64(Din), bt_pad64(Dout));
  cudaError_t err = allow_smem(mlp_bridge_fwd_tc_kernel<TX, NPH>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (R + TM - 1) / TM;
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  mlp_bridge_fwd_tc_kernel<TX, NPH><<<blocks, NTHREADS, bytes, stream>>>(
      static_cast<const TX*>(x), gin, bin,
      static_cast<const __nv_bfloat16*>(W), bias, gout, bout,
      static_cast<__nv_bfloat16*>(out), R, Din, Dout, drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX>
int launch_tc(const void* x, const float* gin, const float* bin,
              const void* W, const float* bias, const float* gout,
              const float* bout, void* out, long long R, int Din, int Dout,
              Dropout drop, cudaStream_t stream) {
  switch ((bt_pad64(Dout) / 64 + 1) / 2) {
    case 1:
      return launch_tc_n<TX, 1>(x, gin, bin, W, bias, gout, bout, out, R,
                                Din, Dout, drop, stream);
    case 2:
      return launch_tc_n<TX, 2>(x, gin, bin, W, bias, gout, bout, out, R,
                                Din, Dout, drop, stream);
    default:
      return launch_tc_n<TX, 3>(x, gin, bin, W, bias, gout, bout, out, R,
                                Din, Dout, drop, stream);
  }
}

}  // namespace

// x (R, Din) bf16 (x_bf16) or float32; out (R, Dout) bf16 in the bf16
// compute mode (is_bf16), else float32 (then x is float32 too); gin/bin
// (Din), bias/gout/bout (Dout) float32, 16-byte aligned; x 16-byte
// aligned.  W: float32 (Din, Dout) in the float32 mode; in the bf16 mode
// the packed bf16 (Kp, Np) matrix, Kp / Np = Din / Dout rounded up to 64,
// zeros outside (Din, Dout).  Din and Dout are multiples of 4 with
// 4 <= Din <= 768 and 4 <= Dout <= 320.  Dropout on the LN_in output when
// drop_threshold > 0 (philox.cuh).
extern "C" int mlp_bridge_fwd(const void* x, const void* gin, const void* bin,
                              const void* W, const void* bias,
                              const void* gout, const void* bout, void* out,
                              long long R, int Din, int Dout,
                              const unsigned long long* drop_seed,
                              unsigned drop_threshold, float drop_scale,
                              int x_bf16, int is_bf16, void* stream) {
  if (R < 1 || Din < 4 || Dout < 4 || Din % 4 != 0 || Dout % 4 != 0
      || Din > BT_MAX_DIN || Dout > BT_MAX_DOUT || (x_bf16 && !is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_seed, drop_threshold, drop_scale, 0ull};
  if (x_bf16)
    return launch_tc<__nv_bfloat16>(x, f(gin), f(bin), W, f(bias), f(gout),
                                    f(bout), out, R, Din, Dout, drop, st);
  if (is_bf16)
    return launch_tc<float>(x, f(gin), f(bin), W, f(bias), f(gout), f(bout),
                            out, R, Din, Dout, drop, st);
  return launch_f32(f(x), f(gin), f(bin), f(W), f(bias), f(gout), f(bout),
                    static_cast<float*>(out), R, Din, Dout, drop, st);
}
