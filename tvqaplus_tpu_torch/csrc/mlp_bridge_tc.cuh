// Device code shared by the fused MLP bridge's tensor-core kernels: the
// forward (mlp_bridge_fwd.cu, mlp_bridge_fwd_tc_kernel) and the backward's
// recompute (mlp_bridge_bwd.cu, mlp_bridge_bwd_tc_kernel), so the two
// cannot drift.
//
// Widths: Din and Dout are run-time values, multiples of 4, with
// 4 <= Din <= BT_MAX_DIN (768) and 4 <= Dout <= BT_MAX_DOUT (320); STAGE's
// bridges are 768 -> 300 and 300 -> 300.  wgmma steps K by 16 and a
// swizzled panel holds 64 columns, so both are padded with zeros to
// multiples of 64 (Kp, Np: 768 -> 768, 300 -> 320): the wrapper packs W
// once a call as a zero-padded bf16 (Kp, Np) matrix, and the kernels keep
// the padded columns of every operand at 0 and divide LN_out's sums by the
// true Dout.
//
// A block's two warpgroups share a tile of TM = 64 rows.  The A operand of
// y1 = yd W is the tile's dropped LN_in output yd, rounded to bf16 (the TPU
// kernel's rounding site, pallas_bridge.py:52-54) and written K-major into
// Kp / 64 swizzled panels.  W streams through a ring of stages, each 64
// rows of W (all Np columns: Np / 64 panels), because bf16 W at 768 x 320
// (480 KB) cannot stay resident; the same stage serves y1 = yd W (W read
// MN-major: rows = depth) and, in the backward, g_yd = g_y1 W^T (W read
// K-major: rows = the output column).  Warpgroup 0 owns the first
// ceil(NP / 2) panels of y1's columns, warpgroup 1 the rest
// (bt_panel_valid); LN_out's row statistics cross the warpgroups through
// shared memory (tri_row_pair_sums).
#pragma once

#include "philox.cuh"
#include "tri_bridge_tc.cuh"
#include "wgmma.cuh"

namespace tvqa {

constexpr int BT_MAX_DIN = 768;
constexpr int BT_MAX_DOUT = 320;
constexpr int BT_QMAX = BT_MAX_DIN / 128;       // x quads a lane holds a row
constexpr int BT_KEEP_WORDS = 4 * BT_QMAX;      // keep-bit words a row

// Padded width: n rounded up to whole 64-column panels.
__host__ __device__ constexpr int bt_pad64(int n) {
  return (n + 63) / 64 * 64;
}

// wgmma m64n128k16 with its 64 accumulators given as two 32-value halves
// (d0: columns 0-63, d1: 64-127), so that a warpgroup's panels of y1 sit in
// one float[NPH][32] array and a pair of them takes one instruction.
template <int TA, int TB>
__device__ __forceinline__ void bt_mma_pair(float (&d0)[32], float (&d1)[32],
                                            uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TVQA_L64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : TVQA_D32(d0, 0), TVQA_D32(d1, 0)
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// cp.async rows [64 c, 64 c + 64) of the packed W (Kp x Np bf16) into a
// ring stage: Np / 64 panels of 64 rows x 64 columns.  Thread t of n.
__device__ __forceinline__ void bt_load_w(uint8_t* stage,
                                          const __nv_bfloat16* __restrict__ W,
                                          int Np, int c, int t, int n) {
  const int per_row = Np / 8;                        // 16-byte chunks
  const __nv_bfloat16* src = W + static_cast<size_t>(c) * TM * Np;
  for (int i = t; i < TM * per_row; i += n) {
    const int r = i / per_row, ch = i - r * per_row;
    tc::cp_async16(stage + (ch >> 3) * TILE_PANEL + tc::swz_chunk(r, ch & 7),
                   src + static_cast<size_t>(r) * Np + ch * 8);
  }
}

// An 8-byte cp.async (through L1: .cg takes 16 bytes only).
__device__ __forceinline__ void bt_cp_async8(void* smem_dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   tc::smem_u32(smem_dst)),
               "l"(src)
               : "memory");
}

// The ring of S stages that W streams through.  A block consumes chunk
// n = 0, 1, 2, ... (chunk n is W's rows 64 (n % KC) .. + 63, KC = Kp / 64,
// whatever the tile or the pass); S - 1 chunks load ahead of the one in
// use.  Every thread of the block calls start() once and next() once per
// chunk; next() returns the chunk's stage, whole and visible to wgmma, and
// starts loading chunk n + S - 1 into the stage that chunk n - 1 used
// (whose products every warpgroup has waited for before the barrier).
template <int S>
struct BtRing {
  uint8_t* base;
  const __nv_bfloat16* W;
  int Np, KC, stage_bytes;
  long long total, n;

  __device__ __forceinline__ void start(int tid) {
    n = 0;
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (s < total) bt_load_w(base + s * stage_bytes, W, Np, s % KC, tid,
                               NTHREADS);
      tc::cp_async_commit();
    }
  }

  __device__ __forceinline__ const uint8_t* next(int tid) {
    tc::cp_async_wait<S - 2>();        // chunk n is in
    tc::fence_async_smem();
    __syncthreads();
    const long long m = n + S - 1;
    if (m < total)
      bt_load_w(base + static_cast<int>(m % S) * stage_bytes, W, Np,
                static_cast<int>(m % KC), tid, NTHREADS);
    tc::cp_async_commit();             // possibly empty: uniform counts
    const uint8_t* st = base + static_cast<int>(n % S) * stage_bytes;
    ++n;
    return st;
  }
};

// x's quads as loaded (the LN pass keeps a batch of rows packed: bf16
// pairs in 32-bit words) and their float32 values.  A bf16 row of
// Din = 300 is 600 bytes, not 16-byte aligned: 8-byte loads for bf16.
template <typename TX> struct BtQuad;
template <> struct BtQuad<__nv_bfloat16> {
  using T = uint2;
  static __device__ __forceinline__ T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ T zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ void get(const T& u, float (&v)[4]) {
    const float2 a = tc::unpack_bf16(u.x), b = tc::unpack_bf16(u.y);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
};
template <> struct BtQuad<float> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void get(const T& u, float (&v)[4]) {
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
};

// The pair of x values at (row, c), c even.
__device__ __forceinline__ float2 bt_pair(const __nv_bfloat16* p) {
  return tc::unpack_bf16(__ldg(reinterpret_cast<const uint32_t*>(p)));
}
__device__ __forceinline__ float2 bt_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Ask L2 for `bytes` bytes from p (the next tile's x rows), thread t of n.
__device__ __forceinline__ void bt_prefetch_l2(const void* p, size_t bytes,
                                               int t, int n) {
  const char* c = static_cast<const char*>(p);
  for (size_t off = static_cast<size_t>(t) * 128; off < bytes;
       off += static_cast<size_t>(n) * 128)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + off));
}

// The keep bits of quads (counter blocks blk[n], one Philox4x32-10 call
// each, as philox.cuh's keep4) drawn side by side: N independent chains in
// flight instead of one ten-round chain after another.  Bit t of bits[n]:
// element 4 blk[n] + t is kept.
template <int N>
__device__ __forceinline__ void bt_keep_quads(uint64_t seed,
                                              const uint64_t (&blk)[N],
                                              uint32_t threshold,
                                              uint32_t (&bits)[N]) {
  uint32_t c0[N], c1[N], c2[N], c3[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    c0[n] = static_cast<uint32_t>(blk[n]);
    c1[n] = static_cast<uint32_t>(blk[n] >> 32);
    c2[n] = c3[n] = 0u;
  }
  uint32_t k0 = static_cast<uint32_t>(seed),
           k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      philox_round(c0[n], c1[n], c2[n], c3[n], k0, k1);
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
    bits[n] = ((c0[n] >> 8) >= threshold ? 1u : 0u)
              | ((c1[n] >> 8) >= threshold ? 2u : 0u)
              | ((c2[n] >> 8) >= threshold ? 4u : 0u)
              | ((c3[n] >> 8) >= threshold ? 8u : 0u);
}

// LN_in of the tile's rows (x rows r0 .. r0 + 63, the first `rows` live)
// into the bf16 A tile a_s: yd = ((x - mean) istd gin + bin) keep, float32
// statistics with the fast variance clipped at 0, rounded to bf16 once
// (the TPU kernel's rounding site); columns [Din, Kp) and dead rows are 0.
// The keep mask is the Philox mask of philox.cuh keyed by the flat index
// row * Din + c of the (R, Din) LN output: one draw gives a quad's four
// bits, and a thread draws a row's quads side by side.  Warp w owns rows
// 8 w .. 8 w + 7; lane l holds the quads at 4 (l + 32 q).  A warp loads a
// batch of rows at once (four in bf16, two in float32: 48 registers of
// x).  With KEEP (the backward) the keep bits go to keep_s (row r, word
// 4 q + t, bit l: element 4 (l + 32 q) + t) and each row's (mean, 1 / std)
// to st_s.
template <typename TX, bool KEEP>
__device__ __forceinline__ void bt_ln_in(
    const TX* __restrict__ x, long long r0, int rows, int Din, int Kp,
    const float* __restrict__ gin, const float* __restrict__ bin,
    const Dropout& drop, uint8_t* a_s, uint32_t* keep_s, float* st_s,
    int warp, int lane) {
  using Q = BtQuad<TX>;
  constexpr int RB = sizeof(TX) == 2 ? 4 : 2;
  const float inv_din = 1.f / Din;
  // the lane's columns' gin and bin (0 past Din), loaded once: the row
  // loop below is then free of branches and of loads but x's
  float4 g4[BT_QMAX], b4[BT_QMAX];
#pragma unroll
  for (int q = 0; q < BT_QMAX; ++q) {
    const int c = 4 * (lane + 32 * q);
    const bool in = c < Din;
    g4[q] = in ? __ldg(reinterpret_cast<const float4*>(gin + c))
               : make_float4(0.f, 0.f, 0.f, 0.f);
    b4[q] = in ? __ldg(reinterpret_cast<const float4*>(bin + c))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll 1
  for (int rb = 0; rb < 8; rb += RB) {
    typename Q::T raw[RB][BT_QMAX];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int r = 8 * warp + rb + j;
#pragma unroll
      for (int q = 0; q < BT_QMAX; ++q) {
        const int c = 4 * (lane + 32 * q);
        raw[j][q] = r < rows && c < Din ? Q::load(x + (r0 + r) * Din + c)
                                        : Q::zero();
      }
    }
    float mean[RB], istd[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      mean[j] = istd[j] = 0.f;
#pragma unroll
      for (int q = 0; q < BT_QMAX; ++q) {
        float v[4];
        Q::get(raw[j][q], v);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          mean[j] += v[t];
          istd[j] = fmaf(v[t], v[t], istd[j]);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        mean[j] += __shfl_xor_sync(0xffffffffu, mean[j], o);
        istd[j] += __shfl_xor_sync(0xffffffffu, istd[j], o);
      }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      mean[j] *= inv_din;
      istd[j] = rsqrtf(fmaxf(istd[j] * inv_din - mean[j] * mean[j], 0.f)
                       + LN_EPS);
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int r = 8 * warp + rb + j;
      const bool live = r < rows;
      uint32_t bits[BT_QMAX];
      if (drop.on()) {
        uint64_t blk[BT_QMAX];
#pragma unroll
        for (int q = 0; q < BT_QMAX; ++q)
          blk[q] = (static_cast<uint64_t>(r0 + r) * Din
                    + 4 * (lane + 32 * q)) >> 2;
        bt_keep_quads<BT_QMAX>(drop.seed, blk, drop.threshold, bits);
      }
      const float ks = drop.on() ? drop.scale : 1.f;
#pragma unroll
      for (int q = 0; q < BT_QMAX; ++q) {
        const int c = 4 * (lane + 32 * q);
        // dead rows and columns past Din: 0 (their gin, bin and x are 0)
        const uint32_t kb = !live ? 0u : (drop.on() ? bits[q] : 0xfu);
        float v[4];
        Q::get(raw[j][q], v);
        const float m = mean[j], is = istd[j];
        const float y0 = ((v[0] - m) * is * g4[q].x + b4[q].x)
                         * (kb & 1u ? ks : 0.f);
        const float y1 = ((v[1] - m) * is * g4[q].y + b4[q].y)
                         * (kb & 2u ? ks : 0.f);
        const float y2 = ((v[2] - m) * is * g4[q].z + b4[q].z)
                         * (kb & 4u ? ks : 0.f);
        const float y3 = ((v[3] - m) * is * g4[q].w + b4[q].w)
                         * (kb & 8u ? ks : 0.f);
        if (c < Kp)
          *reinterpret_cast<uint2*>(a_s + (c >> 6) * TILE_PANEL
                                    + tc::swz(r, c & 63)) =
              make_uint2(tc::pack_bf16(y0, y1), tc::pack_bf16(y2, y3));
        if (KEEP && drop.on()) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const uint32_t word =
                __ballot_sync(0xffffffffu, c < Din && ((kb >> t) & 1u));
            if (lane == 0) keep_s[r * BT_KEEP_WORDS + 4 * q + t] = word;
          }
        }
      }
      if (KEEP && lane == 0) {
        st_s[2 * r] = mean[j];
        st_s[2 * r + 1] = istd[j];
      }
    }
  }
}

// The keep multipliers (1 when the dropout is off) of the pair (row r,
// columns c, c + 1), c even, from bt_ln_in's bitmap.
__device__ __forceinline__ float2 bt_keep_pair(const uint32_t* keep_s,
                                               const Dropout& drop, int r,
                                               int c) {
  if (!drop.on()) return make_float2(1.f, 1.f);
  const uint32_t w = keep_s[r * BT_KEEP_WORDS + 4 * (c >> 7) + (c & 3)]
                     >> ((c & 127) >> 2);
  const uint32_t w1 = keep_s[r * BT_KEEP_WORDS + 4 * (c >> 7) + (c & 3) + 1]
                      >> ((c & 127) >> 2);
  return make_float2(w & 1u ? drop.scale : 0.f, w1 & 1u ? drop.scale : 0.f);
}

// The y1 panels of a warpgroup: acc[p] holds column panel p0 + p, with
// p0 = 0 for warpgroup 0 (panels 0 .. NPH - 1, NPH = ceil(NP / 2)) and
// p0 = NP - NPH for warpgroup 1 (the last NPH panels).  Where NP is odd
// the two share panel NPH - 1, and warpgroup 1's copy is not used
// (bt_panel_valid).  Both warpgroups issue the same instructions, a pair
// of adjacent panels one n128 product: a branch on the warpgroup around
// wgmma makes the compiler serialize every wgmma of the kernel.
__device__ __forceinline__ bool bt_panel_valid(int wg, int p0, int p,
                                               int NPH) {
  return wg == 0 || p0 + p >= NPH;
}

// acc += the A tile's chunk kc (columns 64 kc .. + 63) times the stage
// (W's rows of that chunk): four depth steps, W read MN-major; `first`
// zeroes acc.
template <int NPH>
__device__ __forceinline__ void bt_y1_mma(float (&acc)[NPH][32],
                                          const uint8_t* a_s,
                                          const uint8_t* st, int kc, int p0,
                                          bool first) {
  tc::fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t a = tc::make_desc(
        tc::smem_u32(a_s) + kc * TILE_PANEL + ks * 32, 16);
    const int on = (first && ks == 0) ? 0 : 1;
#pragma unroll
    for (int p = 0; p < NPH; p += 2) {
      const uint64_t b = tc::make_desc(
          tc::smem_u32(st) + (p0 + p) * TILE_PANEL
              + ks * 2 * tc::ATOM_BYTES, TILE_PANEL);
      if (p + 1 < NPH)
        bt_mma_pair<0, 1>(acc[p], acc[p + 1 < NPH ? p + 1 : p], a, b, on);
      else
        tc::mma_ss<64, 0, 1>(acc[p], a, b, on);
    }
  }
  tc::commit();
  tc::wait_all();
}

// y1 = yd W over the tile: the KC chunks of the ring, then acc += bias
// (0 in a panel that is not the warpgroup's) and the LN_out statistics of
// ReLU(y1) over both warpgroups' columns (padded columns are 0 and
// excluded: the sums are divided by Dout): mean m2 and 1 / std i2 of the
// thread's two rows.  One exchange round (ex).
template <int NPH, int S>
__device__ __forceinline__ void bt_y1(float (&acc)[NPH][32], BtRing<S>& ring,
                                      const uint8_t* a_s, const float* bias_s,
                                      float* ex, float (&m2)[2],
                                      float (&i2)[2], int KC, int Dout,
                                      int p0, int wg, int rl, int tid) {
  const int lane = tid & 31;
#pragma unroll 1
  for (int kc = 0; kc < KC; ++kc)
    bt_y1_mma<NPH>(acc, a_s, ring.next(tid), kc, p0, kc == 0);
  m2[0] = m2[1] = i2[0] = i2[1] = 0.f;
#pragma unroll
  for (int p = 0; p < NPH; ++p) {
    const bool valid = bt_panel_valid(wg, p0, p, NPH);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      acc[p][i] = valid ? acc[p][i] + bias_s[64 * (p0 + p) + acc_col(i, lane)]
                        : 0.f;                                   // y1
      const float y2 = fmaxf(acc[p][i], 0.f);
      m2[h] += y2;
      i2[h] = fmaf(y2, y2, i2[h]);
    }
  }
  tri_row_pair_sums(ex, m2, i2, wg, rl, lane);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m2[h] /= Dout;
    i2[h] = rsqrtf(fmaxf(i2[h] / Dout - m2[h] * m2[h], 0.f) + LN_EPS);
  }
}

// Column sums over a 64-column panel: v[2 q + e] holds this thread's sum
// (both its rows) of column 8 q + 2 (lane % 4) + e.  Three folds over the
// lanes that hold the column's other rows leave in v[e] the warp's sum of
// column bt_fold_panel(..) + e, which it returns: 8 (b2 + 2 b3 + 4 b4) +
// 2 (lane % 4) (bN: bit N of lane).  Each lane ends with its own two
// columns; the four warps of a warpgroup hold the same columns.
__device__ __forceinline__ int bt_fold_panel(float (&v)[16], int lane) {
  fold<16>(v, 16, lane);
  fold<8>(v, 8, lane);
  fold<4>(v, 4, lane);
  return 8 * (((lane >> 2) & 1) + 2 * ((lane >> 3) & 1)
              + 4 * ((lane >> 4) & 1)) + 2 * (lane & 3);
}

// As bt_fold_panel for 32 columns, v[2 q + e] with q < 4: v[0] is the
// warp's sum of the returned column 8 (b3 + 2 b4) + 2 (lane % 4) + b2.
__device__ __forceinline__ int bt_fold_half(float (&v)[8], int lane) {
  fold<8>(v, 16, lane);
  fold<4>(v, 8, lane);
  fold<2>(v, 4, lane);
  return 8 * (((lane >> 3) & 1) + 2 * ((lane >> 4) & 1)) + 2 * (lane & 3)
         + ((lane >> 2) & 1);
}

}  // namespace tvqa
