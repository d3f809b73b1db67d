// Philox4x32-10 counter-based random bits for in-kernel dropout.
//
// Replaces the TPU PRNG stream of tvqaplus_tpu/ops/pallas_attention.py
// (_keep_mask: pltpu.prng_seed per grid cell + prng_random_bits).  There
// the backward replays the mask only because it walks the forward's grid
// cells in the same order.  Here the mask is a pure function of (seed,
// flat element index e) of the tensor the dropout acts on, so a backward
// with another blocking, and the plain PyTorch version (ops/philox.py),
// draw the same bits:
//   words = Philox4x32-10(counter = (e >> 2, 0, 0) as 4 x 32 bits,
//                         key = (seed lo, seed hi))
//   bits  = words[e & 3]
//   keep  = (bits >> 8) >= threshold,   threshold = ceil(p * 2^24)
// The keep decision is an integer compare, so the kernel and the plain
// version cannot disagree by a rounding.  A kept value is scaled by
// 1 / (1 - p) (a float32 the wrapper passes), a dropped one is 0.
#pragma once

#include <cstdint>

namespace tvqa {

struct Philox4 {
  uint32_t x, y, z, w;
};

constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

// One round on the counter words (c0..c3) with the round's key (k0, k1);
// the caller bumps the key by (PHILOX_W0, PHILOX_W1) between rounds.
__device__ __forceinline__ void philox_round(uint32_t& c0, uint32_t& c1,
                                             uint32_t& c2, uint32_t& c3,
                                             uint32_t k0, uint32_t k1) {
  const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
  const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
  const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
  c0 = n0;
  c1 = lo1;
  c2 = n2;
  c3 = lo0;
}

__device__ __forceinline__ Philox4 philox4x32_10(uint64_t ctr,
                                                 uint64_t seed) {
  uint32_t c0 = static_cast<uint32_t>(ctr), c1 = static_cast<uint32_t>(
                                                 ctr >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = static_cast<uint32_t>(seed),
           k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    philox_round(c0, c1, c2, c3, k0, k1);
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  return {c0, c1, c2, c3};
}

// Dropout multipliers (0 or scale) of the four elements e0 .. e0+3 (e0 a
// multiple of 4): one Philox call gives all four words.
__device__ __forceinline__ void keep4(uint64_t seed, uint64_t e0,
                                      uint32_t threshold, float scale,
                                      float (&m)[4]) {
  const Philox4 r = philox4x32_10(e0 >> 2, seed);
  m[0] = (r.x >> 8) >= threshold ? scale : 0.f;
  m[1] = (r.y >> 8) >= threshold ? scale : 0.f;
  m[2] = (r.z >> 8) >= threshold ? scale : 0.f;
  m[3] = (r.w >> 8) >= threshold ? scale : 0.f;
}

// Dropout parameters as the C entries receive them: no dropout when
// threshold == 0.  The seed lies in device memory (seed_ptr: a slot of the
// training step's seed tensor, which the step itself fills on the device,
// so a replayed CUDA graph draws a new mask each step); every kernel reads
// it once, first thing (load_seed), and the backward reads its forward's
// slot.  seed_ptr is not read when threshold == 0.
//
// The struct also says where the kernel's rows lie in the tensor whose flat
// index keys the mask, and the width its LayerNorms average over.  A width
// dv <= D runs in the instantiation D on inputs zero-padded to D
// (ops/widths.py): element (r, c), c < dv, of a (rows, dv) tensor keys
// r dv + c (row_key), and of a (rows, 3 dv) one keys 3 dv r + g dv + c in
// third g (key3); every LayerNorm divides its sums by dv (inv1 = 1 / dv)
// or 3 dv (inv3), quotients made on the host so that dv = D multiplies by
// the constant the kernels used before.  The pad columns are zero in the
// LN input, so they add nothing to the sums (every LN here takes the fast
// variance E[x^2] - E[x]^2), and zero gamma / beta keep them zero.
// gmap (the merged input encoder under context parallelism): row r =
// n len + l of the local (N len, D) input, n = b g_loc + g, keys as row
// (b g_glob + gmap[g]) len + l of the whole group axis, so each frame
// draws the mask one process draws for it; null for the identity.
struct Dropout {
  const unsigned long long* seed_ptr;
  unsigned threshold;
  float scale;
  unsigned long long seed;
  int dv = 0;
  float inv1 = 0.f, inv3 = 0.f;
  const int* gmap = nullptr;
  int g_loc = 1, g_glob = 1, len = 1;
  __device__ __forceinline__ bool on() const { return threshold != 0u; }
  __device__ __forceinline__ void load_seed() {
    seed = on() ? *seed_ptr : 0ull;
  }
  // the key of column 0 of local row r
  __device__ __forceinline__ unsigned long long row_key(long long r) const {
    if (gmap != nullptr) {
      const long long n = r / len, b = n / g_loc;
      r = (b * g_glob + gmap[n - b * g_loc]) * len + (r - n * len);
    }
    return static_cast<unsigned long long>(r) * static_cast<unsigned>(dv);
  }
  // the key of column c of third g (x, y or x*y) of row r of a
  // [x; y; x*y] tensor
  __device__ __forceinline__ unsigned long long key3(long long r, int g,
                                                     int c) const {
    return static_cast<unsigned long long>(r) * (3u * dv) + g * dv + c;
  }
};

// Whether an instantiation of width d runs the true width dv.
inline bool width_ok(int dv, int d) {
  return dv >= 4 && dv <= d && dv % 4 == 0;
}

// The Dropout a C entry hands its kernels at true width dv (1 <= dv <= D,
// a multiple of 4 so that four adjacent columns of a third share a Philox
// call) with the group map of Dropout (gmap may be null).
inline Dropout entry_dropout(const unsigned long long* seed_ptr,
                             unsigned threshold, float scale, int dv,
                             const int* gmap = nullptr, int g_loc = 1,
                             int g_glob = 1, int len = 1) {
  Dropout d{seed_ptr, threshold, scale, 0ull};
  d.dv = dv;
  d.inv1 = 1.f / dv;
  d.inv3 = 1.f / (3 * dv);
  d.gmap = gmap;
  d.g_loc = g_loc;
  d.g_glob = g_glob;
  d.len = len;
  return d;
}

}  // namespace tvqa
