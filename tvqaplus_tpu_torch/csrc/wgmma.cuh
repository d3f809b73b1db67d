// Hopper tensor-core building blocks (sm_90a): warpgroup matrix multiply
// (wgmma, bf16 operands, float32 sums), its shared-memory descriptors, the
// 128-byte swizzle, and cp.async copies.
//
// One storage format serves every shared-memory operand.  A bf16 matrix of
// R rows and C columns (C a multiple of 64) is kept as C / 64 PANELS; a
// panel is R rows of 128 bytes (64 values), and the 16-byte chunk c of row
// r sits at chunk c ^ (r & 7) of that row (the 128-byte swizzle, so that
// both row-wise and column-wise accesses spread over the banks).  Panels
// must start on a 1024-byte boundary.  wgmma reads such a matrix either
//   * "K-major": rows are the operand's M (or N) index and columns its
//     depth K (A as [m][k], B as [n][k]); a depth step of 16 advances the
//     start address by 32 bytes inside a panel, 64 columns change panel;
//   * "MN-major" (the transposed 16-bit operand): rows are the depth K and
//     columns the M (or N) index (A as [k][m], B as [k][n]); a depth step
//     of 16 advances the start by 16 rows (2048 bytes), and the N index
//     runs over panels (leading byte offset = the panel stride).
// In both the stride byte offset is 1024 (eight rows).
//
// A thread's share of a 64 x N float32 accumulator (d[N / 2]): with
// w = warp of the warpgroup, l = lane,
//   d[i] is row 16 w + l / 4 + 8 ((i / 2) % 2),
//           column 8 (i / 4) + 2 (l % 4) + i % 2.
// The A operand may also come from registers: for a depth step the four
// registers hold bf16 pairs at (row, k), (row + 8, k), (row, k + 8),
// (row + 8, k + 8) with row = l / 4, k = 2 (l % 4): exactly the packed
// accumulator values d[8 s + 0..7] of depth step s, so a product's
// float32 result feeds the next product without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "common.cuh"
#include "philox.cuh"

namespace tvqa {
namespace tc {

constexpr int ROW_BYTES = 128;
constexpr int ATOM_BYTES = 1024;        // eight rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, col) inside a panel, col < 64.
__device__ __forceinline__ int swz(int row, int col) {
  return row * ROW_BYTES + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

// Byte offset of the 16-byte chunk (row, chunk) inside a panel.
__device__ __forceinline__ int swz_chunk(int row, int chunk) {
  return row * ROW_BYTES + (((chunk ^ row) & 7) << 4);
}

// Descriptor of a swizzled operand starting at shared address `addr`
// (byte address in the shared window); lbo = leading byte offset (the panel
// stride of an MN-major operand, unused otherwise).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16)
         | (static_cast<uint64_t>(ATOM_BYTES >> 4) << 32)
         | (1ull << 62);               // 128-byte swizzle
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of d across this point (an
// accumulator that an asynchronous wgmma may still be writing).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Make generic-proxy shared-memory writes visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1..15) over `nthreads` threads (a multiple of 32).
__device__ __forceinline__ void bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem_dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- transaction barriers and bulk copies (a ring of slabs fed by the
// copy engine: one thread issues a slab's copy, which completes on the
// slab's "full" barrier; every consumer warp arrives on its "empty" barrier
// once its products have read it) -------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count)
               : "memory");
}
// Make the initialised barriers visible to the copy engine.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive (the producer) and expect `bytes` more to land on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory by the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- a pair of CTAs (a thread-block cluster of two) sharing the ring's
// slabs: one CTA's copy engine writes every slab into both CTAs' slots
// (multicast), once the other CTA has signalled that its slot is free ----
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
// Every thread of both CTAs.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// Arrive on the barrier at `bar`'s offset in CTA `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cta(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_u32(bar)), "r"(cta)
      : "memory");
}
// Whether the barrier's phase of parity `parity` is complete (no wait),
// with the cluster's arrivals visible.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0u;
}
// One try of mbar_wait (it may suspend the thread for a while).
__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0u;
}
// bulk_g2s into the same offset of every CTA in `mask` (bit c: cluster CTA
// c), completing on the barrier at `bar`'s offset in each.
__device__ __forceinline__ void bulk_g2s_mcast(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

#define TVQA_D8(d, o)                                                  \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define TVQA_D16(d, o) TVQA_D8(d, o), TVQA_D8(d, o + 8)
#define TVQA_D32(d, o) TVQA_D16(d, o), TVQA_D16(d, o + 16)
#define TVQA_D64(d, o) TVQA_D32(d, o), TVQA_D32(d, o + 32)
#define TVQA_L8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define TVQA_L16                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define TVQA_L32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"
#define TVQA_L64                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x N) = [d +] A B, one depth step of 16; A and B from shared memory.
// TA / TB = 1 for an MN-major (transposed) operand.  acc = 0 overwrites d.
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int acc) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "unsupported width");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " TVQA_L8
        ", %8, %9, p, 1, 1, %11, %12;\n}\n"
        : TVQA_D8(d, 0)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " TVQA_L16
        ", %16, %17, p, 1, 1, %19, %20;\n}\n"
        : TVQA_D16(d, 0)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TVQA_L32
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : TVQA_D32(d, 0)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TVQA_L64
        ", %64, %65, p, 1, 1, %67, %68;\n}\n"
        : TVQA_D64(d, 0)
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
}

// As mma_ss with A from registers (the layout in the header note).
template <int N, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int acc) {
  static_assert(N == 32 || N == 64 || N == 128, "unsupported width");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " TVQA_L16
        ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : TVQA_D16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TVQA_L32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : TVQA_D32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TVQA_L64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : TVQA_D64(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
}

}  // namespace tc

// ---- row tiles in the accumulator layout ----------------------------------
//
// A warpgroup owns a tile of TM = 64 rows; a thread holds two rows of it (rl
// = 16 warp + lane / 4 and rl + 8) in the accumulator layout above, so
// row-wise passes run on registers between the products, and a row
// statistic is a sum over the thread's values and the four lanes of its
// quad.  Shared-memory operands are panels of 128-byte rows.

constexpr int TM = 64;                  // rows of a tile (the wgmma M)
constexpr int TILE_PANEL = TM * tc::ROW_BYTES;       // panel of a 64-row tile

// Sizes at hidden width D (a multiple of 64): W (3D x D bf16) as D / 64
// panels of 3D rows, and a 64-row tile of D columns.
template <int D>
struct Shapes {
  static constexpr int PANELS = D / 64;
  static constexpr int W_ROWS = 3 * D;
  static constexpr int W_PANEL = W_ROWS * tc::ROW_BYTES;
  static constexpr int W_BYTES = PANELS * W_PANEL;
  static constexpr int TILE_BYTES = PANELS * TILE_PANEL;
};
// ... at the backward kernels' width
constexpr int W_ROWS = Shapes<BWD_D>::W_ROWS;
constexpr int W_PANEL = Shapes<BWD_D>::W_PANEL;      // panel of W (3D rows)
constexpr int W_BYTES = Shapes<BWD_D>::W_BYTES;
constexpr int TILE_BYTES = Shapes<BWD_D>::TILE_BYTES;  // 64 x 128 bf16

__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  return p + ((tc::ATOM_BYTES - (tc::smem_u32(p) & (tc::ATOM_BYTES - 1)))
              & (tc::ATOM_BYTES - 1));
}

// cp.async `rows` rows of D bf16 (row stride ld values) into the D / 64
// panels of an R-row matrix at dst; rows past `rows` are zeroed.  Thread t
// of n.
template <int D = BWD_D>
__device__ __forceinline__ void tc_load_rows(uint8_t* dst, int R,
                                             const __nv_bfloat16* src,
                                             int ld, int rows, int t,
                                             int n) {
  constexpr int CH = D / 8;             // 16-byte chunks of a row
  constexpr int SH = CH == 8 ? 3 : (CH == 16 ? 4 : 5);
  static_assert(CH == 1 << SH, "D is 64, 128 or 256");
  for (int c = t; c < R * CH; c += n) {
    const int r = c >> SH, ch = c & (CH - 1);
    uint8_t* d = dst + (ch >> 3) * (R * tc::ROW_BYTES)
                 + tc::swz_chunk(r, ch & 7);
    if (r < rows)
      tc::cp_async16(d, src + static_cast<size_t>(r) * ld + ch * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// cp.async `rows` rows of 8 `chunks` bf16 (row stride ld) into one panel of
// TM rows; rows past `rows` are zeroed, columns past 8 `chunks` untouched.
__device__ __forceinline__ void tc_load_panel(uint8_t* dst,
                                              const __nv_bfloat16* src,
                                              int ld, int rows, int chunks,
                                              int t, int n) {
  for (int c = t; c < TM * chunks; c += n) {
    const int r = c / chunks, ch = c % chunks;
    uint8_t* d = dst + tc::swz_chunk(r, ch);
    if (r < rows)
      tc::cp_async16(d, src + static_cast<size_t>(r) * ld + ch * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// R rows of D float32 values (row stride ld, 16-byte aligned) rounded to
// bf16 into the D / 64 panels of an R-row matrix at dst, the layout of
// tc_load_rows; thread t of n.  Generic-proxy stores: fence_async_smem
// before a wgmma reads them.
template <int D = BWD_D>
__device__ __forceinline__ void tc_store_rows_f32(uint8_t* dst, int R,
                                                  const float* src, int ld,
                                                  int t, int n) {
  constexpr int CH = D / 8;
  constexpr int SH = CH == 8 ? 3 : (CH == 16 ? 4 : 5);
  static_assert(CH == 1 << SH, "D is 64, 128 or 256");
  for (int c = t; c < R * CH; c += n) {
    const int r = c >> SH, ch = c & (CH - 1);
    const float4* p = reinterpret_cast<const float4*>(
        src + static_cast<size_t>(r) * ld + ch * 8);
    const float4 a = __ldg(p), b = __ldg(p + 1);
    *reinterpret_cast<uint4*>(dst + (ch >> 3) * (R * tc::ROW_BYTES)
                              + tc::swz_chunk(r, ch & 7)) =
        make_uint4(tc::pack_bf16(a.x, a.y), tc::pack_bf16(a.z, a.w),
                   tc::pack_bf16(b.x, b.y), tc::pack_bf16(b.z, b.w));
  }
}

// Sum over the four lanes that share a row of the accumulator layout.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Per row half h: the sums of both warpgroups of exchange round `ex` (each
// warpgroup first stores its quad sums of the row's own columns), where the
// two warpgroups split the columns of one 64-row tile (the tri bridge, the
// MLP bridge, the D = 256 forwards).  A block barrier.
__device__ __forceinline__ void tri_row_pair_sums(float* ex, float (&a)[2],
                                                  float (&b)[2], int wg,
                                                  int rl, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[h] = quad_sum(a[h]);
    b[h] = quad_sum(b[h]);
    if ((lane & 3) == 0) {
      ex[(wg * TM + rl + 8 * h) * 2] = a[h];
      ex[(wg * TM + rl + 8 * h) * 2 + 1] = b[h];
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rl + 8 * h;
    a[h] = ex[r * 2] + ex[(TM + r) * 2];
    b[h] = ex[r * 2 + 1] + ex[(TM + r) * 2 + 1];
  }
}

// Column of accumulator value i (row half (i / 2) % 2) for this lane.
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
}

// v[0 .. N) -> v[0 .. N / 2): lanes with `mask` set keep the upper half's
// sums, the others the lower half's, each adding its partner's share.
// Three folds (masks 16, 8, 4) sum a column's values over the eight lanes
// that hold its other rows.
template <int N, int S>
__device__ __forceinline__ void fold(float (&v)[S], int mask, int lane) {
  const bool up = lane & mask;
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const float send = up ? v[k] : v[k + N / 2];
    const float keep = up ? v[k + N / 2] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// Eight Philox4x32-10 blocks (counters blk0, blk0 + 2, .., blk0 + 14, as
// philox.cuh's philox4x32_10) advanced round by round side by side, so that
// eight independent chains are in flight instead of one ten-round chain
// after another; returns their 32 keep bits, block n in bits 4 n .. 4 n + 3.
__device__ __forceinline__ uint32_t keep_word(uint64_t seed, uint64_t blk0,
                                              uint32_t threshold) {
  uint32_t c0[8], c1[8], c2[8], c3[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const uint64_t blk = blk0 + 2 * n;
    c0[n] = static_cast<uint32_t>(blk);
    c1[n] = static_cast<uint32_t>(blk >> 32);
    c2[n] = c3[n] = 0u;
  }
  uint32_t k0 = static_cast<uint32_t>(seed),
           k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
      philox_round(c0[n], c1[n], c2[n], c3[n], k0, k1);
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  uint32_t bits = 0u;
#pragma unroll
  for (int n = 0; n < 8; ++n)
    bits |= (((c0[n] >> 8) >= threshold ? 1u : 0u)
             | ((c1[n] >> 8) >= threshold ? 2u : 0u)
             | ((c2[n] >> 8) >= threshold ? 4u : 0u)
             | ((c3[n] >> 8) >= threshold ? 8u : 0u)) << (4 * n);
  return bits;
}

// keep_word as a call: one copy of the code, compiled apart from its
// caller's register pressure.  The backward draws at the start of a tile,
// where little is live and a call is cheap; inlined into its 64-wide
// instantiation the draw ran three times slower than in the 32-wide one.
// The forward at D = 128 draws with the att accumulator live and inline,
// the one at D = 64 inline before its scores; the D = 256 forwards call
// (with no product in flight).
__device__ __noinline__ uint32_t keep_word_call(uint64_t seed, uint64_t blk0,
                                                uint32_t threshold) {
  return keep_word(seed, blk0, threshold);
}

// Keep bits of the Philox dropout for the thread's values in 8 NQ columns
// of its two rows.  A Philox call covers four adjacent columns, which two
// neighbouring lanes share, so the even lane draws for row rl, the odd one
// for row rl + 8, and one shuffle per eight calls trades the bits.
// e_mine = the flat index of column 0 of this group in the row this lane
// draws for.  Value (half h, chunk q, t) is kept when
// bit 4 (q % 8) + t of kw[h][q / 8] is set.  NQ = 4 (32 columns) draws a
// whole word and uses its lower half.
template <int NQ, bool CALL>
__device__ __forceinline__ void tc_keep_bits(const Dropout& drop,
                                             uint64_t e_mine, int lane,
                                             uint32_t (&kw)[2][(NQ + 7) / 8]) {
  const bool odd = lane & 1;
#pragma unroll
  for (int wd = 0; wd < (NQ + 7) / 8; ++wd) {
    // chunk q = 8 wd + qq draws block (e_mine + 8 q + 4 (lane % 4 / 2)) / 4
    const uint64_t blk0 = (e_mine + 64 * wd + 4 * ((lane & 3) >> 1)) >> 2;
    const uint32_t mine = CALL
        ? keep_word_call(drop.seed, blk0, drop.threshold)
        : keep_word(drop.seed, blk0, drop.threshold);
    const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
    kw[0][wd] = (odd ? other : mine) >> (2 * (lane & 1));
    kw[1][wd] = (odd ? mine : other) >> (2 * (lane & 1));
  }
}

// ---- W through a ring of slabs fed by the copy engine (the D = 256
// forwards) -----------------------------------------------------------------
//
// W (K x 256) is rounded to bf16 once a call into K / 32 SLABS of 16 KB
// (w_slab_pack_kernel), each 32 rows of W as it lies in shared memory: four
// panels of 32 rows (columns 64 pn + j), read MN-major, the 128-byte
// swizzle.  A block reads the same sequence of PER slabs (the W of its
// products) once for every tile it takes; the ring brings them in order.

constexpr int SLAB_ROWS = 32;
constexpr int SLAB_BYTES = SLAB_ROWS * 256 * 2;       // 16 KB
constexpr int SLAB_PANEL = SLAB_ROWS * tc::ROW_BYTES;  // 4 KB

// Matrix blockIdx.y (W0, else W1; K x 256 float32, row-major) into its
// K / 32 slabs at Wp + blockIdx.y K 256: a thread a 16-byte chunk.  Slab sl
// holds rows 32 sl + r in panel pn = q / 256 (chunk q of the slab); row r's
// chunk j / 8 lies at chunk (j / 8) ^ (r % 8).
template <int D>
__global__ void __launch_bounds__(NTHREADS)
w_slab_pack_kernel(const float* __restrict__ W0,
                   const float* __restrict__ W1, int K,
                   __nv_bfloat16* __restrict__ Wp) {
  static_assert(D == 256, "slabs of 256 columns");
  constexpr int CHUNKS = SLAB_BYTES / 16;
  const int c = blockIdx.x * NTHREADS + threadIdx.x;
  if (c >= K / SLAB_ROWS * CHUNKS) return;
  const float* W = blockIdx.y == 0 ? W0 : W1;
  const int sl = c / CHUNKS, q = c % CHUNKS, r = q / 8 % SLAB_ROWS;
  const float* src = W + static_cast<size_t>(SLAB_ROWS * sl + r) * D
                     + 64 * (q / 256) + 8 * ((q % 8) ^ (r % 8));
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  reinterpret_cast<uint4*>(Wp + static_cast<size_t>(blockIdx.y) * K * D)[c] =
      make_uint4(tc::pack_bf16(a.x, a.y), tc::pack_bf16(a.z, a.w),
                 tc::pack_bf16(b.x, b.y), tc::pack_bf16(b.z, b.w));
}

// NSLOT slots of SLAB_BYTES with a full and an empty barrier each.  The
// block's slab j (0 <= j < total) is slab j % PER of the packed W and lands
// in slot j % NSLOT, for the (j / NSLOT)-th time: its full barrier's phase
// of that parity, which thread 0 arms (expect_tx) and the copy engine
// completes.  Each warp arrives on the slot's empty barrier once its
// products have read the slab, and thread 0 refills the slot when all
// eight have.  With CL = 2 (a cluster of two CTAs that walk the same slab
// sequence) CTA 0's copy engine writes every slab into both CTAs' slots:
// CTA 1's thread 0 arms its own full barrier once its warps have released
// the slot and then arrives on CTA 0's empty barrier (a ninth arrival
// there), so CTA 0 copies into a slot only when both CTAs' readers are
// done and CTA 1 expects the bytes (it arms the first NSLOT slabs before
// the cluster syncs).  Thread 0 hands slabs out (pump) whenever it can,
// never waiting: once after the cluster syncs (refill), then from every
// take (where warp 0 polls the slab's barrier, so that thread 0 is never
// put to sleep on it, as mbarrier.try_wait may, while the slab may need
// its own hand) and give; so no block barrier a slab, and the next
// product's first slabs come in while this one's last are read.  (Also
// refilling from the row passes between products ran no faster on the
// card.)  All threads keep the counters alike.
template <int NSLOT, int PER, int CL>
struct SlabRing {
  uint8_t* slots;
  uint64_t* full;
  uint64_t* empty;
  const uint8_t* w;
  int total, fetched, taken, given;
  uint32_t rank;

  // Thread 0 initialises the barriers (CTA 1 of a pair also arms the first
  // slabs); the caller then syncs the cluster (CL = 2) or the block and
  // calls refill().
  __device__ __forceinline__ void init(uint8_t* slots_, uint64_t* bars,
                                       const void* w_, int total_) {
    slots = slots_;
    full = bars;
    empty = bars + NSLOT;
    w = static_cast<const uint8_t*>(w_);
    total = total_;
    taken = given = 0;
    rank = CL == 1 ? 0u : tc::cluster_rank();
    fetched = rank == 0 ? 0 : min(NSLOT, total);
    if (threadIdx.x == 0) {
      for (int k = 0; k < NSLOT; ++k) {
        tc::mbar_init(full + k, 1);
        tc::mbar_init(empty + k, NWARPS + (CL == 2 && rank == 0));
      }
      tc::mbar_fence_init();
      for (int k = 0; k < fetched; ++k)
        tc::mbar_expect_tx(full + k, SLAB_BYTES);
    }
  }
  __device__ __forceinline__ void pump() {
    if (threadIdx.x != 0) return;
    while (fetched < total) {
      const int k = fetched % NSLOT;
      if (!tc::mbar_test(empty + k, ((fetched / NSLOT) & 1) ^ 1)) break;
      tc::mbar_expect_tx(full + k, SLAB_BYTES);
      const uint8_t* src = w + static_cast<size_t>(fetched % PER) * SLAB_BYTES;
      if (CL == 1)
        tc::bulk_g2s(slots + k * SLAB_BYTES, src, SLAB_BYTES, full + k);
      else if (rank == 0)
        tc::bulk_g2s_mcast(slots + k * SLAB_BYTES, src, SLAB_BYTES, full + k,
                           (1 << CL) - 1);
      else
        tc::mbar_arrive_cta(empty + k, 0);  // CTA 0 may copy into the slot
      ++fetched;
    }
  }
  // pump from code that every thread of the block runs: the warp
  // reconverges before it goes on, as a block barrier that may follow (an
  // aligned one) requires.  (Without it, pumping between the products hung
  // the pair at the first reuse of a slot.)
  __device__ __forceinline__ void refill() {
    pump();
    __syncwarp();
  }
  // The shared address of the next slab, once it has landed.
  __device__ __forceinline__ uint32_t take() {
    const int k = taken % NSLOT;
    const uint32_t parity = (taken / NSLOT) & 1;
    if (threadIdx.x < 32) {            // warp 0 polls: thread 0 pumps
      while (!tc::mbar_test(full + k, parity)) pump();
    } else {
      while (!tc::mbar_try(full + k, parity)) {
      }
    }
    __syncwarp();
    ++taken;
    return tc::smem_u32(slots + k * SLAB_BYTES);
  }
  // The warp's products have read the oldest slab not given back.
  __device__ __forceinline__ void give(int lane) {
    const int k = given % NSLOT;
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(empty + k);
    ++given;
    pump();
    __syncwarp();
  }
};

// acc (64 x 128, the warpgroup's columns [128 wg, 128 wg + 128)) = A W,
// with A the 64 x 32 NS bf16 tile at shared address a_addr (K-major, panels
// of TILE_PANEL) and W's next NS slabs from the ring.  Each warp gives a
// slab back once the products that read it are done (one slab late, so
// the tensor cores always have the next one queued).  The loop unrolls, so
// that the products are not serialised behind a run-time loop.
template <int NS, typename Ring>
__device__ __forceinline__ void mma_ring_w(float (&acc)[64], uint32_t a_addr,
                                           Ring& ring, int wg, int lane) {
#pragma unroll
  for (int p = 0; p < NS; ++p) {
    const uint32_t st = ring.take() + 2 * wg * SLAB_PANEL;
    tc::fence();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ks = 2 * p + q;
      tc::mma_ss<128, 0, 1>(
          acc, tc::make_desc(a_addr + (ks / 4) * TILE_PANEL + (ks % 4) * 32,
                             16),
          tc::make_desc(st + q * 2 * tc::ATOM_BYTES, SLAB_PANEL),
          p > 0 || q > 0);
    }
    tc::commit();
    if (p > 0) {
      tc::wait<1>();
      ring.give(lane);
    }
  }
  tc::wait<0>();
  ring.give(lane);
  tc::fence_regs(acc);
}

// The most clusters of two CTAs of `kern` (NTHREADS threads, `smem` bytes
// of dynamic shared memory) the card holds at once; 0 if the card does not
// say.  The caller keeps it.
template <typename Kern>
inline int pair_clusters(Kern kern, int smem) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(2, 1, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kern, &cfg) == cudaSuccess ? n
                                                                       : 0;
}

// Launch `kern` on `clusters` clusters of two CTAs (NTHREADS threads,
// `smem` bytes of dynamic shared memory each) on `stream`.
template <typename... P, typename... A>
inline cudaError_t launch_pairs(void (*kern)(P...), int clusters, int smem,
                                cudaStream_t stream, A&&... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(2 * clusters, 1, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, std::forward<A>(args)...);
}

}  // namespace tvqa
