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
  static_assert(N == 32 || N == 64 || N == 128, "unsupported width");
  if constexpr (N == 32) {
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
}  // namespace tvqa
