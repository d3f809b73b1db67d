// Checks csrc/wgmma.cuh's operand layouts on the card: one 64 x N x K wgmma
// product per case against a host reference, for A and B read K-major and
// MN-major (the transposed 16-bit operand) from the panelised 128-byte-swizzled
// storage, A from registers, B at a row offset, N = 32 / 64 / 128.  The
// "swap" cases exchange the leading and stride byte offsets of an MN-major
// descriptor and must FAIL (error of order 10, or a fault): they show which
// field means what.  Every "swap=0" line must print an error below 1e-4.
//
// From the repo's root, into the kernels' build directory:
//
//   mkdir -p build/tvqaplus_tpu_torch
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/tvqaplus_tpu_torch/check_wgmma scripts/check_wgmma_layouts.cu
//   build/tvqaplus_tpu_torch/check_wgmma
//
// Run it after any change to wgmma.cuh and before writing a kernel on it: a
// wrong descriptor gives wrong numbers silently.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include "../tvqaplus_tpu_torch/csrc/wgmma.cuh"
using namespace tvqa::tc;

__device__ __forceinline__ uint64_t desc2(uint32_t addr, int lbo, int sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16)
         | (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

struct P {
  int a_bytes, b_bytes, ksteps;
  int a_panel_stride, b_panel_stride;  // bytes
  int b_off;                            // byte offset of B start
  int swap;                             // swap lbo/sbo for MN-major
  int a_regs;
};

template <int N, int TA, int TB>
__global__ void k(const uint8_t* A, const uint8_t* B, const float* Af,
                  float* out, P p) {
  extern __shared__ __align__(1024) uint8_t sm[];
  uint8_t* base = sm + ((1024 - (smem_u32(sm) & 1023)) & 1023);
  uint8_t* as = base;
  uint8_t* bs = base + ((p.a_bytes + 1023) / 1024) * 1024;
  for (int i = threadIdx.x; i < p.a_bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(as)[i] = reinterpret_cast<const uint4*>(A)[i];
  for (int i = threadIdx.x; i < p.b_bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(bs)[i] = reinterpret_cast<const uint4*>(B)[i];
  fence_async_smem();
  __syncthreads();
  float d[N / 2];
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  fence();
  for (int s = 0; s < p.ksteps; ++s) {
    uint64_t da, db;
    if (TA == 0) da = make_desc(smem_u32(as) + (s / 4) * p.a_panel_stride + (s % 4) * 32, 16);
    else da = p.swap ? desc2(smem_u32(as) + s * 2048, 1024, p.a_panel_stride)
                     : desc2(smem_u32(as) + s * 2048, p.a_panel_stride, 1024);
    if (TB == 0) db = make_desc(smem_u32(bs) + p.b_off + (s / 4) * p.b_panel_stride + (s % 4) * 32, 16);
    else db = p.swap ? desc2(smem_u32(bs) + p.b_off + s * 2048, 1024, p.b_panel_stride)
                     : desc2(smem_u32(bs) + p.b_off + s * 2048, p.b_panel_stride, 1024);
    if (p.a_regs) {
      uint32_t a[4];
      const int r = 16 * w + l / 4, kk = 16 * s + 2 * (l % 4);
      const int K = 16 * p.ksteps;
      a[0] = pack_bf16(Af[r * K + kk], Af[r * K + kk + 1]);
      a[1] = pack_bf16(Af[(r + 8) * K + kk], Af[(r + 8) * K + kk + 1]);
      a[2] = pack_bf16(Af[r * K + kk + 8], Af[r * K + kk + 9]);
      a[3] = pack_bf16(Af[(r + 8) * K + kk + 8], Af[(r + 8) * K + kk + 9]);
      mma_rs<N, TB>(d, a, db, s > 0);
    } else {
      mma_ss<N, TA, TB>(d, da, db, s > 0);
    }
  }
  commit();
  wait_all();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    out[row * N + col] = d[i];
  }
}

static float bf(float x) {
  uint32_t u; memcpy(&u, &x, 4);
  u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000u;
  float y; memcpy(&y, &u, 4); return y;
}
// store logical [R][C] row-major into panels
static std::vector<uint8_t> panels(const std::vector<float>& m, int R, int C) {
  std::vector<uint8_t> o((size_t)((C + 63) / 64) * R * 128, 0);
  for (int r = 0; r < R; ++r) for (int c = 0; c < C; ++c) {
    float v = m[(size_t)r * C + c]; uint32_t u; memcpy(&u, &v, 4);
    uint16_t h = u >> 16;
    int pnl = c / 64, cc = c % 64;
    size_t off = (size_t)pnl * R * 128 + r * 128 + ((((cc >> 3) ^ r) & 7) << 4) + ((cc & 7) << 1);
    memcpy(&o[off], &h, 2);
  }
  return o;
}

template <int N, int TA, int TB>
double run(int K, int b_rows_extra, int swap, int a_regs, const char* name) {
  const int M = 64;
  // logical A [M][K], B [K][N]
  std::vector<float> A(M * K), B((size_t)K * N);
  for (auto& v : A) v = bf((rand() % 2001 - 1000) / 1000.f);
  for (auto& v : B) v = bf((rand() % 2001 - 1000) / 1000.f);
  std::vector<float> ref(M * N, 0.f);
  for (int m = 0; m < M; ++m) for (int n = 0; n < N; ++n) {
    double s = 0; for (int kk = 0; kk < K; ++kk) s += (double)A[m * K + kk] * B[(size_t)kk * N + n];
    ref[m * N + n] = (float)s;
  }
  std::vector<uint8_t> Ap, Bp; P p{}; p.ksteps = K / 16; p.swap = swap; p.a_regs = a_regs;
  if (TA == 0) { Ap = panels(A, M, K); p.a_panel_stride = M * 128; }
  else { std::vector<float> At((size_t)K * M); for (int m = 0; m < M; ++m) for (int kk = 0; kk < K; ++kk) At[(size_t)kk * M + m] = A[m * K + kk];
         Ap = panels(At, K, M); p.a_panel_stride = K * 128; }
  if (TB == 0) {  // storage [R = extra + N][K]
    int R = b_rows_extra + N; std::vector<float> Bt((size_t)R * K, 7.f);
    for (int n = 0; n < N; ++n) for (int kk = 0; kk < K; ++kk) Bt[(size_t)(b_rows_extra + n) * K + kk] = B[(size_t)kk * N + n];
    Bp = panels(Bt, R, K); p.b_panel_stride = R * 128; p.b_off = b_rows_extra * 128;
  } else { Bp = panels(B, K, N); p.b_panel_stride = K * 128; p.b_off = 0; }
  p.a_bytes = Ap.size(); p.b_bytes = Bp.size();
  uint8_t *dA, *dB; float *dAf, *dO;
  cudaMalloc(&dA, Ap.size()); cudaMalloc(&dB, Bp.size()); cudaMalloc(&dAf, A.size() * 4); cudaMalloc(&dO, M * N * 4);
  cudaMemcpy(dA, Ap.data(), Ap.size(), cudaMemcpyHostToDevice);
  cudaMemcpy(dB, Bp.data(), Bp.size(), cudaMemcpyHostToDevice);
  cudaMemcpy(dAf, A.data(), A.size() * 4, cudaMemcpyHostToDevice);
  cudaMemset(dO, 0, M * N * 4);
  size_t smem = ((Ap.size() + 1023) / 1024) * 1024 + Bp.size() + 1024;
  cudaFuncSetAttribute(k<N, TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k<N, TA, TB><<<1, 128, smem>>>(dA, dB, dAf, dO, p);
  cudaError_t e = cudaDeviceSynchronize();
  std::vector<float> out(M * N);
  cudaMemcpy(out.data(), dO, M * N * 4, cudaMemcpyDeviceToHost);
  double err = 0; for (int i = 0; i < M * N; ++i) err = fmax(err, fabs(out[i] - ref[i]));
  printf("%-40s N=%d K=%d swap=%d err=%g cuda=%d\n", name, N, K, swap, err, (int)e);
  cudaFree(dA); cudaFree(dB); cudaFree(dAf); cudaFree(dO);
  return err;
}

int main() {
  run<128, 0, 0>(128, 0, 0, 0, "A Kmaj, B Kmaj");
  run<64, 0, 0>(128, 0, 0, 0, "A Kmaj, B Kmaj");
  run<32, 0, 0>(32, 0, 0, 0, "A Kmaj, B Kmaj");
  run<64, 0, 0>(128, 64, 0, 0, "A Kmaj, B Kmaj row offset 64");
  run<64, 0, 0>(128, 192, 0, 0, "A Kmaj, B Kmaj row offset 192");
  run<128, 0, 0>(128, 0, 0, 1, "A regs, B Kmaj");
  run<32, 0, 0>(64, 0, 0, 1, "A regs, B Kmaj");
  for (int sw = 0; sw < 2; ++sw) {
    run<128, 0, 1>(128, 0, sw, 0, "A Kmaj, B MNmaj 2 panels");
    run<128, 0, 1>(384, 0, sw, 0, "A Kmaj, B MNmaj 2 panels K=384");
    run<64, 0, 1>(64, 0, sw, 0, "A Kmaj, B MNmaj 1 panel");
    run<128, 0, 1>(64, 0, sw, 1, "A regs, B MNmaj 2 panels");
    run<64, 0, 1>(32, 0, sw, 1, "A regs, B MNmaj 1 panel K=32");
    run<128, 1, 1>(64, 0, sw, 0, "A MNmaj, B MNmaj");
    run<64, 1, 1>(64, 0, sw, 0, "A MNmaj, B MNmaj");
  }
  return 0;
}
