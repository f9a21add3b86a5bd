// Hopper (sm_90a) building blocks shared by the flash attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu): 16-byte
// cp.async copies into 128-byte-swizzled bf16 tiles, the wgmma shared-memory
// descriptor for that swizzle, and the two m64n64k16 wgmma forms the
// kernels use (both operands in shared memory, K-major; A from registers,
// B MN-major).
//
// A [64 x HDP] bf16 tile is HDP/64 panels of 64 rows x 128 bytes; in each
// 1024-byte group of 8 rows the 16-byte chunk c of row r sits at chunk
// c ^ (r & 7) (the 128-byte swizzle, Swizzle<3,4,3>, the pattern TMA's
// SWIZZLE_128B writes).  One such tile serves as a K-major operand (its
// rows are M or N, its columns the contraction) and as an MN-major B
// operand (its rows the contraction): the descriptors below name each.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;        // rows per tile: one wgmma M
constexpr int kKeys = 64;        // keys per tile: a 64-wide N or K
constexpr int kWG = 128;         // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills the 16 bytes when !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
// 4-byte async copy global -> shared; zero-fills the 4 bytes when !ok.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// make this thread's generic-proxy shared writes visible to wgmma's
// (async-proxy) operand reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [0, 64) of a [rows x hd] bf16 matrix (rows `row_stride` elements
// apart) into the swizzled tile at `dst`, by `kThreadsT` threads (`tid` in
// [0, kThreadsT)); rows past rows_valid and columns past hd are zero
template <int HDP, int kThreadsT = kWG>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base,
                                          int rows_valid, size_t row_stride,
                                          int hd, int tid) {
  constexpr int kChunks = HDP / 8;       // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreadsT; ++it) {
    const int i = tid + it * kThreadsT;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < rows_valid && c * 8 < hd;
    const bf16* src = ok ? base + (size_t)r * row_stride + c * 8 : base;
    const uint32_t off = (c >> 3) * (kRows * 128) + r * 128 +
                         (((c & 7) ^ (r & 7)) << 4);
    cp_async16(dst + off, src, ok);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  For a K-major
// operand SBO = 1024 B steps between 8-row groups and LBO is unused; for an
// MN-major B operand of an n64 product, the 8-row groups of the contraction
// step by 1024 B too and the N extent is one 64-wide swizzle atom, so both
// offsets are 1024 B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo & 0x3FFFF) >> 4) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}
// The K-major descriptor of k-step kk (16 columns) of a tile at `tile`
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * (kRows * 128) + (kk & 3) * 32, 16);
}
// The MN-major descriptor of k-step kk (16 rows) of 64-wide panel n
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int n,
                                                 int kk) {
  return sw128_desc(tile + n * (kRows * 128) + kk * 2048, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads / writes across the
// asynchronous wgmma window
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for A fragments in registers, which wgmma reads asynchronously
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    asm volatile("" : "+r"(a[i >> 2][i & 3])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64]; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64]; A in registers (bf16 pairs), B
// MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// Accumulator layout of a m64nN wgmma (f32): thread t of the warpgroup
// holds, for each 8-column group i, d[4i + 0..1] at row 16*(t/32) +
// (t%32)/4 and columns 8i + 2*(t%4) + {0, 1}, and d[4i + 2..3] at that row
// + 8.  The A fragment of k-step kk (16 columns) of the same rows is
// {row lo half, row+8 lo half, row hi half, row+8 hi half}, so accumulator
// elements i..i+3 (i % 4 == 0) pack into frag[i / 8][(i / 4) % 2 * 2 + {0,
// 1}]: an accumulator feeds the next product's A operand with no shuffle.
__device__ __forceinline__ void pack_frag(uint32_t (&a)[4][4], int i,
                                          float p0, float p1, float p2,
                                          float p3) {
  a[i >> 3][((i >> 2) & 1) * 2 + 0] = pack_bf16(p0, p1);
  a[i >> 3][((i >> 2) & 1) * 2 + 1] = pack_bf16(p2, p3);
}

}  // namespace
