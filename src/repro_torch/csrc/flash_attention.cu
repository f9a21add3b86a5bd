// Causal / windowed GQA flash attention (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` / `_kernel` in
// src/repro/kernels/flash_attention/kernel.py.  There the grid (B, H, nQ, nK)
// ran in order on one core and carried (m, l, acc) along nK in revisited
// output blocks; here blocks run in parallel in no order, so each block owns
// one (query tile of 64 rows, head, sequence) and loops over the key tiles
// itself, keeping the online-softmax state in registers.
//
// What bounds it on the H100: at the serving path's S = 448, bytes.  A
// causal prefill does 4 * S(S+1)/2 * hd FLOP per head against 8 * S * hd
// bytes (Q, K, V and O once, in bf16): (S+1)/4 FLOP/B, ~112 at S = 448,
// under the card's ~295 FLOP/B ridge (989 TFLOP/s bf16 over 3.35 TB/s).  It
// turns bound by operations only above S ~ 1.2k.  At these sizes the time
// goes to latency: the chain of loads, products and softmax steps of the
// heaviest (diagonal-most) query tile.
//
// bf16 design (flash_wgmma_kernel):
//   * one warpgroup (128 threads) owns 64 query rows of one head;
//   * S = Q.K^T and O += P.V run on the tensor cores through `wgmma`
//     (m64n64k16, bf16 in, f32 accumulate).  Q and K are K-major shared
//     operands, V an MN-major shared operand (the descriptor's transpose
//     bit); P never leaves registers: the S accumulator is rescaled, cast to
//     bf16 and fed back as the register A operand of the P.V product;
//   * K/V tiles of 64 keys go through a two-stage shared-memory ring filled
//     by 16-byte `cp.async` copies, so the load of tile j+1 overlaps the
//     products of tile j.  The copies write the 128-byte swizzle that the
//     descriptors name (the pattern TMA's SWIZZLE_128B writes), and zero-fill
//     rows past Sk and columns past hd: head dims 16..256 share the padded
//     widths 64, 128 and 256, with no per-call tensor map to encode;
//   * key tiles wholly above the causal diagonal or below the window are
//     skipped; only diagonal and window-edge tiles are masked; the softmax
//     works on raw scores and folds the scale into one FMA per exp, and
//     rescales the accumulator only when a row's max moved;
//   * blocks take (query tile, head, sequence) items heaviest first; when
//     the grid fits in two blocks per SM the second round runs lightest
//     first, so each SM pairs a heavy causal tile with a light one;
//   * q_offset is the absolute position of query row 0 (a prefix-cache
//     suffix prefill: Sq suffix rows against the whole Sk-long key stream).
//     It enters every causal and window test and every tile bound as the
//     query tile's absolute start qa0 = q_offset + q0; key tiles stay
//     aligned to absolute position 0, as in the full prefill.
// float32 inputs have no bf16 tensor-core path; they keep the CUDA-core
// kernel (flash_f32_kernel), chosen by the launcher on dtype.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------- float32 --

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // keys per tile
constexpr int kThreads = 256;    // 4 threads per query row
constexpr int kColsPerThread = kBK / 4;

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int Sq, int Sk, int H, int KVH, int causal, int window,
                 int q_offset, float soft_cap) {
  constexpr int LD = HD + 1;             // padded row stride (words)
  constexpr int kDPerThread = HD / 4;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;             // [kBK][LD]
  float* Vs = Ks + kBK * LD;             // [kBK][LD]
  float* Ss = Vs + kBK * LD;             // [kBQ][kBK + 1]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;
  const int q0 = qt * kBQ;
  const float scale = rsqrtf((float)HD);

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int row = i / HD, d = i - row * HD;
    const int s = q0 + row;
    Qs[row * LD + d] = s < Sq ? q[(((size_t)b * Sq + s) * H + h) * HD + d] : 0.f;
  }

  const int qa0 = q_offset + q0;         // absolute position of row 0
  int k_end = Sk;
  if (causal) k_end = min(Sk, qa0 + kBQ);
  int k_begin = 0;
  if (window >= 0) k_begin = max(0, qa0 - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  float m_i = -CUDART_INF_F, l_i = 0.f;
  float acc[kDPerThread];
#pragma unroll
  for (int i = 0; i < kDPerThread; ++i) acc[i] = 0.f;
  const int qpos = qa0 + r;              // absolute, for the masks

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                     // previous tile fully consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i - c * HD;
      const int s = k0 + c;
      const size_t off = (((size_t)b * Sk + s) * KVH + kvh) * HD + d;
      Ks[c * LD + d] = s < Sk ? k[off] : 0.f;
      Vs[c * LD + d] = s < Sk ? v[off] : 0.f;
    }
    __syncthreads();

    float sc[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) sc[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        sc[j] += qd * Ks[(sub + 4 * j) * LD + d];
    }
    float mc = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int kpos = k0 + sub + 4 * j;
      float s = sc[j] * scale;
      if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
      bool ok = kpos < Sk;
      if (causal) ok = ok && qpos >= kpos;
      if (window >= 0) ok = ok && kpos > qpos - window;
      sc[j] = ok ? s : -CUDART_INF_F;
      mc = fmaxf(mc, sc[j]);
    }
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
    const float m_new = fmaxf(m_i, mc);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const float p = sc[j] == -CUDART_INF_F ? 0.f : __expf(sc[j] - m_new);
      Ss[r * (kBK + 1) + sub + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = m_i == -CUDART_INF_F ? 0.f : __expf(m_i - m_new);
    l_i = l_i * corr + psum;
    m_i = m_new;
    __syncwarp();                        // the row's 4 threads share Ss[r]
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i) acc[i] *= corr;
    for (int c = 0; c < kBK; ++c) {
      const float p = Ss[r * (kBK + 1) + c];
#pragma unroll
      for (int i = 0; i < kDPerThread; ++i)
        acc[i] += p * Vs[c * LD + sub + 4 * i];
    }
  }

  if (q0 + r < Sq) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    float* orow = out + (((size_t)b * Sq + q0 + r) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i) orow[sub + 4 * i] = acc[i] * inv;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int H, int KVH, int causal, int window,
               int q_offset, float soft_cap, cudaStream_t s) {
  constexpr int LD = HD + 1;
  const size_t smem = sizeof(float) * ((kBQ + 2 * kBK) * LD + kBQ * (kBK + 1));
  auto kern = flash_f32_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, KVH,
      causal, window, q_offset, soft_cap);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(int hd, const void* q, const void* k, const void* v,
                 void* out, int B, int Sq, int Sk, int H, int KVH, int causal,
                 int window, int q_offset, float soft_cap, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_f32<16>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, q_offset, soft_cap, s);
    case 32: return launch_f32<32>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, q_offset, soft_cap, s);
    case 48: return launch_f32<48>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, q_offset, soft_cap, s);
    case 64: return launch_f32<64>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, q_offset, soft_cap, s);
    case 96: return launch_f32<96>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, q_offset, soft_cap, s);
    case 128: return launch_f32<128>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, q_offset, soft_cap, s);
    case 256: return launch_f32<256>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, q_offset, soft_cap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------- bf16 --

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;        // query rows per block: one wgmma M
constexpr int kKeys = 64;        // keys per tile: the S product's N
constexpr int kWG = 128;         // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

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

// A [64 x HDP] bf16 tile in shared memory is HDP/64 panels of 64 rows x
// 128 bytes; in each 1024-byte group of 8 rows the 16-byte chunk c of row r
// sits at chunk c ^ (r & 7) (the 128-byte swizzle, Swizzle<3,4,3>).
template <int HDP>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base,
                                          int rows_valid, size_t row_stride,
                                          int hd, int tid) {
  constexpr int kChunks = HDP / 8;       // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kWG; ++it) {
    const int i = tid + it * kWG;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < rows_valid && c * 8 < hd;
    const bf16* src = ok ? base + (size_t)r * row_stride + c * 8 : base;
    const uint32_t off = (c >> 3) * (kRows * 128) + r * 128 +
                         (((c & 7) ^ (r & 7)) << 4);
    cp_async16(dst + off, src, ok);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  For the K-major
// operands (Q, K) SBO = 1024 B steps between 8-row groups and LBO is unused;
// for the MN-major V operand of an n64 product, the 8-key groups step by
// 1024 B too and the N extent is one 64-wide swizzle atom, so both offsets
// are 1024 B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo & 0x3FFFF) >> 4) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
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

// Accumulator layout of a m64nN wgmma (f32): thread t of the warpgroup holds,
// for each 8-column group i, d[4i + 0..1] at row 16*(t/32) + (t%32)/4 and
// columns 8i + 2*(t%4) + {0, 1}, and d[4i + 2..3] at that row + 8.
template <int HDP>
__global__ void __launch_bounds__(kWG)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
                   int Sk, int H, int KVH, int hd, int causal, int window,
                   int q_offset, float soft_cap, int sms) {
  constexpr int kPanels = HDP / 64;
  constexpr uint32_t kTileBytes = kRows * HDP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // stage s: K at sQ + (1 + 2s) * tile, V at sQ + (2 + 2s) * tile

  // Work items in order of causal weight, heaviest first.  When the grid
  // fits in two blocks per SM, the second round takes them lightest first,
  // so the SM that runs a heavy query tile shares it with a light one.  A
  // tile's weight is the key tiles it really sees, from k_begin to
  // min(Sk, q_offset + q0 + 64): for any q_offset that count does not
  // decrease with the query tile (without a window it is the offset's
  // tiles plus qt + 1), so the highest query tile is still the heaviest
  // and the ranks below are still the weight order.
  const int nqt = (Sq + kRows - 1) / kRows, per_qt = H * (int)gridDim.y;
  const int n_items = nqt * per_qt, w = blockIdx.x + (int)gridDim.x * blockIdx.y;
  const int rank = (n_items <= 2 * sms && w >= sms) ? n_items - 1 + sms - w : w;
  const int qt = nqt - 1 - rank / per_qt;
  const int h = rank % per_qt % H, b = rank % per_qt / H;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = qt * kRows;
  const int r0 = 16 * warp + (lane >> 2);        // this thread's rows r0, r0+8
  const int cq = 2 * (lane & 3);                 // and columns cq + {0, 1}
  const float scale = rsqrtf((float)hd);

  const int qa0 = q_offset + q0;                 // absolute position of row 0
  int k_end = Sk;
  if (causal) k_end = min(Sk, qa0 + kRows);
  int k_begin = 0;
  if (window >= 0) k_begin = max(0, qa0 - window + 1);
  k_begin = (k_begin / kKeys) * kKeys;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;

  const size_t kv_stride = (size_t)KVH * hd;
  const bf16* kbase = k + ((size_t)b * Sk * KVH + kvh) * hd;
  const bf16* vbase = v + ((size_t)b * Sk * KVH + kvh) * hd;
  load_tile<HDP>(sQ, q + (((size_t)b * Sq + q0) * H + h) * hd, Sq - q0,
                 (size_t)H * hd, hd, tid);
  if (n_tiles > 0) {
    load_tile<HDP>(sQ + kTileBytes, kbase + (size_t)k_begin * kv_stride,
                   Sk - k_begin, kv_stride, hd, tid);
    load_tile<HDP>(sQ + 2 * kTileBytes, vbase + (size_t)k_begin * kv_stride,
                   Sk - k_begin, kv_stride, hd, tid);
  }
  cp_async_commit();

  float o[kPanels][32];
#pragma unroll
  for (int n = 0; n < kPanels; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;                      // this thread's partial sums
  const float sl2 = scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * kKeys;
    const uint32_t sK = sQ + (1 + 2 * (j & 1)) * kTileBytes;
    const uint32_t sV = sK + kTileBytes;
    if (j + 1 < n_tiles) {                       // prefetch tile j+1
      const uint32_t nK = sQ + (1 + 2 * ((j + 1) & 1)) * kTileBytes;
      const int k1 = k0 + kKeys;
      load_tile<HDP>(nK, kbase + (size_t)k1 * kv_stride, Sk - k1, kv_stride,
                     hd, tid);
      load_tile<HDP>(nK + kTileBytes, vbase + (size_t)k1 * kv_stride, Sk - k1,
                     kv_stride, hd, tid);
    }
    cp_async_commit();
    cp_async_wait1();                            // tile j (and Q) landed
    fence_async_shared();
    __syncthreads();

    // S = Q . K^T over HDP / 16 k-steps
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (kRows * 128) + (kk & 3) * 32;
      wgmma_ss(s, sw128_desc(sQ + off, 16), sw128_desc(sK + off, 16), kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // soft cap and mask the raw scores; the log2 scale rides in the exp
    bool full = k0 + kKeys <= Sk;
    if (causal) full = full && k0 + kKeys - 1 <= qa0;
    if (window >= 0) full = full && k0 > qa0 + kRows - 1 - window;
    if (soft_cap > 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = soft_cap * tanhf(s[i] * scale / soft_cap) * kLog2e;
    }
    const float sl = soft_cap > 0.f ? 1.f : sl2;   // raw -> log2 units
    if (!full) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int qpos = qa0 + r0 + ((i & 2) ? 8 : 0);
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window >= 0) ok = ok && kpos > qpos - window;
        if (!ok) s[i] = -CUDART_INF_F;
      }
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0 * sl), n1 = fmaxf(m1, mx1 * sl);
    const float u0 = n0 == -CUDART_INF_F ? 0.f : n0;   // a row with nothing
    const float u1 = n1 == -CUDART_INF_F ? 0.f : n1;   // valid yet stays 0
    const float c0 = ex2(m0 - u0), c1 = ex2(m1 - u1);
    m0 = n0;
    m1 = n1;
    float ps0 = 0.f, ps1 = 0.f;
    uint32_t pa[4][4];                           // P as the A operand, bf16
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const float p0 = ex2(fmaf(s[i], sl, -u0)), p1 = ex2(fmaf(s[i + 1], sl, -u0));
      const float p2 = ex2(fmaf(s[i + 2], sl, -u1)), p3 = ex2(fmaf(s[i + 3], sl, -u1));
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      // columns 8*(i/4) .. +7 are half (i/4)&1 of k-step i/8
      pa[i >> 3][((i >> 2) & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[i >> 3][((i >> 2) & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
    if (c0 != 1.f || c1 != 1.f) {                // the row max moved
#pragma unroll
      for (int n = 0; n < kPanels; ++n)
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          o[n][i] *= c0;
          o[n][i + 1] *= c0;
          o[n][i + 2] *= c1;
          o[n][i + 3] *= c1;
        }
    }
#pragma unroll
    for (int n = 0; n < kPanels; ++n) fence_regs(o[n]);

    // O += P . V: k-steps of 16 keys, one n64 product per 64-wide panel
    wg_fence();
#pragma unroll
    for (int n = 0; n < kPanels; ++n)
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs_mn(o[n], pa[kk],
                    sw128_desc(sV + n * (kRows * 128) + kk * 2048, 1024));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int n = 0; n < kPanels; ++n) fence_regs(o[n]);
    __syncthreads();                             // stage free for tile j+2
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int qa = q0 + r0, qb = qa + 8;
#pragma unroll
  for (int n = 0; n < kPanels; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int col = 64 * n + 8 * (i >> 2) + cq;
      if (col >= hd) continue;
      if (qa < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((size_t)b * Sq + qa) * H + h) * hd + col) =
            __floats2bfloat162_rn(o[n][i] * inv0, o[n][i + 1] * inv0);
      if (qb < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((size_t)b * Sq + qb) * H + h) * hd + col) =
            __floats2bfloat162_rn(o[n][i + 2] * inv1, o[n][i + 3] * inv1);
    }
}

template <int HDP>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Sk, int H, int KVH, int hd, int causal,
                int window, int q_offset, float soft_cap, cudaStream_t s) {
  // Q plus a two-stage K/V ring, and 1 KB to align the swizzle atoms
  const int smem = 5 * kRows * HDP * 2 + 1024;
  auto kern = flash_wgmma_kernel<HDP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  dim3 grid((Sq + kRows - 1) / kRows * H, B);
  kern<<<grid, kWG, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, H, KVH,
      hd, causal, window, q_offset, soft_cap, sms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int KVH, int hd,
                                      int causal, int window, int q_offset,
                                      int dtype, float soft_cap,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_f32(hd, q, k, v, out, B, Sq, Sk, H, KVH, causal, window,
                        q_offset, soft_cap, s);
  if (hd % 16 != 0 || hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64)
    return launch_bf16<64>(q, k, v, out, B, Sq, Sk, H, KVH, hd, causal,
                           window, q_offset, soft_cap, s);
  if (hd <= 128)
    return launch_bf16<128>(q, k, v, out, B, Sq, Sk, H, KVH, hd, causal,
                            window, q_offset, soft_cap, s);
  return launch_bf16<256>(q, k, v, out, B, Sq, Sk, H, KVH, hd, causal, window,
                          q_offset, soft_cap, s);
}
