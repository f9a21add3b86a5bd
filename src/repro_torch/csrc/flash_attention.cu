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
//     rows past Sk and columns past hd (past hdv for V): every head dim
//     hd % 8 == 0 up to 256 runs at the padded width 64, 128, 192 or 256
//     (the Q.K^T k16 steps cover the zero-filled columns, the output store
//     skips them), with no per-call tensor map to encode.  V and the output
//     may be narrower than Q and K (MLA: hd 192, hdv 128 on the 192-wide
//     instance): V's zero columns add nothing to the P.V panels past hdv,
//     and the store skips them;
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
// Both kernels can also write each row's log-sum-exp of its scaled scores
// (LSE, natural log, [B, H, Sq] float32) for the backward kernels of
// flash_attention_bwd.cu; serving passes a null pointer and skips it.
// A head dim the kernels do not take (bf16: hd % 8 != 0; float32: not an
// instance) is zero-padded by the Python launcher, which passes the softmax
// scale of the real head dim: zero columns add nothing to Q.K^T or P.V.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper_mma.cuh"

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
                 float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                 int hdv, int causal,
                 int window, int q_offset, const int* __restrict__ q_offset_dev,
                 float soft_cap, float scale) {
  if (q_offset_dev != nullptr) q_offset = *q_offset_dev;
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
      const size_t row = ((size_t)b * Sk + s) * KVH + kvh;
      Ks[c * LD + d] = s < Sk ? k[row * HD + d] : 0.f;
      // V rows are hdv wide; the columns past hdv stay zero
      Vs[c * LD + d] = s < Sk && d < hdv ? v[row * hdv + d] : 0.f;
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
    float* orow = out + (((size_t)b * Sq + q0 + r) * H + h) * hdv;
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i)
      if (sub + 4 * i < hdv) orow[sub + 4 * i] = acc[i] * inv;
    // the row's log-sum-exp of the scaled scores, for the backward
    if (lse != nullptr && sub == 0)
      lse[((size_t)b * H + h) * Sq + q0 + r] = m_i + logf(l_i);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int Sq, int Sk, int H, int KVH, int hdv,
               int causal, int window, int q_offset, const int* q_offset_dev,
               float soft_cap, float scale, cudaStream_t s) {
  constexpr int LD = HD + 1;
  const size_t smem = sizeof(float) * ((kBQ + 2 * kBK) * LD + kBQ * (kBK + 1));
  auto kern = flash_f32_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), Sq, Sk, H, KVH, hdv, causal, window, q_offset,
      q_offset_dev, soft_cap, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(int hd, const void* q, const void* k, const void* v,
                 void* out, void* lse, int B, int Sq, int Sk, int H,
                 int KVH, int hdv, int causal, int window, int q_offset,
                 const int* q_offset_dev, float soft_cap, float scale,
                 cudaStream_t s) {
  if (hdv <= 0 || hdv > hd) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch_f32<16>(q, k, v, out, lse, B, Sq, Sk, H, KVH, hdv, causal, window, q_offset, q_offset_dev, soft_cap, scale, s);
    case 32: return launch_f32<32>(q, k, v, out, lse, B, Sq, Sk, H, KVH, hdv, causal, window, q_offset, q_offset_dev, soft_cap, scale, s);
    case 48: return launch_f32<48>(q, k, v, out, lse, B, Sq, Sk, H, KVH, hdv, causal, window, q_offset, q_offset_dev, soft_cap, scale, s);
    case 64: return launch_f32<64>(q, k, v, out, lse, B, Sq, Sk, H, KVH, hdv, causal, window, q_offset, q_offset_dev, soft_cap, scale, s);
    case 96: return launch_f32<96>(q, k, v, out, lse, B, Sq, Sk, H, KVH, hdv, causal, window, q_offset, q_offset_dev, soft_cap, scale, s);
    case 128: return launch_f32<128>(q, k, v, out, lse, B, Sq, Sk, H, KVH, hdv, causal, window, q_offset, q_offset_dev, soft_cap, scale, s);
    case 256: return launch_f32<256>(q, k, v, out, lse, B, Sq, Sk, H, KVH, hdv, causal, window, q_offset, q_offset_dev, soft_cap, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------- bf16 --
// (cp.async tiles, descriptors and the wgmma forms: hopper_mma.cuh)

// Accumulator layout of a m64nN wgmma (f32): thread t of the warpgroup holds,
// for each 8-column group i, d[4i + 0..1] at row 16*(t/32) + (t%32)/4 and
// columns 8i + 2*(t%4) + {0, 1}, and d[4i + 2..3] at that row + 8.
template <int HDP>
__global__ void __launch_bounds__(kWG)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out,
                   float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                   int hd, int hdv, int causal, int window, int q_offset,
                   const int* __restrict__ q_offset_dev, float soft_cap,
                   float scale, int sms) {
  if (q_offset_dev != nullptr) q_offset = *q_offset_dev;
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

  const int qa0 = q_offset + q0;                 // absolute position of row 0
  int k_end = Sk;
  if (causal) k_end = min(Sk, qa0 + kRows);
  int k_begin = 0;
  if (window >= 0) k_begin = max(0, qa0 - window + 1);
  k_begin = (k_begin / kKeys) * kKeys;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;

  // V rows are hdv wide (MLA: 128 against q/k's 192); their loads zero-fill
  // the columns past hdv, as the K loads do past hd
  const size_t kv_stride = (size_t)KVH * hd, v_stride = (size_t)KVH * hdv;
  const bf16* kbase = k + ((size_t)b * Sk * KVH + kvh) * hd;
  const bf16* vbase = v + ((size_t)b * Sk * KVH + kvh) * hdv;
  load_tile<HDP>(sQ, q + (((size_t)b * Sq + q0) * H + h) * hd, Sq - q0,
                 (size_t)H * hd, hd, tid);
  if (n_tiles > 0) {
    load_tile<HDP>(sQ + kTileBytes, kbase + (size_t)k_begin * kv_stride,
                   Sk - k_begin, kv_stride, hd, tid);
    load_tile<HDP>(sQ + 2 * kTileBytes, vbase + (size_t)k_begin * v_stride,
                   Sk - k_begin, v_stride, hdv, tid);
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
      load_tile<HDP>(nK + kTileBytes, vbase + (size_t)k1 * v_stride, Sk - k1,
                     v_stride, hdv, tid);
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
  if (lse != nullptr && (lane & 3) == 0) {
    // the rows' log-sum-exp of the scaled scores, natural log (m is in
    // log2 units), for the backward
    float* lrow = lse + ((size_t)b * H + h) * Sq;
    if (qa < Sq) lrow[qa] = (m0 + log2f(l0)) * kLn2;
    if (qb < Sq) lrow[qb] = (m1 + log2f(l1)) * kLn2;
  }
#pragma unroll
  for (int n = 0; n < kPanels; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int col = 64 * n + 8 * (i >> 2) + cq;
      if (col >= hdv) continue;
      if (qa < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((size_t)b * Sq + qa) * H + h) * hdv + col) =
            __floats2bfloat162_rn(o[n][i] * inv0, o[n][i + 1] * inv0);
      if (qb < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((size_t)b * Sq + qb) * H + h) * hdv + col) =
            __floats2bfloat162_rn(o[n][i + 2] * inv1, o[n][i + 3] * inv1);
    }
}

template <int HDP>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int Sq, int Sk, int H, int KVH, int hd,
                int hdv, int causal, int window, int q_offset,
                const int* q_offset_dev, float soft_cap, float scale,
                cudaStream_t s) {
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
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), Sq, Sk, H, KVH, hd, hdv, causal, window,
      q_offset, q_offset_dev, soft_cap, scale, sms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hd / hdv: the widths of q and k / of v and out, as the arrays are laid
// out (the launcher zero-pads a head dim the kernels do not take, and
// passes the softmax scale of the real one).  lse: null, or [B, H, Sq]
// float32 for each row's log-sum-exp of its scaled scores (the backward's
// input; serving passes null).  q_offset_dev: null, or one int32 in device
// memory that both kernels read at entry in place of q_offset (a suffix
// prefill captured in a CUDA graph, whose launch arguments are fixed at
// capture while the offset changes per replay; the grid does not depend on
// it, so the host checks only the argument).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Sk, int H, int KVH,
                                      int hd, int hdv,
                                      int causal, int window, int q_offset,
                                      const int* q_offset_dev, int dtype,
                                      float soft_cap, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_f32(hd, q, k, v, out, lse, B, Sq, Sk, H, KVH, hdv, causal,
                        window, q_offset, q_offset_dev, soft_cap, scale, s);
  if (hd <= 0 || hd % 8 != 0 || hd > 256 || hdv <= 0 || hdv % 8 != 0 ||
      hdv > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = hd > hdv ? hd : hdv;     // the padded width covers both
#define FLASH_BF16(HDP)                                                     \
  launch_bf16<HDP>(q, k, v, out, lse, B, Sq, Sk, H, KVH, hd, hdv, causal,    \
                   window, q_offset, q_offset_dev, soft_cap, scale, s)
  if (w <= 64) return FLASH_BF16(64);
  if (w <= 128) return FLASH_BF16(128);
  if (w <= 192) return FLASH_BF16(192);
  return FLASH_BF16(256);
#undef FLASH_BF16
}
