// Flash attention backward (dQ, dK, dV) for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no backward kernel and
// trains by differentiating its jnp chunked attention
// (src/repro/models/attention.py:flash_attention) under jax.checkpoint.
// The port's forward on the card is the hand kernel of flash_attention.cu,
// which also writes each row's log-sum-exp (LSE); these three kernels are
// its backward, so no plain attention runs on the training path.
//
// With P = exp(scale * Q.K^T - LSE) (masked entries 0), O = P.V and dO:
//   flash_bwd_preprocess   D[b,h,i]  = sum_d dO[i,d] * O[i,d]
//   flash_bwd_dkdv         dV[j]     = sum_i P[i,j] dO[i]
//                          dS[i,j]   = P[i,j] * (dO[i].V[j] - D[i])
//                          dK[j]     = scale * sum_i dS[i,j] Q[i]
//   flash_bwd_dq           dQ[i]     = scale * sum_j dS[i,j] K[j]
// With a soft cap, s' = cap * tanh(s / cap) and dS also takes the factor
// (1 - tanh^2).
//
// What bounds them: operations.  dkdv does four products per (query, key)
// pair (S, dP, dV, dK) and dq three (S and dP again, then dQ): at the
// training shape (B 4, S 1024, 32 heads x 128, causal) 68.8 and 51.6 GFLOP
// against 0.20 and 0.17 GB of inputs and outputs read once (~340 and ~305
// FLOP/B, above the card's ~295 ridge): bf16 tensor-core work, 0.070 and
// 0.052 ms at 989 TFLOP/s.
//
// bf16 design (flash_bwd_dkdv_wgmma, flash_bwd_dq_wgmma): every product is
// a wgmma m64n64k16 (bf16 in, float32 accumulate) of hopper_mma.cuh, on the
// 128-byte-swizzled tiles that the forward uses; tiles of 64 queries and 64
// keys; 16-byte cp.async copies zero-fill rows past Sq / Sk and columns past
// hd / hdv, so every width hd % 8 == 0 up to 256 runs at the padded width
// HDP = 64, 128, 192 or 256 (the Python launcher zero-pads other head dims
// into a copy and passes the real head dim's scale).
//   * dkdv: one block per (64-key tile, kv head, sequence).  K and V are
//     loaded once; a two-stage cp.async ring carries (Q, dO) tiles and
//     their 64 LSE and D values over the flattened (query head g of the kv
//     head, query tile) steps that the causal and window masks leave, so
//     step t + 1's load overlaps step t's products.  Per step, with keys
//     as rows (the wgmma M) and queries as columns:
//       S^T  = K.Q^T                  (ss: A = K, B = Q, both K-major)
//       P^T  = exp2(S^T scale log2e - LSE log2e), masked, packed to bf16
//              A fragments straight from the accumulator (LSE per column)
//       dV  += P^T.dO                 (rs: B = the dO tile MN-major)
//       dP^T = V.dO^T                 (ss, issued with dV's product)
//       dS^T = P^T (dP^T - D) [(1 - tanh^2)], packed over P's fragments
//       dK  += dS^T.Q                 (rs: B = the same Q tile MN-major)
//     dK is scaled once at the store.  The GQA sum over the kv head's G
//     query heads happens inside the block in a fixed order: no atomics.
//   * dq: one block per (64-query tile, head, sequence); Q, dO and the
//     rows' LSE and D loaded once, a two-stage ring of (K, V) tiles; per
//     step S = Q.K^T and dP = dO.V^T (ss, one commit group), dS, then
//     dQ += dS.K (rs: B = K MN-major).  It recomputes S and dP rather than
//     sum dQ across dkdv's blocks, so the result stays deterministic.
//   * Blocks take items heaviest first (dkdv: key tile 0, which every
//     causal query tile sees; dq: the last query tile), the forward's
//     rank order, with its lightest-first second round when the grid fits
//     in two blocks per SM.
//   * Registers: a warpgroup owns at most two 64-wide column panels of
//     dK and dV (dkdv) or of dQ (dq): 128 threads up to HDP 128, two
//     warpgroups above, each computing the block's S^T and dP^T (S and
//     dP) itself and its own panels of the sums (at HDP 192 warpgroup 1
//     repeats its one panel in its second accumulator, never stored, so
//     that no branch splits the wgmma stream).  Peak per thread in dkdv:
//     dK + dV 128, one 64 x 64 accumulator 32, P's (then dS's) and the
//     soft cap's fragments 16 + 16; ptxas gives dkdv 254 registers at HDP
//     128 (two blocks an SM) and no spill.  The wide instances pay the
//     repeated S and dP products (dkdv 6 products' time for 4, dq 5 for
//     3) to stay on the tensor cores.
//   * Rounding: P and dS are rounded to bf16 before their products (as the
//     forward rounds P, and as SDPA does); dkdv's dS takes the rounded P.
// float32 inputs keep the CUDA-core kernels below (no TF32), chosen by the
// launcher on dtype: float32 tiles in shared memory, 256 threads as a 16 x
// 16 grid of register micro-tiles, runtime head dims up to 256.
//
// Left for later: TMA loads from a producer warp (with mbarriers), two
// consumer warpgroups on one ring with the next step's S^T product
// overlapping this step's softmax, and persistent blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

// ---------------- the preprocess (both dtypes), float32 CUDA-core kernels --

constexpr int kThreads = 256;    // a 16 x 16 thread grid

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// D[b,h,i] = sum_d dO[b,i,h,d] * O[b,i,h,d]: one warp per (b, i, h) row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_preprocess_kernel(const T* __restrict__ out,
                            const T* __restrict__ dout, float* __restrict__ D,
                            int rows, int Sq, int H, int hdv) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + (size_t)row * hdv;
  const T* d = dout + (size_t)row * hdv;
  float acc = 0.f;
  for (int c = lane; c < hdv; c += 32) acc += to_f(o[c]) * to_f(d[c]);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const int h = row % H, i = row / H % Sq, b = row / H / Sq;
  if (lane == 0) D[((size_t)b * H + h) * Sq + i] = acc;
}

// dst [rows][HD + 1] <- rows of `width` elements, `stride` apart;
// rows past rows_valid and columns past width are zero
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int rows, int rows_valid,
                                          size_t stride, int width) {
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    dst[r * (HD + 1) + d] =
        r < rows_valid && d < width ? src[(size_t)r * stride + d] : 0.f;
  }
}

// The shared tiles of both kernels: K, V, Q, dO ([BT][HD + 1] each), P and
// dS ([BT][BT + 1]), and the query rows' LSE and D.
template <int HD, int BT>
struct Smem {
  static constexpr int LD = HD + 1, LS = BT + 1;
  static constexpr size_t bytes =
      sizeof(float) * (4 * BT * LD + 2 * BT * LS + 2 * BT);
  float *K, *V, *Q, *dO, *P, *dS, *lse, *D;
  __device__ explicit Smem(float* base) {
    K = base;
    V = K + BT * LD;
    Q = V + BT * LD;
    dO = Q + BT * LD;
    P = dO + BT * LD;
    dS = P + BT * LS;
    lse = dS + BT * LS;
    D = lse + BT;
  }
};

// For the query tile at q0 (rows in sm.Q / sm.dO, their LSE and D loaded)
// against the key tile at k0 (sm.K / sm.V): P and dS, each thread for rows
// ty + 16 r and keys tx + 16 c, written to sm.P and sm.dS.
template <int HD, int BT>
__device__ __forceinline__ void probs_and_grads(const Smem<HD, BT>& sm,
                                                int q0, int k0, int Sq,
                                                int Sk, int causal,
                                                int window, float soft_cap,
                                                float scale) {
  constexpr int RT = BT / 16, LD = HD + 1, LS = BT + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[RT][RT], dp[RT][RT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < RT; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[RT], da[RT], kb[RT], vb[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      qa[r] = sm.Q[(ty + 16 * r) * LD + d];
      da[r] = sm.dO[(ty + 16 * r) * LD + d];
      kb[r] = sm.K[(tx + 16 * r) * LD + d];
      vb[r] = sm.V[(tx + 16 * r) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < RT; ++c) {
        s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
        dp[r][c] = fmaf(da[r], vb[c], dp[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int li = ty + 16 * r, i = q0 + li;
#pragma unroll
    for (int c = 0; c < RT; ++c) {
      const int lj = tx + 16 * c, j = k0 + lj;
      bool ok = i < Sq && j < Sk;
      if (causal) ok = ok && j <= i;
      if (window >= 0) ok = ok && j > i - window;
      float x = s[r][c] * scale, dcap = 1.f;
      if (soft_cap > 0.f) {
        const float t = tanhf(x / soft_cap);
        x = soft_cap * t;
        dcap = 1.f - t * t;
      }
      const float p = ok ? expf(x - sm.lse[li]) : 0.f;
      sm.P[li * LS + lj] = p;
      sm.dS[li * LS + lj] = p * (dp[r][c] - sm.D[li]) * dcap;
    }
  }
}

// rows [q0, q0 + BT) of head h into sm.Q / sm.dO / sm.lse / sm.D
template <int HD, int BT>
__device__ __forceinline__ void load_query_tile(
    const Smem<HD, BT>& sm, const float* q, const float* dout, const float* lse,
    const float* D, int b, int h, int q0, int Sq, int H, int hd, int hdv) {
  load_rows<HD>(sm.Q, q + (((size_t)b * Sq + q0) * H + h) * hd, BT,
                   Sq - q0, (size_t)H * hd, hd);
  load_rows<HD>(sm.dO, dout + (((size_t)b * Sq + q0) * H + h) * hdv, BT,
                   Sq - q0, (size_t)H * hdv, hdv);
  if (threadIdx.x < BT) {
    const int i = q0 + threadIdx.x;
    const size_t at = ((size_t)b * H + h) * Sq + i;
    sm.lse[threadIdx.x] = i < Sq ? lse[at] : 0.f;
    sm.D[threadIdx.x] = i < Sq ? D[at] : 0.f;
  }
}

// keys [k0, k0 + BT) of kv head kvh into sm.K / sm.V
template <int HD, int BT>
__device__ __forceinline__ void load_key_tile(const Smem<HD, BT>& sm,
                                              const float* k,
                                              const float* v, int b,
                                              int kvh, int k0, int Sk,
                                              int KVH, int hd, int hdv) {
  load_rows<HD>(sm.K, k + (((size_t)b * Sk + k0) * KVH + kvh) * hd, BT,
                   Sk - k0, (size_t)KVH * hd, hd);
  load_rows<HD>(sm.V, v + (((size_t)b * Sk + k0) * KVH + kvh) * hdv, BT,
                   Sk - k0, (size_t)KVH * hdv, hdv);
}

template <int HD, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, float* __restrict__ dk,
                      float* __restrict__ dv, int Sq, int Sk, int H, int KVH,
                      int hd, int hdv, int causal, int window,
                      float soft_cap, float scale) {
  constexpr int RT = BT / 16, CT = HD / 16, LD = HD + 1, LS = BT + 1;
  extern __shared__ float smem[];
  const Smem<HD, BT> sm(smem);
  const int k0 = blockIdx.x * BT, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_key_tile<HD, BT>(sm, k, v, b, kvh, k0, Sk, KVH, hd, hdv);

  // this thread's keys ty + 16 r, columns tx + 16 c
  float dK[RT][CT], dV[RT][CT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) dK[r][c] = dV[r][c] = 0.f;

  // the query rows that see a key of this tile: i >= k0 when causal, and
  // i < (last key) + window with a window
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window >= 0 ? min(Sq, min(Sk, k0 + BT) - 1 + window) : Sq;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int q0 = q_lo; q0 < q_hi; q0 += BT) {
      __syncthreads();                 // the previous tile is consumed
      load_query_tile<HD, BT>(sm, q, dout, lse, D, b, h, q0, Sq, H, hd,
                                 hdv);
      __syncthreads();
      probs_and_grads<HD, BT>(sm, q0, k0, Sq, Sk, causal, window, soft_cap,
                              scale);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BT; ++i) {
        float pj[RT], sj[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          pj[r] = sm.P[i * LS + ty + 16 * r];
          sj[r] = sm.dS[i * LS + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const float qv = sm.Q[i * LD + tx + 16 * c];
          const float dov = sm.dO[i * LD + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            dV[r][c] = fmaf(pj[r], dov, dV[r][c]);
            dK[r][c] = fmaf(sj[r], qv, dK[r][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= Sk) continue;
    const size_t row = ((size_t)b * Sk + j) * KVH + kvh;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) dk[row * hd + col] = dK[r][c] * scale;
      if (col < hdv) dv[row * hdv + col] = dV[r][c];
    }
  }
}

template <int HD, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, float* __restrict__ dq, int Sq,
                    int Sk, int H, int KVH, int hd, int hdv, int causal,
                    int window, float soft_cap, float scale) {
  constexpr int RT = BT / 16, CT = HD / 16, LD = HD + 1, LS = BT + 1;
  extern __shared__ float smem[];
  const Smem<HD, BT> sm(smem);
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_query_tile<HD, BT>(sm, q, dout, lse, D, b, h, q0, Sq, H, hd, hdv);

  // this thread's rows ty + 16 r, columns tx + 16 c
  float dQ[RT][CT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) dQ[r][c] = 0.f;

  // the keys this tile's rows see: j <= (last row) when causal, and
  // j > q0 - window with a window
  int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  k_lo = k_lo / BT * BT;
  const int k_hi = causal ? min(Sk, min(Sq, q0 + BT)) : Sk;
  for (int k0 = k_lo; k0 < k_hi; k0 += BT) {
    __syncthreads();                   // the previous tile is consumed
    load_key_tile<HD, BT>(sm, k, v, b, kvh, k0, Sk, KVH, hd, hdv);
    __syncthreads();
    probs_and_grads<HD, BT>(sm, q0, k0, Sq, Sk, causal, window, soft_cap,
                            scale);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float sj[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) sj[r] = sm.dS[(ty + 16 * r) * LS + j];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float kv = sm.K[j * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RT; ++r) dQ[r][c] = fmaf(sj[r], kv, dQ[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= Sq) continue;
    float* row = dq + (((size_t)b * Sq + i) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) row[col] = dQ[r][c] * scale;
    }
  }
}

// ------------------------------------------------------ bf16: wgmma kernels --

// The bf16 instance at padded width HDP (64, 128, 192, 256): a warpgroup
// owns at most two 64-wide column panels of the block's sums.
template <int HDP>
struct Wg {
  static constexpr int kPanels = HDP / 64;
  static constexpr int kPPW = kPanels < 2 ? kPanels : 2;   // per warpgroup
  static constexpr int kNWG = (kPanels + 1) / 2;
  static constexpr int kThreads = kWG * kNWG;
  static constexpr uint32_t kTile = kRows * HDP * 2;       // one bf16 tile
  // two fixed tiles and a two-stage ring of two, 1 KB to align the
  // swizzle atoms; dkdv also keeps each stage's 64 LSE and 64 D values
  static constexpr int kSmemDq = 6 * kTile + 1024;
  static constexpr int kSmemDkdv = kSmemDq + 2 * 512;
};

// whether query i attends key j
__device__ __forceinline__ bool attends(int i, int j, int Sq, int Sk,
                                        int causal, int window) {
  bool ok = i < Sq && j < Sk;
  if (causal) ok = ok && j <= i;
  if (window >= 0) ok = ok && j > i - window;
  return ok;
}

// whether every query of the tile at q0 attends every key of the tile at k0
__device__ __forceinline__ bool tile_full(int q0, int k0, int Sq, int Sk,
                                          int causal, int window) {
  bool full = k0 + kKeys <= Sk && q0 + kRows <= Sq;
  if (causal) full = full && k0 + kKeys - 1 <= q0;
  if (window >= 0) full = full && k0 > q0 + kRows - 1 - window;
  return full;
}

// P = exp(scale * s - LSE) of a raw score s, lse2 = LSE * log2(e); with a
// soft cap the score is cap * tanh(scale * s / cap) and dcap = 1 - tanh^2
__device__ __forceinline__ float prob(float s, float lse2, float sl,
                                      float scale, float soft_cap,
                                      float& dcap) {
  if (soft_cap > 0.f) {
    const float t = tanhf(s * scale / soft_cap);
    dcap = 1.f - t * t;
    return ex2(fmaf(soft_cap * t, kLog2e, -lse2));
  }
  dcap = 1.f;
  return ex2(fmaf(s, sl, -lse2));
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The 64-wide column panel that warpgroup wg's p-th accumulator sums.  At
// HDP 192 warpgroup 1 has one panel: its second accumulator repeats it and
// is never stored, so every warpgroup issues the same products with no
// divergent branch (ptxas serializes wgmma around one).
template <int HDP>
__device__ __forceinline__ int panel_of(int wg, int p) {
  return min(wg * Wg<HDP>::kPPW + p, Wg<HDP>::kPanels - 1);
}

// The forward's rank order: item w of n_items in order of causal weight,
// heaviest first; when the grid fits in two blocks per SM the second round
// takes them lightest first, so an SM pairs a heavy item with a light one.
__device__ __forceinline__ int heavy_rank(int n_items, int sms) {
  const int w = blockIdx.x;
  return (n_items <= 2 * sms && w >= sms) ? n_items - 1 + sms - w : w;
}

// Accumulator element i (see hopper_mma.cuh) of this thread sits at row
// r0 + (i & 2 ? 8 : 0) and column 8 (i / 4) + cq + (i & 1).
template <int HDP>
__global__ void __launch_bounds__(Wg<HDP>::kThreads)
flash_bwd_dkdv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ D, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int B, int Sq, int Sk, int H,
                     int KVH, int hd, int hdv, int causal, int window,
                     float soft_cap, float scale, int sms) {
  using W = Wg<HDP>;
  constexpr int kPPW = W::kPPW, kT = W::kThreads;
  constexpr uint32_t kTile = W::kTile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u, sV = sK + kTile;
  // ring stage s: Q at sK + (2 + 2s) tiles, dO one tile on; its 64 LSE and
  // then 64 D values at rows + 512 s
  const uint32_t rows = sK + 6 * kTile;
  const float* rows_sm =
      reinterpret_cast<const float*>(smem_raw + (rows - raw));

  // heaviest first: with a causal mask key tile 0 sees every query tile
  const int per_kt = KVH * B;
  const int rank = heavy_rank((Sk + kKeys - 1) / kKeys * per_kt, sms);
  const int kt = rank / per_kt, kvh = rank % per_kt % KVH;
  const int b = rank % per_kt / KVH, G = H / KVH;
  const int tid = threadIdx.x, wg = W::kNWG > 1 ? tid >> 7 : 0;
  const int r0 = 16 * ((tid & 127) >> 5) + ((tid & 31) >> 2);
  const int cq = 2 * (tid & 3);
  const int k0 = kt * kKeys;

  // the query rows that see a key of this tile: i >= k0 when causal, and
  // i < (last key) + window with a window
  const int q_lo = causal ? k0 : 0;
  const int q_hi =
      window >= 0 ? min(Sq, min(Sk, k0 + kKeys) - 1 + window) : Sq;
  const int nqt = q_hi > q_lo ? (q_hi - q_lo + kRows - 1) / kRows : 0;
  const int n_steps = G * nqt;

  const size_t kv_stride = (size_t)KVH * hd, v_stride = (size_t)KVH * hdv;
  if (n_steps > 0) {        // else no query sees the tile: dK = dV = 0
    load_tile<HDP, kT>(sK, k + (((size_t)b * Sk + k0) * KVH + kvh) * hd,
                       Sk - k0, kv_stride, hd, tid);
    load_tile<HDP, kT>(sV, v + (((size_t)b * Sk + k0) * KVH + kvh) * hdv,
                       Sk - k0, v_stride, hdv, tid);
  }
  // step t: query head kvh * G + t / nqt, query tile q_lo + 64 (t % nqt)
  auto load_step = [&](int t) {
    const int h = kvh * G + t / nqt, q0 = q_lo + (t % nqt) * kRows;
    const uint32_t sQ = sK + (2 + 2 * (t & 1)) * kTile;
    load_tile<HDP, kT>(sQ, q + (((size_t)b * Sq + q0) * H + h) * hd,
                       Sq - q0, (size_t)H * hd, hd, tid);
    load_tile<HDP, kT>(sQ + kTile,
                       dout + (((size_t)b * Sq + q0) * H + h) * hdv, Sq - q0,
                       (size_t)H * hdv, hdv, tid);
    if (tid < 2 * kRows) {
      const int i = q0 + (tid & (kRows - 1));
      const float* src = (tid < kRows ? lse : D) + ((size_t)b * H + h) * Sq;
      cp_async4(rows + 512 * (t & 1) + 4 * tid, i < Sq ? src + i : src,
                i < Sq);
    }
  };
  if (n_steps > 0) load_step(0);
  cp_async_commit();

  float dKa[kPPW][32], dVa[kPPW][32];
#pragma unroll
  for (int p = 0; p < kPPW; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dKa[p][i] = dVa[p][i] = 0.f;
  const float sl = scale * kLog2e;

  for (int t = 0; t < n_steps; ++t) {
    const int q0 = q_lo + (t % nqt) * kRows;
    const uint32_t sQ = sK + (2 + 2 * (t & 1)) * kTile, sdO = sQ + kTile;
    const float* lse_sm = rows_sm + 128 * (t & 1);
    const float* d_sm = lse_sm + kRows;
    if (t + 1 < n_steps) load_step(t + 1);
    cp_async_commit();
    cp_async_wait1();                  // step t's tiles (and K, V) landed
    fence_async_shared();
    __syncthreads();

    // S^T = K.Q^T: keys x queries
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss(s, kmajor_desc(sK, kk), kmajor_desc(sQ, kk), kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // P^T, each column's LSE from the stage; bf16 A fragments
    const bool full = tile_full(q0, k0, Sq, Sk, causal, window);
    uint32_t pa[4][4], ca[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int c = 8 * (i >> 2) + cq;
      const float2 l = *reinterpret_cast<const float2*>(lse_sm + c);
      const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
      float p[4], dc[4];
      p[0] = prob(s[i], l0, sl, scale, soft_cap, dc[0]);
      p[1] = prob(s[i + 1], l1, sl, scale, soft_cap, dc[1]);
      p[2] = prob(s[i + 2], l0, sl, scale, soft_cap, dc[2]);
      p[3] = prob(s[i + 3], l1, sl, scale, soft_cap, dc[3]);
      if (!full) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (!attends(q0 + c + (u & 1), k0 + r0 + (u & 2 ? 8 : 0), Sq, Sk,
                       causal, window))
            p[u] = 0.f;
      }
      pack_frag(pa, i, p[0], p[1], p[2], p[3]);
      pack_frag(ca, i, dc[0], dc[1], dc[2], dc[3]);
    }

    // dV += P^T.dO, and dP^T = V.dO^T in the same commit group
    float dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    fence_regs(dp);
#pragma unroll
    for (int p = 0; p < kPPW; ++p) fence_regs(dVa[p]);
    wg_fence();
#pragma unroll
    for (int p = 0; p < kPPW; ++p)
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs_mn(dVa[p], pa[kk],
                    mnmajor_desc(sdO, panel_of<HDP>(wg, p), kk));
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss(dp, kmajor_desc(sV, kk), kmajor_desc(sdO, kk), kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(dp);
#pragma unroll
    for (int p = 0; p < kPPW; ++p) fence_regs(dVa[p]);
    fence_frags(pa);

    // dS^T = P^T (dP^T - D) [(1 - tanh^2)], over P's fragments
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int c = 8 * (i >> 2) + cq, f = ((i >> 2) & 1) * 2;
      const float2 d = *reinterpret_cast<const float2*>(d_sm + c);
      const float2 p01 = unpack_bf16(pa[i >> 3][f]);
      const float2 p23 = unpack_bf16(pa[i >> 3][f + 1]);
      float ds[4] = {p01.x * (dp[i] - d.x), p01.y * (dp[i + 1] - d.y),
                     p23.x * (dp[i + 2] - d.x), p23.y * (dp[i + 3] - d.y)};
      if (soft_cap > 0.f) {
        const float2 c01 = unpack_bf16(ca[i >> 3][f]);
        const float2 c23 = unpack_bf16(ca[i >> 3][f + 1]);
        ds[0] *= c01.x;
        ds[1] *= c01.y;
        ds[2] *= c23.x;
        ds[3] *= c23.y;
      }
      pack_frag(pa, i, ds[0], ds[1], ds[2], ds[3]);
    }

    // dK += dS^T.Q
#pragma unroll
    for (int p = 0; p < kPPW; ++p) fence_regs(dKa[p]);
    wg_fence();
#pragma unroll
    for (int p = 0; p < kPPW; ++p)
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs_mn(dKa[p], pa[kk],
                    mnmajor_desc(sQ, panel_of<HDP>(wg, p), kk));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < kPPW; ++p) fence_regs(dKa[p]);
    fence_frags(pa);
    __syncthreads();                   // stage t & 1 free for step t + 2
  }

  const int ja = k0 + r0, jb = ja + 8;
#pragma unroll
  for (int p = 0; p < kPPW; ++p) {
    const int n = wg * kPPW + p;
    if (n >= W::kPanels) continue;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int col = 64 * n + 8 * (i >> 2) + cq;
      if (col < hd) {
        if (ja < Sk)
          store2(dk + (((size_t)b * Sk + ja) * KVH + kvh) * hd + col,
                 dKa[p][i] * scale, dKa[p][i + 1] * scale);
        if (jb < Sk)
          store2(dk + (((size_t)b * Sk + jb) * KVH + kvh) * hd + col,
                 dKa[p][i + 2] * scale, dKa[p][i + 3] * scale);
      }
      if (col < hdv) {
        if (ja < Sk)
          store2(dv + (((size_t)b * Sk + ja) * KVH + kvh) * hdv + col,
                 dVa[p][i], dVa[p][i + 1]);
        if (jb < Sk)
          store2(dv + (((size_t)b * Sk + jb) * KVH + kvh) * hdv + col,
                 dVa[p][i + 2], dVa[p][i + 3]);
      }
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(Wg<HDP>::kThreads)
flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ D, bf16* __restrict__ dq, int B,
                   int Sq, int Sk, int H, int KVH, int hd, int hdv,
                   int causal, int window, float soft_cap, float scale,
                   int sms) {
  using W = Wg<HDP>;
  constexpr int kPPW = W::kPPW, kT = W::kThreads;
  constexpr uint32_t kTile = W::kTile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + kTile;
  // ring stage s: K at sQ + (2 + 2s) tiles, V one tile on

  // heaviest first: with a causal mask the last query tile sees every key
  // tile
  const int nqt = (Sq + kRows - 1) / kRows, per_qt = H * B;
  const int rank = heavy_rank(nqt * per_qt, sms);
  const int qt = nqt - 1 - rank / per_qt;
  const int h = rank % per_qt % H, b = rank % per_qt / H;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, wg = W::kNWG > 1 ? tid >> 7 : 0;
  const int r0 = 16 * ((tid & 127) >> 5) + ((tid & 31) >> 2);
  const int cq = 2 * (tid & 3);
  const int q0 = qt * kRows;

  // the keys this tile's rows see: j <= (last row) when causal, and
  // j > q0 - window with a window
  int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  k_lo = k_lo / kKeys * kKeys;
  const int k_hi = causal ? min(Sk, min(Sq, q0 + kRows)) : Sk;
  const int n_steps = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;

  if (n_steps > 0) {        // else the rows see no key: dQ = 0
    load_tile<HDP, kT>(sQ, q + (((size_t)b * Sq + q0) * H + h) * hd,
                       Sq - q0, (size_t)H * hd, hd, tid);
    load_tile<HDP, kT>(sdO, dout + (((size_t)b * Sq + q0) * H + h) * hdv,
                       Sq - q0, (size_t)H * hdv, hdv, tid);
  }
  const size_t kv_stride = (size_t)KVH * hd, v_stride = (size_t)KVH * hdv;
  const bf16* kbase = k + ((size_t)b * Sk * KVH + kvh) * hd;
  const bf16* vbase = v + ((size_t)b * Sk * KVH + kvh) * hdv;
  auto load_step = [&](int j) {
    const int k0 = k_lo + j * kKeys;
    const uint32_t sK = sQ + (2 + 2 * (j & 1)) * kTile;
    load_tile<HDP, kT>(sK, kbase + (size_t)k0 * kv_stride, Sk - k0,
                       kv_stride, hd, tid);
    load_tile<HDP, kT>(sK + kTile, vbase + (size_t)k0 * v_stride, Sk - k0,
                       v_stride, hdv, tid);
  };
  if (n_steps > 0) load_step(0);
  cp_async_commit();

  // this thread's rows ia and ia + 8: their LSE (log2 units) and D
  const int ia = q0 + r0, ib = ia + 8;
  const size_t at = ((size_t)b * H + h) * Sq;
  const float la = ia < Sq ? lse[at + ia] * kLog2e : 0.f;
  const float lb = ib < Sq ? lse[at + ib] * kLog2e : 0.f;
  const float da = ia < Sq ? D[at + ia] : 0.f;
  const float db = ib < Sq ? D[at + ib] : 0.f;

  float dQa[kPPW][32];
#pragma unroll
  for (int p = 0; p < kPPW; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dQa[p][i] = 0.f;
  const float sl = scale * kLog2e;

  for (int j = 0; j < n_steps; ++j) {
    const int k0 = k_lo + j * kKeys;
    const uint32_t sK = sQ + (2 + 2 * (j & 1)) * kTile, sV = sK + kTile;
    if (j + 1 < n_steps) load_step(j + 1);
    cp_async_commit();
    cp_async_wait1();                  // step j's tiles (and Q, dO) landed
    fence_async_shared();
    __syncthreads();

    // S = Q.K^T and dP = dO.V^T: queries x keys
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss(s, kmajor_desc(sQ, kk), kmajor_desc(sK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss(dp, kmajor_desc(sdO, kk), kmajor_desc(sV, kk), kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(s);
    fence_regs(dp);

    // dS = P (dP - D) [(1 - tanh^2)] as bf16 A fragments
    const bool full = tile_full(q0, k0, Sq, Sk, causal, window);
    uint32_t dsa[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int c = 8 * (i >> 2) + cq;
      float p[4], dc[4];
      p[0] = prob(s[i], la, sl, scale, soft_cap, dc[0]);
      p[1] = prob(s[i + 1], la, sl, scale, soft_cap, dc[1]);
      p[2] = prob(s[i + 2], lb, sl, scale, soft_cap, dc[2]);
      p[3] = prob(s[i + 3], lb, sl, scale, soft_cap, dc[3]);
      if (!full) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (!attends(u & 2 ? ib : ia, k0 + c + (u & 1), Sq, Sk, causal,
                       window))
            p[u] = 0.f;
      }
      pack_frag(dsa, i, p[0] * (dp[i] - da) * dc[0],
                p[1] * (dp[i + 1] - da) * dc[1],
                p[2] * (dp[i + 2] - db) * dc[2],
                p[3] * (dp[i + 3] - db) * dc[3]);
    }

    // dQ += dS.K
#pragma unroll
    for (int p = 0; p < kPPW; ++p) fence_regs(dQa[p]);
    wg_fence();
#pragma unroll
    for (int p = 0; p < kPPW; ++p)
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs_mn(dQa[p], dsa[kk],
                    mnmajor_desc(sK, panel_of<HDP>(wg, p), kk));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < kPPW; ++p) fence_regs(dQa[p]);
    fence_frags(dsa);
    __syncthreads();                   // stage j & 1 free for step j + 2
  }

#pragma unroll
  for (int p = 0; p < kPPW; ++p) {
    const int n = wg * kPPW + p;
    if (n >= W::kPanels) continue;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int col = 64 * n + 8 * (i >> 2) + cq;
      if (col >= hd) continue;
      if (ia < Sq)
        store2(dq + (((size_t)b * Sq + ia) * H + h) * hd + col,
               dQa[p][i] * scale, dQa[p][i + 1] * scale);
      if (ib < Sq)
        store2(dq + (((size_t)b * Sq + ib) * H + h) * hd + col,
               dQa[p][i + 2] * scale, dQa[p][i + 3] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *D;
  int B, Sq, Sk, H, KVH, hd, hdv, causal, window;
  float soft_cap, scale;
};

template <int HD, int BT>
int launch_dkdv(const Args& a, void* dk, void* dv, cudaStream_t s) {
  auto kern = flash_bwd_dkdv_kernel<HD, BT>;
  constexpr size_t smem = Smem<HD, BT>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sk + BT - 1) / BT, a.KVH, a.B);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.D),
      static_cast<float*>(dk), static_cast<float*>(dv), a.Sq, a.Sk, a.H,
      a.KVH, a.hd, a.hdv, a.causal, a.window, a.soft_cap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int BT>
int launch_dq(const Args& a, void* dq, cudaStream_t s) {
  auto kern = flash_bwd_dq_kernel<HD, BT>;
  constexpr size_t smem = Smem<HD, BT>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sq + BT - 1) / BT, a.H, a.B);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.D),
      static_cast<float*>(dq), a.Sq, a.Sk, a.H, a.KVH, a.hd, a.hdv,
      a.causal, a.window, a.soft_cap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <int HDP>
int launch_dkdv_wgmma(const Args& a, void* dk, void* dv, cudaStream_t s) {
  using W = Wg<HDP>;
  auto kern = flash_bwd_dkdv_wgmma<HDP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmemDkdv);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = (a.Sk + kKeys - 1) / kKeys * a.KVH * a.B;
  kern<<<items, W::kThreads, W::kSmemDkdv, s>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.D),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.B, a.Sq, a.Sk, a.H,
      a.KVH, a.hd, a.hdv, a.causal, a.window, a.soft_cap, a.scale,
      sm_count());
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_dq_wgmma(const Args& a, void* dq, cudaStream_t s) {
  using W = Wg<HDP>;
  auto kern = flash_bwd_dq_wgmma<HDP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmemDq);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = (a.Sq + kRows - 1) / kRows * a.H * a.B;
  kern<<<items, W::kThreads, W::kSmemDq, s>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.D),
      static_cast<bf16*>(dq), a.B, a.Sq, a.Sk, a.H, a.KVH, a.hd, a.hdv,
      a.causal, a.window, a.soft_cap, a.scale, sm_count());
  return static_cast<int>(cudaGetLastError());
}

// The instance for widths (hd, hdv) and dtype: bf16 (1) takes the wgmma
// instance at padded width 64, 128, 192 or 256 that holds both, for
// multiples of 8 only; float32 (0) the CUDA-core instance HD, the smallest
// of 32, 64, 128, 192, 256 that holds both (64 x 64 tiles up to 128, 32 x
// 32 above).  Returns that width, or 0 where there is none.
int instance_width(int dtype, int hd, int hdv) {
  const int w = hd > hdv ? hd : hdv;
  if (hd <= 0 || hdv <= 0 || w > 256) return 0;
  if (dtype == 1) {
    if (hd % 8 || hdv % 8) return 0;
    return w <= 64 ? 64 : w <= 128 ? 128 : w <= 192 ? 192 : 256;
  }
  return w <= 32 ? 32 : w <= 64 ? 64 : w <= 128 ? 128 : w <= 192 ? 192 : 256;
}

template <bool kDq>
int dispatch(int dtype, const Args& a, void* o0, void* o1, cudaStream_t s) {
  const int w = instance_width(dtype, a.hd, a.hdv);
  if (w == 0 || a.B <= 0 || a.H <= 0 || a.KVH <= 0 || a.H % a.KVH != 0 ||
      a.Sq <= 0 || a.Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
#define BWD_WGMMA(HDP) \
  (kDq ? launch_dq_wgmma<HDP>(a, o0, s) : launch_dkdv_wgmma<HDP>(a, o0, o1, s))
    switch (w) {
      case 64: return BWD_WGMMA(64);
      case 128: return BWD_WGMMA(128);
      case 192: return BWD_WGMMA(192);
      default: return BWD_WGMMA(256);
    }
#undef BWD_WGMMA
  }
#define BWD(HD, BT) \
  (kDq ? launch_dq<HD, BT>(a, o0, s) : launch_dkdv<HD, BT>(a, o0, o1, s))
  switch (w) {
    case 32: return BWD(32, 64);
    case 64: return BWD(64, 64);
    case 128: return BWD(128, 64);
    case 192: return BWD(192, 32);
    default: return BWD(256, 32);
  }
#undef BWD
}

}  // namespace

// Layouts: q [B,Sq,H,hd], k [B,Sk,KVH,hd], v [B,Sk,KVH,hdv], out / dout
// [B,Sq,H,hdv] and dq / dk / dv like q / k / v, all contiguous, in float32
// (dtype 0) or bf16 (dtype 1; hd and hdv multiples of 8, 16-byte aligned
// rows); lse and D [B,H,Sq] float32.  `scale` is the softmax scale the
// forward used (the real head dim's when the launcher padded it); soft_cap
// <= 0 means none; window < 0 means none.  Every launcher launches on
// `stream` and returns cudaGetLastError().
extern "C" int flash_bwd_preprocess_launch(const void* out, const void* dout,
                                           void* D, int B, int Sq, int H,
                                           int hdv, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * Sq * H;
  if (rows <= 0 || hdv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (dtype == 0)
    flash_bwd_preprocess_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout),
        static_cast<float*>(D), rows, Sq, H, hdv);
  else
    flash_bwd_preprocess_kernel<bf16><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
        static_cast<float*>(D), rows, Sq, H, hdv);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* D, void* dk,
                                     void* dv, int B, int Sq, int Sk, int H,
                                     int KVH, int hd, int hdv, int causal,
                                     int window, int dtype, float soft_cap,
                                     float scale, void* stream) {
  const Args a{q, k, v, dout, lse, D, B, Sq, Sk, H, KVH, hd, hdv, causal,
               window, soft_cap, scale};
  return dispatch<false>(dtype, a, dk, dv, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* D, void* dq,
                                   int B, int Sq, int Sk, int H, int KVH,
                                   int hd, int hdv, int causal, int window,
                                   int dtype, float soft_cap, float scale,
                                   void* stream) {
  const Args a{q, k, v, dout, lse, D, B, Sq, Sk, H, KVH, hd, hdv, causal,
               window, soft_cap, scale};
  return dispatch<true>(dtype, a, dq, nullptr,
                        static_cast<cudaStream_t>(stream));
}
