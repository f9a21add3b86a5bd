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
// Design (simple and right, not fast): every product is a CUDA-core float32
// FMA on tiles held in shared memory as float32 (bf16 inputs are widened on
// load), 256 threads as a 16 x 16 grid, each thread a register micro-tile.
//   * dkdv: one block per (key tile, kv head, sequence).  It loops over the
//     kv head's G query heads and, for each, over the query tiles that can
//     see the key tile (the causal and window masks bound them), and
//     accumulates dK and dV in registers: the GQA sum happens inside the
//     block, in a fixed order.
//   * dq: one block per (query tile, head, sequence), looping over the key
//     tiles the masks leave.
//   * No atomics anywhere: the same inputs give the same bits.
// Tiles are 64 x 64 up to head dim 128 and 32 x 32 above (at 256: four
// 32-row float32 tiles of 257 words, 140 KB of shared memory).  The head
// dims are runtime values up to the instance's width HD (32, 64, 128, 192,
// 256): loads zero-fill the columns past hd (past hdv for V and dO) and the
// stores skip them, so value heads narrower than q/k heads (MLA: 192 / 128)
// and head dims no instance has (gemma-3: 168) need no padded copy.
//
// What bounds it: operations.  The backward does 2.5x the forward's matmul
// FLOP (five products against two); this design recomputes Q.K^T and dO.V^T
// in both dkdv and dq (seven), on CUDA cores at float32 rates.  Moving the
// products to wgmma with TMA-fed tiles is the speed work that follows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;    // a 16 x 16 thread grid

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

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

// dst [rows][HD + 1] float32 <- rows of `width` elements, `stride` apart;
// rows past rows_valid and columns past width are zero
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int rows,
                                          int rows_valid, size_t stride,
                                          int width) {
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    dst[r * (HD + 1) + d] =
        r < rows_valid && d < width ? to_f(src[(size_t)r * stride + d]) : 0.f;
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
template <typename T, int HD, int BT>
__device__ __forceinline__ void load_query_tile(
    const Smem<HD, BT>& sm, const T* q, const T* dout, const float* lse,
    const float* D, int b, int h, int q0, int Sq, int H, int hd, int hdv) {
  load_rows<T, HD>(sm.Q, q + (((size_t)b * Sq + q0) * H + h) * hd, BT,
                   Sq - q0, (size_t)H * hd, hd);
  load_rows<T, HD>(sm.dO, dout + (((size_t)b * Sq + q0) * H + h) * hdv, BT,
                   Sq - q0, (size_t)H * hdv, hdv);
  if (threadIdx.x < BT) {
    const int i = q0 + threadIdx.x;
    const size_t at = ((size_t)b * H + h) * Sq + i;
    sm.lse[threadIdx.x] = i < Sq ? lse[at] : 0.f;
    sm.D[threadIdx.x] = i < Sq ? D[at] : 0.f;
  }
}

// keys [k0, k0 + BT) of kv head kvh into sm.K / sm.V
template <typename T, int HD, int BT>
__device__ __forceinline__ void load_key_tile(const Smem<HD, BT>& sm,
                                              const T* k, const T* v, int b,
                                              int kvh, int k0, int Sk,
                                              int KVH, int hd, int hdv) {
  load_rows<T, HD>(sm.K, k + (((size_t)b * Sk + k0) * KVH + kvh) * hd, BT,
                   Sk - k0, (size_t)KVH * hd, hd);
  load_rows<T, HD>(sm.V, v + (((size_t)b * Sk + k0) * KVH + kvh) * hdv, BT,
                   Sk - k0, (size_t)KVH * hdv, hdv);
}

template <typename T, int HD, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int H, int KVH,
                      int hd, int hdv, int causal, int window,
                      float soft_cap, float scale) {
  constexpr int RT = BT / 16, CT = HD / 16, LD = HD + 1, LS = BT + 1;
  extern __shared__ float smem[];
  const Smem<HD, BT> sm(smem);
  const int k0 = blockIdx.x * BT, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_key_tile<T, HD, BT>(sm, k, v, b, kvh, k0, Sk, KVH, hd, hdv);

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
      load_query_tile<T, HD, BT>(sm, q, dout, lse, D, b, h, q0, Sq, H, hd,
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
      if (col < hd) dk[row * hd + col] = from_f<T>(dK[r][c] * scale);
      if (col < hdv) dv[row * hdv + col] = from_f<T>(dV[r][c]);
    }
  }
}

template <typename T, int HD, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, T* __restrict__ dq, int Sq,
                    int Sk, int H, int KVH, int hd, int hdv, int causal,
                    int window, float soft_cap, float scale) {
  constexpr int RT = BT / 16, CT = HD / 16, LD = HD + 1, LS = BT + 1;
  extern __shared__ float smem[];
  const Smem<HD, BT> sm(smem);
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_query_tile<T, HD, BT>(sm, q, dout, lse, D, b, h, q0, Sq, H, hd, hdv);

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
    load_key_tile<T, HD, BT>(sm, k, v, b, kvh, k0, Sk, KVH, hd, hdv);
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
    T* row = dq + (((size_t)b * Sq + i) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) row[col] = from_f<T>(dQ[r][c] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *D;
  int B, Sq, Sk, H, KVH, hd, hdv, causal, window;
  float soft_cap, scale;
};

template <typename T, int HD, int BT>
int launch_dkdv(const Args& a, void* dk, void* dv, cudaStream_t s) {
  auto kern = flash_bwd_dkdv_kernel<T, HD, BT>;
  constexpr size_t smem = Smem<HD, BT>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sk + BT - 1) / BT, a.KVH, a.B);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.D),
      static_cast<T*>(dk), static_cast<T*>(dv), a.Sq, a.Sk, a.H, a.KVH, a.hd,
      a.hdv, a.causal, a.window, a.soft_cap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int BT>
int launch_dq(const Args& a, void* dq, cudaStream_t s) {
  auto kern = flash_bwd_dq_kernel<T, HD, BT>;
  constexpr size_t smem = Smem<HD, BT>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sq + BT - 1) / BT, a.H, a.B);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.D),
      static_cast<T*>(dq), a.Sq, a.Sk, a.H, a.KVH, a.hd, a.hdv, a.causal,
      a.window, a.soft_cap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The instance for widths (hd, hdv): HD the smallest of 32, 64, 128, 192,
// 256 that holds both; 64 x 64 tiles up to 128, 32 x 32 above.
template <typename T, bool kDq>
int dispatch(const Args& a, void* o0, void* o1, cudaStream_t s) {
  const int w = a.hd > a.hdv ? a.hd : a.hdv;
  if (a.hd <= 0 || a.hdv <= 0 || w > 256 || a.B <= 0 || a.H <= 0 ||
      a.KVH <= 0 || a.H % a.KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define BWD(HD, BT)                                                   \
  (kDq ? launch_dq<T, HD, BT>(a, o0, s) : launch_dkdv<T, HD, BT>(a, o0, o1, s))
  if (w <= 32) return BWD(32, 64);
  if (w <= 64) return BWD(64, 64);
  if (w <= 128) return BWD(128, 64);
  if (w <= 192) return BWD(192, 32);
  return BWD(256, 32);
#undef BWD
}

}  // namespace

// Layouts: q [B,Sq,H,hd], k [B,Sk,KVH,hd], v [B,Sk,KVH,hdv], out / dout
// [B,Sq,H,hdv] and dq / dk / dv like q / k / v, all contiguous, in float32
// (dtype 0) or bf16 (dtype 1); lse and D [B,H,Sq] float32.  `scale` is the
// softmax scale the forward used; soft_cap <= 0 means none; window < 0
// means none.  Every launcher launches on `stream` and returns
// cudaGetLastError().
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float, false>(a, dk, dv, s)
                    : dispatch<bf16, false>(a, dk, dv, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float, true>(a, dq, nullptr, s)
                    : dispatch<bf16, true>(a, dq, nullptr, s);
}
