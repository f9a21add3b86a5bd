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
// turns bound by operations only above S ~ 1.2k.  So the gap to the bound
// (PERF.md) is latency and CUDA-core arithmetic, not the HBM rate: fewer,
// fatter blocks and tensor-core products are what close it, not fewer
// bytes.  This first version is simple: the products run on the CUDA cores
// in float32 (bf16 inputs widened on load), with Q, K, V and the score tile
// in shared memory (rows padded by one word against bank conflicts) and each
// thread holding a 1 x hd/4 slice of the output accumulator in registers.
// Key tiles above the causal diagonal or below the window are skipped, as
// the Pallas kernel skipped them.  Tensor cores (wgmma) and TMA-fed
// pipelines are later work; PERF.md records the gap to the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // keys per tile
constexpr int kThreads = 256;    // 4 threads per query row
constexpr int kColsPerThread = kBK / 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 int Sq, int Sk, int H, int KVH, int causal, int window,
                 float soft_cap) {
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
    Qs[row * LD + d] = s < Sq ? to_f(q[(((size_t)b * Sq + s) * H + h) * HD + d]) : 0.f;
  }

  // key range this tile of queries can see
  int k_end = Sk;
  if (causal) k_end = min(Sk, q0 + kBQ);
  int k_begin = 0;
  if (window >= 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  float m_i = -CUDART_INF_F, l_i = 0.f;
  float acc[kDPerThread];
#pragma unroll
  for (int i = 0; i < kDPerThread; ++i) acc[i] = 0.f;
  const int qpos = q0 + r;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                     // previous tile fully consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i - c * HD;
      const int s = k0 + c;
      const size_t off = (((size_t)b * Sk + s) * KVH + kvh) * HD + d;
      Ks[c * LD + d] = s < Sk ? to_f(k[off]) : 0.f;
      Vs[c * LD + d] = s < Sk ? to_f(v[off]) : 0.f;
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

  if (qpos < Sq) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    T* orow = out + (((size_t)b * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i) from_f(acc[i] * inv, orow + sub + 4 * i);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KVH, int causal, int window,
           float soft_cap, cudaStream_t s) {
  constexpr int LD = HD + 1;
  const size_t smem = sizeof(float) * ((kBQ + 2 * kBK) * LD + kBQ * (kBK + 1));
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KVH, causal,
      window, soft_cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int H, int KVH, int causal, int window,
                float soft_cap, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, soft_cap, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, soft_cap, s);
    case 48: return launch<T, 48>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, soft_cap, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, soft_cap, s);
    case 96: return launch<T, 96>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, soft_cap, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, soft_cap, s);
    case 256: return launch<T, 256>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, soft_cap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int KVH, int hd,
                                      int causal, int window, int dtype,
                                      float soft_cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, B, Sq, Sk, H, KVH, causal,
                              window, soft_cap, s);
  return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Sk, H, KVH,
                                    causal, window, soft_cap, s);
}
