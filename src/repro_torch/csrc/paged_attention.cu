// Paged decode attention with exact per-page heat, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_class_partials` / `_kernel` in
// src/repro/kernels/paged_attention/kernel.py and the jnp gather path the
// reference engine runs (src/repro/models/decode.py,
// paged_decode_attention_gather).
//
// What bounds it on the H100: bytes.  A decode step reads every valid K and
// V row of every sequence once (B * len * KVH * hd * 2 values) and does two
// multiply-adds per value read, far below the ~295 operations per byte the
// tensor cores need to be the limit.  The design therefore aims at reading
// each KV byte once, coalesced: one block per (kv head, sequence) walks that
// sequence's pages in chunks of 64 tokens; a warp reads one token's head_dim
// contiguous values for q.k, and the P.V pass reads V rows with neighbouring
// threads on neighbouring dims.  The G query heads that share a kv head
// (GQA) reuse each K/V value from registers.  Tokens past the sequence's
// length or outside the window are never read.  The softmax is online
// (running max m, sum l, accumulator), so nothing but the output leaves the
// block.  Simple first: no TMA, no tensor cores (the q.k work per value is
// one multiply-add per query head; wgmma would need 64 query rows).
//
// Heat: the TPU kernel carried (m, l, acc) along a sequential grid axis and
// normalised each page's mass by the running max at visit time.  Here the
// block keeps each page's own (m_page, l_page) per query head in a scratch
// buffer and, after the walk, writes the exact softmax mass of each page:
//     heat[b, kvh, page] = sum_g l_page[g] * exp(m_page[g] - m[g]) / l[g]
// The wrapper sums over kv heads: deterministic, no atomics.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;          // tokens scored per step
constexpr int kMaxG = 8;            // query heads per kv head
constexpr int kMaxDPerThread = 2;   // head_dim <= 256

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,        // [B, H, hd]
                    const T* __restrict__ pool_k,   // [NB, bt, KVH, hd]
                    const T* __restrict__ pool_v,
                    const int* __restrict__ table,  // [B, MP] start block
                    const int* __restrict__ logical,  // [B, MP] or null
                    const int* __restrict__ lengths,  // [B]
                    float* __restrict__ out,        // [B, H, hd]
                    float* __restrict__ heat_part,  // [B, KVH, MP]
                    float* __restrict__ scratch,    // [2, B, KVH, MP, G]
                    int B, int H, int KVH, int hd, int MP, int page_blocks,
                    int bt, int window, float soft_cap) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pt = page_blocks * bt;
  const float scale = rsqrtf((float)hd);
  const int len = lengths[b];
  const int lo = window >= 0 ? len - window : 0;   // first valid position
  const size_t tok_stride = (size_t)KVH * hd;      // one token's row

  __shared__ float qs[kMaxG][256];
  __shared__ float ps[kMaxG][kChunk];
  __shared__ int tok_s[kChunk];      // pool row (block * bt + offset) per token
  // per query head: running max / sum over the whole row, the rescale factor
  // of the current chunk, and the current page's own max / sum
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];
  __shared__ float mpg_s[kMaxG], lpg_s[kMaxG];

  for (int i = tid; i < G * hd; i += kThreads) {
    int g = i / hd, d = i - g * hd;
    qs[g][d] = to_f(q[((size_t)b * H + kvh * G + g) * hd + d]);
  }
  if (tid < G) { m_s[tid] = -CUDART_INF_F; l_s[tid] = 0.f; }
  float acc[kMaxG][kMaxDPerThread];
  for (int g = 0; g < kMaxG; ++g)
    for (int i = 0; i < kMaxDPerThread; ++i) acc[g][i] = 0.f;
  float* m_pg_out = scratch;
  float* l_pg_out = scratch + (size_t)B * KVH * MP * G;

  for (int j = 0; j < MP; ++j) {
    const int start = table[b * MP + j];
    const int lg = logical ? logical[b * MP + j] : j;
    const int pos0 = lg * pt;
    if (tid < G) { mpg_s[tid] = -CUDART_INF_F; lpg_s[tid] = 0.f; }
    // valid tokens of this page: positions [max(pos0, lo), min(pos0+pt, len))
    const int t_begin = start < 0 ? pt : max(0, lo - pos0);
    const int t_end = start < 0 ? 0 : min(pt, len - pos0);
    for (int c0 = t_begin; c0 < t_end; c0 += kChunk) {
      const int n = min(kChunk, t_end - c0);
      if (tid < n) {
        int t = c0 + tid;
        tok_s[tid] = (start + t / bt) * bt + t % bt;
      }
      __syncthreads();
      // scores: one warp per token, lanes over head_dim
      for (int c = warp; c < n; c += kWarps) {
        const T* krow = pool_k + (size_t)tok_s[c] * tok_stride + (size_t)kvh * hd;
        float kv[8];
        int nd = 0;
        for (int d = lane; d < hd; d += 32) kv[nd++] = to_f(krow[d]);
        for (int g = 0; g < G; ++g) {
          float s = 0.f;
          int k = 0;
          for (int d = lane; d < hd; d += 32) s += qs[g][d] * kv[k++];
          s = warp_sum(s) * scale;
          if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
          if (lane == 0) ps[g][c] = s;
        }
      }
      __syncthreads();
      // online softmax update; warp w owns heads w, w + 4, ...
      for (int g = warp; g < G; g += kWarps) {
        const float m_old = m_s[g], mp_old = mpg_s[g];
        const float s0 = lane < n ? ps[g][lane] : -CUDART_INF_F;
        const float s1 = lane + 32 < n ? ps[g][lane + 32] : -CUDART_INF_F;
        const float mc = warp_max(fmaxf(s0, s1));
        const float m_new = fmaxf(m_old, mc);
        const float p0 = lane < n ? __expf(s0 - m_new) : 0.f;
        const float p1 = lane + 32 < n ? __expf(s1 - m_new) : 0.f;
        const float psum = warp_sum(p0 + p1);
        const float mp_new = fmaxf(mp_old, mc);
        const float qsum = warp_sum((lane < n ? __expf(s0 - mp_new) : 0.f) +
                                    (lane + 32 < n ? __expf(s1 - mp_new) : 0.f));
        __syncwarp();
        if (lane < n) ps[g][lane] = p0;
        if (lane + 32 < n) ps[g][lane + 32] = p1;
        if (lane == 0) {
          const float corr = m_old == -CUDART_INF_F ? 0.f : __expf(m_old - m_new);
          const float cp = mp_old == -CUDART_INF_F ? 0.f : __expf(mp_old - mp_new);
          corr_s[g] = corr;
          m_s[g] = m_new;
          l_s[g] = l_s[g] * corr + psum;
          mpg_s[g] = mp_new;
          lpg_s[g] = lpg_s[g] * cp + qsum;
        }
      }
      __syncthreads();
      // every thread: rescale its accumulator dims and add P.V
      for (int g = 0; g < G; ++g) {
        const float corr = corr_s[g];
        for (int i = 0; i < kMaxDPerThread; ++i) acc[g][i] *= corr;
      }
      for (int c = 0; c < n; ++c) {
        const T* vrow = pool_v + (size_t)tok_s[c] * tok_stride + (size_t)kvh * hd;
        for (int i = 0; i < kMaxDPerThread; ++i) {
          const int d = tid + i * kThreads;
          if (d < hd) {
            const float vv = to_f(vrow[d]);
            for (int g = 0; g < G; ++g) acc[g][i] += ps[g][c] * vv;
          }
        }
      }
      __syncthreads();
    }
    __syncthreads();
    if (tid < G) {
      const size_t o = (((size_t)b * KVH + kvh) * MP + j) * G + tid;
      m_pg_out[o] = mpg_s[tid];
      l_pg_out[o] = lpg_s[tid];
    }
  }
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    const float inv = 1.f / fmaxf(l_s[g], 1e-30f);
    for (int i = 0; i < kMaxDPerThread; ++i) {
      const int d = tid + i * kThreads;
      if (d < hd) out[((size_t)b * H + kvh * G + g) * hd + d] = acc[g][i] * inv;
    }
  }
  for (int j = tid; j < MP; j += kThreads) {
    float h = 0.f;
    for (int g = 0; g < G; ++g) {
      const size_t o = (((size_t)b * KVH + kvh) * MP + j) * G + g;
      const float mp = m_pg_out[o];
      if (l_s[g] > 0.f && mp != -CUDART_INF_F)
        h += l_pg_out[o] * __expf(mp - m_s[g]) / l_s[g];
    }
    heat_part[((size_t)b * KVH + kvh) * MP + j] = h;
  }
}

}  // namespace

extern "C" int paged_decode_launch(
    const void* q, const void* pool_k, const void* pool_v, const int* table,
    const int* logical, const int* lengths, float* out, float* heat_part,
    float* scratch, int B, int H, int KVH, int hd, int MP, int page_blocks,
    int bt, int window, int dtype, float soft_cap, void* stream) {
  dim3 grid(KVH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    paged_decode_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(pool_k),
        static_cast<const float*>(pool_v), table, logical, lengths, out,
        heat_part, scratch, B, H, KVH, hd, MP, page_blocks, bt, window, soft_cap);
  } else {
    paged_decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(pool_k),
        static_cast<const __nv_bfloat16*>(pool_v), table, logical, lengths, out,
        heat_part, scratch, B, H, KVH, hd, MP, page_blocks, bt, window, soft_cap);
  }
  return static_cast<int>(cudaGetLastError());
}
