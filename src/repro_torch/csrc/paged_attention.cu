// Paged decode attention with exact per-page heat, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_class_partials` / `_kernel` in
// src/repro/kernels/paged_attention/kernel.py, the multi-class combine of
// src/repro/kernels/paged_attention/ops.py (`paged_decode_attention`, which
// merges the classes with ref.combine_partials_ref), and the jnp gather path
// the reference engine runs (src/repro/models/decode.py,
// paged_decode_attention_gather).
//
// What bounds it on the H100: bytes.  A decode step reads every valid K and
// V row of every sequence once (B * len * KVH * hd * 2 values) and does two
// multiply-adds per value read, far below the ~295 operations per byte the
// tensor cores need to be the limit.  No tensor cores here: deepseek-7b is
// MHA (G = 1), one query row per kv head, which gives a 64-row wgmma nothing
// to do.  The lever is loads in flight, so the design spreads them:
//
// Pass 1, paged_split_kernel, grid (splits, KVH, B).  Each block owns a
//   fixed, contiguous range of page slots of one (sequence, kv head); the
//   wrapper sizes the ranges from MP, B * KVH and the SM count alone (no
//   host sync), aiming at two to four blocks per SM.  Inside a block each
//   warp owns whole pages: the lanes split a token's head_dim into 16-byte
//   chunks and a warp reads up to 8 tokens per lane (16 K and V vectors per
//   lane in flight) before it computes.  A page's own (m_page, l_page) per
//   query head stays in the warp's registers until it is written once; the
//   warp keeps its running (acc, m, l) per query head (acc sized by the
//   template head-group GP, never runtime-indexed) and the block merges its
//   warps once, in shared memory, at the end.  A block whose pages hold no
//   valid token writes m = -inf, l = 0 and exits.
// Pass 2, paged_combine_kernel, grid (H / 2, B).  Merges the splits of each
//   (b, h) as combine_partials_ref does, writes out in q's dtype, and writes
//   the exact heat
//       heat[b, page] = sum_h l_page * exp(m_page - m[b, h]) / l[b, h],
//   summed over the heads inside the kernel in a fixed order: deterministic,
//   no atomics.  A row with nothing valid gets out = 0 and heat 0.
// A size class of 4^c-block pages is one more set of splits for pass 2, so
// a multi-class call is one split launch per class and one combine.
// Pass 2 in its LOCAL mode (paged_local_combine_launch) serves the sharded
// flash-decoding of src/repro/distributed/flashdecode.py, whose per-shard
// body (`_partials`) is this kernel's computation over the shard's own
// blocks.  It normalises nothing: it writes the row's max m and the sum l
// against it, acc = sum_s acc_s * exp(m_s - m) in float32, and the heat
//       heat[b, page] = sum_h l_page * exp(m_page - m[b, h]),
// against each head's local max, with no division by l; the ranks merge
// (m, l, acc) with one all-reduce MAX and two SUMs.  A row with nothing
// valid writes m = -1e30 (the reference's NEG_INF), l = acc = heat = 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

#define NEG_INF (-CUDART_INF_F)

template <typename T> __device__ __forceinline__ void unpack16(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float store_f(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 store_f(float x, __nv_bfloat16*) {
  return __float2bfloat16(x);
}

// 16-byte chunk c of a row of hd elements.  VEC: the row is a whole number
// of 16-byte chunks (hd % (16 / sizeof(T)) == 0) and one vector load reads
// it; otherwise (phi-3-smoke's bf16 hd 12: 24-byte rows, not 16-byte
// aligned) the chunk is read element by element and zero-filled past hd, so
// the persistent pools are read in place, never copied to a padded width.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* row, int c, int hd) {
  constexpr int VE = 16 / sizeof(T);
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(row + c * VE));
  } else {
    using W = typename std::conditional<sizeof(T) == 2, unsigned short,
                                        unsigned int>::type;
    const W* src = reinterpret_cast<const W*>(row) + c * VE;
    alignas(16) W w[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e)
      w[e] = c * VE + e < hd ? __ldg(src + e) : W(0);
    return *reinterpret_cast<const uint4*>(w);
  }
}

// exp(a - b) where a may be -inf (-> 0); b is finite or -inf only with a
__device__ __forceinline__ float exp_diff(float a, float b) {
  return a == NEG_INF ? 0.f : __expf(a - b);
}

// T: element type; GP: query heads per kv head, rounded up to 1, 2, 4 or 8;
// CPL: 16-byte chunks per lane (2 only for float32 rows wider than 128);
// VEC: rows are whole 16-byte chunks (load_chunk).
template <typename T, int GP, int CPL, bool VEC>
__global__ void __launch_bounds__(128)
paged_split_kernel(const T* __restrict__ q,         // [B, H, hd]
                   const T* __restrict__ pool_k,    // [NB, bt, KVH, hd]
                   const T* __restrict__ pool_v,
                   const int* __restrict__ table,   // [B, MP] start block
                   const int* __restrict__ logical, // [B, MP] or null
                   const int* __restrict__ lengths, // [B]
                   float* __restrict__ acc_part,    // [B, H, NS, hd]
                   float* __restrict__ ml_part,     // [2, B, H, NS]
                   float* __restrict__ page_ml,     // [2, B, H, NP]
                   int B, int H, int KVH, int hd, int MP, int pps,
                   int page_blocks, int bt, int window, float soft_cap,
                   int NS, int s0, int NP, int p0) {
  constexpr int VE = 16 / sizeof(T);           // elements per 16-byte chunk
  constexpr int DPL = CPL * VE;                // head dims per lane
  constexpr int U = (GP <= 2 ? 8 : GP == 4 ? 4 : 2) / CPL;  // tokens per lane
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH, hbase = kvh * G;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pt = page_blocks * bt;
  const int len = lengths[b];
  const int lo = window >= 0 ? len - window : 0;   // first valid position
  const int j0 = split * pps, j1 = min(MP, j0 + pps);
  const int CH = (hd + VE - 1) / VE;               // chunks per row
  int lpt = 1;                                     // lanes per token
  while (lpt < CH && lpt < 32) lpt <<= 1;
  const int tpp = 32 / lpt;                        // tokens per pass
  const int cl = lane & (lpt - 1), tl = lane / lpt;
  const float scale = rsqrtf((float)hd);
  const size_t tok_stride = (size_t)KVH * hd;
  const size_t pml = (size_t)B * H * NP;           // page_ml: m then l
  const size_t sml = (size_t)B * H * NS;           // ml_part: m then l
  const int sidx = s0 + split;

  // valid token range [tb, te) of page slot j
  auto page_range = [&](int j, int& start, int& tb, int& te) {
    start = table[b * MP + j];
    int lg = logical ? logical[b * MP + j] : j;
    lg = max(lg, 0);
    const int pos0 = lg * pt;
    tb = max(0, lo - pos0);
    te = start < 0 ? 0 : min(pt, len - pos0);
  };

  float qv[GP][DPL];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = cl + 32 * i;
      float f[VE];
      if (g < G && c < CH) {
        const uint4 u =
            load_chunk<T, VEC>(q + ((size_t)b * H + hbase + g) * hd, c, hd);
        unpack16<T>(u, f);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) qv[g][i * VE + e] = f[e];
    }

  // every warp finds out alone whether the split holds a valid token: no
  // block barrier before the K/V loads
  bool any = false;
  for (int j = j0 + lane; j < j1; j += 32) {
    int start, tb, te;
    page_range(j, start, tb, te);
    any = any || te > tb;
  }
  if (!__any_sync(0xffffffffu, any)) {
    for (int i = threadIdx.x; i < G * (j1 - j0); i += blockDim.x) {
      const int g = i / (j1 - j0), j = j0 + i % (j1 - j0);
      const size_t o = ((size_t)b * H + hbase + g) * NP + p0 + j;
      page_ml[o] = NEG_INF;
      page_ml[pml + o] = 0.f;
    }
    if ((int)threadIdx.x < G) {
      const size_t o = ((size_t)b * H + hbase + threadIdx.x) * NS + sidx;
      ml_part[o] = NEG_INF;
      ml_part[sml + o] = 0.f;
    }
    return;
  }

  float m_w[GP], l_w[GP], acc[GP][DPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m_w[g] = NEG_INF;
    l_w[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;
  }

  for (int j = j0 + warp; j < j1; j += nw) {
    int start, tb, te;
    page_range(j, start, tb, te);
    float mp[GP], lp[GP];                        // this page's own max / sum
#pragma unroll
    for (int g = 0; g < GP; ++g) { mp[g] = NEG_INF; lp[g] = 0.f; }
    const size_t page_row = (size_t)max(start, 0) * bt;
    for (int t0 = tb; t0 < te; t0 += tpp * U) {
      uint4 kr[U][CPL], vr[U][CPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * tpp + tl;
        const size_t row = (page_row + t) * tok_stride + (size_t)kvh * hd;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = cl + 32 * i;
          if (t < te && c < CH) {
            kr[u][i] = load_chunk<T, VEC>(pool_k + row, c, hd);
            vr[u][i] = load_chunk<T, VEC>(pool_v + row, c, hd);
          } else {
            kr[u][i] = make_uint4(0, 0, 0, 0);
            vr[u][i] = make_uint4(0, 0, 0, 0);
          }
        }
      }
      // scores: partial dots over this lane's dims, summed over the lpt
      // lanes of a token
      float s[GP][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[DPL];
#pragma unroll
        for (int i = 0; i < CPL; ++i) unpack16<T>(kr[u][i], kf + i * VE);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float a = 0.f;
#pragma unroll
          for (int d = 0; d < DPL; ++d) a = fmaf(qv[g][d], kf[d], a);
          s[g][u] = a;
        }
      }
      for (int o = 1; o < lpt; o <<= 1)
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int u = 0; u < U; ++u)
            s[g][u] += __shfl_xor_sync(0xffffffffu, s[g][u], o);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool ok = t0 + u * tpp + tl < te;
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float x = s[g][u] * scale;
          if (soft_cap > 0.f) x = soft_cap * tanhf(x / soft_cap);
          s[g][u] = ok ? x : NEG_INF;
        }
      }
      // online softmax: the page's own (mp, lp) and the warp's (m, l, acc);
      // token t0 is valid, so every batch max is finite
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float cm = s[g][0];
#pragma unroll
        for (int u = 1; u < U; ++u) cm = fmaxf(cm, s[g][u]);
        for (int o = lpt; o < 32; o <<= 1)
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
        const float mp_new = fmaxf(mp[g], cm);
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[g][u] = exp_diff(s[g][u], mp_new);   // p relative to the page max
          ps += s[g][u];
        }
        for (int o = lpt; o < 32; o <<= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, o);
        lp[g] = lp[g] * exp_diff(mp[g], mp_new) + ps;
        mp[g] = mp_new;
        const float m_new = fmaxf(m_w[g], mp_new);
        const float corr = exp_diff(m_w[g], m_new);
        const float f = __expf(mp_new - m_new);
        l_w[g] = l_w[g] * corr + ps * f;
        m_w[g] = m_new;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[g][d] *= corr;
#pragma unroll
        for (int u = 0; u < U; ++u) s[g][u] *= f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[DPL];
#pragma unroll
        for (int i = 0; i < CPL; ++i) unpack16<T>(vr[u][i], vf + i * VE);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[g][d] = fmaf(s[g][u], vf[d], acc[g][d]);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GP; ++g)
        if (g < G) {
          const size_t o = ((size_t)b * H + hbase + g) * NP + p0 + j;
          page_ml[o] = mp[g];
          page_ml[pml + o] = lp[g];
        }
    }
  }

  // the lanes of one chunk column hold other tokens' shares of its dims
  for (int o = lpt; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        acc[g][d] += __shfl_xor_sync(0xffffffffu, acc[g][d], o);

  // merge the warps once: [nw][GP] m, [nw][GP] l, [nw][G][hd] acc
  extern __shared__ float sm[];
  float* sm_m = sm;
  float* sm_l = sm + nw * GP;
  float* sm_acc = sm + 2 * nw * GP;
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      sm_m[warp * GP + g] = m_w[g];
      sm_l[warp * GP + g] = l_w[g];
    }
  }
  if (tl == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = cl + 32 * i;
        if (g < G && c < CH) {
#pragma unroll
          for (int e = 0; e < VE; ++e)
            if (c * VE + e < hd)
              sm_acc[((size_t)warp * G + g) * hd + c * VE + e] = acc[g][i * VE + e];
        }
      }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < G * hd; x += blockDim.x) {
    const int g = x / hd, d = x - g * hd;
    float M = NEG_INF;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, sm_m[w * GP + g]);
    float a = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float mw = sm_m[w * GP + g];
      if (mw != NEG_INF) a += sm_acc[((size_t)w * G + g) * hd + d] * __expf(mw - M);
    }
    acc_part[(((size_t)b * H + hbase + g) * NS + sidx) * hd + d] = a;
  }
  if ((int)threadIdx.x < G) {
    const int g = threadIdx.x;
    float M = NEG_INF;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, sm_m[w * GP + g]);
    float L = 0.f;
    for (int w = 0; w < nw; ++w) L += sm_l[w * GP + g] * exp_diff(sm_m[w * GP + g], M);
    const size_t o = ((size_t)b * H + hbase + g) * NS + sidx;
    ml_part[o] = M;
    ml_part[sml + o] = L;
  }
}

// Block (c, b) merges heads [c * hpc, (c + 1) * hpc) of row b and writes the
// heat of page slots c, c + C, c + 2C, ...  Every load of a phase is issued
// at once (no loop carries a load), so the block waits a few round trips.
// LOCAL: write unnormalised acc (T = float) and the heads' (m, l) to ml_out
// ([2, B, H]: m then l), and the heat with no division by l.
template <typename T, bool LOCAL>
__global__ void __launch_bounds__(256)
paged_combine_kernel(const float* __restrict__ acc_part,  // [B, H, NS, hd]
                     const float* __restrict__ ml_part,   // [2, B, H, NS]
                     const float* __restrict__ page_ml,   // [2, B, H, NP]
                     T* __restrict__ out,                 // [B, H, hd]
                     float* __restrict__ heat,            // [B, NP]
                     float* __restrict__ ml_out,          // LOCAL: [2, B, H]
                     int B, int H, int hd, int NS, int NP, int hpc) {
  const int c = blockIdx.x, b = blockIdx.y, C = gridDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nw = blockDim.x >> 5;
  const int h0 = c * hpc;
  extern __shared__ float sm[];
  float* s_m = sm;                 // [H * NS] every split's max of row b
  float* s_l = s_m + H * NS;       // [H * NS] and its sum
  float* sM = s_l + H * NS;        // [H] row max over the splits
  float* sL = sM + H;              // [H] row sum
  float* sf = sL + H;              // [hpc * NS] weight of each split
  const size_t row = (size_t)b * H * NS;
  for (int i = tid; i < H * NS; i += blockDim.x) {
    s_m[i] = ml_part[row + i];
    s_l[i] = ml_part[(size_t)B * H * NS + row + i];
  }
  __syncthreads();
  for (int hh = warp; hh < H; hh += nw) {       // a warp per head
    float M = NEG_INF;
    for (int s = lane; s < NS; s += 32) M = fmaxf(M, s_m[hh * NS + s]);
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f;
    for (int s = lane; s < NS; s += 32)
      L += s_l[hh * NS + s] * exp_diff(s_m[hh * NS + s], M);
    for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    if (lane == 0) {
      sM[hh] = M;
      sL[hh] = L;
      if (LOCAL && hh >= h0 && hh < h0 + hpc) {
        ml_out[(size_t)b * H + hh] = M == NEG_INF ? -1e30f : M;
        ml_out[(size_t)B * H + (size_t)b * H + hh] = L;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < hpc * NS; i += blockDim.x) {
    const int h = h0 + i / NS;
    const float w = h < H ? exp_diff(s_m[h * NS + i % NS], sM[h]) : 0.f;
    sf[i] = LOCAL ? w : w / fmaxf(h < H ? sL[h] : 1.f, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < hpc * hd; i += blockDim.x) {
    const int hl = i / hd, h = h0 + hl, d = i - hl * hd;
    if (h >= H) break;
    const float* ar = acc_part + (((size_t)b * H + h) * NS) * hd + d;
    const float* f = sf + hl * NS;
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < NS; ++s) {
      const float a = ar[(size_t)s * hd];         // empty splits hold no acc:
      o += f[s] != 0.f ? a * f[s] : 0.f;          // select, never 0 * junk
    }
    T* dst = out + ((size_t)b * H + h) * hd + d;
    *dst = store_f(o, dst);
  }
  // heat: a warp per page slot, lanes over the heads, a fixed-order sum
  const float* pm = page_ml + (size_t)b * H * NP;
  const float* pl = page_ml + (size_t)B * H * NP + (size_t)b * H * NP;
  for (int p = c + warp * C; p < NP; p += nw * C) {
    float sum = 0.f;
    for (int hh = lane; hh < H; hh += 32) {
      const size_t o = (size_t)hh * NP + p;
      if (LOCAL)
        sum += pl[o] * exp_diff(pm[o], sM[hh]);
      else if (sL[hh] > 0.f)
        sum += pl[o] * exp_diff(pm[o], sM[hh]) / sL[hh];
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) heat[(size_t)b * NP + p] = sum;
  }
}

template <typename T, int GP, int CPL, bool VEC>
int launch_split(const void* q, const void* pool_k, const void* pool_v,
                 const int* table, const int* logical, const int* lengths,
                 float* acc_part, float* ml_part, float* page_ml, int B, int H,
                 int KVH, int hd, int MP, int pps, int page_blocks, int bt,
                 int window, float soft_cap, int NS, int s0, int NP, int p0,
                 cudaStream_t s) {
  const int splits = (MP + pps - 1) / pps;
  const int warps = min(pps, 4);
  const int G = H / KVH;
  const size_t smem = sizeof(float) * (2 * warps * GP + (size_t)warps * G * hd);
  dim3 grid(splits, KVH, B);
  paged_split_kernel<T, GP, CPL, VEC><<<grid, 32 * warps, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), table, logical, lengths, acc_part,
      ml_part, page_ml, B, H, KVH, hd, MP, pps, page_blocks, bt, window,
      soft_cap, NS, s0, NP, p0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CPL, bool VEC>
int dispatch_g(int G, const void* q, const void* pool_k, const void* pool_v,
               const int* table, const int* logical, const int* lengths,
               float* acc_part, float* ml_part, float* page_ml, int B, int H,
               int KVH, int hd, int MP, int pps, int page_blocks, int bt,
               int window, float soft_cap, int NS, int s0, int NP, int p0,
               cudaStream_t s) {
#define PAGED_SPLIT(GP)                                                      \
  launch_split<T, GP, CPL, VEC>(q, pool_k, pool_v, table, logical, lengths,       \
                           acc_part, ml_part, page_ml, B, H, KVH, hd, MP,    \
                           pps, page_blocks, bt, window, soft_cap, NS, s0,   \
                           NP, p0, s)
  if (G <= 1) return PAGED_SPLIT(1);
  if (G <= 2) return PAGED_SPLIT(2);
  if (G <= 4) return PAGED_SPLIT(4);
  if (G <= 8) return PAGED_SPLIT(8);
#undef PAGED_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool LOCAL>
int launch_combine(const float* acc_part, const float* ml_part,
                   const float* page_ml, void* out, float* heat,
                   float* ml_out, int B, int H, int hd, int NS, int NP,
                   cudaStream_t s) {
  const int hpc = 2;                                 // heads per block
  const int smem = (int)sizeof(float) * (2 * H * NS + 2 * H + hpc * NS);
  dim3 grid((H + hpc - 1) / hpc, B);
  auto kern = paged_combine_kernel<T, LOCAL>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<grid, 256, smem, s>>>(acc_part, ml_part, page_ml,
                               static_cast<T*>(out), heat, ml_out, B, H, hd,
                               NS, NP, hpc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One page-size class: partials of splits [s0, s0 + ceil(MP / pps)) and the
// page statistics of slots [p0, p0 + MP) of the call's NS splits / NP slots.
extern "C" int paged_split_launch(
    const void* q, const void* pool_k, const void* pool_v, const int* table,
    const int* logical, const int* lengths, float* acc_part, float* ml_part,
    float* page_ml, int B, int H, int KVH, int hd, int MP, int pps,
    int page_blocks, int bt, int window, int dtype, float soft_cap, int NS,
    int s0, int NP, int p0, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KVH;
#define PAGED_G(T, CPL, VEC)                                                  \
  dispatch_g<T, CPL, VEC>(G, q, pool_k, pool_v, table, logical, lengths,      \
                          acc_part, ml_part, page_ml, B, H, KVH, hd, MP, pps, \
                          page_blocks, bt, window, soft_cap, NS, s0, NP, p0,  \
                          s)
  if (hd <= 0 || hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (hd > 128)   // two chunks a lane: whole 16-byte rows only
      return hd % 4 == 0 ? PAGED_G(float, 2, true)
                         : static_cast<int>(cudaErrorInvalidValue);
    return hd % 4 == 0 ? PAGED_G(float, 1, true) : PAGED_G(float, 1, false);
  }
  return hd % 8 == 0 ? PAGED_G(__nv_bfloat16, 1, true)
                     : PAGED_G(__nv_bfloat16, 1, false);
#undef PAGED_G
}

// Merge the NS splits of every (b, h) into out (q's dtype) and heat [B, NP].
extern "C" int paged_combine_launch(const float* acc_part, const float* ml_part,
                                    const float* page_ml, void* out,
                                    float* heat, int B, int H, int hd, int NS,
                                    int NP, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_combine<float, false>(acc_part, ml_part, page_ml, out, heat,
                                        nullptr, B, H, hd, NS, NP, s);
  return launch_combine<__nv_bfloat16, false>(acc_part, ml_part, page_ml, out,
                                              heat, nullptr, B, H, hd, NS, NP,
                                              s);
}

// A shard's partials, unnormalised: acc [B, H, hd] float32, (m, l) as
// ml_out [2, B, H], and heat [B, NP] against each head's local max.
extern "C" int paged_local_combine_launch(const float* acc_part,
                                          const float* ml_part,
                                          const float* page_ml, float* acc,
                                          float* ml_out, float* heat, int B,
                                          int H, int hd, int NS, int NP,
                                          void* stream) {
  return launch_combine<float, true>(acc_part, ml_part, page_ml, acc, heat,
                                     ml_out, B, H, hd, NS, NP,
                                     static_cast<cudaStream_t>(stream));
}
