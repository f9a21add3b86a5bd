// Paged MLA (latent) decode attention with exact per-block heat, for NVIDIA
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes MLA's absorbed decode in
// jnp over a gather of every block of the table (src/repro/models/decode.py,
// paged_decode_attention_mla_gather), and the port did the same in torch
// ops.  At a served batch of long contexts that gather is the larger part of
// a decode step: it copies all `max_blocks` blocks of every row, valid or
// not, and converts them to float32, layer by layer.
//
// What it computes, per sequence b and query head h (16 heads share every
// latent row, MQA-like): scores s_t = scale * (q_eff[b, h] . c_t +
// q_rope[b, h] . k_rope_t) over the row's valid latents [c_t | k_rope_t]
// (pool_ckv [NB, bt, L + R], read through the block table), then o_lat[b, h]
// = softmax(s) . c (the latents' first L channels), and the heat
// heat[b, block] = sum_h sum_{t in block} p[h, t], the exact softmax mass
// per block that DAMON reads (what the gather path emits).
//
// What bounds it on the H100: bytes.  Each valid latent (1,152 bytes at L
// 512, R 64) is read once and meets 16 heads x (576 + 512) multiply-adds:
// ~30 operations per byte, an order of magnitude under the tensor cores'
// ridge, but above what the CUDA cores give (67 TFLOP/s in float32).  So the
// products run on the tensor cores (mma.sync m16n8k16, bf16 in, float32
// sums), the 16 heads filling the 16 rows of an mma tile, and the design
// keeps the latents' reads in flight:
//
// Pass 1, mla_decode_split_kernel, grid (splits, B), 4 consumer warps and a
//   producer warp that only issues copies.  A block owns a contiguous range
//   of table slots of one sequence (sized by the wrapper from B, the table
//   width and the SM count alone: no host sync) and walks it in tiles of 64
//   tokens, two tiles in shared memory: the next one's copies (a bulk copy
//   a latent row, completing on the stage's mbarrier) run under this one's
//   products (rows past the length, or in unmapped blocks, are not copied,
//   and masked).  q is split into two bf16 parts (q = hi + lo, so the
//   scores keep ~16 bits of q's float32 mantissa) and each consumer holds
//   the mma fragments of a quarter of the contraction (k-steps) in
//   registers for the whole block: per tile it multiplies all 64 tokens
//   over its quarter (eight independent chains of products, and no reads of
//   q from shared memory), the four partial score tiles meet in shared
//   memory, and each consumer sums the partials of its 16 tokens in a fixed
//   order.  Each block slot's mass per head is kept for the heat (its
//   tokens' p summed against the tile's running max); the tile's P is
//   shared through shared memory in bf16, and each consumer accumulates its
//   quarter of the L output channels (float32 sums in registers) against
//   the same tile.  The block writes its (m, l, acc) per head.
// Pass 2, mla_decode_combine_kernel, grid (H, B).  Merges the splits of
//   each (b, h), writes o_lat in float32, and the heat
//       heat[b, blk] = sum_h l_blk * exp(m_blk - m[b, h]) / l[b, h],
//   summed over the heads in a fixed order: deterministic, no atomics.  A
//   row with nothing valid gets o_lat = 0 and heat 0.
// A float32 pool (a float32 model on the card, as the precision checks run
// it) takes mla_decode_split_f32_kernel for pass 1 instead: the same grid
// and partials, scalar float32 products, one table slot at a time.

#include "hopper_mma.cuh"

#include <math_constants.h>

namespace {

constexpr int kTile = 64;        // tokens per shared-memory tile
constexpr int kWarps = 4;        // consumer warps (and one producer)
constexpr int kThreads = 32 * (kWarps + 1);
constexpr int kCWarps = 4;       // the combine's warps
constexpr int kCThreads = 32 * kCWarps;
constexpr int kF32Threads = 256; // the float32 split pass's threads
constexpr int kHeads = 16;       // mma rows: the query heads, zero-padded
constexpr int kPS = kTile + 8;   // row stride of the shared P tile
constexpr int kSS = kTile + 4;   // row stride of the partial scores
constexpr int kKQ = 9;           // k-steps a warp holds: q up to 576 wide

#define MLA_NEG_INF (-CUDART_INF_F)

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// mbarriers and bulk (TMA) copies: a stage buffer's barrier expects the
// bytes of its tile's rows, each row one bulk copy that completes them
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a barrier of the consumer warps alone (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(32 * kWarps) : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col): bf16 in, float32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// exp(a - b) where a may be -inf (-> 0); b is finite or -inf only with a
__device__ __forceinline__ float exp_diff(float a, float b) {
  return a == MLA_NEG_INF ? 0.f : __expf(a - b);
}

// NV: 8-channel output tiles per warp (kv_lora = 32 * NV).
template <int NV>
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_split_kernel(const float* __restrict__ q,       // [B, H, D] f32
                        const bf16* __restrict__ pool,     // [NB, bt, D]
                        const int* __restrict__ table,     // [B, MB]
                        const int* __restrict__ lengths,   // [B]
                        float* __restrict__ acc_part,      // [B, H, NS, L]
                        float* __restrict__ ml_part,       // [2, B, H, NS]
                        float* __restrict__ page_ml,       // [2, B, H, MB]
                        int B, int H, int D, int DP, int MB, int bt, int pps,
                        int NS, float scale) {
  constexpr int L = 32 * NV;
  const int RS = DP + 8;               // row stride (elements) of a KV tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sKV = reinterpret_cast<bf16*>(smem_raw);     // [2][kTile][RS]
  float* sS = reinterpret_cast<float*>(sKV + 2 * kTile * RS);
                                                     // [4][16][kSS] partial S
  bf16* sP = reinterpret_cast<bf16*>(sS + kWarps * kHeads * kSS);
                                                     // [16][kPS]
  float* red_m = reinterpret_cast<float*>(sP + kHeads * kPS);  // [4][16]
  float* red_l = red_m + kWarps * kHeads;                      // [4][16]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int s = blockIdx.x, b = blockIdx.y;
  const int len = lengths[b];
  const int* trow = table + (size_t)b * MB;
  const int j0 = s * pps, j1 = min(MB, j0 + pps);
  const int jend = min(j1, (len + bt - 1) / bt);   // slots that hold a token
  const int ppt = kTile / bt;                      // slots per tile
  const int ntiles = jend > j0 ? (jend - j0 + ppt - 1) / ppt : 0;
  const int jt = min(j1, j0 + ntiles * ppt);       // slots the tiles cover
  const size_t pml = (size_t)B * H * MB;
  const size_t sml = (size_t)B * H * NS;

  // slots past the last tile hold nothing: (m, l) = (-inf, 0)
  for (int i = tid; i < H * (j1 - jt); i += kThreads) {
    const int h = i / (j1 - jt), j = jt + i % (j1 - jt);
    const size_t o = ((size_t)b * H + h) * MB + j;
    page_ml[o] = MLA_NEG_INF;
    page_ml[pml + o] = 0.f;
  }
  if (ntiles == 0) {
    if (tid < H) {
      const size_t o = ((size_t)b * H + tid) * NS + s;
      ml_part[o] = MLA_NEG_INF;
      ml_part[sml + o] = 0.f;
    }
    return;
  }

  // copies: the producer warp (warp 4) loads every tile by bulk copies, one
  // a latent row, lane i rows i and i + 32; it reads their table entries a
  // tile ahead (lookup: nothing uses them until the next tile, so the
  // reads' latency hides), and issue sets the stage's barrier to expect the
  // valid rows' bytes, copies those rows and leaves their validity for the
  // consumers in sMask[buf] (a token is valid if its slot is mapped and its
  // position is below the length).  Rows not copied keep what the buffer
  // held (zeros, or an earlier tile's latents): finite, and masked.  The
  // copies of tile t + 1 run while the four consumer warps compute tile t
  const int lbt = __ffs(bt) - 1;                   // bt is a power of 2
  const int tok0 = warp * 16;                      // a consumer's tokens
  uint32_t* sMask = reinterpret_cast<uint32_t*>(red_l + kWarps * kHeads);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sMask + 4);
  const uint32_t row_bytes = D * 2;
  auto lookup = [&](int t, int r) -> int {
    int blk = -1;
    const int j = j0 + t * ppt + (r >> lbt);
    if (t < ntiles && j < jend && (j << lbt) + (r & (bt - 1)) < len)
      blk = __ldg(trow + j);
    return blk;
  };
  auto issue = [&](int blk_a, int blk_b, int buf) {
    bf16* dst = sKV + buf * kTile * RS;
    const uint32_t m0 = __ballot_sync(0xffffffffu, blk_a >= 0);
    const uint32_t m1 = __ballot_sync(0xffffffffu, blk_b >= 0);
    if (lane == 0) {
      sMask[buf * 2] = m0;
      sMask[buf * 2 + 1] = m1;
      mbar_expect(bars + buf, (__popc(m0) + __popc(m1)) * row_bytes);
    }
    __syncwarp();
    if (blk_a >= 0)
      bulk_copy(dst + lane * RS,
                pool + ((size_t)blk_a * bt + (lane & (bt - 1))) * D,
                row_bytes, bars + buf);
    if (blk_b >= 0)
      bulk_copy(dst + (lane + 32) * RS,
                pool + ((size_t)blk_b * bt + ((lane + 32) & (bt - 1))) * D,
                row_bytes, bars + buf);
  };
  // zero the tile buffers (a row no copy writes must hold finite values:
  // its P is 0, and 0 * NaN is not), set up the stages' barriers
  auto zero = [&](bf16* p, int n) {
    for (int i = tid; i < n / 8; i += kThreads)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
  };
  zero(sKV, kTile * RS);
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
  }
  fence_async_shared();
  __syncthreads();
  // q [H, D] float32 through the second tile buffer (cp.async), made two
  // bf16 parts there (hi, lo = q - hi; zero past H and D), and taken into
  // registers: consumer w keeps the A fragments of its quarter of the
  // contraction, k-steps [kq * w, kq * w + kq), for good
  const bool producer = warp == kWarps;
  const int NK = DP >> 4, kq = (NK + kWarps - 1) / kWarps;
  const int k_lo = producer ? NK : min(NK, kq * warp);
  const int k_n = min(NK, k_lo + kq) - k_lo;
  uint32_t qf[kKQ][2][4];
  {
    const int QC = D >> 2;                         // 16-byte chunks of q
    float* stage = reinterpret_cast<float*>(sKV + kTile * RS);
    bf16* sQ = reinterpret_cast<bf16*>(stage + kHeads * D);  // [2][16][RS]
    if (producer) {
      issue(lookup(0, lane), lookup(0, lane + 32), 0);
      for (int i = lane; i < H * QC; i += 32)
        cp_async16(smem_u32(stage + i * 4), q + (size_t)b * H * D + i * 4,
                   true);
      cp_async_commit();
      cp_async_wait0();
    }
    __syncthreads();
    for (int i = tid; i < kHeads * RS; i += kThreads) {
      const int h = i / RS, c = i - h * RS;
      const float x = (h < H && c < D) ? stage[h * D + c] : 0.f;
      const bf16 hi = __float2bfloat16(x);
      sQ[i] = hi;
      sQ[kHeads * RS + i] = __float2bfloat16(x - __bfloat162float(hi));
    }
    __syncthreads();
    const uint32_t qa =
        smem_u32(sQ) + ((lane & 15) * RS + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int k = 0; k < kKQ; ++k)
      if (k < k_n) {
        ldsm_x4(qa + (k_lo + k) * 32, qf[k][0]);
        ldsm_x4(qa + kHeads * RS * 2 + (k_lo + k) * 32, qf[k][1]);
      }
    __syncthreads();                   // q is in registers
    zero(sKV + kTile * RS, kTile * RS);
    fence_async_shared();
  }

  if (producer) {
    int next_a = lookup(1, lane), next_b = lookup(1, lane + 32);
    for (int t = 0; t < ntiles; ++t) {
      __syncthreads();               // every consumer is done with t - 1
      if (t + 1 < ntiles) {
        issue(next_a, next_b, (t + 1) & 1);
        next_a = lookup(t + 2, lane);
        next_b = lookup(t + 2, lane + 32);
      }
    }
    return;
  }

  const uint32_t sKV_u = smem_u32(sKV), sP_u = smem_u32(sP);
  float m_run[2] = {MLA_NEG_INF, MLA_NEG_INF};     // rows g and g + 8
  float l_run[2] = {0.f, 0.f};
  float o[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    // every consumer is done with tile t - 1 (its buffer, partial scores,
    // P and reductions are free: the producer copies tile t + 1 into it),
    // and tile t has landed
    __syncthreads();
    mbar_wait(bars + (t & 1), (t >> 1) & 1);
    const uint32_t vm = (sMask[(t & 1) * 2 + (warp >> 1)] >> ((warp & 1) * 16))
                        & 0xffffu;
    const uint32_t kv_u = sKV_u + (t & 1) * kTile * RS * 2;
    const int jb = j0 + t * ppt;

    // ---- partial scores of all 64 tokens over this warp's k-steps: eight
    // independent chains (one an 8-token n-tile), q's hi then lo part
    {
      float ps4[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) ps4[n][i] = 0.f;
      const uint32_t ka = kv_u + (((lane & 7) + ((lane >> 4) << 3)) * RS +
                                  ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
      for (int k = 0; k < kKQ; ++k)
        if (k < k_n) {
          const uint32_t kk = ka + (k_lo + k) * 32;
#pragma unroll
          for (int n = 0; n < 8; n += 2) {
            uint32_t bk[4];
            ldsm_x4(kk + n * 8 * RS * 2, bk);
            mma16816(ps4[n], qf[k][0], bk[0], bk[1]);
            mma16816(ps4[n + 1], qf[k][0], bk[2], bk[3]);
            mma16816(ps4[n], qf[k][1], bk[0], bk[1]);
            mma16816(ps4[n + 1], qf[k][1], bk[2], bk[3]);
          }
        }
      float* dst = sS + warp * kHeads * kSS;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<float2*>(dst + g * kSS + n * 8 + tg * 2) =
            make_float2(ps4[n][0], ps4[n][1]);
        *reinterpret_cast<float2*>(dst + (g + 8) * kSS + n * 8 + tg * 2) =
            make_float2(ps4[n][2], ps4[n][3]);
      }
    }
    consumers_sync();
    // ---- this warp's 16 tokens: the four partials summed, in a fixed
    // order; sc[n-tile][c0..c3] as an m16n8 accumulator of tokens tok0..
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int col = tok0 + nt * 8 + tg * 2, row = g + 8 * rh;
        float2 a = make_float2(0.f, 0.f);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float2 v = *reinterpret_cast<const float2*>(
              sS + (w * kHeads + row) * kSS + col);
          a.x += v.x;
          a.y += v.y;
        }
        sc[nt][rh * 2] = a.x;
        sc[nt][rh * 2 + 1] = a.y;
      }
    // scale and mask (the warp's own copies' validity): token lt = nt * 8
    // + tg * 2 + e of the warp's 16
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = (vm >> (nt * 8 + tg * 2 + e)) & 1u;
        sc[nt][e] = ok ? sc[nt][e] * scale : MLA_NEG_INF;
        sc[nt][2 + e] = ok ? sc[nt][2 + e] * scale : MLA_NEG_INF;
      }

    // ---- the tile's max per head, over the four warps
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float wm = fmaxf(fmaxf(sc[0][rh * 2], sc[0][rh * 2 + 1]),
                       fmaxf(sc[1][rh * 2], sc[1][rh * 2 + 1]));
      wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, 1));
      wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, 2));
      if (tg == 0) red_m[warp * kHeads + g + 8 * rh] = wm;
    }
    consumers_sync();
    float m_new[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float mt = red_m[g + 8 * rh];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        mt = fmaxf(mt, red_m[w * kHeads + g + 8 * rh]);
      m_new[rh] = fmaxf(m_run[rh], mt);
    }
    // ---- P against the new max: float32 sums, bf16 into shared memory
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[nt][i] = exp_diff(sc[nt][i], m_new[i >> 1]);
        ps[i >> 1] += sc[nt][i];
      }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      ps[rh] += __shfl_xor_sync(0xffffffffu, ps[rh], 1);
      ps[rh] += __shfl_xor_sync(0xffffffffu, ps[rh], 2);
      if (tg == 0) red_l[warp * kHeads + g + 8 * rh] = ps[rh];
    }
    // ---- each table slot's mass per head, for the heat: (m_new, the sum
    // of its tokens' p against m_new), which weighs like the slot's own
    // (max, sum): l * exp(m - M) is the same.  A slot is bt tokens of the
    // warp's 16: summed within a lane, then across the lanes that hold it
    {
      float pl[2][2];                              // [row half][n-tile]
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          pl[rh][nt] = sc[nt][rh * 2] + sc[nt][rh * 2 + 1];
      if (bt >= 4) {
#pragma unroll
        for (int ox = 1; ox <= 2; ox <<= 1) {
          if (4 * ox > bt) break;
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              pl[rh][nt] += __shfl_xor_sync(0xffffffffu, pl[rh][nt], ox);
        }
      }
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = tok0 + nt * 8 + tg * 2 + e;
            const int j = jb + (r >> lbt), h = g + 8 * rh;
            if ((r & (bt - 1)) == 0 && j < j1 && h < H) {
              const float l = bt == 1 ? sc[nt][rh * 2 + e]
                              : bt >= 16 ? pl[rh][0] + pl[rh][1]
                                         : pl[rh][nt];
              const size_t o2 = ((size_t)b * H + h) * MB + j;
              page_ml[o2] = m_new[rh];
              page_ml[pml + o2] = l;
            }
          }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = tok0 + nt * 8 + tg * 2;
      *reinterpret_cast<uint32_t*>(sP + g * kPS + c) =
          pack_bf16(sc[nt][0], sc[nt][1]);
      *reinterpret_cast<uint32_t*>(sP + (g + 8) * kPS + c) =
          pack_bf16(sc[nt][2], sc[nt][3]);
    }
    consumers_sync();
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const float corr = exp_diff(m_run[rh], m_new[rh]);
      float lt = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) lt += red_l[w * kHeads + g + 8 * rh];
      l_run[rh] = l_run[rh] * corr + lt;
      m_run[rh] = m_new[rh];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        o[n][rh * 2] *= corr;
        o[n][rh * 2 + 1] *= corr;
      }
    }

    // ---- o += P (16 x 64) . V (64 x this warp's L / 4 channels)
    const int c0 = warp * 8 * NV;
    const uint32_t pa = sP_u + ((lane & 15) * kPS + (lane >> 4) * 8) * 2;
    const uint32_t va = kv_u + (((lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                c0 + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int kt = 0; kt < kTile; kt += 16) {
      uint32_t a[4];
      ldsm_x4(pa + kt * 2, a);
      if constexpr (NV == 1) {
        uint32_t b0, b1;
        ldsm_x2_t(va + kt * RS * 2, b0, b1);
        mma16816(o[0], a, b0, b1);
      } else {
#pragma unroll
        for (int n = 0; n < NV; n += 2) {
          uint32_t bv[4];
          ldsm_x4_t(va + (kt * RS + n * 8) * 2, bv);
          mma16816(o[n], a, bv[0], bv[1]);
          mma16816(o[n + 1], a, bv[2], bv[3]);
        }
      }
    }
  }

  // ---- this split's (m, l, acc) per head
  const int c0 = warp * 8 * NV;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int h = g + 8 * rh;
    if (h >= H) continue;
    float* dst = acc_part + (((size_t)b * H + h) * NS + s) * L + c0 + tg * 2;
#pragma unroll
    for (int n = 0; n < NV; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(o[n][rh * 2], o[n][rh * 2 + 1]);
    if (warp == 0 && tg == 0) {
      const size_t o2 = ((size_t)b * H + h) * NS + s;
      ml_part[o2] = m_run[rh];
      ml_part[sml + o2] = l_run[rh];
    }
  }
}

// Pass 1 for a float32 pool (the precision checks run float32 models on
// the card): the same grid, slots and partials as the bf16 pass, in scalar
// float32 products, one table slot's latents at a time in shared memory.
__global__ void __launch_bounds__(kF32Threads)
mla_decode_split_f32_kernel(const float* __restrict__ q,      // [B, H, D]
                            const float* __restrict__ pool,   // [NB, bt, D]
                            const int* __restrict__ table,    // [B, MB]
                            const int* __restrict__ lengths,  // [B]
                            float* __restrict__ acc_part,     // [B,H,NS,L]
                            float* __restrict__ ml_part,      // [2,B,H,NS]
                            float* __restrict__ page_ml,      // [2,B,H,MB]
                            int B, int H, int L, int D, int MB, int bt,
                            int pps, int NS, float scale) {
  extern __shared__ float fsm[];
  float* sQ = fsm;                 // [H][D]
  float* sC = sQ + H * D;          // [bt][D] the slot's latents
  float* sA = sC + bt * D;         // [H][L] the running acc
  float* sP = sA + H * L;          // [H][bt] scores, then p against sM
  float* sM = sP + H * bt;         // [H] running max
  float* sL = sM + H;              // [H] running sum
  float* sF = sL + H;              // [H] the running acc's rescale
  const int tid = threadIdx.x, s = blockIdx.x, b = blockIdx.y;
  const int len = lengths[b];
  const int* trow = table + (size_t)b * MB;
  const int j0 = s * pps, j1 = min(MB, j0 + pps);
  const size_t pml = (size_t)B * H * MB, sml = (size_t)B * H * NS;
  for (int i = tid; i < H * D; i += kF32Threads)
    sQ[i] = q[(size_t)b * H * D + i];
  for (int i = tid; i < H * L; i += kF32Threads) sA[i] = 0.f;
  if (tid < H) {
    sM[tid] = MLA_NEG_INF;
    sL[tid] = 0.f;
  }
  __syncthreads();
  for (int j = j0; j < j1; ++j) {
    const int blk = trow[j];
    // a slot's valid tokens are a prefix of it: mapped, below the length
    const int nv = blk < 0 ? 0 : max(0, min(bt, len - j * bt));
    if (nv == 0) {
      for (int h = tid; h < H; h += kF32Threads) {
        const size_t o = ((size_t)b * H + h) * MB + j;
        page_ml[o] = MLA_NEG_INF;
        page_ml[pml + o] = 0.f;
      }
      continue;
    }
    for (int i = tid; i < nv * D; i += kF32Threads)
      sC[i] = pool[(size_t)blk * bt * D + i];
    __syncthreads();
    for (int i = tid; i < H * nv; i += kF32Threads) {
      const int h = i / nv, t = i - h * nv;
      float a = 0.f;
      for (int c = 0; c < D; ++c) a += sQ[h * D + c] * sC[t * D + c];
      sP[h * bt + t] = a * scale;
    }
    __syncthreads();
    if (tid < H) {
      const int h = tid;
      float mb = MLA_NEG_INF;
      for (int t = 0; t < nv; ++t) mb = fmaxf(mb, sP[h * bt + t]);
      const float m_new = fmaxf(sM[h], mb);
      float lb = 0.f;
      for (int t = 0; t < nv; ++t) {
        const float p = expf(sP[h * bt + t] - m_new);
        sP[h * bt + t] = p;
        lb += p;
      }
      const size_t o = ((size_t)b * H + h) * MB + j;
      page_ml[o] = m_new;          // the slot's mass against m_new
      page_ml[pml + o] = lb;
      sF[h] = exp_diff(sM[h], m_new);
      sL[h] = sL[h] * sF[h] + lb;
      sM[h] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < H * L; i += kF32Threads) {
      const int h = i / L, c = i - h * L;
      float a = sA[i] * sF[h];
      for (int t = 0; t < nv; ++t) a += sP[h * bt + t] * sC[t * D + c];
      sA[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < H * L; i += kF32Threads) {
    const int h = i / L, c = i - h * L;
    acc_part[(((size_t)b * H + h) * NS + s) * L + c] = sA[i];
  }
  if (tid < H) {
    const size_t o = ((size_t)b * H + tid) * NS + s;
    ml_part[o] = sM[tid];
    ml_part[sml + o] = sL[tid];
  }
}

// Block (h, b) merges head h's splits of row b into o_lat and writes the
// heat of table slots h, h + 4H, ... (warp w: h + wH, ...).
__global__ void __launch_bounds__(kCThreads)
mla_decode_combine_kernel(const float* __restrict__ acc_part,  // [B,H,NS,L]
                          const float* __restrict__ ml_part,   // [2,B,H,NS]
                          const float* __restrict__ page_ml,   // [2,B,H,MB]
                          float* __restrict__ out,             // [B, H, L]
                          float* __restrict__ heat,            // [B, MB]
                          int B, int H, int L, int NS, int MB) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  extern __shared__ float sm[];
  float* s_m = sm;                 // [H * NS] every split's max of row b
  float* s_l = s_m + H * NS;       // [H * NS] and its sum
  float* sM = s_l + H * NS;        // [H] row max over the splits
  float* sL = sM + H;              // [H] row sum
  float* sw = sL + H;              // [NS] head h's weight of each split
  const size_t row = (size_t)b * H * NS;
  for (int i = tid; i < H * NS; i += kCThreads) {
    s_m[i] = ml_part[row + i];
    s_l[i] = ml_part[(size_t)B * H * NS + row + i];
  }
  __syncthreads();
  for (int hh = warp; hh < H; hh += kCWarps) {
    float M = MLA_NEG_INF;
    for (int x = lane; x < NS; x += 32) M = fmaxf(M, s_m[hh * NS + x]);
    for (int ox = 16; ox > 0; ox >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, ox));
    float S = 0.f;
    for (int x = lane; x < NS; x += 32)
      S += s_l[hh * NS + x] * exp_diff(s_m[hh * NS + x], M);
    for (int ox = 16; ox > 0; ox >>= 1)
      S += __shfl_xor_sync(0xffffffffu, S, ox);
    if (lane == 0) {
      sM[hh] = M;
      sL[hh] = S;
    }
  }
  __syncthreads();
  for (int x = tid; x < NS; x += kCThreads)
    sw[x] = sL[h] > 0.f ? exp_diff(s_m[h * NS + x], sM[h]) / sL[h] : 0.f;
  __syncthreads();
  const float* ar = acc_part + ((size_t)b * H + h) * NS * L;
  for (int d = tid; d < L; d += kCThreads) {
    float a = 0.f;
    for (int x = 0; x < NS; ++x) {
      const float w = sw[x];     // an empty split wrote no acc: select,
      if (w != 0.f) a += ar[(size_t)x * L + d] * w;   // never 0 * junk
    }
    out[((size_t)b * H + h) * L + d] = a;
  }
  const float* pm = page_ml + (size_t)b * H * MB;
  const float* pl = page_ml + (size_t)B * H * MB + (size_t)b * H * MB;
  for (int p = h + warp * H; p < MB; p += kCWarps * H) {
    float sum = 0.f;
    for (int hh = lane; hh < H; hh += 32)
      if (sL[hh] > 0.f)
        sum += pl[(size_t)hh * MB + p] * exp_diff(pm[(size_t)hh * MB + p],
                                                  sM[hh]) / sL[hh];
    for (int ox = 16; ox > 0; ox >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, ox);
    if (lane == 0) heat[(size_t)b * MB + p] = sum;
  }
}

template <int NV>
int launch_split(const float* q, const void* pool, const int* table,
                 const int* lengths, float* acc_part, float* ml_part,
                 float* page_ml, int B, int H, int D, int MB, int bt, int pps,
                 int NS, float scale, cudaStream_t s) {
  const int DP = (D + 15) / 16 * 16, RS = DP + 8;
  const size_t smem =
      sizeof(bf16) * ((size_t)2 * kTile * RS + (size_t)kHeads * kPS) +
      sizeof(float) * ((size_t)kWarps * kHeads * kSS + 2 * kWarps * kHeads) +
      sizeof(uint32_t) * 4 + sizeof(uint64_t) * 2;
  auto kern = mla_decode_split_kernel<NV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(NS, B);
  kern<<<grid, kThreads, smem, s>>>(q, static_cast<const bf16*>(pool), table,
                                    lengths, acc_part, ml_part, page_ml, B, H,
                                    D, DP, MB, bt, pps, NS, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both passes: o_lat [B, H, L] float32 and heat [B, MB] float32 from q
// [B, H, L + R] float32 (q_eff then q_rope), the latent pool [NB, bt, L +
// R] (dtype 1: bf16, 0: float32), the table [B, MB] and the lengths [B]
// (tokens valid, the current one included), through a float32 workspace
// of the NS splits' partials.
extern "C" int mla_decode_launch(const float* q, const void* pool,
                                 const int* table, const int* lengths,
                                 float* acc_part, float* ml_part,
                                 float* page_ml, float* out, float* heat,
                                 int B, int H, int L, int R, int MB, int bt,
                                 int pps, int NS, float scale, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = L + R;
  if (H < 1 || H > kHeads || D % 8 || D > 16 * kWarps * kKQ || bt < 1 ||
      bt > 16 || 16 % bt ||
      pps < 1 || (pps * bt) % kTile || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  if (dtype == 0) {
    const size_t smem =
        sizeof(float) * ((size_t)(H + bt) * D + (size_t)H * (L + bt + 3));
    cudaError_t e = cudaFuncSetAttribute(
        mla_decode_split_f32_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    mla_decode_split_f32_kernel<<<dim3(NS, B), kF32Threads, smem, s>>>(
        q, static_cast<const float*>(pool), table, lengths, acc_part,
        ml_part, page_ml, B, H, L, D, MB, bt, pps, NS, scale);
    err = static_cast<int>(cudaGetLastError());
  } else switch (L) {
    case 32: err = launch_split<1>(q, pool, table, lengths, acc_part, ml_part, page_ml, B, H, D, MB, bt, pps, NS, scale, s); break;
    case 64: err = launch_split<2>(q, pool, table, lengths, acc_part, ml_part, page_ml, B, H, D, MB, bt, pps, NS, scale, s); break;
    case 128: err = launch_split<4>(q, pool, table, lengths, acc_part, ml_part, page_ml, B, H, D, MB, bt, pps, NS, scale, s); break;
    case 256: err = launch_split<8>(q, pool, table, lengths, acc_part, ml_part, page_ml, B, H, D, MB, bt, pps, NS, scale, s); break;
    case 512: err = launch_split<16>(q, pool, table, lengths, acc_part, ml_part, page_ml, B, H, D, MB, bt, pps, NS, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const int smem = (int)sizeof(float) * (2 * H * NS + 2 * H + NS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mla_decode_combine_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(H, B);
  mla_decode_combine_kernel<<<grid, kCThreads, smem, s>>>(
      acc_part, ml_part, page_ml, out, heat, B, H, L, NS, MB);
  return static_cast<int>(cudaGetLastError());
}
