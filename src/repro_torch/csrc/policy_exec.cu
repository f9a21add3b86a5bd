// A verified policy program run over a batch of fault contexts in one
// launch, for NVIDIA Hopper (sm_90a).
//
// No TPU kernel: this is the port's counterpart of the reference's compile
// step, `compile_program` (src/repro/core/jit.py:49, a `lax.while_loop` over
// a `lax.switch(pc, ...)` that `jax.jit(jax.vmap(...))` turns into one
// executable over the fault batch) and `compile_predicated`
// (src/repro/core/predicate.py:297).  One generic kernel serves every
// program: it interprets the lowered instruction table, so nothing is
// compiled per program or batch bucket.
//
// Design: one thread per lane (one fault context).  Each thread holds the
// eleven int64 registers, `pc` and `fuel`, and runs
// `while (pc >= 0 && fuel > 0) switch (op[pc])`, the reference's while_loop
// over switch run per lane.  The block first stages the instruction table
// in shared memory (32 bytes an instruction; Figure-1 at 64 regions unrolls
// to ~900, ~29 KB), so every fetch after that is a shared-memory read that
// the lanes of a warp at one pc share.  The ctx rows are read in place; the
// maps are one flat int64 buffer with an offset and a live length per slot.
//
// What bounds it on the H100: neither bytes nor operations.  A batch reads
// B x 69 x 8 bytes of ctx and the maps once and writes a few words a lane;
// at the serving path's buckets (4..64 lanes) that is a few microseconds at
// HBM rate, far under the launch latency, which is what the kernel costs.
// Lanes at different pcs diverge and serialise within their warp; at these
// batch sizes that costs less than one launch of the eager executor, which
// issues a few torch ops for every instruction.
//
// Semantics are those of the port's torch bodies (core/lower.py `alu_t`,
// `cmp_t`, `ldctx_dyn`, `map_lookup(_dyn)`, `helper_t`, `rb_words`,
// `BatchCtx.event_write`) and the interpreter `PolicyVM`, bit for bit:
// 64-bit wrapping arithmetic (done on uint64_t: signed overflow is undefined
// in C++), a logical right shift, shift counts masked with 63, x / 0 == 0,
// x % 0 == x, a divisor of -1 as a negation (INT64_MIN / -1 never reaches
// the hardware divide), the promotion-cost helper's floor division.
//
// Output, one int64 row a lane of width 3 + 5 x rb_cap:
//   [r0, ring count, ring drops, rb_cap x (ts, tag, a0, a1, a2)]
// with the ring slots past the count zeroed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The instruction table's row (kernels/policy_exec/ops.py `CODE_DTYPE`).
struct PIns {
  int32_t op, dst, src, target;
  int64_t imm, src2;
};
static_assert(sizeof(PIns) == 32, "PIns is 32 bytes");

// core/context.py's ctx layout, core/isa.py's opcodes, core/vm.py's helper
// ids and obs/ringbuf.py's trace tag; tests/test_torch_policy_exec.py holds
// each constant to its Python definition.
constexpr int kNumRegs = 11;
constexpr int kCtxLen = 69;
constexpr int kMaxTiers = 4;
constexpr int kFreeBlocksO0 = 8;
constexpr int kFragO0 = 12;
constexpr int kZeroNsPerBlock = 20;
constexpr int kCompactNsPerBlock = 21;
constexpr int kKtimeNs = 24;
constexpr int kMigCumSetupT0 = 47;
constexpr int kMigCumNsT0 = 51;
constexpr int kEvProgTrace = 16;
constexpr int kRbFields = 5;

enum Opcode : int {
  kMov = 0, kAdd = 1, kSub = 2, kMul = 3, kDiv = 4, kMod = 5, kAnd = 6,
  kOr = 7, kXor = 8, kLsh = 9, kRsh = 10, kMin = 11, kMax = 12,
  kMovi = 16, kMaxi = 28, kNeg = 29,
  kLdctx = 32, kLdmap = 33, kMapsz = 34, kLdmapx = 35, kLdctxr = 36,
  kJa = 48, kJeq = 49, kJset = 55, kJeqi = 56, kJseti = 62, kJnzdec = 63,
  kCall = 80, kExit = 81,
};
constexpr int kImmToReg = kMovi - kMov;      // ALU imm op -> reg op
constexpr int kJimmToJreg = kJeqi - kJeq;    // cond jump imm -> reg

enum Helper : int {
  kHelperKtime = 1, kHelperTrace = 2, kHelperPromotionCost = 3,
  kHelperMigrateCost = 4, kHelperRingbufOutput = 5,
};

constexpr int kThreads = 128;
constexpr int kSmemMaxBytes = 200 * 1024;   // larger tables read global memory
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) +
                              static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) -
                              static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t wmul(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) *
                              static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t clampi(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int64_t alu(int op, int64_t a, int64_t b) {
  switch (op) {
    case kMov: return b;
    case kAdd: return wadd(a, b);
    case kSub: return wsub(a, b);
    case kMul: return wmul(a, b);
    case kDiv:
      if (b == 0) return 0;
      if (b == -1) return wsub(0, a);
      return a / b;                       // C truncates toward zero
    case kMod:
      if (b == 0) return a;
      if (b == -1) return 0;
      return a % b;                       // the dividend's sign
    case kAnd: return a & b;
    case kOr: return a | b;
    case kXor: return a ^ b;
    case kLsh: return static_cast<int64_t>(static_cast<uint64_t>(a) << (b & 63));
    case kRsh: return static_cast<int64_t>(static_cast<uint64_t>(a) >> (b & 63));
    case kMin: return a < b ? a : b;
    case kMax: return a > b ? a : b;
  }
  return 0;
}

__device__ __forceinline__ bool cmp(int op, int64_t a, int64_t b) {
  switch (op) {
    case kJeq: return a == b;
    case kJeq + 1: return a != b;         // JNE
    case kJeq + 2: return a < b;          // JLT
    case kJeq + 3: return a <= b;         // JLE
    case kJeq + 4: return a > b;          // JGT
    case kJeq + 5: return a >= b;         // JGE
    case kJset: return (a & b) != 0;
  }
  return false;
}

// torch.div(x, 1000, rounding_mode="floor")
__device__ __forceinline__ int64_t floordiv1000(int64_t x) {
  int64_t q = x / 1000;
  return (x % 1000 != 0 && x < 0) ? q - 1 : q;
}

__device__ __forceinline__ int64_t map_get(const int64_t* __restrict__ maps,
                                           const int64_t* __restrict__ meta,
                                           int n_maps, int64_t slot,
                                           int64_t idx) {
  slot = clampi(slot, 0, n_maps - 1);
  const int64_t len = meta[n_maps + slot];
  return (idx >= 0 && idx < len) ? maps[meta[slot] + idx] : 0;
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
policy_exec_kernel(const PIns* __restrict__ code, int n_code,
                   const int64_t* __restrict__ ctx, int B,
                   const int64_t* __restrict__ maps,
                   const int64_t* __restrict__ meta, int n_maps,
                   int64_t* __restrict__ out, int rb_cap, long long fuel,
                   int halt_returns_r0) {
  extern __shared__ int4 staged[];
  const PIns* prog = code;
  if (kSmem) {
    const int4* from = reinterpret_cast<const int4*>(code);
    for (int i = threadIdx.x; i < 2 * n_code; i += blockDim.x)
      staged[i] = from[i];
    __syncthreads();
    prog = reinterpret_cast<const PIns*>(staged);
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int64_t* c = ctx + static_cast<size_t>(lane) * kCtxLen;
  const int width = 3 + kRbFields * rb_cap;
  int64_t* o = out + static_cast<size_t>(lane) * width;
  int64_t* ev = o + 3;

  int64_t r[kNumRegs];
#pragma unroll
  for (int i = 0; i < kNumRegs; ++i) r[i] = 0;
  int64_t count = 0, drops = 0;
  bool exited = false;
  int pc = 0;
  long long left = fuel;
  while (pc >= 0 && pc < n_code && left > 0) {
    const PIns ins = prog[pc];
    --left;
    int next = pc + 1;
    const int op = ins.op;
    if (op <= kMax) {
      r[ins.dst] = alu(op, r[ins.dst], r[ins.src]);
    } else if (op == kMovi) {
      r[ins.dst] = ins.imm;
    } else if (op > kMovi && op <= kMaxi) {
      r[ins.dst] = alu(op - kImmToReg, r[ins.dst], ins.imm);
    } else if (op >= kJeq && op <= kJset) {
      if (cmp(op, r[ins.dst], r[ins.src])) next = ins.target;
    } else if (op >= kJeqi && op <= kJseti) {
      if (cmp(op - kJimmToJreg, r[ins.dst], ins.src2)) next = ins.target;
    } else {
      switch (op) {
        case kNeg: r[ins.dst] = wsub(0, r[ins.dst]); break;
        case kLdctx: r[ins.dst] = c[clampi(ins.imm, 0, kCtxLen - 1)]; break;
        case kLdctxr: r[ins.dst] = c[clampi(r[ins.src], 0, kCtxLen - 1)]; break;
        case kLdmap:
          r[ins.dst] = map_get(maps, meta, n_maps, ins.imm, r[ins.src]);
          break;
        case kLdmapx:
          r[ins.dst] = map_get(maps, meta, n_maps, r[ins.src2], r[ins.src]);
          break;
        case kMapsz: r[ins.dst] = meta[n_maps + clampi(ins.imm, 0, n_maps - 1)]; break;
        case kJa: next = ins.target; break;
        case kJnzdec: {
          const int64_t v = wsub(r[ins.dst], 1);
          r[ins.dst] = v;
          if (v != 0) next = ins.target;
          break;
        }
        case kCall: {
          const int64_t h = ins.imm;
          int64_t ret = 0;
          if (h == kHelperKtime) {
            ret = c[kKtimeNs];
          } else if (h == kHelperPromotionCost) {
            const int order = static_cast<int>(clampi(r[1], 0, 3));
            const int64_t nblocks = int64_t(1) << (2 * order);
            const int64_t zero = wmul(c[kZeroNsPerBlock], nblocks);
            const int64_t compact = floordiv1000(
                wmul(wmul(c[kCompactNsPerBlock], nblocks),
                     wadd(1000, c[kFragO0 + order])));
            ret = wadd(zero, c[kFreeBlocksO0 + order] > 0 ? 0 : compact);
          } else if (h == kHelperMigrateCost) {
            const int order = static_cast<int>(clampi(r[1], 0, 3));
            const int64_t nblocks = int64_t(1) << (2 * order);
            const int64_t s = clampi(r[2], 0, kMaxTiers - 1);
            const int64_t d = clampi(r[3], 0, kMaxTiers - 1);
            const int lo = static_cast<int>(s < d ? s : d);
            const int hi = static_cast<int>(s < d ? d : s);
            const int64_t setup = wsub(c[kMigCumSetupT0 + hi], c[kMigCumSetupT0 + lo]);
            const int64_t per = wsub(c[kMigCumNsT0 + hi], c[kMigCumNsT0 + lo]);
            ret = wadd(setup, wmul(per, nblocks));
          } else if (h == kHelperTrace || h == kHelperRingbufOutput) {
            if (count < rb_cap) {
              int64_t* slot = ev + count * kRbFields;
              slot[0] = c[kKtimeNs];
              if (h == kHelperTrace) {
                slot[1] = kEvProgTrace; slot[2] = r[1]; slot[3] = 0; slot[4] = 0;
              } else {
                slot[1] = r[1]; slot[2] = r[2]; slot[3] = r[3]; slot[4] = r[4];
              }
              ++count;
              ret = 0;
            } else {
              ++drops;
              ret = -1;
            }
          }
          r[0] = ret;
          break;
        }
        case kExit: exited = true; next = -1; break;
        default: next = -1; break;        // no such opcode in a lowered program
      }
    }
    pc = next;
  }
  o[0] = (exited || halt_returns_r0) ? r[0] : 0;
  o[1] = count;
  o[2] = drops;
  for (int64_t i = count * kRbFields; i < static_cast<int64_t>(rb_cap) * kRbFields; ++i)
    ev[i] = 0;
}

__global__ void empty_kernel() {}

}  // namespace

// Launches on the current device (the caller makes it the tensors' own).
extern "C" int policy_exec_launch(const void* code, int n_code, const void* ctx,
                                  int B, const void* maps, const void* meta,
                                  int n_maps, void* out, int rb_cap,
                                  long long fuel, int halt_returns_r0,
                                  void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = B < kThreads ? ((B + 31) / 32) * 32 : kThreads;
  const int blocks = (B + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(n_code) * sizeof(PIns);
  const PIns* c = static_cast<const PIns*>(code);
  const int64_t* x = static_cast<const int64_t*>(ctx);
  const int64_t* m = static_cast<const int64_t*>(maps);
  const int64_t* mt = static_cast<const int64_t*>(meta);
  int64_t* o = static_cast<int64_t*>(out);
  if (smem <= kSmemMaxBytes) {
    // above 48 KB only after an opt-in, which is per device
    static bool opted_in[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices || !opted_in[dev]) {
      e = cudaFuncSetAttribute(
          policy_exec_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemMaxBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < kMaxDevices) opted_in[dev] = true;
    }
    policy_exec_kernel<true><<<blocks, threads, smem, s>>>(
        c, n_code, x, B, m, mt, n_maps, o, rb_cap, fuel, halt_returns_r0);
  } else {
    policy_exec_kernel<false><<<blocks, threads, 0, s>>>(
        c, n_code, x, B, m, mt, n_maps, o, rb_cap, fuel, halt_returns_r0);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the same stream: the launch-latency floor the
// executor's time is read against.
extern "C" int policy_exec_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
