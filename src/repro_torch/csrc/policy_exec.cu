// A verified policy program run over a batch of fault contexts in one
// launch, for NVIDIA Hopper (sm_90a).
//
// No TPU kernel: this is the port's counterpart of the reference's compile
// step, `compile_program` (src/repro/core/jit.py:49, a `lax.while_loop` over
// a `lax.switch(pc, ...)` that `jax.jit(jax.vmap(...))` turns into one
// executable over the fault batch) and `compile_predicated`
// (src/repro/core/predicate.py:297).  One generic kernel serves every
// program: it interprets the packed instruction table, one thread a lane
// (one fault context), so nothing is compiled per program or batch bucket.
//
// What bounds it on the H100: neither bytes nor operations, and not the
// launch either once the rows are staged.  A batch reads B x 69 x 8 bytes
// of ctx, the maps and the table once and writes a few words a lane, a
// few nanoseconds at HBM rate.  What a lane waits on is its chain of
// interpreted steps (5 to ~100 for the main path's program): at the
// serving buckets a block holds one or two warps, nothing hides one
// step's latency behind another's, and a step costs its dependent
// instructions and, above all, its taken branches (chip_smoke.py phase 4
// prints a row's cost by kind: a rare row, which takes the outer loop's
// branches, costs about 2.5 inner-loop rows).  The design:
//
// * A staged prologue.  Before any lane runs, one thread hands the copy
//   engine a 1-D bulk copy (`cp.async.bulk`, completed on an `mbarrier`;
//   no tensor map for a contiguous run) for each region the block reads:
//   its lanes' ctx rows, the maps' (offset, length) table, the maps' flat
//   buffer and the instruction table.  All of them are in flight together
//   and no thread spends registers on them (16-byte loads would take a
//   thread's registers round by round); an unaligned source's first and
//   last words go by plain loads.  After that every ctx, map and table
//   read is a shared-memory read.  The layout is planned in Python
//   (kernels/policy_exec/ops.py `stage_plan`, the one source of the
//   offsets): ctx and the map table always, then the maps if they fit
//   beside them in 227 KB, then the table if it fits beside those; what
//   does not fit is read in place from device memory (the `kMapsSmem`,
//   `kTableSmem` instances of one kernel).
// * The eleven registers out of local memory: a lane's eleven words side
//   by side in shared memory, indexed at run time there, so ptxas reports
//   no stack frame.  (Held against true registers read through a select
//   tree, shared memory was 20-25% faster at every serving bucket: PERF.md.)
// * Pre-decoded 32-byte rows.  `pack_code` stores each row's handler,
//   its sub-op, where operand b comes from, the operand itself (SUBI's
//   negated, JEQI's src2) and LDCTX's clamped column, and nothing the
//   kernel does not read, so no step decodes an opcode.  MOV, ADD, SUBI,
//   MUL and LDCTX are one handler that picks its result by selects; a
//   jump's sub is its 8-bit truth table over (eq, lt, set).
// * A straight inner loop.  Arithmetic rows and jumps not taken, most of
//   a run, go through a loop with no branch taken but the one back, so
//   the lanes of a warp at different pcs of it run together.  It is
//   software-pipelined: while row pc runs, row pc + 1's registers and ctx
//   word and row pc + 2's fields are loading, and pc's write is forwarded
//   to pc + 1's registers, read before it landed.  A taken jump, a rare
//   row (maps, DIV/MOD and the other ALU ops, LDCTXR, JNZDEC, helper
//   calls, EXIT), the end and the fuel's end leave it; the outer loop runs
//   the rare row and reloads the pipeline from the register file.

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
struct __align__(16) PIns {
  int32_t ctl;        // handler | sub << 8 | b from register << 16 | op << 24
  int32_t dst, src, target;
  int64_t k;          // operand b when it is not a register (pack_code's)
  int32_t kctx, pad;  // LDCTX's ctx index (clamped; 0 in other rows)
};
static_assert(sizeof(PIns) == 32, "PIns is 32 bytes");
constexpr int kRowWords = sizeof(PIns) / 8;

// core/context.py's ctx layout, core/isa.py's opcodes, core/vm.py's helper
// ids, obs/ringbuf.py's trace tag and ops.py's handlers and budget;
// tests/test_torch_policy_exec.py holds each constant to its Python
// definition.
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

// The ISA's opcodes (core/isa.py), which ops.py `decode` maps onto the
// handlers below; a kHAlu row's `sub` is its reg-form op (kSub..kMax,
// kNeg), a kHMap row's its opcode.
enum Opcode : int {
  kMov = 0, kAdd = 1, kSub = 2, kMul = 3, kDiv = 4, kMod = 5, kAnd = 6,
  kOr = 7, kXor = 8, kLsh = 9, kRsh = 10, kMin = 11, kMax = 12,
  kMovi = 16, kMaxi = 28, kNeg = 29,
  kLdctx = 32, kLdmap = 33, kMapsz = 34, kLdmapx = 35, kLdctxr = 36,
  kJa = 48, kJeq = 49, kJset = 55, kJeqi = 56, kJseti = 62, kJnzdec = 63,
  kCall = 80, kExit = 81,
};

// A row's handler, in the order the loop tests them (by how often the
// policies run them), and the bits of its `ctl` word.
enum Handler : int {
  kHArith = 0,      // dst = one of b, dst + b, dst * b, ctx[kctx], by sub:
                    // MOV, MOVI, ADD, ADDI, SUBI (b = -imm), MUL, MULI,
                    // LDCTX
  kHJump = 1,       // pc = target if bit s of sub, s = eq | lt << 1 |
                    // set << 2 of (dst, b): JA and the conditional jumps
  kHMap = 2,        // LDMAP (slot k), LDMAPX (slot register k), MAPSZ
  kHAlu = 3,        // dst = alu(sub, dst, b): the other ALU ops, NEG
  kHLdctxr = 4,     // dst = ctx[clamp(src)]
  kHJnzdec = 5,
  kHCall = 6,       // helper k
  kHExit = 7,
};

// kHArith's results.
enum ArithCode : int { kArMov = 0, kArAdd = 1, kArMul = 2, kArCtx = 3 };

enum CtlBits : int { kSubShift = 8, kBRegBit = 65536, kOpShift = 24 };

enum Helper : int {
  kHelperKtime = 1, kHelperTrace = 2, kHelperPromotionCost = 3,
  kHelperMigrateCost = 4, kHelperRingbufOutput = 5,
};

constexpr int kThreads = 128;          // lanes a block (ops.py MAX_LANES)
constexpr int kSmemBudget = 232448;    // a block's shared memory (SMEM_BUDGET)
constexpr int kMaxDevices = 64;
constexpr int kExited = -2;            // the pc after EXIT (no jump targets it)

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
    case kSub: return wsub(a, b);
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
    case kNeg: return wsub(0, a);
  }
  return 0;                               // MOV, ADD, MUL: kHArith
}

// torch.div(x, 1000, rounding_mode="floor")
__device__ __forceinline__ int64_t floordiv1000(int64_t x) {
  int64_t q = x / 1000;
  return (x % 1000 != 0 && x < 0) ? q - 1 : q;
}

// ---------------------------------------------------------------- staging
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Where word 0 of a region staged at byte offset `off` lands: one word on
// when the source is 8 bytes off a 16-byte boundary, so the source's and
// the copy's 16-byte boundaries coincide (ops.py gives each region a
// spare word for it).
__device__ __forceinline__ int64_t* staged(unsigned char* smem, int off,
                                           const void* src) {
  return reinterpret_cast<int64_t*>(
      smem + off + (reinterpret_cast<uintptr_t>(src) & 8));
}

// The words of [src, src + n) a bulk copy takes: the 16-byte aligned run
// after the source's first word when that is unaligned.
struct Run {
  int lead, words;
};
__device__ __forceinline__ Run bulk_run(const int64_t* src, int n) {
  const int lead = (reinterpret_cast<uintptr_t>(src) & 8) ? 1 : 0;
  const int words = n > lead ? ((n - lead) & ~1) : 0;
  return {lead, words};
}

// Thread 0: the bulk copy of a region's aligned run, completing on `bar`,
// and its unaligned first and last words by plain loads.
__device__ __forceinline__ void stage_region(unsigned char* smem, int off,
                                             const int64_t* src, int n,
                                             uint32_t bar) {
  int64_t* dst = staged(smem, off, src);
  const Run run = bulk_run(src, n);
  if (run.words > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst + run.lead)),
        "l"(src + run.lead), "r"(8 * run.words), "r"(bar)
        : "memory");
  if (run.lead && n > 0) dst[0] = src[0];
  if (run.lead + run.words < n) dst[n - 1] = src[n - 1];
}

struct Args {
  const PIns* code;
  const int64_t* ctx;
  const int64_t* maps;
  const int64_t* meta;           // [2, n_maps]: offsets, live lengths
  int64_t* out;
  int fuel, n_code, B, map_words, n_maps, rb_cap, halt_returns_r0;
  // byte offsets in the block's shared memory (ops.py `stage_plan`);
  // maps and table only in the instances that stage them
  int ctx_off, regs_off, meta_off, maps_off, table_off;
};

template <bool kTableSmem, bool kMapsSmem>
__global__ void __launch_bounds__(kThreads) policy_exec_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int first = blockIdx.x * blockDim.x;
  const int rows = min(static_cast<int>(blockDim.x), a.B - first);
  const int64_t* gctx = a.ctx + static_cast<size_t>(first) * kCtxLen;
  const int64_t* table = reinterpret_cast<const int64_t*>(a.code);

  // the prologue: every region in flight at once, one wait
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const uint32_t bar_addr = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar_addr),
                 "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    uint32_t bytes = 8 * (bulk_run(gctx, rows * kCtxLen).words +
                          bulk_run(a.meta, 2 * a.n_maps).words);
    if (kMapsSmem) bytes += 8 * bulk_run(a.maps, a.map_words).words;
    if (kTableSmem) bytes += 8 * bulk_run(table, kRowWords * a.n_code).words;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(bar_addr), "r"(bytes)
                 : "memory");
    stage_region(smem, a.ctx_off, gctx, rows * kCtxLen, bar_addr);
    stage_region(smem, a.meta_off, a.meta, 2 * a.n_maps, bar_addr);
    if (kMapsSmem) stage_region(smem, a.maps_off, a.maps, a.map_words, bar_addr);
    if (kTableSmem) {
      stage_region(smem, a.table_off, table, kRowWords * a.n_code, bar_addr);
      int64_t* spare = staged(smem, a.table_off, table) + kRowWords * a.n_code;
#pragma unroll
      for (int i = 0; i < 2 * kRowWords; ++i) spare[i] = 0;   // two zero rows
    }
  }
  __syncthreads();                     // the barrier's init, the plain words
  const int t = threadIdx.x;
  if (t >= rows) return;
  uint32_t landed = 0;
  while (!landed)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(landed)
        : "r"(bar_addr), "r"(0)
        : "memory");

  const int64_t* c = staged(smem, a.ctx_off, gctx) + t * kCtxLen;
  const int64_t* meta = staged(smem, a.meta_off, a.meta);
  const int64_t* maps =
      kMapsSmem ? staged(smem, a.maps_off, a.maps) : a.maps;
  const PIns* prog =
      kTableSmem ? reinterpret_cast<const PIns*>(staged(smem, a.table_off, table))
                 : a.code;
  const int n_code = a.n_code, n_maps = a.n_maps;
  const int width = 3 + kRbFields * a.rb_cap;
  int64_t* o = a.out + static_cast<size_t>(first + t) * width;
  int64_t* ev = o + 3;
  // the lane's registers, 88 bytes apart (11 words: odd, so the 16 lanes
  // of a 64-bit access fall on distinct bank pairs)
  int64_t* r = reinterpret_cast<int64_t*>(smem + a.regs_off) + t * kNumRegs;
#pragma unroll
  for (int k = 0; k < kNumRegs; ++k) r[k] = 0;

  int64_t count = 0, drops = 0;
  // The rare rows' effects (map reads, DIV/MOD and the other ALU ops,
  // LDCTXR, JNZDEC, helper calls, EXIT); returns the next pc.
  auto rare = [&](const PIns& ins, int pc, int h, int sub, int64_t x,
                  int64_t y, int64_t b) -> int {
    int next = pc + 1;
    switch (h) {
      case kHMap: {
        const int64_t slot = clampi(
            sub == kLdmapx ? r[static_cast<int>(ins.k)] : ins.k, 0,
            n_maps - 1);
        const int64_t len = meta[n_maps + slot];
        r[ins.dst] = sub == kMapsz
                         ? len
                         : ((y >= 0 && y < len) ? maps[meta[slot] + y] : 0);
        break;
      }
      case kHAlu: r[ins.dst] = alu(sub, x, b); break;
      case kHLdctxr: r[ins.dst] = c[clampi(y, 0, kCtxLen - 1)]; break;
      case kHJnzdec: {
        const int64_t v = wsub(x, 1);
        r[ins.dst] = v;
        if (v != 0) next = ins.target;
        break;
      }
      case kHCall: {
        const int64_t helper = ins.k;
        int64_t ret = 0;
        if (helper == kHelperKtime) {
          ret = c[kKtimeNs];
        } else if (helper == kHelperPromotionCost) {
          const int order = static_cast<int>(clampi(r[1], 0, 3));
          const int64_t nblocks = int64_t(1) << (2 * order);
          const int64_t zero = wmul(c[kZeroNsPerBlock], nblocks);
          const int64_t compact = floordiv1000(
              wmul(wmul(c[kCompactNsPerBlock], nblocks),
                   wadd(1000, c[kFragO0 + order])));
          ret = wadd(zero, c[kFreeBlocksO0 + order] > 0 ? 0 : compact);
        } else if (helper == kHelperMigrateCost) {
          const int order = static_cast<int>(clampi(r[1], 0, 3));
          const int64_t nblocks = int64_t(1) << (2 * order);
          const int64_t s = clampi(r[2], 0, kMaxTiers - 1);
          const int64_t d = clampi(r[3], 0, kMaxTiers - 1);
          const int lo = static_cast<int>(s < d ? s : d);
          const int hi = static_cast<int>(s < d ? d : s);
          const int64_t setup = wsub(c[kMigCumSetupT0 + hi], c[kMigCumSetupT0 + lo]);
          const int64_t per = wsub(c[kMigCumNsT0 + hi], c[kMigCumNsT0 + lo]);
          ret = wadd(setup, wmul(per, nblocks));
        } else if (helper == kHelperTrace ||
                   helper == kHelperRingbufOutput) {
          if (count < a.rb_cap) {
            int64_t* slot = ev + count * kRbFields;
            slot[0] = c[kKtimeNs];
            if (helper == kHelperTrace) {
              slot[1] = kEvProgTrace; slot[2] = r[1]; slot[3] = 0; slot[4] = 0;
            } else {
              slot[1] = r[1]; slot[2] = r[2]; slot[3] = r[3];
              slot[4] = r[4];
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
      case kHExit: next = kExited; break;
      default: next = -1; break;        // pack_code writes no other handler
    }
    return next;
  };
  // The row `d` rows after pc: a staged table has two zeroed spare rows
  // past its end (valid register indices), one in place is clamped.
  auto row = [&](int pc, int d) -> const PIns& {
    return prog[kTableSmem || pc + d < n_code ? pc + d : n_code - 1];
  };
  auto stop = [&](int next) {
    return static_cast<unsigned>(next) >= static_cast<unsigned>(n_code);
  };
  // The steps.  Arithmetic rows and jumps, most of a run, go through an
  // inner loop that is one straight line with a single branch back: it is
  // software-pipelined (while row pc runs, row pc + 1's registers and ctx
  // word and row pc + 2's fields are loading; pc's write is forwarded to
  // pc + 1's registers, which were read before it landed) and branch-free
  // (an arithmetic row picks its result by selects, a jump writes dst back
  // and picks its next pc from the truth table).  It leaves on a taken
  // jump (the outer loop reloads the pipeline at the target), at the end,
  // when the fuel runs out, or on reaching a rare row, which the outer
  // loop runs with the registers the pipeline forwarded; after it only the
  // registers are reloaded.
  int pc = 0, left = a.fuel;
  PIns cur = prog[0], nxt = row(0, 1);
  int64_t x = r[cur.dst], y = r[cur.src], cv = c[cur.kctx];
  while (left > 0) {
    int h = cur.ctl & 0xff;
    if (h <= kHJump) {
      int next;
      bool rare_next = false;
      for (;;) {
        const PIns after = row(pc, 2);
        const int64_t nx = r[nxt.dst], ny = r[nxt.src];
        const int64_t ncv = c[nxt.kctx];
        const int sub = (cur.ctl >> kSubShift) & 0xff;
        const int64_t b = (cur.ctl & kBRegBit) ? y : cur.k;
        const int64_t lo = (sub & 1) ? wadd(x, b) : b;
        const int64_t hi = (sub & 1) ? cv : wmul(x, b);
        const int s = (x == b) | (x < b) << 1 | ((x & b) != 0) << 2;
        const bool jump = h == kHJump;
        const int64_t v = jump ? x : ((sub & 2) ? hi : lo);
        r[cur.dst] = v;
        --left;
        next = jump && ((sub >> s) & 1) ? cur.target : pc + 1;
        if (next != pc + 1 || left == 0 || stop(next)) break;
        x = nxt.dst == cur.dst ? v : nx;
        y = nxt.src == cur.dst ? v : ny;
        cv = ncv;
        cur = nxt;
        nxt = after;
        pc = next;
        h = cur.ctl & 0xff;
        if (h > kHJump) {               // run it outside, pipeline intact
          rare_next = true;
          break;
        }
      }
      if (!rare_next) {                 // a taken jump, the end, no fuel
        pc = next;
        if (left == 0 || stop(pc)) break;
        cur = prog[pc];
        nxt = row(pc, 1);
        x = r[cur.dst];
        y = r[cur.src];
        cv = c[cur.kctx];
        continue;
      }
    }
    // row pc is rare; its registers are current
    const int sub = (cur.ctl >> kSubShift) & 0xff;
    const int next =
        rare(cur, pc, h, sub, x, y, (cur.ctl & kBRegBit) ? y : cur.k);
    if (--left == 0 || stop(next)) {
      pc = next;
      break;
    }
    cur = next == pc + 1 ? nxt : prog[next];   // reload after its writes
    nxt = row(next, 1);
    x = r[cur.dst];
    y = r[cur.src];
    cv = c[cur.kctx];
    pc = next;
  }
  o[0] = (pc == kExited || a.halt_returns_r0) ? r[0] : 0;
  o[1] = count;
  o[2] = drops;
  for (int64_t i = count * kRbFields; i < static_cast<int64_t>(a.rb_cap) * kRbFields; ++i)
    ev[i] = 0;
}

__global__ void empty_kernel() {}

// One instance's launch; the opt-in above 48 KB of shared memory is per
// kernel and device.
template <bool kTableSmem, bool kMapsSmem>
cudaError_t launch(const Args& a, int threads, int smem_bytes,
                   cudaStream_t s) {
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || !opted_in[dev]) {
    e = cudaFuncSetAttribute(
        policy_exec_kernel<kTableSmem, kMapsSmem>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  policy_exec_kernel<kTableSmem, kMapsSmem>
      <<<(a.B + threads - 1) / threads, threads, smem_bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches on the current device (the caller makes it the tensors' own),
// `threads` lanes a block and the shared-memory layout `stage_plan` gave:
// `smem_bytes` in all, the regions at the byte offsets given, -1 for the
// maps or the table read in place.
extern "C" int policy_exec_launch(const void* code, int n_code, const void* ctx,
                                  int B, const void* maps, int map_words,
                                  const void* meta, int n_maps, void* out,
                                  int rb_cap, long long fuel,
                                  int halt_returns_r0, int threads,
                                  int smem_bytes, int ctx_off, int regs_off,
                                  int meta_off, int maps_off, int table_off,
                                  void* stream) {
  if (B == 0) return 0;
  if (threads <= 0 || threads > kThreads || threads % 32 ||
      smem_bytes > kSmemBudget || ctx_off < 0 || regs_off < 0 || meta_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.code = static_cast<const PIns*>(code);
  a.ctx = static_cast<const int64_t*>(ctx);
  a.maps = static_cast<const int64_t*>(maps);
  a.meta = static_cast<const int64_t*>(meta);
  a.out = static_cast<int64_t*>(out);
  // a verified program stops far below 2^31 steps
  a.fuel = static_cast<int>(fuel < 0 ? 0 : (fuel > INT32_MAX ? INT32_MAX : fuel));
  a.n_code = n_code;
  a.B = B;
  a.map_words = map_words;
  a.n_maps = n_maps;
  a.rb_cap = rb_cap;
  a.halt_returns_r0 = halt_returns_r0;
  a.ctx_off = ctx_off;
  a.regs_off = regs_off;
  a.meta_off = meta_off;
  a.maps_off = maps_off;
  a.table_off = table_off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (2 * (table_off >= 0) + (maps_off >= 0)) {
    case 0: e = launch<false, false>(a, threads, smem_bytes, s); break;
    case 1: e = launch<false, true>(a, threads, smem_bytes, s); break;
    case 2: e = launch<true, false>(a, threads, smem_bytes, s); break;
    default: e = launch<true, true>(a, threads, smem_bytes, s); break;
  }
  return static_cast<int>(e);
}

// An empty kernel on the same stream: the launch-latency floor the
// executor's time is read against.
extern "C" int policy_exec_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
