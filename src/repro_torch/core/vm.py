"""Host-side interpreter for verified policy programs.

Page-fault handling in the framework happens on the host (the serving
scheduler decides block allocation before dispatching a device step), so the
common path runs here.  The batched/vectorized jnp paths live in
:mod:`repro.core.jit` and :mod:`repro.core.predicate`; since the unified
pipeline, all three executors consume the SAME lowered IR from
:mod:`repro.core.lower` (one verifier pass, absolute branch targets,
resolved map slots) instead of re-deriving it from the raw instruction
stream each.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..obs.ringbuf import EV_PROG_TRACE
from .context import CTX_LEN
from .isa import (ALU_IMM_OPS, ALU_REG_OPS, COND_JUMP_IMM, COND_JUMP_REG,
                  NUM_REGS, Op, Program, _wrap64)
from .maps import MapRegistry

# ---------------------------------------------------------------------------
# Helper (bpf_* analogue) registry
# ---------------------------------------------------------------------------

# helper signature: fn(regs: list[int], ctx: np.ndarray, state: HelperState) -> int
HELPER_KTIME = 1
HELPER_TRACE = 2
HELPER_PROMOTION_COST = 3
HELPER_MIGRATE_COST = 4
HELPER_RINGBUF_OUTPUT = 5

# Helpers that emit into the per-invocation event-slot buffer.  Every
# executor gives them the same semantics: write one (ts, tag, a0, a1, a2)
# record and return 0, or return -1 and bump the lane drop counter once the
# invocation's verifier-derived slot budget (facts["rb_cap"]) is spent.
RB_HELPERS = frozenset({HELPER_TRACE, HELPER_RINGBUF_OUTPUT})


@dataclass
class HelperState:
    """Mutable state helpers may touch (event-slot buffer, clock)."""
    ktime_ns: int = 0
    rb_cap: int = 0                                 # per-invocation slot budget
    rb_events: list = field(default_factory=list)   # this run's records
    rb_drops: int = 0                               # lifetime slot-overflow drops


def _helper_ktime(regs, ctx, state: HelperState) -> int:
    return state.ktime_ns


def _rb_emit(ctx, state: HelperState, tag: int, a0: int, a1: int,
             a2: int) -> int:
    if len(state.rb_events) >= state.rb_cap:
        state.rb_drops += 1
        return -1
    from .context import CTX  # local import to avoid cycle at module load
    state.rb_events.append((int(ctx[CTX.KTIME_NS]), tag, a0, a1, a2))
    return 0


def _helper_trace(regs, ctx, state: HelperState) -> int:
    """bpf_trace(r1) — legacy single-word trace, now a ring-buffer record
    with tag EV_PROG_TRACE (it used to vanish on the compiled executors)."""
    return _rb_emit(ctx, state, EV_PROG_TRACE, int(regs[1]), 0, 0)


def _helper_ringbuf_output(regs, ctx, state: HelperState) -> int:
    """bpf_ringbuf_output(tag=r1, a0=r2, a1=r3, a2=r4) — emit one typed
    event; the record timestamp is the modeled clock from ctx so streams
    are executor-independent."""
    return _rb_emit(ctx, state, int(regs[1]), int(regs[2]), int(regs[3]),
                    int(regs[4]))


def _helper_promotion_cost(regs, ctx, state: HelperState) -> int:
    """bpf_mm_promotion_cost(order=r1) — the paper's empirical cost estimate.

    cost(order) = zeroing(order) + (compaction if no free page of that order).
    Reads the calibrated constants and buddy state out of ctx.
    """
    from .context import CTX  # local import to avoid cycle at module load
    order = max(0, min(3, int(regs[1])))
    nblocks = 4 ** order
    zero = int(ctx[CTX.ZERO_NS_PER_BLOCK]) * nblocks
    free = int(ctx[CTX.FREE_BLOCKS_O0 + order])
    if free > 0:
        return zero
    frag = int(ctx[CTX.FRAG_O0 + order])  # FIXED_POINT scaled (0..1000)
    compact = (int(ctx[CTX.COMPACT_NS_PER_BLOCK]) * nblocks
               * (1000 + frag) // 1000)
    return zero + compact


def _helper_migrate_cost(regs, ctx, state: HelperState) -> int:
    """bpf_mm_migrate_cost(order=r1, src_tier=r2, dst_tier=r3) — full cost of
    moving an order-k page between two tiers of the N-pool graph: the summed
    fixed setup + per-block transfer of every edge on the src->dst path, read
    from the cumulative ctx tables so it matches CostModel.migrate_ns
    exactly.  A same-tier query costs 0."""
    from .context import CTX, MAX_TIERS  # local import to avoid cycle
    order = max(0, min(3, int(regs[1])))
    src = max(0, min(MAX_TIERS - 1, int(regs[2])))
    dst = max(0, min(MAX_TIERS - 1, int(regs[3])))
    lo, hi = (src, dst) if src <= dst else (dst, src)
    setup = int(ctx[CTX.MIG_CUM_SETUP_T0 + hi]) \
        - int(ctx[CTX.MIG_CUM_SETUP_T0 + lo])
    per_block = int(ctx[CTX.MIG_CUM_NS_T0 + hi]) \
        - int(ctx[CTX.MIG_CUM_NS_T0 + lo])
    return setup + per_block * (4 ** order)


HELPERS: dict[int, Callable] = {
    HELPER_KTIME: _helper_ktime,
    HELPER_TRACE: _helper_trace,
    HELPER_PROMOTION_COST: _helper_promotion_cost,
    HELPER_MIGRATE_COST: _helper_migrate_cost,
    HELPER_RINGBUF_OUTPUT: _helper_ringbuf_output,
}
HELPER_IDS = frozenset(HELPERS.keys())


class VMFault(Exception):
    """Runtime fault — should be unreachable for verified programs."""


@dataclass
class RunResult:
    ret: int
    steps: int
    trace: list                                 # EV_PROG_TRACE payloads (r1)
    events: list = field(default_factory=list)  # this run's (ts, tag, a0, a1, a2)
    dropped: int = 0                            # slot-budget drops this run


class PolicyVM:
    """Executes a verified Program against a ctx vector + map registry.

    The program is lowered ONCE at attach time (:func:`repro.core.lower.
    lower` — the same pass the compiled backends consume), so the run loop
    walks absolute branch targets and resolved map slots."""

    def __init__(self, program: Program, maps: MapRegistry | None = None) -> None:
        from .lower import lower    # late: lower imports jax lazily-heavy deps
        self.maps = maps if maps is not None else MapRegistry()
        self.lowered = lower(program, self.maps, helper_ids=HELPER_IDS)
        self.facts = self.lowered.facts
        self.program = program
        self.helper_state = HelperState(rb_cap=self.facts.get("rb_cap", 0))

    def run(self, ctx: np.ndarray) -> RunResult:
        insns = self.lowered.insns
        hs = self.helper_state
        if hs.rb_cap:
            hs.rb_events = []
        drops0 = hs.rb_drops
        regs = [0] * NUM_REGS
        pc = 0
        fuel = self.facts["max_steps"] + 8
        steps = 0
        n = len(insns)
        ctx_hi = CTX_LEN - 1
        while True:
            if steps >= fuel:
                raise VMFault("fuel exhausted — verifier bound violated (bug)")
            if not (0 <= pc < n):
                raise VMFault(f"pc out of bounds: {pc}")
            insn = insns[pc]
            op = insn.op
            steps += 1

            if op in ALU_REG_OPS:
                a, b = regs[insn.dst], regs[insn.src]
                regs[insn.dst] = _alu(op, a, b)
                pc += 1
            elif op in ALU_IMM_OPS:
                if op == Op.MOVI:
                    regs[insn.dst] = _wrap64(insn.imm)
                else:
                    regs[insn.dst] = _alu(_IMM2REG[op], regs[insn.dst], insn.imm)
                pc += 1
            elif op == Op.NEG:
                regs[insn.dst] = _wrap64(-regs[insn.dst])
                pc += 1
            elif op == Op.LDCTX:
                regs[insn.dst] = int(ctx[insn.imm])
                pc += 1
            elif op == Op.LDCTXR:
                regs[insn.dst] = int(ctx[max(0, min(regs[insn.src], ctx_hi))])
                pc += 1
            elif op == Op.LDMAP:
                regs[insn.dst] = self.maps[insn.imm].lookup(regs[insn.src])
                pc += 1
            elif op == Op.LDMAPX:
                mid = max(0, min(regs[insn.src2], len(self.maps) - 1))
                regs[insn.dst] = self.maps[mid].lookup(regs[insn.src])
                pc += 1
            elif op == Op.MAPSZ:
                regs[insn.dst] = len(self.maps[insn.imm])
                pc += 1
            elif op == Op.JA:
                pc = insn.target
            elif op in COND_JUMP_REG:
                taken = _cmp(op, regs[insn.dst], regs[insn.src])
                pc = insn.target if taken else pc + 1
            elif op in COND_JUMP_IMM:
                taken = _cmp(_JIMM2REG[op], regs[insn.dst], insn.src2)
                pc = insn.target if taken else pc + 1
            elif op == Op.JNZDEC:
                regs[insn.dst] = _wrap64(regs[insn.dst] - 1)
                pc = insn.target if regs[insn.dst] != 0 else pc + 1
            elif op == Op.CALL:
                regs[0] = _wrap64(int(HELPERS[insn.imm](regs, ctx, self.helper_state)))
                pc += 1
            elif op == Op.EXIT:
                ev = hs.rb_events
                return RunResult(
                    regs[0], steps,
                    [e[2] for e in ev if e[1] == EV_PROG_TRACE] if ev else [],
                    ev, hs.rb_drops - drops0)
            else:
                raise VMFault(f"unhandled opcode {op!r}")


def _alu(op: Op, a: int, b: int) -> int:
    if op == Op.MOV:
        return b
    if op == Op.ADD:
        return _wrap64(a + b)
    if op == Op.SUB:
        return _wrap64(a - b)
    if op == Op.MUL:
        return _wrap64(a * b)
    if op == Op.DIV:
        if b == 0:
            return 0
        # eBPF divide is unsigned on the bit pattern; we use truncated signed
        # division toward zero which matches C semantics for the s64 ALU.
        q = abs(a) // abs(b)
        return _wrap64(-q if (a < 0) != (b < 0) else q)
    if op == Op.MOD:
        if b == 0:
            return a
        r = abs(a) % abs(b)
        return _wrap64(-r if a < 0 else r)
    if op == Op.AND:
        return _wrap64(a & b)
    if op == Op.OR:
        return _wrap64(a | b)
    if op == Op.XOR:
        return _wrap64(a ^ b)
    if op == Op.LSH:
        return _wrap64(a << (b & 63))
    if op == Op.RSH:
        return _wrap64((a & ((1 << 64) - 1)) >> (b & 63))
    if op == Op.MIN:
        return min(a, b)
    if op == Op.MAX:
        return max(a, b)
    raise VMFault(f"bad ALU op {op!r}")


def _cmp(op: Op, a: int, b: int) -> bool:
    if op == Op.JEQ:
        return a == b
    if op == Op.JNE:
        return a != b
    if op == Op.JLT:
        return a < b
    if op == Op.JLE:
        return a <= b
    if op == Op.JGT:
        return a > b
    if op == Op.JGE:
        return a >= b
    if op == Op.JSET:
        return (a & b) != 0
    raise VMFault(f"bad cmp op {op!r}")


_IMM2REG = {
    Op.ADDI: Op.ADD, Op.SUBI: Op.SUB, Op.MULI: Op.MUL, Op.DIVI: Op.DIV,
    Op.MODI: Op.MOD, Op.ANDI: Op.AND, Op.ORI: Op.OR, Op.XORI: Op.XOR,
    Op.LSHI: Op.LSH, Op.RSHI: Op.RSH, Op.MINI: Op.MIN, Op.MAXI: Op.MAX,
}
_JIMM2REG = {
    Op.JEQI: Op.JEQ, Op.JNEI: Op.JNE, Op.JLTI: Op.JLT, Op.JLEI: Op.JLE,
    Op.JGTI: Op.JGT, Op.JGEI: Op.JGE, Op.JSETI: Op.JSET,
}
