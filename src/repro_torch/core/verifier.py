"""Load-time static verifier for policy programs.

Mirrors the guarantees the in-kernel eBPF verifier gives the paper's
mechanism: a loaded program provably terminates, never reads uninitialized
registers, never accesses out-of-bounds context fields, only references
registered maps and white-listed helpers, and returns a value on every path.

The analysis is a conservative abstract interpretation over the CFG:
  * registers carry an abstract state {UNINIT, INIT, CONST(c)};
  * conditional jumps fork the state; join = field-wise meet;
  * JNZDEC loops must have a const-tracked counter <= MAX_LOOP_ITERS and the
    loop body may not write the counter (other than the JNZDEC itself) —
    which bounds every cycle in the CFG and hence total execution length.
"""

from __future__ import annotations

from dataclasses import dataclass

from .context import CTX_LEN
from .isa import (ALU_IMM_OPS, ALU_REG_OPS, COND_JUMP_IMM, COND_JUMP_REG,
                  MAX_LOOP_ITERS, MAX_PROGRAM_LEN, MAX_SIM_INSNS, NUM_REGS,
                  Insn, Op, Program)

UNINIT = "uninit"
INIT = "init"


class VerifierError(Exception):
    """Program rejected at load time."""


@dataclass
class _RegState:
    # value: UNINIT | INIT | ("const", c)
    vals: list

    def copy(self) -> "_RegState":
        return _RegState(list(self.vals))

    def meet(self, other: "_RegState") -> tuple["_RegState", bool]:
        changed = False
        out = []
        for a, b in zip(self.vals, other.vals):
            if a == b:
                out.append(a)
            elif a == UNINIT or b == UNINIT:
                out.append(UNINIT)
                changed = changed or (a != UNINIT)
            else:  # const vs const / const vs init -> init
                out.append(INIT)
                changed = changed or (a != INIT)
        return _RegState(out), changed


def verify(program: Program, *, num_maps: int = 0, map_lens: list[int] | None = None,
           helper_ids: frozenset[int] = frozenset()) -> dict:
    """Verify ``program``; raise VerifierError on rejection.

    Returns a dict of facts useful to the JIT: {"max_steps": int}.
    """
    insns = program.insns
    n = len(insns)
    if n == 0:
        raise VerifierError("empty program")
    if n > MAX_PROGRAM_LEN:
        raise VerifierError(f"program too long: {n} > {MAX_PROGRAM_LEN}")

    # ---- structural checks ------------------------------------------------
    loop_headers: dict[int, int] = {}   # jnzdec pc -> loop target pc
    for pc, insn in enumerate(insns):
        if not isinstance(insn.op, Op):
            raise VerifierError(f"{pc}: unknown opcode {insn.op}")
        if not (0 <= insn.dst < NUM_REGS and 0 <= insn.src < NUM_REGS):
            raise VerifierError(f"{pc}: register out of range in {insn!r}")
        if insn.op in (Op.JA,) or insn.op in COND_JUMP_REG or insn.op in COND_JUMP_IMM:
            tgt = pc + 1 + insn.imm
            if insn.imm < 0:
                raise VerifierError(f"{pc}: backward jump only allowed via JNZDEC")
            if not (0 <= tgt < n):
                raise VerifierError(f"{pc}: jump target {tgt} out of bounds")
        elif insn.op == Op.JNZDEC:
            tgt = pc + 1 + insn.imm
            if insn.imm >= 0:
                raise VerifierError(f"{pc}: JNZDEC must jump backward")
            if not (0 <= tgt < n):
                raise VerifierError(f"{pc}: JNZDEC target {tgt} out of bounds")
            loop_headers[pc] = tgt
        elif insn.op == Op.LDCTX:
            if not (0 <= insn.imm < CTX_LEN):
                raise VerifierError(f"{pc}: ctx offset {insn.imm} out of bounds [0,{CTX_LEN})")
        elif insn.op == Op.LDCTXR:
            if not (0 <= insn.src < NUM_REGS):
                raise VerifierError(f"{pc}: bad index register in LDCTXR")
        elif insn.op == Op.LDMAP:
            if not (0 <= insn.src2 < num_maps):
                raise VerifierError(f"{pc}: map id {insn.src2} not registered")
        elif insn.op == Op.LDMAPX:
            if num_maps < 1:
                raise VerifierError(f"{pc}: LDMAPX requires >=1 registered map")
            if not (0 <= insn.src2 < NUM_REGS):
                raise VerifierError(f"{pc}: bad map register in LDMAPX")
        elif insn.op == Op.MAPSZ:
            if not (0 <= insn.imm < num_maps):
                raise VerifierError(f"{pc}: map id {insn.imm} not registered")
        elif insn.op == Op.CALL:
            if insn.imm not in helper_ids:
                raise VerifierError(f"{pc}: helper {insn.imm} not white-listed")
        elif insn.op in (Op.DIVI, Op.MODI):
            if insn.imm == 0:
                raise VerifierError(f"{pc}: division by immediate zero")

    if insns[-1].op not in (Op.EXIT, Op.JA):
        # last insn must not fall off the end
        if not (insns[-1].op == Op.JNZDEC):
            raise VerifierError("program may fall off the end (last insn not EXIT)")

    # ---- loop bounding ------------------------------------------------------
    # For each JNZDEC at pc with target t: the counter register must be
    # const-assigned (MOVI) on every path reaching t, with value <= MAX_LOOP_ITERS,
    # and no instruction in [t, pc) may write the counter.
    for pc, tgt in loop_headers.items():
        counter = insns[pc].dst
        for body_pc in range(tgt, pc):
            b = insns[body_pc]
            writes = _written_reg(b)
            if writes == counter:
                raise VerifierError(
                    f"{pc}: loop body (pc {body_pc}) writes JNZDEC counter r{counter}")
            if b.op == Op.JNZDEC:
                raise VerifierError(f"{pc}: nested JNZDEC loops are not allowed")

    # ---- dataflow: reachability + init/const tracking ----------------------
    loop_trips: dict[int, int] = {}     # jnzdec pc -> exact trip count
    start = _RegState([UNINIT] * NUM_REGS)
    states: dict[int, _RegState] = {0: start}
    work = [0]
    visited_exit = False
    visits = 0
    while work:
        pc = work.pop()
        visits += 1
        if visits > 20 * n + 1000:
            raise VerifierError("verifier state explosion (CFG too complex)")
        st = states[pc].copy()
        insn = insns[pc]
        succs: list[int] = []

        def read(r: int) -> None:
            if st.vals[r] == UNINIT:
                raise VerifierError(f"{pc}: read of uninitialized register r{r} in {insn!r}")

        op = insn.op
        if op in ALU_REG_OPS:
            if op != Op.MOV:
                read(insn.dst)
            read(insn.src)
            st.vals[insn.dst] = INIT
            if op == Op.MOV and isinstance(states[pc].vals[insn.src], tuple):
                st.vals[insn.dst] = states[pc].vals[insn.src]
            succs = [pc + 1]
        elif op in ALU_IMM_OPS:
            if op == Op.MOVI:
                st.vals[insn.dst] = ("const", insn.imm)
            else:
                read(insn.dst)
                st.vals[insn.dst] = INIT
            succs = [pc + 1]
        elif op == Op.NEG:
            read(insn.dst)
            st.vals[insn.dst] = INIT
            succs = [pc + 1]
        elif op in (Op.LDCTX, Op.MAPSZ):
            st.vals[insn.dst] = INIT
            succs = [pc + 1]
        elif op == Op.LDMAP:
            read(insn.src)
            st.vals[insn.dst] = INIT
            succs = [pc + 1]
        elif op == Op.LDCTXR:
            # the index register must be provably initialized, and a
            # verifier-tracked constant index must be inside the ctx struct
            # (the analogue of the kernel verifier's ctx bounds check); a
            # non-const index is runtime-clamped identically by every backend
            read(insn.src)
            v = st.vals[insn.src]
            if isinstance(v, tuple) and v[0] == "const" \
                    and not (0 <= v[1] < CTX_LEN):
                raise VerifierError(
                    f"{pc}: LDCTXR index {v[1]} out of ctx bounds [0,{CTX_LEN})")
            st.vals[insn.dst] = INIT
            succs = [pc + 1]
        elif op == Op.LDMAPX:
            read(insn.src)
            read(insn.src2)
            st.vals[insn.dst] = INIT
            succs = [pc + 1]
        elif op == Op.JA:
            succs = [pc + 1 + insn.imm]
        elif op in COND_JUMP_REG:
            read(insn.dst)
            read(insn.src)
            succs = [pc + 1, pc + 1 + insn.imm]
        elif op in COND_JUMP_IMM:
            read(insn.dst)
            succs = [pc + 1, pc + 1 + insn.imm]
        elif op == Op.JNZDEC:
            read(insn.dst)
            v = states[pc].vals[insn.dst]
            if not (isinstance(v, tuple) and v[0] == "const"):
                raise VerifierError(
                    f"{pc}: JNZDEC counter r{insn.dst} is not a verifier-tracked "
                    f"constant at loop entry")
            if not (0 < v[1] <= MAX_LOOP_ITERS):
                raise VerifierError(
                    f"{pc}: JNZDEC trip count {v[1]} outside (0, {MAX_LOOP_ITERS}]")
            loop_trips[pc] = v[1]
            st.vals[insn.dst] = ("const", v[1])  # keep const through iterations
            # back edge: state at target must already subsume; we only follow
            # the fall-through to keep the fixpoint finite (counter is const
            # and the body cannot write it, so the body state is stable).
            succs = [pc + 1]
        elif op == Op.CALL:
            # helpers read r1..r5 as needed (treated as may-read: require r1 init
            # is too strict for nullary helpers; we require nothing, helpers are
            # total functions) and write r0.
            st.vals[0] = INIT
            succs = [pc + 1]
        elif op == Op.EXIT:
            read(0)
            visited_exit = True
            succs = []
        else:
            raise VerifierError(f"{pc}: unhandled opcode {op!r}")

        for s in succs:
            if s >= n:
                raise VerifierError(f"{pc}: control falls off the end of the program")
            if s not in states:
                states[s] = st.copy()
                work.append(s)
            else:
                merged, changed = states[s].meet(st)
                if changed:
                    states[s] = merged
                    work.append(s)

    if not visited_exit:
        raise VerifierError("no reachable EXIT")

    # ---- worst-case step bound ---------------------------------------------
    # Straight-line length + every loop body re-executed (bound-1) more times.
    max_steps = n
    for pc, tgt in loop_headers.items():
        body = pc - tgt + 1
        max_steps += body * MAX_LOOP_ITERS
    if max_steps > MAX_SIM_INSNS:
        raise VerifierError(f"worst-case instruction count {max_steps} > {MAX_SIM_INSNS}")

    return {"max_steps": max_steps, "num_loops": len(loop_headers),
            "loop_trips": loop_trips}


def _written_reg(insn: Insn) -> int | None:
    if insn.op in ALU_REG_OPS or insn.op in ALU_IMM_OPS or insn.op in (
            Op.NEG, Op.LDCTX, Op.LDCTXR, Op.LDMAP, Op.LDMAPX, Op.MAPSZ):
        return insn.dst
    if insn.op == Op.CALL:
        return 0
    return None
