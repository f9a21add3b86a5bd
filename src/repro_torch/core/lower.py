"""Shared lowering pass: verified bytecode -> the flat IR the interpreter runs.

The IR half of ``repro.core.lower``: :func:`lower` runs the verifier ONCE
and emits a :class:`LoweredProgram` of :class:`LIns` — branch targets
resolved to ABSOLUTE pcs, map slots normalized into ``imm``, ctx offsets
validated.  :class:`~repro_torch.core.vm.PolicyVM` lowers at construction
and walks this IR.

The reference module also holds the verifier-bounded unroll, the segment
cut points and the jnp per-op bodies of its batched XLA executors; those
belong to the batched policy executor, which this package does not port
yet (ROADMAP, "Modules still to port", item 5).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .context import CTX_LEN, MAX_TIERS
from .isa import JUMP_OPS, Op, Program
from .verifier import verify

# Bump when the IR layout or any lowering semantics change: the artifact
# cache (core.cache) folds this into every digest so stale on-disk pickles
# can never be misread by a newer pipeline.
# v2: ring-buffer helpers (HELPER_TRACE / bpf_ringbuf_output) lower to real
# per-lane event-slot writes instead of a device no-op.
IR_VERSION = 2

# Hard per-invocation per-lane event-slot budget.  The exact worst case is
# computed from the verifier's loop trip counts per program; this clamp
# bounds the threaded device buffer for emit-heavy loops (drops past it are
# counted, identically on every executor).
RB_MAX_PER_RUN = 64


@dataclass(frozen=True)
class LIns:
    """One lowered instruction.

    Field use per op class (everything irrelevant is 0 / -1):

    ======================  ====================================================
    ALU reg/imm, NEG        ``dst``, ``src`` / ``imm``
    LDCTX                   ``dst``, ``imm`` = validated ctx offset
    LDCTXR                  ``dst``, ``src`` = index register
    LDMAP                   ``dst``, ``src`` = index reg, ``imm`` = map SLOT
    LDMAPX                  ``dst``, ``src`` = index reg, ``src2`` = map-id reg
    MAPSZ                   ``dst``, ``imm`` = map SLOT
    JA                      ``target`` (absolute)
    cond jumps              ``dst``(lhs), ``src``(rhs reg) / ``src2``(rhs imm),
                            ``target`` = absolute taken-pc
    JNZDEC                  ``dst`` = counter, ``target`` = absolute loop head
    CALL                    ``imm`` = helper id
    EXIT                    —
    ======================  ====================================================
    """
    op: Op
    dst: int = 0
    src: int = 0
    imm: int = 0
    src2: int = 0
    target: int = -1


@dataclass(frozen=True)
class LoweredProgram:
    """The verified, resolved program every backend consumes."""
    name: str
    insns: tuple[LIns, ...]
    facts: dict            # verifier facts; loop_trips keyed by lowered pc
    num_maps: int
    map_caps: tuple[int, ...]     # registered map capacities (shape contract)
    source_len: int

    def digest(self) -> str:
        """Stable content hash — the artifact-cache key component.

        Covers the instruction stream, the map-registry SHAPE contract
        (slot count + capacities; map *contents* are runtime data), the ctx
        layout width (so a ctx-struct change invalidates old artifacts) and
        the IR version."""
        h = hashlib.sha256()
        h.update(f"ir{IR_VERSION}:ctx{CTX_LEN}:tiers{MAX_TIERS}:"
                 f"maps{self.num_maps}:{self.map_caps}:".encode())
        for i in self.insns:
            h.update(f"{int(i.op)},{i.dst},{i.src},{i.imm},{i.src2},"
                     f"{i.target};".encode())
        return h.hexdigest()


def _rb_capacity(program: Program, facts: dict) -> int:
    """Worst-case ring-buffer emissions of ONE invocation: every CALL to an
    emitting helper weighted by its loop's verifier-proven trip count (loops
    are non-nested, so one weight per site), clamped to RB_MAX_PER_RUN.
    This is the static size of the per-lane slot buffer each executor
    threads — and 0 for the (default) programs that never emit, which is
    what keeps the no-telemetry fast path's traced computations unchanged."""
    from .vm import RB_HELPERS          # late: vm imports this module's peer
    insns = program.insns
    loops = [(pc + 1 + insn.imm, pc, trips)      # (body start, back edge, n)
             for pc, insn in enumerate(insns) if insn.op == Op.JNZDEC
             for trips in (facts.get("loop_trips", {}).get(pc, 1),)]
    total = 0
    for pc, insn in enumerate(insns):
        if insn.op == Op.CALL and insn.imm in RB_HELPERS:
            weight = 1
            for t, j, trips in loops:
                if t <= pc < j:
                    weight = trips
                    break
            total += weight
    return min(total, RB_MAX_PER_RUN)


def lower(program: Program, maps, *, helper_ids=None) -> LoweredProgram:
    """Verify ``program`` once and lower it to the shared flat IR."""
    if helper_ids is None:
        from .vm import HELPER_IDS      # late: vm imports verifier only
        helper_ids = HELPER_IDS
    facts = verify(program, num_maps=len(maps), map_lens=maps.lens(),
                   helper_ids=helper_ids)
    facts["rb_cap"] = _rb_capacity(program, facts)
    out: list[LIns] = []
    for pc, insn in enumerate(program.insns):
        op = insn.op
        if op in JUMP_OPS or op == Op.JNZDEC:
            out.append(LIns(op, insn.dst, insn.src, 0, insn.src2,
                            target=pc + 1 + insn.imm))
        elif op == Op.LDMAP:
            # raw form carries the map id in src2; normalize into imm so the
            # backends read one field for the resolved slot
            out.append(LIns(op, insn.dst, insn.src, imm=insn.src2))
        else:
            out.append(LIns(op, insn.dst, insn.src, insn.imm, insn.src2))
    caps = tuple(maps[i].capacity for i in range(len(maps)))
    return LoweredProgram(name=program.name, insns=tuple(out), facts=facts,
                          num_maps=len(maps), map_caps=caps,
                          source_len=len(program.insns))
