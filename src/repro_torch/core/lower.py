"""Shared lowering pass: verified bytecode -> one flat IR for every executor.

The counterpart of ``repro.core.lower``:

  * :func:`lower` runs the verifier ONCE and emits a :class:`LoweredProgram`
    of :class:`LIns` — branch targets resolved to ABSOLUTE pcs, map slots
    normalized into ``imm``, ctx offsets validated — the only program form
    the executors consume;
  * :func:`unroll_lowered` expands the verifier-bounded loops (trip counts
    come from the verifier facts, not a re-analysis) into forward-only
    straight-line code, recording the loop-copy boundaries the segmented
    predicated executor cuts at; :func:`plan_scan_stages` and
    :func:`segment_code` plan its stages and segments;
  * the int64 torch per-op bodies (:func:`alu_t`, :func:`cmp_t`,
    :func:`ldctx_dyn`, :func:`map_lookup`, :func:`map_lookup_dyn`,
    :func:`helper_t`) are written once against a :class:`BatchCtx` lane
    view, so the predicated executor (:mod:`predicate`) and the pc-walking
    fallback (:mod:`jit`) lower every opcode through the same code.

The host interpreter (:mod:`vm`) shares the IR and keeps its scalar Python
helper bodies.  torch has no usable ``uint64``, so the logical right shift
is written on int64 with a mask (:func:`alu_t`).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..obs.ringbuf import EV_PROG_TRACE
from .context import CTX, CTX_LEN, MAX_TIERS
from .isa import JUMP_OPS, Op, Program
from .verifier import verify

I64 = torch.int64
INT64_MAX = (1 << 63) - 1

# Hard cap on the flattened (all loops expanded) program length — a backstop
# far above any real policy; longer programs run on the pc-walking fallback.
MAX_UNROLLED = 20_000

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

# Ring-buffer event record width: (ts, tag, a0, a1, a2), all int64.
RB_FIELDS = 5


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


# ---------------------------------------------------------------------------
# Loop flattening (verifier-bounded unroll) over the lowered IR
# ---------------------------------------------------------------------------

def _retarget(ins: LIns, tgt: int) -> LIns:
    return LIns(ins.op, ins.dst, ins.src, ins.imm, ins.src2, tgt)


def _expand_one(insns: list[LIns], cuts: list[int], t: int, j: int,
                trips: int) -> tuple[list[LIns], list[int]]:
    """Expand the JNZDEC loop body ``[t, j)`` (back edge at ``j``) into
    ``trips`` copies, each closed by the faithful counter SUBI; remap every
    absolute target; shift the recorded cut points past the loop."""
    body = insns[t:j]
    counter = insns[j].dst
    blen = len(body) + 1
    shift = trips * blen - (j - t + 1)

    def remap(tgt: int, copy: int) -> int:
        if tgt < t:
            return tgt
        if t <= tgt < j:
            return t + copy * blen + (tgt - t)
        if tgt == j:        # "continue": this copy's counter SUBI
            return t + copy * blen + len(body)
        return tgt + shift  # past the loop

    out: list[LIns] = []
    for ins in insns[:t]:
        out.append(_retarget(ins, remap(ins.target, 0))
                   if ins.target >= 0 else ins)
    for copy in range(trips):
        for ins in body:
            out.append(_retarget(ins, remap(ins.target, copy))
                       if ins.target >= 0 else ins)
        out.append(LIns(Op.SUBI, counter, 0, 1))
    for ins in insns[j + 1:]:
        out.append(_retarget(ins, remap(ins.target, 0))
                   if ins.target >= 0 else ins)
    # cut points: every copy boundary of this loop is a legal segment cut
    # (the original back-edge positions); prior cuts past the loop shift
    new_cuts = [c if c <= t else c + shift for c in cuts]
    new_cuts.extend(t + copy * blen for copy in range(trips + 1))
    return out, sorted(set(new_cuts))


def unroll_lowered(lp: LoweredProgram) -> tuple[tuple[LIns, ...],
                                                tuple[int, ...]]:
    """Flatten every verifier-bounded loop; returns ``(code, cut_points)``.

    ``code`` is forward-jump-only straight-line IR; ``cut_points`` are the
    loop-copy (back-edge) boundaries, the positions the segmented predicated
    compiler prefers to split at.  Trip counts come from the verifier facts
    of the SINGLE :func:`lower` pass — no re-verification per expansion.
    Raises ``ValueError`` when the flattened form exceeds ``MAX_UNROLLED``.
    """
    insns = list(lp.insns)
    trips_by_pc = dict(lp.facts.get("loop_trips", {}))
    # expand LAST loop first: earlier loop positions (and their trip keys)
    # stay valid because nothing before the expanded span moves
    loops = sorted((pc for pc, ins in enumerate(insns)
                    if ins.op == Op.JNZDEC), reverse=True)
    cuts: list[int] = []
    for j in loops:
        t = insns[j].target
        trips = trips_by_pc[j]
        insns, cuts = _expand_one(insns, cuts, t, j, trips)
        if len(insns) > MAX_UNROLLED:
            raise ValueError(f"unrolled program too long ({len(insns)})")
    return tuple(insns), tuple(cuts)


def _spans_congruent(code: tuple[LIns, ...], a: int, b: int,
                     blen: int) -> bool:
    """True when ``code[a:a+blen]`` and ``code[b:b+blen]`` are loop-copy
    congruent: every non-target field identical, and targets either both
    absent, both the SAME relative offset within their copy, or both the
    SAME absolute pc outside both copies (a shared past-loop exit)."""
    for o in range(blen):
        ia, ib = code[a + o], code[b + o]
        if (ia.op, ia.dst, ia.src, ia.imm, ia.src2) != \
                (ib.op, ib.dst, ib.src, ib.imm, ib.src2):
            return False
        ta, tb = ia.target, ib.target
        if (ta < 0) != (tb < 0):
            return False
        if ta < 0:
            continue
        rel = (ta - a == tb - b) and 0 <= ta - a < blen
        absolute = (ta == tb) and ta >= a + blen and tb >= b + blen
        if not (rel or absolute):
            return False
    return True


def plan_scan_stages(code: tuple[LIns, ...], cuts: tuple[int, ...]
                     ) -> tuple[list[tuple], int]:
    """Factor flattened ``code`` into a stage plan for the fused one-dispatch
    executor: maximal runs of CONGRUENT loop copies (the spans between the
    equally-spaced cut points :func:`unroll_lowered` records) collapse to a
    single ``("scan", start, end, trips, blen)`` stage — one copy body,
    run ``trips`` times — and everything else stays verbatim
    ``("plain", start, end)`` stages.

    Returns ``(stages, traced_len)`` where ``traced_len`` is the number of
    instructions the fused executor lowers (each scan run counts one
    copy); it is the budget number a caller compares against its segment
    limit.  A run is rejected (stays plain) unless every copy is congruent
    with the first, no jump from before the run lands inside it anywhere but
    its first pc (a front copy is peeled off into the prologue until that
    holds), and every exit target lands at/after the run end.
    """
    n = len(code)
    cs = sorted({c for c in cuts if 0 <= c <= n})
    runs: list[tuple[int, int, int, int]] = []   # (start, end, trips, blen)
    i = 0
    while i < len(cs) - 1:
        start = cs[i]
        blen = cs[i + 1] - start
        k = i + 1
        while (k + 1 < len(cs) and cs[k + 1] - cs[k] == blen
               and _spans_congruent(code, start, cs[k], blen)):
            k += 1
        trips = k - i
        if trips >= 2 and blen > 0:
            # peel front copies into the plain prologue until no jump from
            # OUTSIDE the run lands strictly inside it (jumps from before a
            # loop can only land in its first copy, so peeling converges)
            while trips >= 2:
                end = start + trips * blen
                bad = [ins.target for pc, ins in enumerate(code)
                       if ins.target >= 0 and not (start <= pc < end)
                       and start < ins.target < end]
                if not bad:
                    break
                if any(t >= start + blen for t in bad):
                    trips = 0      # lands past copy 0: not peelable, reject
                    break
                start += blen
                trips -= 1
            # exits from the copy body must land at/after the run end
            if trips >= 2 and all(
                    ins.target < start + blen or ins.target >= end
                    for ins in code[start:start + blen] if ins.target >= 0):
                runs.append((start, end, trips, blen))
        i = k
    stages: list[tuple] = []
    pos = 0
    for start, end, trips, blen in runs:
        if pos < start:
            stages.append(("plain", pos, start))
        stages.append(("scan", start, end, trips, blen))
        pos = end
    if pos < n:
        stages.append(("plain", pos, n))
    traced = sum((st[4] if st[0] == "scan" else st[2] - st[1])
                 for st in stages)
    return stages, traced


def segment_code(code: tuple[LIns, ...], cuts: tuple[int, ...],
                 limit: int) -> list[tuple[int, int]]:
    """Partition straight-line ``code`` into ``[start, end)`` spans of at most
    ``limit`` insns, cutting at loop-copy boundaries when one is in reach
    (straight-line code may be cut anywhere, so a hard cut is the fallback).
    """
    n = len(code)
    segs: list[tuple[int, int]] = []
    pos = 0
    while pos < n:
        hard = pos + limit
        if n <= hard:
            end = n
        else:
            prefer = [c for c in cuts if pos < c <= hard]
            end = max(prefer) if prefer else hard
        segs.append((pos, end))
        pos = end
    return segs


# ---------------------------------------------------------------------------
# Shared int64 torch per-op lowering (consumed by predicate.py AND jit.py)
# ---------------------------------------------------------------------------

def exec_device(device) -> torch.device:
    """An executor's device, ``None`` meaning CUDA (the engine's
    convention), with the CUDA index made explicit, so it compares equal
    to the device its tensors report.  Raises, naming the CPU option, when
    CUDA is asked for and no GPU is visible."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the batched policy executor runs on CUDA by "
                           "default and no GPU is visible; pass "
                           "device='cpu' to run it on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def alu_t(op: Op, a, b):
    """64-bit ALU body over int64 lanes (``b`` a lane tensor or a 0-d
    tensor).  Mirrors the reference's jnp body and the interpreter's scalar
    ``vm._alu`` bit for bit, wraparound included."""
    if op == Op.MOV:
        return b.expand_as(a)
    if op == Op.ADD:
        return a + b
    if op == Op.SUB:
        return a - b
    if op == Op.MUL:
        return a * b
    if op == Op.DIV:
        # truncated signed division toward zero, x/0 == 0, as the
        # interpreter computes it on Python ints.  A divisor of -1 is a
        # negation (INT64_MIN / -1 wraps to INT64_MIN and must not reach the
        # hardware divide).  The reference's jnp body divides the magnitudes
        # with a floor divide, which differs from its own interpreter when
        # an operand is INT64_MIN (abs wraps); the port follows the
        # interpreter.
        zero = b == 0
        neg1 = b == -1
        den = torch.where(zero | neg1, torch.ones_like(b), b)
        q = torch.div(a, den, rounding_mode="trunc")
        q = torch.where(neg1, -a, q)
        return torch.where(zero, torch.zeros_like(q), q)
    if op == Op.MOD:
        # remainder with the dividend's sign (C's %), x % 0 == x
        zero = b == 0
        den = torch.where(zero | (b == -1), torch.ones_like(b), b)
        r = torch.fmod(a, den)
        return torch.where(zero, a.expand_as(r), r)
    if op == Op.AND:
        return a & b
    if op == Op.OR:
        return a | b
    if op == Op.XOR:
        return a ^ b
    if op == Op.LSH:
        return a << (b & 63)
    if op == Op.RSH:
        # logical shift: the arithmetic shift with the sign-extended top
        # bits masked off (INT64_MAX >> (s - 1) keeps the low 64 - s bits);
        # a shift of 0 is the identity
        s = b & 63
        mask = INT64_MAX >> (s - 1).clamp_min(0)
        return torch.where(s == 0, a, (a >> s) & mask)
    if op == Op.MIN:
        return torch.minimum(a, b)
    if op == Op.MAX:
        return torch.maximum(a, b)
    raise ValueError(f"bad ALU op {op}")


def cmp_t(op: Op, a, b):
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
    raise ValueError(f"bad cmp op {op}")


class BatchCtx:
    """Ctx view over a ``[B, CTX_LEN]`` int64 matrix: every executor of
    this package runs lane-vectorized over the fault batch.  ``consts`` is
    the executor's cache of 0-d device constants, kept across calls so a
    CUDA batch creates none (each would be a host-to-device copy)."""
    __slots__ = ("ctx", "_consts")

    def __init__(self, ctx: torch.Tensor, consts: dict | None = None):
        self.ctx = ctx
        self._consts = {} if consts is None else consts

    def col(self, off: int):
        return self.ctx[:, off]

    def col_dyn(self, idx):
        """ctx[i, idx_i] with a ``[B]`` index vector (callers clamp)."""
        return torch.gather(self.ctx, 1, idx[:, None])[:, 0]

    def const(self, v: int) -> torch.Tensor:
        """A 0-d int64 constant on the ctx's device (cached per view)."""
        t = self._consts.get(v)
        if t is None:
            t = torch.tensor(v, dtype=I64, device=self.ctx.device)
            self._consts[v] = t
        return t

    def zeros_like_lane(self):
        return torch.zeros(self.ctx.shape[0], dtype=I64,
                           device=self.ctx.device)

    def lane(self, v: int):
        """Broadcast a python constant to the lane shape."""
        return torch.full((self.ctx.shape[0],), v, dtype=I64,
                          device=self.ctx.device)

    def event_write(self, events, count, drops, words, fire):
        """One ``bpf_ringbuf_output`` emission per firing lane into its slot
        buffer: ``events [B, cap, RB_FIELDS]``, ``count``/``drops`` ``[B]``,
        ``words`` five ``[B]`` vectors, ``fire`` the per-lane active mask
        (inactive lanes write nothing, count nothing, drop nothing).
        Returns ``(events, count, drops, r0)``: r0 = 0 on success, -1 when
        the slot budget is spent (then drops increments) — bit-identical to
        the interpreter helper."""
        B, cap = events.shape[0], events.shape[1]
        ok = fire & (count < cap)
        idx = count.clamp(0, cap - 1)
        lanes = torch.arange(B, device=events.device)
        row = torch.stack([w.expand(B) for w in words], dim=-1)
        cur = events[lanes, idx]
        events[lanes, idx] = torch.where(ok[:, None], row, cur)
        count = count + ok.to(I64)
        drops = drops + (fire & ~ok).to(I64)
        r0 = torch.where(ok, self.const(0), self.const(-1))
        return events, count, drops, r0


def ldctx_dyn(cv: BatchCtx, idx):
    """The LDCTXR body: bounds-clamped register-indexed ctx read.  The
    verifier already rejected provably-OOB indices; the clamp covers the
    residual dynamic range exactly like the map-op loads do."""
    return cv.col_dyn(idx.clamp(0, CTX_LEN - 1))


def map_lookup(map_arrays, map_lens, slot: int, idx):
    """LDMAP body (static, lowering-resolved slot): bounds-checked lookup,
    out-of-range reads return 0 (missing key)."""
    arr = map_arrays[slot]
    ok = (idx >= 0) & (idx < map_lens[slot])
    safe = idx.clamp(0, arr.shape[0] - 1)
    return torch.where(ok, arr[safe], torch.zeros_like(idx))


def map_lookup_dyn(map_arrays, map_lens, mid, idx, zero):
    """LDMAPX body (map-in-map): the map id is a runtime-clamped register.
    Lowered as a masked accumulation over the registered maps."""
    mid = mid.clamp(0, len(map_arrays) - 1)
    val = zero
    for k, arr in enumerate(map_arrays):
        ok = (idx >= 0) & (idx < map_lens[k]) & (mid == k)
        safe = idx.clamp(0, arr.shape[0] - 1)
        val = torch.where(ok, arr[safe], val)
    return val


def helper_t(helper_id: int, reg, cv: BatchCtx):
    """Helper-call lowering shared by the executors.  ``reg(i)`` reads
    register ``i`` as a ``[B]`` lane vector.  Must mirror the scalar bodies
    in :mod:`vm` bit for bit.  ``4 ** order`` is the shift ``1 << 2*order``
    (order is clamped to [0, 3])."""
    from .vm import (HELPER_KTIME, HELPER_MIGRATE_COST,
                     HELPER_PROMOTION_COST, RB_HELPERS)
    if helper_id == HELPER_KTIME:
        return cv.col(CTX.KTIME_NS)
    if helper_id == HELPER_PROMOTION_COST:
        order = reg(1).clamp(0, 3)
        nblocks = cv.const(1) << (2 * order)
        zero = cv.col(CTX.ZERO_NS_PER_BLOCK) * nblocks
        free = cv.col_dyn(CTX.FREE_BLOCKS_O0 + order)
        frag = cv.col_dyn(CTX.FRAG_O0 + order)
        compact = _floordiv(cv.col(CTX.COMPACT_NS_PER_BLOCK) * nblocks
                            * (1000 + frag), cv.const(1000))
        return zero + torch.where(free > 0, cv.const(0), compact)
    if helper_id == HELPER_MIGRATE_COST:
        order = reg(1).clamp(0, 3)
        nblocks = cv.const(1) << (2 * order)
        src = reg(2).clamp(0, MAX_TIERS - 1)
        dst = reg(3).clamp(0, MAX_TIERS - 1)
        lo = torch.minimum(src, dst)
        hi = torch.maximum(src, dst)
        setup = (cv.col_dyn(CTX.MIG_CUM_SETUP_T0 + hi)
                 - cv.col_dyn(CTX.MIG_CUM_SETUP_T0 + lo))
        per = (cv.col_dyn(CTX.MIG_CUM_NS_T0 + hi)
               - cv.col_dyn(CTX.MIG_CUM_NS_T0 + lo))
        return setup + per * nblocks
    if helper_id in RB_HELPERS:
        # the executors' CALL arms route these through BatchCtx.event_write
        # (they mutate the event buffers, not just r0) — landing here means
        # an executor was miswired
        raise ValueError(f"ring-buffer helper {helper_id} must lower "
                         f"through event_write, not helper_t")
    # any future host-only facility: no-op on the device
    return cv.zeros_like_lane()


def rb_words(helper_id: int, reg, cv: BatchCtx):
    """The 5-word event record of a ring-buffer helper call: ``(ts, tag,
    a0, a1, a2)`` as lane vectors.  ``ts`` is the modeled clock from ctx —
    NOT wall time — so the record is bit-identical to the interpreter's."""
    from .vm import HELPER_TRACE
    ts = cv.col(CTX.KTIME_NS)
    if helper_id == HELPER_TRACE:
        return (ts, cv.lane(EV_PROG_TRACE), reg(1), cv.lane(0), cv.lane(0))
    return (ts, reg(1), reg(2), reg(3), reg(4))


def collect_rb_events(ev, cnt, drop, n: int) -> tuple[list, int]:
    """Host-side drain of an executor's per-lane event buffers: the records
    of the first ``n`` lanes (lane-major, slot order — exactly the order a
    scalar interpreter loop over the same rows appends) plus their summed
    slot-drop count.  ``ev [B, cap, RB_FIELDS]``, ``cnt``/``drop`` ``[B]``.
    """
    ev = np.asarray(ev)
    cnt = np.asarray(cnt)
    drop = np.asarray(drop)
    out: list = []
    for lane in range(min(n, ev.shape[0])):
        k = int(cnt[lane])
        for s in range(k):
            out.append(tuple(int(x) for x in ev[lane, s]))
    return out, int(drop[:n].sum())
