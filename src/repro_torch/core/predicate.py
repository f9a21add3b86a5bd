"""Predicated executor: verified policy program -> straight-line masked
int64 torch ops over the fault batch.

The counterpart of ``repro.core.predicate``.  The verifier's guarantees
make a branch-free batch executor possible:

  1. bounded-loop UNROLLING — JNZDEC trip counts are verifier-proven exact
     constants, so every loop expands to exactly ``trips`` copies of its
     body (:func:`repro_torch.core.lower.unroll_lowered`); the result has
     only FORWARD jumps;
  2. IF-CONVERSION — forward-jump-only code executes as one straight line
     with a per-lane active mask: conditional jumps move lanes into a
     pending mask at their target, register writes are
     ``where(active, ...)``.

Every instruction is a few elementwise ops over ``[N]`` int64 lanes on the
executor's device; there is no data-dependent host control flow, so a CUDA
batch runs as a stream of launches with one host sync: the decisions (and
ring events) coming back to the caller.

The reference splits long unrolls into chained segments and fuses
congruent loop copies into scan stages, because those are the shapes XLA
compiles; eager torch issues the same op per instruction either way, so
the port walks the whole forward-only unroll as one span.  The planners
(:func:`~repro_torch.core.lower.segment_code`,
:func:`~repro_torch.core.lower.plan_scan_stages`) stay in ``lower`` and
are held to the reference's plans by the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .isa import (ALU_IMM_OPS, ALU_REG_OPS, COND_JUMP_IMM, COND_JUMP_REG,
                  NUM_REGS, Op, Program)
from .lower import (I64, RB_FIELDS, BatchCtx, LIns, LoweredProgram, alu_t,
                    cmp_t, collect_rb_events, exec_device, helper_t,
                    ldctx_dyn, lower, map_lookup, map_lookup_dyn, rb_words,
                    unroll_lowered)
from .maps import MapRegistry
from .vm import _IMM2REG, _JIMM2REG, RB_HELPERS


def unroll(program: Program | LoweredProgram, maps: MapRegistry
           ) -> tuple[LIns, ...]:
    """Flatten all bounded loops; returns the forward-only lowered code."""
    lp = program if isinstance(program, LoweredProgram) else \
        lower(program, maps)
    code, _cuts = unroll_lowered(lp)
    return code


class _Machine:
    """The per-batch machine state: registers, the done mask, the final r0
    and (for emitting programs) the per-lane ring-event buffers."""
    __slots__ = ("regs", "done", "r0", "ev", "ecnt", "edrop")

    def __init__(self, B: int, device, rb_cap: int):
        z = torch.zeros(B, dtype=I64, device=device)
        self.regs = [z] * NUM_REGS
        self.done = torch.zeros(B, dtype=torch.bool, device=device)
        self.r0 = z
        self.ev = self.ecnt = self.edrop = None
        if rb_cap:
            self.ev = torch.zeros((B, rb_cap, RB_FIELDS), dtype=I64,
                                  device=device)
            self.ecnt = z.clone()
            self.edrop = z.clone()


def _or_into(pending: dict, target: int, mask) -> None:
    cur = pending.get(target)
    pending[target] = mask if cur is None else cur | mask


def _exec(code: tuple[LIns, ...], cv: BatchCtx, map_arrays, map_lens,
          st: _Machine, rb_cap: int) -> None:
    """Execute the forward-only ``code`` predicated, in place on ``st``.
    ``pending`` maps a jump-target pc to the lanes waiting for it; each is
    consumed as the walk passes its target."""
    regs = st.regs
    active = torch.ones_like(st.done)
    pending: dict = {}
    K = cv.const

    def write(dst, val):
        regs[dst] = torch.where(active, val, regs[dst])

    for pc, insn in enumerate(code):
        if pc in pending:
            active = active | pending.pop(pc)
        op = insn.op
        if op in ALU_REG_OPS:
            write(insn.dst, alu_t(op, regs[insn.dst], regs[insn.src]))
        elif op in ALU_IMM_OPS:
            if op == Op.MOVI:
                write(insn.dst, K(insn.imm))
            else:
                write(insn.dst, alu_t(_IMM2REG[op], regs[insn.dst],
                                      K(insn.imm)))
        elif op == Op.NEG:
            write(insn.dst, -regs[insn.dst])
        elif op == Op.LDCTX:
            write(insn.dst, cv.col(insn.imm))
        elif op == Op.LDCTXR:
            write(insn.dst, ldctx_dyn(cv, regs[insn.src]))
        elif op == Op.LDMAP:
            write(insn.dst, map_lookup(map_arrays, map_lens, insn.imm,
                                       regs[insn.src]))
        elif op == Op.LDMAPX:
            write(insn.dst, map_lookup_dyn(map_arrays, map_lens,
                                           regs[insn.src2], regs[insn.src],
                                           cv.zeros_like_lane()))
        elif op == Op.MAPSZ:
            write(insn.dst, map_lens[insn.imm])
        elif op == Op.JA:
            _or_into(pending, insn.target, active)
            active = torch.zeros_like(active)
        elif op in COND_JUMP_REG or op in COND_JUMP_IMM:
            if op in COND_JUMP_REG:
                taken = cmp_t(op, regs[insn.dst], regs[insn.src])
            else:
                taken = cmp_t(_JIMM2REG[op], regs[insn.dst], K(insn.src2))
            taken = taken & active
            _or_into(pending, insn.target, taken)
            active = active & ~taken
        elif op == Op.CALL:
            if rb_cap and insn.imm in RB_HELPERS:
                words = rb_words(insn.imm, lambda i: regs[i], cv)
                st.ev, st.ecnt, st.edrop, r0 = cv.event_write(
                    st.ev, st.ecnt, st.edrop, words, active)
            else:
                r0 = helper_t(insn.imm, lambda i: regs[i], cv)
            write(0, r0)
        elif op == Op.EXIT:
            st.r0 = torch.where(active & ~st.done, regs[0], st.r0)
            st.done = st.done | active
            active = torch.zeros_like(active)
        else:   # pragma: no cover
            raise ValueError(f"unhandled opcode {op}")
    assert not pending, f"unconsumed jump targets {sorted(pending)}"


class PredicatedPolicy:
    """Batch fault-decision executor (the engine's default batch route)."""

    def __init__(self, program: Program | LoweredProgram, maps: MapRegistry,
                 code=None, device=None) -> None:
        self.maps = maps
        self.device = exec_device(device)
        lp = program if isinstance(program, LoweredProgram) else \
            lower(program, maps)
        # code: the unroll of ``lp`` when the caller already has it (the
        # hook registry reads it from the artifact cache)
        self.code = code if code is not None else \
            unroll_lowered(lp)[0]               # ValueError if too long
        self.unrolled_len = len(self.code)
        self.rb_cap = int(lp.facts.get("rb_cap", 0))
        self._last_rb: tuple | None = None     # (ev, cnt, drops) numpy
        self._map_cache: tuple | None = None   # (version, arrays, lens)
        self._consts: dict = {}                # 0-d device constants

    def _map_args(self):
        ver = self.maps.version()
        if self._map_cache is None or self._map_cache[0] != ver:
            dev = self.device
            arrays = tuple(
                torch.from_numpy(np.ascontiguousarray(
                    self.maps[i].live_array(), dtype=np.int64)).to(dev)
                for i in range(len(self.maps)))
            lens = torch.tensor(self.maps.lens(), dtype=I64, device=dev)
            if not arrays:
                arrays = (torch.zeros(1, dtype=I64, device=dev),)
                lens = torch.zeros(1, dtype=I64, device=dev)
            self._map_cache = (ver, arrays, lens)
        return self._map_cache[1], self._map_cache[2]

    def run_batch_device(self, ctx: torch.Tensor) -> torch.Tensor:
        """Decisions for a ``[B, CTX_LEN]`` int64 ctx already on the
        executor's device; returns ``[B]`` int64 on that device without a
        host sync (ring buffers stay on the device in ``_last_rb``)."""
        if ctx.device != self.device:
            raise ValueError(f"ctx on {ctx.device}, executor on "
                             f"{self.device}")
        arrays, lens = self._map_args()
        cv = BatchCtx(ctx, self._consts)
        st = _Machine(ctx.shape[0], self.device, self.rb_cap)
        _exec(self.code, cv, arrays, lens, st, self.rb_cap)
        if self.rb_cap:
            self._last_rb = (st.ev, st.ecnt, st.edrop)
        return st.r0

    def run_batch(self, ctx_mat: np.ndarray) -> np.ndarray:
        """ctx_mat: ``[batch, CTX_LEN]`` -> int64 ``[batch]`` decisions."""
        ctx = torch.from_numpy(np.ascontiguousarray(ctx_mat, dtype=np.int64))
        out = self.run_batch_device(ctx.to(self.device))
        if self.rb_cap:
            self._last_rb = tuple(t.cpu().numpy() for t in self._last_rb)
        return out.cpu().numpy()

    def take_events(self, n: int) -> tuple[list, int]:
        """Drain the last batch's ring-buffer records for the first ``n``
        lanes (and their slot-drop count); empty until the next batch."""
        if self._last_rb is None:
            return [], 0
        ev, cnt, dr = self._last_rb
        self._last_rb = None
        return collect_rb_events(ev, cnt, dr, n)
