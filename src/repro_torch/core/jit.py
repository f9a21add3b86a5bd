"""Fallback batch executor: a lane-vectorized walk over the program counter.

The counterpart of ``repro.core.jit``, which compiles the lowered IR into a
``lax.while_loop`` over ``lax.switch(pc, ...)`` and vmaps it over the fault
batch.  The hook registry takes this route only for programs whose
flattening exceeds :data:`repro_torch.core.lower.MAX_UNROLLED`, where the
predicated executor cannot unroll them.

Machine state per lane: ``(pc, regs[NUM_REGS], fuel)``.  Each step runs,
for every distinct pc among the still-running lanes, that instruction on
the lanes sitting at it — the JNZDEC loops run as real loops.  Verified
programs terminate within ``max_steps``; the fuel (``max_steps + 8``, as
the reference) bounds the walk all the same.  Its speed does not matter
(one host sync per step); its decisions, ring events and drop counts are
bit-identical to the interpreter's, because every op lowers through the
same :mod:`lower` bodies as the predicated executor.
"""

from __future__ import annotations

import numpy as np
import torch

from .isa import (ALU_IMM_OPS, ALU_REG_OPS, COND_JUMP_IMM, COND_JUMP_REG,
                  NUM_REGS, Op, Program)
from .lower import (I64, RB_FIELDS, BatchCtx, LoweredProgram, alu_t, cmp_t,
                    collect_rb_events, exec_device, helper_t, ldctx_dyn,
                    lower, map_lookup, map_lookup_dyn, rb_words)
from .maps import MapRegistry
from .vm import _IMM2REG, _JIMM2REG, RB_HELPERS


class JitPolicy:
    """Program + its maps, batched execution by pc walk."""

    def __init__(self, program: Program | LoweredProgram, maps: MapRegistry,
                 device=None) -> None:
        self.maps = maps
        self.device = exec_device(device)
        lp = program if isinstance(program, LoweredProgram) else \
            lower(program, maps)
        self.lowered = lp
        self.facts = lp.facts
        self.rb_cap = int(self.facts.get("rb_cap", 0))
        self._last_rb: tuple | None = None
        self._map_cache: tuple | None = None
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

    def _step(self, insn, pc: int, at, cv, arrays, lens, regs, pcs, rb):
        """Execute ``insn`` (at ``pc``) on the lanes of mask ``at``."""
        op = insn.op
        K = cv.const

        def write(dst, val):
            regs[dst] = torch.where(at, val, regs[dst])

        nxt = pc + 1
        if op in ALU_REG_OPS:
            write(insn.dst, alu_t(op, regs[insn.dst], regs[insn.src]))
        elif op in ALU_IMM_OPS:
            write(insn.dst, K(insn.imm) if op == Op.MOVI else
                  alu_t(_IMM2REG[op], regs[insn.dst], K(insn.imm)))
        elif op == Op.NEG:
            write(insn.dst, -regs[insn.dst])
        elif op == Op.LDCTX:
            write(insn.dst, cv.col(insn.imm))
        elif op == Op.LDCTXR:
            write(insn.dst, ldctx_dyn(cv, regs[insn.src]))
        elif op == Op.LDMAP:
            write(insn.dst, map_lookup(arrays, lens, insn.imm,
                                       regs[insn.src]))
        elif op == Op.LDMAPX:
            write(insn.dst, map_lookup_dyn(arrays, lens, regs[insn.src2],
                                           regs[insn.src],
                                           cv.zeros_like_lane()))
        elif op == Op.MAPSZ:
            write(insn.dst, lens[insn.imm])
        elif op == Op.JA:
            nxt = insn.target
        elif op in COND_JUMP_REG or op in COND_JUMP_IMM:
            if op in COND_JUMP_REG:
                taken = cmp_t(op, regs[insn.dst], regs[insn.src])
            else:
                taken = cmp_t(_JIMM2REG[op], regs[insn.dst], K(insn.src2))
            return torch.where(at, torch.where(taken, K(insn.target),
                                               K(pc + 1)), pcs)
        elif op == Op.JNZDEC:
            newv = regs[insn.dst] - 1
            write(insn.dst, newv)
            return torch.where(at, torch.where(newv != 0, K(insn.target),
                                               K(pc + 1)), pcs)
        elif op == Op.CALL:
            if rb is not None and insn.imm in RB_HELPERS:
                words = rb_words(insn.imm, lambda i: regs[i], cv)
                rb[0], rb[1], rb[2], r0 = cv.event_write(
                    rb[0], rb[1], rb[2], words, at)
            else:
                r0 = helper_t(insn.imm, lambda i: regs[i], cv)
            write(0, r0)
        elif op == Op.EXIT:
            nxt = -1                     # halted
        else:   # pragma: no cover
            raise ValueError(f"unhandled opcode {op}")
        return torch.where(at, K(nxt), pcs)

    def run_batch(self, ctx_mat: np.ndarray) -> np.ndarray:
        """ctx_mat: ``[batch, CTX_LEN]`` -> int64 ``[batch]`` decisions."""
        dev = self.device
        ctx = torch.from_numpy(np.ascontiguousarray(
            ctx_mat, dtype=np.int64)).to(dev)
        B = ctx.shape[0]
        arrays, lens = self._map_args()
        cv = BatchCtx(ctx, self._consts)
        insns = self.lowered.insns
        regs = [torch.zeros(B, dtype=I64, device=dev)] * NUM_REGS
        pcs = torch.zeros(B, dtype=I64, device=dev)
        fuel = torch.full((B,), self.facts["max_steps"] + 8, dtype=I64,
                          device=dev)
        rb = None
        if self.rb_cap:
            rb = [torch.zeros((B, self.rb_cap, RB_FIELDS), dtype=I64,
                              device=dev),
                  torch.zeros(B, dtype=I64, device=dev),
                  torch.zeros(B, dtype=I64, device=dev)]
        while True:
            running = (pcs >= 0) & (fuel > 0)
            live = torch.unique(pcs[running]).tolist()
            if not live:
                break
            new_pcs = pcs
            for pc in live:
                at = running & (pcs == pc)
                new_pcs = self._step(insns[pc], pc, at, cv, arrays, lens,
                                     regs, new_pcs, rb)
            pcs = new_pcs
            fuel = fuel - running.to(I64)
        if rb is not None:
            self._last_rb = tuple(t.cpu().numpy() for t in rb)
        return regs[0].cpu().numpy()

    def take_events(self, n: int) -> tuple[list, int]:
        """Drain the last run's ring-buffer records for the first ``n``
        lanes (and their slot-drop count); empty until the next run."""
        if self._last_rb is None:
            return [], 0
        ev, cnt, dr = self._last_rb
        self._last_rb = None
        return collect_rb_events(ev, cnt, dr, n)
