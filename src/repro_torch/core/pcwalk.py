"""The lane-vectorized pc walk over lowered code, in plain PyTorch.

One walk serves two callers: the pc-walking executor's eager body on the
CPU (:class:`repro_torch.core.jit.JitPolicy`, over the looped code) and
the policy-program kernel's plain version
(:func:`repro_torch.kernels.policy_exec.ops.policy_exec_plain`, over
either route's code).  Each step runs, for every distinct pc among the
still-running lanes, that instruction on the lanes sitting at it (one
host sync per step), so JNZDEC loops run as real loops, per lane.  A lane
runs while ``0 <= pc < len(code)`` and its fuel lasts; one that stops
without ``EXIT`` returns its r0 register when ``halt_returns_r0`` (the JIT
route) and 0 otherwise (the predicated route's ``_Machine``).  Every op
lowers through the :mod:`lower` bodies the predicated executor uses, so
decisions, ring events and drops are bit-identical to the interpreter's.
"""

from __future__ import annotations

import torch

from .isa import (ALU_IMM_OPS, ALU_REG_OPS, COND_JUMP_IMM, COND_JUMP_REG,
                  NUM_REGS, Op)
from .lower import (I64, RB_FIELDS, BatchCtx, LIns, alu_t, cmp_t, helper_t,
                    ldctx_dyn, map_lookup, map_lookup_dyn, rb_words)
from .vm import _IMM2REG, _JIMM2REG, RB_HELPERS


def _step(insn: LIns, pc: int, at, cv: BatchCtx, arrays, lens, regs, pcs,
          rb):
    """Execute ``insn`` (at ``pc``) on the lanes of mask ``at``; returns
    the lanes' next pcs."""
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
        write(insn.dst, map_lookup(arrays, lens, insn.imm, regs[insn.src]))
    elif op == Op.LDMAPX:
        write(insn.dst, map_lookup_dyn(arrays, lens, regs[insn.src2],
                                       regs[insn.src], cv.zeros_like_lane()))
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
            rb[0], rb[1], rb[2], r0 = cv.event_write(rb[0], rb[1], rb[2],
                                                     words, at)
        else:
            r0 = helper_t(insn.imm, lambda i: regs[i], cv)
        write(0, r0)
    elif op == Op.EXIT:
        nxt = -1                     # halted
    else:   # pragma: no cover
        raise ValueError(f"unhandled opcode {op}")
    return torch.where(at, K(nxt), pcs)


def pc_walk(code: tuple[LIns, ...], cv: BatchCtx, arrays, lens, *,
            rb_cap: int, fuel: int, halt_returns_r0: bool):
    """Run ``code`` on every lane of ``cv`` against the per-map ``arrays``
    and live ``lens``.  Returns ``(r0 [B], [events [B, rb_cap, 5], count
    [B], drops [B]] or None)``."""
    ctx = cv.ctx
    dev, B, n = ctx.device, ctx.shape[0], len(code)
    zero = torch.zeros(B, dtype=I64, device=dev)
    regs = [zero] * NUM_REGS
    pcs = zero
    left = torch.full((B,), fuel, dtype=I64, device=dev)
    exited = torch.zeros(B, dtype=torch.bool, device=dev)
    rb = None
    if rb_cap:
        rb = [torch.zeros((B, rb_cap, RB_FIELDS), dtype=I64, device=dev),
              zero, zero]
    while True:
        running = (pcs >= 0) & (pcs < n) & (left > 0)
        live = torch.unique(pcs[running]).tolist()
        if not live:
            break
        new_pcs = pcs
        for pc in live:
            at = running & (pcs == pc)
            if code[pc].op == Op.EXIT:
                exited = exited | at
            new_pcs = _step(code[pc], pc, at, cv, arrays, lens, regs,
                            new_pcs, rb)
        pcs = new_pcs
        left = left - running.to(I64)
    r0 = regs[0] if halt_returns_r0 else torch.where(exited, regs[0], zero)
    return r0, rb
