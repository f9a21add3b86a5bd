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

On the CPU every instruction is a few elementwise ops over ``[N]`` int64
lanes (the eager body, :func:`_exec`).  On a CUDA device a batch is ONE
launch of the hand-written kernel ``csrc/policy_exec.cu``
(:mod:`repro_torch.kernels.policy_exec`), which runs the same unroll per
lane from a packed instruction table, between an asynchronous copy of the
ctx rows up and of the decisions (and ring events) down through pinned
buffers, with one host sync.  That kernel is the port's
counterpart of the reference's ``compile_predicated``; :class:`BatchExecutor`
holds what this executor and the pc-walking one (:mod:`jit`) share.

The reference splits long unrolls into chained segments and fuses
congruent loop copies into scan stages, because those are the shapes XLA
compiles; the port walks the whole forward-only unroll as one span, eagerly
on the CPU and in one kernel launch on the card.  The planners
(:func:`~repro_torch.core.lower.segment_code`,
:func:`~repro_torch.core.lower.plan_scan_stages`) stay in ``lower`` and
are held to the reference's plans by the tests.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .context import CTX_LEN
from .isa import (ALU_IMM_OPS, ALU_REG_OPS, COND_JUMP_IMM, COND_JUMP_REG,
                  NUM_REGS, Op, Program)
from ..kernels.policy_exec import ops as pe
from ..kernels.roundtrip import RoundTrip
from .lower import (I64, RB_FIELDS, BatchCtx, LIns, LoweredProgram, alu_t,
                    cmp_t, collect_rb_events, exec_device, helper_t,
                    ldctx_dyn, lower, map_lookup, map_lookup_dyn, rb_words,
                    unroll_lowered)
from .maps import MapRegistry
from .vm import _IMM2REG, _JIMM2REG, RB_HELPERS
from ..obs.telemetry import NO_SPAN


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


class BatchExecutor:
    """What the two batch executors share: the device copy of the maps,
    one batch per call and the ring-buffer drain.  On a CUDA device a batch
    is one ``policy_exec`` launch over ``code``, packed once here, inside a
    :class:`~repro_torch.kernels.roundtrip.RoundTrip` kept per batch size
    (the rows up from pinned memory, the launch, the decisions down); on
    the CPU the subclass's eager torch body (``_run_eager``) runs."""

    def __init__(self, maps: MapRegistry, device: torch.device, code,
                 rb_cap: int, *, fuel: int, halt_returns_r0: bool) -> None:
        self.maps = maps
        self.device = device
        self.rb_cap = rb_cap
        self._fuel = fuel
        self._halt_returns_r0 = halt_returns_r0
        self._maps_dev = pe.DeviceMaps(maps, device)
        self._last_rb: tuple | None = None     # (ev, cnt, drops)
        self._consts: dict = {}                # eager 0-d device constants
        self._on_card = device.type == "cuda"
        self._table = None
        self._staging: dict = {}               # batch size -> run_batch's
        if self._on_card:
            self._table = pe.pack_code(code).to(device)

    def _run_eager(self, ctx: torch.Tensor):
        """``(r0 [B], (ev, cnt, drops) or None)`` by the eager body."""
        raise NotImplementedError

    def _launch(self, ctx: torch.Tensor) -> torch.Tensor:
        flat, meta = self._maps_dev.flat()
        return pe.policy_exec(self._table, ctx, flat, meta,
                              rb_cap=self.rb_cap, fuel=self._fuel,
                              halt_returns_r0=self._halt_returns_r0)

    def run_batch_device(self, ctx: torch.Tensor) -> torch.Tensor:
        """Decisions for a ``[B, CTX_LEN]`` int64 ctx already on the
        executor's device; returns ``[B]`` int64 on that device without a
        host sync (ring buffers stay on the device in ``_last_rb``)."""
        if ctx.device != self.device:
            raise ValueError(f"ctx on {ctx.device}, executor on "
                             f"{self.device}")
        if self._on_card:
            r0, *rb = pe.split_out(self._launch(ctx), self.rb_cap)
        else:
            r0, rb = self._run_eager(ctx)
        if self.rb_cap:
            self._last_rb = tuple(rb)
        return r0

    def _staging_for(self, B: int):
        """The round trip of a batch of ``B`` rows (made at its first
        batch) and the kernel's launch arguments over its device buffers
        (rebuilt when a map reload replaces the device maps or the fuel
        changes)."""
        flat, meta = self._maps_dev.flat()
        st = self._staging.get(B)
        if st is None:
            st = self._staging[B] = {
                "trip": RoundTrip((B, CTX_LEN), I64,
                                  (B, 3 + RB_FIELDS * self.rb_cap), I64,
                                  self.device, "policy"),
                "maps": None, "fuel": None}
        if st["maps"] is not flat or st["fuel"] != self._fuel:
            st["args"] = pe.launch_args(
                self._table, st["trip"].dev_in, flat, meta,
                st["trip"].dev_out, rb_cap=self.rb_cap, fuel=self._fuel,
                halt_returns_r0=self._halt_returns_r0)
            st["maps"], st["fuel"] = flat, self._fuel
        return st

    def run_batch(self, ctx_mat: np.ndarray, tel=None) -> np.ndarray:
        """ctx_mat: ``[batch, CTX_LEN]`` -> int64 ``[batch]`` decisions.
        On the card: the rows into the batch size's pinned buffer, then the
        round trip (the copy up, the launch and the copy down on the
        current stream, one wait); the decisions and ring rows are copied
        out of the pinned buffer, which the next batch of that size
        overwrites.  ``tel``: a tracing telemetry hub (None: untraced),
        which records the batch's device work as a ``dev policy`` span and
        resolves its pending device spans after the wait."""
        if not self._on_card:
            ctx = torch.from_numpy(np.ascontiguousarray(ctx_mat,
                                                        dtype=np.int64))
            with (tel.device_span("dev policy", self.device)
                  if tel is not None else NO_SPAN):
                out = self.run_batch_device(ctx).numpy()
            if tel is not None:
                tel.resolve_device()
            return out
        B = len(ctx_mat)
        if B == 0:                       # nothing to launch, no events
            self._last_rb = None
            return np.zeros(0, np.int64)
        st = self._staging_for(B)
        trip, args = st["trip"], st["args"]
        np.copyto(trip.host_in, ctx_mat, casting="unsafe")
        # the launch goes to the current device: make it the executor's
        guard = (contextlib.nullcontext()
                 if torch.cuda.current_device() == self.device.index
                 else torch.cuda.device(self.device))
        with guard:
            trip(lambda: pe.launch(
                args, torch.cuda.current_stream(self.device).cuda_stream),
                tel)
        r0, *rb = pe.split_out(trip.host_out, self.rb_cap)
        if self.rb_cap:
            self._last_rb = tuple(np.array(t) for t in rb)
        return r0.copy()

    def take_events(self, n: int) -> tuple[list, int]:
        """Drain the last batch's ring-buffer records for the first ``n``
        lanes (and their slot-drop count); empty until the next batch."""
        if self._last_rb is None:
            return [], 0
        ev, cnt, dr = (t.cpu() if torch.is_tensor(t) else t
                       for t in self._last_rb)
        self._last_rb = None
        return collect_rb_events(ev, cnt, dr, n)


class PredicatedPolicy(BatchExecutor):
    """Batch fault-decision executor (the engine's default batch route)."""

    def __init__(self, program: Program | LoweredProgram, maps: MapRegistry,
                 code=None, device=None) -> None:
        device = exec_device(device)
        lp = program if isinstance(program, LoweredProgram) else \
            lower(program, maps)
        # code: the unroll of ``lp`` when the caller already has it (the
        # hook registry reads it from the artifact cache)
        self.code = code if code is not None else \
            unroll_lowered(lp)[0]               # ValueError if too long
        self.unrolled_len = len(self.code)
        # forward-only code: each step moves a lane's pc forward, so it
        # stops within len(code) steps and the fuel never binds, as in
        # the eager walk; a lane that never exits returns 0 (_Machine.r0)
        super().__init__(maps, device, self.code,
                         int(lp.facts.get("rb_cap", 0)),
                         fuel=len(self.code), halt_returns_r0=False)

    def _run_eager(self, ctx: torch.Tensor):
        arrays, lens = self._maps_dev.arrays()
        cv = BatchCtx(ctx, self._consts)
        st = _Machine(ctx.shape[0], self.device, self.rb_cap)
        _exec(self.code, cv, arrays, lens, st, self.rb_cap)
        return st.r0, (st.ev, st.ecnt, st.edrop) if self.rb_cap else None
