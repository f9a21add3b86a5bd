"""Fallback batch executor: a lane-vectorized walk over the program counter.

The counterpart of ``repro.core.jit``, which compiles the lowered IR into a
``lax.while_loop`` over ``lax.switch(pc, ...)`` and vmaps it over the fault
batch.  The hook registry takes this route only for programs whose
flattening exceeds :data:`repro_torch.core.lower.MAX_UNROLLED`, where the
predicated executor cannot unroll them.

Machine state per lane: ``(pc, regs[NUM_REGS], fuel)``.  Verified
programs terminate within ``max_steps``; the fuel (``max_steps + 8``, as
the reference) bounds the walk all the same, and a lane that stops
without ``EXIT`` returns its r0 register.  On a CUDA device a batch is ONE
launch of ``csrc/policy_exec.cu`` over the looped code (the JNZDEC loops
run as real loops, per lane), the counterpart of the reference's
``compile_program``.  On the CPU the eager body runs: :func:`pcwalk.pc_walk`
(one host sync per step), which is also the kernel's plain version.  Its
decisions, ring events and drop counts are bit-identical to the
interpreter's, because every op lowers through the same :mod:`lower`
bodies as the predicated executor.
"""

from __future__ import annotations

import torch

from .isa import Program
from .lower import BatchCtx, LoweredProgram, exec_device, lower
from .maps import MapRegistry
from .pcwalk import pc_walk
from .predicate import BatchExecutor


class JitPolicy(BatchExecutor):
    """Program + its maps, batched execution by pc walk."""

    def __init__(self, program: Program | LoweredProgram, maps: MapRegistry,
                 device=None) -> None:
        device = exec_device(device)
        lp = program if isinstance(program, LoweredProgram) else \
            lower(program, maps)
        self.lowered = lp
        self.facts = lp.facts
        super().__init__(maps, device, lp.insns,
                         int(self.facts.get("rb_cap", 0)),
                         fuel=self.facts["max_steps"] + 8,
                         halt_returns_r0=True)

    def _run_eager(self, ctx: torch.Tensor):
        arrays, lens = self._maps_dev.arrays()
        return pc_walk(self.lowered.insns, BatchCtx(ctx, self._consts),
                       arrays, lens, rb_cap=self.rb_cap, fuel=self._fuel,
                       halt_returns_r0=True)
