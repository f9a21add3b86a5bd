"""Hook points in the framework memory manager.

The paper introduces one new eBPF hook on the Linux page-fault path and
sketches more (reclaim, tiering).  We implement the same surface: named hook
points a verified program can be attached to.  If nothing is attached, the
default code path runs with zero overhead — mirroring the paper's "zero
overhead on non-hinted faults" property.

Containment: the verifier gates what loads; the PolicySupervisor
(``repro.resilience``) gates what keeps RUNNING.  Both dispatch paths run
the program under a containment envelope — an injected or real runtime
error, an out-of-contract return value, or a ring-slot exhaustion streak
costs the program a strike and falls the decision back to the kernel
default; enough strikes auto-detach the program (EV_DETACH) and the
manager serves on the default THP policy.  The engine never crashes on a
misbehaving program.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..obs.ringbuf import EV_DETACH, EV_HOOK
from ..resilience.faults import SITE_HOOK_RUN
from ..resilience import supervisor as _supervisor_mod
from ..resilience.supervisor import (REASON_INVALID_RETURN,
                                     REASON_RB_EXHAUSTION,
                                     REASON_RUNTIME_ERROR, PolicySupervisor)
from .context import CTX, POLICY_FALLBACK

# the supervisor keeps its own copy of the sentinel (importing it from here
# would be circular); hold the two definitions together
assert _supervisor_mod.POLICY_FALLBACK == POLICY_FALLBACK
from .isa import Program
from .maps import MapRegistry
from .vm import PolicyVM

HOOK_FAULT = "mm_fault"            # page-size decision on fault (the paper's hook)
HOOK_RECLAIM = "mm_reclaim"        # victim selection under memory pressure
HOOK_TIER = "mm_tier"              # page placement for tiering (future work in paper)
HOOK_EVICT = "mm_evict"            # prefix-cache eviction (Cache-is-King mold)
HOOK_PROFILE = "mm_profile"        # sampled profiler on the DAMON aggregation tick

KNOWN_HOOKS = (HOOK_FAULT, HOOK_RECLAIM, HOOK_TIER, HOOK_EVICT, HOOK_PROFILE)
HOOK_INDEX = {h: i for i, h in enumerate(KNOWN_HOOKS)}


@dataclass
class AttachedProgram:
    program: Program
    vm: PolicyVM


class HookRegistry:
    def __init__(self, telemetry=None, injector=None,
                 supervisor=None) -> None:
        # telemetry hub (repro.obs.Telemetry) or None; every tracepoint in
        # the dispatch paths below guards on it so the default (no
        # telemetry) configuration pays one is-None check per dispatch
        self.telemetry = telemetry
        # resilience FailureInjector (chaos runs) or None; sites guard on it
        # the same way they guard on telemetry
        self.injector = injector
        self.supervisor = supervisor if supervisor is not None \
            else PolicySupervisor()
        self._hooks: dict[str, AttachedProgram | None] = {h: None for h in KNOWN_HOOKS}
        # decisions evaluated (one per ctx row — a batch of N counts N)
        self.invocations: dict[str, int] = {h: 0 for h in KNOWN_HOOKS}
        # program-invocation EVENTS: how many times the hook actually fired.
        # A batch of N faults is ONE batch_call — the number the hot-path
        # benchmark and the one-invocation-per-step tests watch.
        self.calls: dict[str, int] = {h: 0 for h in KNOWN_HOOKS}
        self.batch_calls: dict[str, int] = {h: 0 for h in KNOWN_HOOKS}

    def attach(self, hook: str, program: Program, maps: MapRegistry) -> None:
        """Verify (load-time, like the kernel) and attach."""
        if hook not in self._hooks:
            raise KeyError(f"unknown hook {hook!r}; known: {KNOWN_HOOKS}")
        vm = PolicyVM(program, maps)   # raises VerifierError on rejection
        self._hooks[hook] = AttachedProgram(program=program, vm=vm)
        self.supervisor.reset(hook)    # fresh attach, clean strike ledger

    def detach(self, hook: str) -> None:
        if hook not in self._hooks:
            raise KeyError(f"unknown hook {hook!r}")
        self._hooks[hook] = None

    def attached(self, hook: str) -> bool:
        return self._hooks.get(hook) is not None

    # ------------------------------------------------------------ containment
    def _strike(self, hook: str, ap: AttachedProgram, reason: int,
                ktime: int) -> bool:
        """One supervisor strike against ``hook``; detaches the program and
        emits EV_DETACH when the threshold is crossed.  Returns True when
        the hook is detached (now or already during this invocation)."""
        if self._hooks.get(hook) is not ap:
            return True                 # already detached this invocation
        if not self.supervisor.strike(hook, reason):
            return False
        self._hooks[hook] = None        # fall back to kernel-default policy
        info = self.supervisor.record_detach(
            hook, reason, getattr(ap.program, "name", "") or "?")
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.emit(EV_DETACH, HOOK_INDEX[hook], info["strikes"], reason,
                     ts=ktime)
            tel.inc("policy_detaches")
        return True

    def _discipline_scalar(self, hook: str, ap: AttachedProgram, ret: int,
                           dropped: int, ktime: int) -> int:
        sup = self.supervisor
        if dropped:
            if sup.note_rb_drops(hook, dropped):
                self._strike(hook, ap, REASON_RB_EXHAUSTION, ktime)
        else:
            sup.note_rb_clean(hook)
        if not sup.valid(hook, ret):
            self._strike(hook, ap, REASON_INVALID_RETURN, ktime)
            return POLICY_FALLBACK
        return ret

    # -------------------------------------------------------------- dispatch
    def run(self, hook: str, ctx_vec: np.ndarray) -> int | None:
        """Run the attached program; None if nothing attached (default path)."""
        ap = self._hooks.get(hook)
        if ap is None:
            return None
        self.invocations[hook] += 1
        self.calls[hook] += 1
        ktime = int(ctx_vec[CTX.KTIME_NS])
        inj = self.injector
        if inj is not None and inj.fires(SITE_HOOK_RUN, HOOK_INDEX[hook],
                                         int(ctx_vec[CTX.PID]),
                                         int(ctx_vec[CTX.ADDR]), ktime):
            self._strike(hook, ap, REASON_RUNTIME_ERROR, ktime)
            return POLICY_FALLBACK
        tel = self.telemetry
        timed = tel is not None and tel.enabled
        t0 = time.perf_counter_ns() if timed else 0
        try:
            res = ap.vm.run(ctx_vec)
        except Exception:
            self._strike(hook, ap, REASON_RUNTIME_ERROR, ktime)
            return POLICY_FALLBACK
        if timed:
            dt = time.perf_counter_ns() - t0
            tel.observe_hook(hook, dt, 1)
            tel.emit(EV_HOOK, HOOK_INDEX[hook], 1, dt)
            for e in res.events:
                tel.ring.push(*e)
            tel.prog_lane_drops += res.dropped
        return self._discipline_scalar(hook, ap, int(res.ret), res.dropped,
                                       ktime)

    # The batched executors (``warm`` / ``run_batch`` and the per-row
    # discipline pass that consumes their output) replace the reference's
    # XLA backends with one vectorized torch executor: ROADMAP, "Modules
    # still to port", item 5.  Until then only the scalar route runs.
    def warm(self, hook: str, max_batch: int = 4) -> None:
        raise NotImplementedError(
            "batched policy executor not ported yet (ROADMAP item 5); "
            "use the scalar fault route")

    def run_batch(self, hook: str, ctx_mat: np.ndarray, *,
                  discipline: bool = True) -> np.ndarray | None:
        raise NotImplementedError(
            "batched policy executor not ported yet (ROADMAP item 5); "
            "use the scalar fault route")
