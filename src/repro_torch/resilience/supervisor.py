"""Policy-program supervision: misbehavior accounting and auto-detach.

The verifier (load time) proves a program terminates and touches only
valid state; the supervisor (run time) is the other half of the kernel's
containment story — a program that KEEPS misbehaving (invalid return
values, runtime/helper errors, ring-slot exhaustion streaks, repeated
segment-budget blowups) is detached after a strike threshold and the
manager falls back to the kernel-default THP policy.  The engine keeps
serving; an ``EV_DETACH`` event and ``engine.metrics()`` counters record
the incident.

Determinism contract (chaos differential): strikes accrue in ROW ORDER.
The batched route disciplines its decision vector sequentially, mirroring
the order the scalar route would have invoked the program, so both routes
strike, fall back and detach at the same fault.  A striking row's decision
becomes ``POLICY_FALLBACK`` (kernel default + fallback accounting); rows
AFTER a mid-batch detach become ``POLICY_DETACHED`` — the kernel default
path with NO fallback accounting, matching the scalar route where
post-detach faults never reach the hook at all.

Known route asymmetry (documented, not hidden): ring-slot drop streaks are
observed per CALL — one scalar invocation vs one whole batch — so a
drop-heavy tracing program can strike at different faults on the two
routes.  The chaos differential therefore runs non-tracing programs; the
drop discipline is covered by its own unit tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Mirrors ``repro.core.context.POLICY_FALLBACK``.  Kept as a literal here —
# NOT imported — because ``core.hooks`` imports this module at class-define
# time, so an import edge back into ``core`` would be circular whenever
# ``repro.resilience`` loads first.  ``core.hooks`` asserts the two values
# agree at import time.
POLICY_FALLBACK = -1

REASON_INVALID_RETURN = 0    # return outside the hook's contract
REASON_RUNTIME_ERROR = 1     # injected fault or exception during execution
REASON_RB_EXHAUSTION = 2     # ring-slot drop streak
REASON_SEGMENT_BLOWUP = 3    # predicated unroll over budget at build time
REASON_NAMES = ("invalid_return", "runtime_error", "rb_exhaustion",
                "segment_blowup")

DETACH_THRESHOLD = 8         # strikes before auto-detach
RB_STREAK_LIMIT = 4          # consecutive dropping calls = one strike

# Return validity: the mm clamps OVER-range decisions into each hook's
# contract (order to the feasible max, tier/victim index into range) — the
# kernel's long-standing clamp convention, which synthetic stress programs
# rely on.  What a program must NEVER produce is a value BELOW the
# POLICY_FALLBACK sentinel: that range is reserved for the manager's own
# sentinels (POLICY_FALLBACK, POLICY_DETACHED) and a program emitting it
# would be misread as one.  Those strike as invalid returns.


@dataclass
class HookDiscipline:
    """Per-hook strike ledger."""
    strikes: int = 0
    reasons: list = field(default_factory=lambda: [0] * len(REASON_NAMES))
    rb_streak: int = 0
    detaches: int = 0
    last_detach_reason: int = -1
    last_program: str = ""


class PolicySupervisor:
    """Strike accounting + detach decisions for every hook.

    ``enabled`` False is the no-containment baseline: strikes are still
    counted (visible in metrics) but no detach ever fires.
    """

    def __init__(self, *, threshold: int = DETACH_THRESHOLD,
                 rb_streak_limit: int = RB_STREAK_LIMIT,
                 enabled: bool = True):
        self.threshold = int(threshold)
        self.rb_streak_limit = int(rb_streak_limit)
        self.enabled = bool(enabled)
        self._state: dict = {}

    def _st(self, hook: str) -> HookDiscipline:
        st = self._state.get(hook)
        if st is None:
            st = self._state[hook] = HookDiscipline()
        return st

    def valid(self, hook: str, decision: int) -> bool:
        return decision >= POLICY_FALLBACK

    def strike(self, hook: str, reason: int) -> bool:
        """Record one strike; True when the threshold is crossed and the
        caller must detach the program NOW."""
        st = self._st(hook)
        st.strikes += 1
        st.reasons[reason] += 1
        if not self.enabled:
            return False
        return st.strikes >= self.threshold

    def note_segment_blowup(self, hook: str) -> None:
        """A predicated build blew the segment budget.  Counts toward the
        strike total but never detaches by itself — the compiler already
        degrades gracefully (while+switch JIT fallback)."""
        st = self._st(hook)
        st.strikes += 1
        st.reasons[REASON_SEGMENT_BLOWUP] += 1

    def note_rb_drops(self, hook: str, drops: int) -> bool:
        """One call dropped ring events.  ``rb_streak_limit`` CONSECUTIVE
        dropping calls convert into one RB_EXHAUSTION strike (streak then
        resets); isolated drops are normal backpressure, a streak means the
        program is sized wrong for its slot budget."""
        if drops <= 0:
            return False
        st = self._st(hook)
        st.rb_streak += 1
        if st.rb_streak < self.rb_streak_limit:
            return False
        st.rb_streak = 0
        return True

    def note_rb_clean(self, hook: str) -> None:
        st = self._state.get(hook)
        if st is not None and st.rb_streak:
            st.rb_streak = 0

    def record_detach(self, hook: str, reason: int, program: str) -> dict:
        st = self._st(hook)
        st.detaches += 1
        st.last_detach_reason = reason
        st.last_program = program
        return {"strikes": st.strikes, "detaches": st.detaches}

    def reset(self, hook: str) -> None:
        """A fresh attach starts with a clean ledger (lifetime detach count
        survives, like the kernel's cumulative stats)."""
        st = self._state.get(hook)
        if st is None:
            return
        detaches, last = st.detaches, st.last_detach_reason
        self._state[hook] = HookDiscipline(detaches=detaches,
                                           last_detach_reason=last)

    def snapshot(self) -> dict:
        """Numeric-only per-hook ledger for ``engine.metrics()``."""
        out = {"enabled": self.enabled, "threshold": self.threshold}
        total_detaches = 0
        for hook, st in sorted(self._state.items()):
            total_detaches += st.detaches
            out[hook] = {
                "strikes": st.strikes,
                "detaches": st.detaches,
                "rb_streak": st.rb_streak,
                "last_detach_reason": st.last_detach_reason,
            }
            for i, name in enumerate(REASON_NAMES):
                out[hook][name] = st.reasons[i]
        out["detaches"] = total_detaches
        return out
