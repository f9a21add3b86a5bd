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

from ..obs.ringbuf import EV_CACHE, EV_COMPILE, EV_DETACH, EV_HOOK
from ..resilience.faults import SITE_HOOK_RUN
from ..resilience import supervisor as _supervisor_mod
from ..resilience.supervisor import (REASON_INVALID_RETURN,
                                     REASON_RB_EXHAUSTION,
                                     REASON_RUNTIME_ERROR, PolicySupervisor)
from .context import CTX, CTX_LEN, POLICY_DETACHED, POLICY_FALLBACK

# the supervisor keeps its own copy of the sentinel (importing it from here
# would be circular); hold the two definitions together
assert _supervisor_mod.POLICY_FALLBACK == POLICY_FALLBACK
from .isa import Program
from .lower import exec_device
from .maps import MapRegistry
from .vm import PolicyVM

HOOK_FAULT = "mm_fault"            # page-size decision on fault (the paper's hook)
HOOK_RECLAIM = "mm_reclaim"        # victim selection under memory pressure
HOOK_TIER = "mm_tier"              # page placement for tiering (future work in paper)
HOOK_EVICT = "mm_evict"            # prefix-cache eviction (Cache-is-King mold)
HOOK_PROFILE = "mm_profile"        # sampled profiler on the DAMON aggregation tick

KNOWN_HOOKS = (HOOK_FAULT, HOOK_RECLAIM, HOOK_TIER, HOOK_EVICT, HOOK_PROFILE)
HOOK_INDEX = {h: i for i, h in enumerate(KNOWN_HOOKS)}


# Batch-execution backend selection: the predicated executor (unroll +
# if-conversion, straight-line masked lane ops) runs in O(unrolled length)
# with NO per-step control flow; the pc-walking fallback (core.jit) runs
# only programs whose flattening exceeds core.lower.MAX_UNROLLED.

# Batches are padded up to power-of-two buckets (pad rows repeat row 0), as
# the reference pads them for its per-bucket compiles.
PAD_MIN = 4


@dataclass
class AttachedProgram:
    program: Program
    vm: PolicyVM
    jit: object | None = None       # JitPolicy, the deep-fallback batch path
    pred: object | None = None      # PredicatedPolicy, the default
    pred_unfit: bool = False        # flattening exceeded lower.MAX_UNROLLED


class HookRegistry:
    def __init__(self, cache=None, telemetry=None, injector=None,
                 supervisor=None, device=None) -> None:
        # unroll-artifact cache (cross-session pickles, core.cache); None =
        # the port's process-wide default
        self.cache = cache
        # where the batch executors run: None = CUDA, resolved (and checked)
        # at the first warm / run_batch, so a registry that only serves the
        # scalar route never needs a GPU
        self.device = device
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

    def _discipline_batch(self, hook: str, ap: AttachedProgram,
                          ctx_mat: np.ndarray, out, n: int) -> np.ndarray:
        """Row-order misbehavior pass over a batch decision vector, mirroring
        the order the scalar route invokes the program so both routes strike
        and detach at the SAME fault (the chaos-differential contract).  A
        striking row's decision becomes POLICY_FALLBACK; rows after a
        mid-batch detach become POLICY_DETACHED (kernel default, no fallback
        accounting — the scalar route never reaches the hook for them).

        Asymmetry note: an injected SITE_HOOK_RUN failure skips the program
        entirely on the scalar route but only overrides its DECISION here
        (all lanes already executed).  Decisions and strikes stay identical;
        programs with map-write or ring-emit side effects would diverge, so
        the chaos differential runs read-only programs.
        """
        out = np.asarray(out)
        inj = self.injector
        injected = inj is not None and inj.site_armed(SITE_HOOK_RUN)
        if not injected:
            # fast path: a well-behaved batch costs one vectorized check
            # (over-range decisions are CLAMPED downstream, the kernel's
            # clamp convention — only sub-sentinel values are misbehavior)
            if not (out < POLICY_FALLBACK).any():
                return out
        hidx = HOOK_INDEX[hook]
        out = np.array(out, dtype=np.int64)
        for i in range(n):
            ktime = int(ctx_mat[i, CTX.KTIME_NS])
            if injected and inj.fires(SITE_HOOK_RUN, hidx,
                                      int(ctx_mat[i, CTX.PID]),
                                      int(ctx_mat[i, CTX.ADDR]), ktime):
                reason = REASON_RUNTIME_ERROR
            elif int(out[i]) < POLICY_FALLBACK:
                reason = REASON_INVALID_RETURN
            else:
                continue
            out[i] = POLICY_FALLBACK
            if self._strike(hook, ap, reason, ktime):
                out[i + 1:n] = POLICY_DETACHED
                break
        return out

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

    def _artifact_cache(self):
        if self.cache is None:
            from .cache import artifact_cache
            self.cache = artifact_cache
        return self.cache

    def _batch_backend(self, ap: AttachedProgram):
        tel = self.telemetry
        built = None        # (1 predicated / -1 pc walk, wall ns) when built
        if ap.pred is None and ap.jit is None:
            self.device = exec_device(self.device)
        if ap.pred is None and not ap.pred_unfit:
            t0 = time.perf_counter_ns()
            try:
                from .predicate import PredicatedPolicy
                code, _cuts = self._artifact_cache().unrolled(
                    ap.vm.lowered, injector=self.injector)
                ap.pred = PredicatedPolicy(ap.vm.lowered, ap.vm.maps,
                                           code=code, device=self.device)
                built = (1, time.perf_counter_ns() - t0)
            except ValueError:      # unroll over MAX_UNROLLED -> JIT fallback
                ap.pred_unfit = True
                hook = next((h for h, a in self._hooks.items() if a is ap),
                            "?")
                # a budget blowup counts toward the program's strike ledger
                # but never detaches by itself — the fallback IS the
                # graceful degradation
                self.supervisor.note_segment_blowup(hook)
        if ap.pred is None and ap.jit is None:
            from .jit import JitPolicy
            t0 = time.perf_counter_ns()
            ap.jit = JitPolicy(ap.vm.lowered, ap.vm.maps, device=self.device)
            built = (-1, time.perf_counter_ns() - t0)
        if built is not None and tel is not None and tel.enabled:
            hook = next((h for h, a in self._hooks.items() if a is ap), "?")
            tel.emit(EV_COMPILE, HOOK_INDEX.get(hook, -1), built[0], built[1])
            cs = self._artifact_cache().stats
            # a1 packs the miss-reason field: low 24 bits total misses,
            # high bits corrupt-artifact misses (see ringbuf.EV_CACHE)
            tel.emit(EV_CACHE, cs.get("unroll_hits", 0),
                     cs.get("unroll_misses", 0)
                     | (cs.get("miss_corrupt", 0) << 24),
                     cs.get("unroll_disk_hits", 0))
            tel.inc("backend_builds")
        return ap.pred if ap.pred is not None else ap.jit

    def warm(self, hook: str, max_batch: int = PAD_MIN) -> None:
        """Eagerly build the batch backend for ``hook`` and run it once per
        bucket up to the ``max_batch`` bucket — engine construction calls
        this so the first decode step does not pay the unroll and the
        device's first launches, and so a warm artifact cache is consumed
        at startup rather than mid-serve.  No-op when nothing is
        attached."""
        ap = self._hooks.get(hook)
        if ap is None:
            return
        backend = self._batch_backend(ap)
        pad = PAD_MIN
        while True:
            backend.run_batch(np.zeros((pad, CTX_LEN), dtype=np.int64))
            if pad >= max_batch:
                break
            pad *= 2

    def run_batch(self, hook: str, ctx_mat: np.ndarray, *,
                  discipline: bool = True) -> np.ndarray | None:
        """Vectorized decision for a batch of faults.

        One call = ONE program invocation regardless of batch size — the
        amortization the batched fault path is built on.  Uses the
        predicated straight-line executor, falling back to the
        pc-walking executor only for programs whose flattening exceeds
        lower.MAX_UNROLLED entirely; the batch is padded to power-of-two
        buckets (pad rows repeat row 0), as the reference pads it.

        ``discipline=False`` skips the per-row misbehavior pass and returns
        the raw decision vector: callers that CONSUME only a subset of the
        rows (``fault_batch`` — an earlier grant can cover later requests)
        must instead discipline each row they consume via
        :meth:`discipline_row`, so strikes accrue for exactly the rows the
        scalar route would have faulted (the route-parity contract).
        Per-call accounting (ring-drop streaks, backend crashes) happens
        here regardless.
        """
        ap = self._hooks.get(hook)
        if ap is None:
            return None
        backend = self._batch_backend(ap)
        n = ctx_mat.shape[0]
        self.invocations[hook] += n
        self.calls[hook] += 1
        self.batch_calls[hook] += 1
        padded = ctx_mat
        pad = PAD_MIN
        while pad < n:
            pad *= 2      # at most log2(max batch) distinct batch shapes
        if pad > n:
            padded = np.concatenate(
                [ctx_mat, np.repeat(ctx_mat[:1], pad - n, axis=0)])
        tel = self.telemetry
        timed = tel is not None and tel.enabled
        t0 = time.perf_counter_ns() if timed else 0
        try:
            out = backend.run_batch(padded)[:n]
        except Exception:
            # a crashing batch backend costs one strike and the whole batch
            # falls back to the kernel default — never an engine crash
            self._strike(hook, ap, REASON_RUNTIME_ERROR,
                         int(ctx_mat[0, CTX.KTIME_NS]) if n else 0)
            return np.full(n, POLICY_FALLBACK, dtype=np.int64)
        dropped = 0
        if timed:
            dt = time.perf_counter_ns() - t0
            tel.observe_hook(hook, dt, n)
            tel.emit(EV_HOOK, HOOK_INDEX[hook], n, dt)
            if getattr(backend, "rb_cap", 0):
                # drain the device event buffers: only the n real lanes — the
                # power-of-two padding rows are repeats of row 0 and their
                # emissions (like their decisions) are discarded
                events, drops = backend.take_events(n)
                for e in events:
                    tel.ring.push(*e)
                tel.prog_lane_drops += drops
                dropped = drops
        sup = self.supervisor
        if dropped:
            if sup.note_rb_drops(hook, dropped):
                self._strike(hook, ap, REASON_RB_EXHAUSTION,
                             int(ctx_mat[0, CTX.KTIME_NS]) if n else 0)
        else:
            sup.note_rb_clean(hook)
        if not discipline:
            return np.asarray(out)
        return self._discipline_batch(hook, ap, ctx_mat, out, n)

    # ------------------------------------------- consumption-time discipline
    def row_discipline_needed(self, hook: str, decisions) -> bool:
        """Whether :meth:`discipline_row` has any work to do for this raw
        decision vector — False on the healthy path, so consuming a clean
        batch costs one vectorized check and zero per-row calls."""
        if decisions is None:
            return False
        inj = self.injector
        if inj is not None and inj.site_armed(SITE_HOOK_RUN):
            return True
        return bool((np.asarray(decisions) < POLICY_FALLBACK).any())

    def discipline_row(self, hook: str, ctx_vec: np.ndarray,
                       decision: int) -> int:
        """Misbehavior pass for ONE consumed batch row (see ``run_batch``
        with ``discipline=False``).  Strikes accrue only for rows the
        caller actually consumes — a row covered by an earlier grant never
        faults on the scalar route, so it must not strike here either.
        Returns the disciplined decision: POLICY_FALLBACK on a strike,
        POLICY_DETACHED once the program detached earlier in the batch."""
        ap = self._hooks.get(hook)
        if ap is None:
            return POLICY_DETACHED
        ktime = int(ctx_vec[CTX.KTIME_NS])
        inj = self.injector
        if inj is not None and inj.fires(SITE_HOOK_RUN, HOOK_INDEX[hook],
                                         int(ctx_vec[CTX.PID]),
                                         int(ctx_vec[CTX.ADDR]), ktime):
            self._strike(hook, ap, REASON_RUNTIME_ERROR, ktime)
            return POLICY_FALLBACK
        if int(decision) < POLICY_FALLBACK:
            self._strike(hook, ap, REASON_INVALID_RETURN, ktime)
            return POLICY_FALLBACK
        return int(decision)
