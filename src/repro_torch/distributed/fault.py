"""Fault tolerance & straggler mitigation for long-running training jobs:
the port's own copy of ``repro.distributed.fault`` (pure Python, host-side
and runtime-agnostic, so fully exercisable in one process):

  * StepWatchdog       — per-step wall-time monitor; flags straggling steps
                         (> k x rolling median) and escalates to a restart
                         recommendation after a run of them.
  * HeartbeatRegistry  — tracks worker liveness; a missed-heartbeat worker
                         marks the job degraded.
  * elastic_plan       — given a target device count, pick the largest
                         (data, model) mesh a checkpoint can be resharded
                         onto (model axis preserved first; data shrinks).
  * RestartableLoop    — crash-only training-loop wrapper: every step is
                         resumable from (step, ckpt); simulated failures in
                         tests restore and replay deterministically.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field


@dataclass
class StepWatchdog:
    slow_factor: float = 3.0
    escalate_after: int = 3
    window: int = 32
    durations: list = field(default_factory=list)
    slow_steps: int = 0
    consecutive_slow: int = 0
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self) -> dict:
        assert self._t0 is not None, "stop() without start()"
        dt = time.monotonic() - self._t0
        self._t0 = None
        return self.record(dt)

    def record(self, dt: float) -> dict:
        med = statistics.median(self.durations) if self.durations else dt
        slow = len(self.durations) >= 4 and dt > self.slow_factor * med
        self.durations.append(dt)
        if len(self.durations) > self.window:
            self.durations.pop(0)
        if slow:
            self.slow_steps += 1
            self.consecutive_slow += 1
        else:
            self.consecutive_slow = 0
        return {
            "duration": dt,
            "median": med,
            "slow": slow,
            "restart_recommended": self.consecutive_slow >= self.escalate_after,
        }


@dataclass
class HeartbeatRegistry:
    timeout_s: float = 60.0
    last_seen: dict = field(default_factory=dict)

    def beat(self, worker: str, now: float | None = None) -> None:
        self.last_seen[worker] = time.monotonic() if now is None else now

    def dead_workers(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [w for w, t in self.last_seen.items()
                if now - t > self.timeout_s]

    def healthy(self, now: float | None = None) -> bool:
        return not self.dead_workers(now)


def elastic_plan(target_chips: int, *, model_axis: int = 16,
                 min_data: int = 1) -> tuple[int, int]:
    """Largest (data, model) mesh fitting ``target_chips``; the model axis is
    preserved if possible (TP degree is baked into kernel block shapes),
    otherwise halved until it fits. Returns (data, model)."""
    m = model_axis
    while m > 1 and target_chips < m * min_data:
        m //= 2
    d = max(min_data, target_chips // m)
    return d, m


class SimulatedFailure(Exception):
    """Raised by tests / chaos hooks to exercise the restart path."""


class RestartableLoop:
    """Crash-only loop: run(step_fn) resumes from the last checkpoint on
    SimulatedFailure (or any transient exception type passed in)."""

    def __init__(self, save_fn, restore_fn, *, max_restarts: int = 3,
                 transient=(SimulatedFailure,)):
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.max_restarts = max_restarts
        self.transient = transient
        self.restarts = 0

    def run(self, state, start_step: int, num_steps: int, step_fn,
            checkpoint_every: int = 10):
        step = start_step
        while step < num_steps:
            try:
                state = step_fn(state, step)
                step += 1
                if step % checkpoint_every == 0:
                    self.save_fn(state, step)
            except self.transient:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                state, step = self.restore_fn()
        return state, step
