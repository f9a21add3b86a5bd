"""Tier-link health: per-edge error accounting with exponential-backoff
quarantine and probe-based re-admission.

Mirrors how a kernel would treat a flaky interconnect path: an edge that
keeps failing copies is marked degraded and traffic routes around it (the
multi-hop migration path already hops over full intermediates; a
quarantined edge is skipped the same way).  All timing is in MODELED
nanoseconds (the mm clock), never wall time, so the state machine replays
exactly under the differential harness.

State machine per edge (``BackoffState``):

* healthy — errors below ``threshold`` consecutive just count.
* quarantined — ``threshold`` consecutive errors (or any error while
  degraded) set ``quarantined_until = now + base_ns << level`` and bump
  the level (capped); ``ok(now)`` is False until the window expires.
* probing — once the window expires the next attempt is the probe: a
  probe failure re-quarantines with a doubled window; a success decays
  one level, and reaching level 0 re-admits the edge.
"""

from __future__ import annotations

from dataclasses import dataclass, field

QUARANTINE_THRESHOLD = 3       # consecutive errors before first quarantine
BACKOFF_BASE_NS = 8_000_000    # first quarantine window (8 modeled ticks)
BACKOFF_MAX_LEVEL = 6          # window caps at base << 6 = 512ms modeled


@dataclass
class BackoffState:
    threshold: int = QUARANTINE_THRESHOLD
    base_ns: int = BACKOFF_BASE_NS
    max_level: int = BACKOFF_MAX_LEVEL
    consec_errors: int = 0
    level: int = 0
    quarantined_until: int = -1
    errors: int = 0
    successes: int = 0
    quarantines: int = 0
    readmits: int = 0

    def backoff_ns(self) -> int:
        return self.base_ns << min(self.level, self.max_level)

    def ok(self, now: int) -> bool:
        """Usable at ``now``?  True once the window expires (the probe)."""
        return now >= self.quarantined_until

    def record_error(self, now: int) -> bool:
        """Count one failure; returns True when this NEWLY quarantines the
        edge (callers emit EV_QUARANTINE exactly then)."""
        self.errors += 1
        self.consec_errors += 1
        if self.level == 0 and self.consec_errors < self.threshold:
            return False
        newly = self.quarantined_until <= now
        self.quarantined_until = now + self.backoff_ns()
        self.level = min(self.level + 1, self.max_level)
        if newly:
            self.quarantines += 1
        return newly

    def record_success(self, now: int) -> bool:
        """Count one success; a successful probe decays one level.  Returns
        True when the edge is fully re-admitted (level back to 0)."""
        self.successes += 1
        self.consec_errors = 0
        if self.level == 0:
            return False
        self.level -= 1
        if self.level == 0:
            self.quarantined_until = -1
            self.readmits += 1
            return True
        return False


class TierHealthMonitor:
    """Per-edge link health + per-tier allocation-failure accounting.

    Edge ``e`` is the link between tier ``e`` and tier ``e+1`` (same
    numbering as ``CostModel.edge_names()``).  The ``active`` flag flips on
    the first recorded error; until then every query short-circuits True so
    a failure-free run pays one attribute read per migration hop.
    ``quarantine`` False (the no-containment baseline) keeps the error
    counters but never routes around a degraded edge.
    """

    def __init__(self, nedges: int, edge_names=None, *,
                 quarantine: bool = True):
        self.edges = [BackoffState() for _ in range(max(0, nedges))]
        self.edge_names = tuple(edge_names) if edge_names else tuple(
            f"edge{i}" for i in range(max(0, nedges)))
        self.quarantine_enabled = bool(quarantine)
        self.tier_alloc_failures = [0] * (max(0, nedges) + 1)
        self.active = False

    def edge_ok(self, edge: int, now: int) -> bool:
        if not self.active or not self.quarantine_enabled:
            return True
        return self.edges[edge].ok(now)

    def path_ok(self, src_tier: int, dst_tier: int, now: int) -> bool:
        """Every edge crossed moving a page src->dst is usable at ``now``."""
        if not self.active or not self.quarantine_enabled:
            return True
        lo, hi = sorted((src_tier, dst_tier))
        return all(self.edges[e].ok(now) for e in range(lo, hi))

    def record_edge_error(self, edge: int, now: int) -> bool:
        self.active = True
        return self.edges[edge].record_error(now)

    def record_edge_success(self, edge: int, now: int) -> bool:
        if not self.active:
            return False
        return self.edges[edge].record_success(now)

    def record_alloc_failure(self, tier: int) -> None:
        self.active = True
        self.tier_alloc_failures[tier] += 1

    def quarantined_edges(self, now: int) -> list:
        return [e for e, st in enumerate(self.edges) if not st.ok(now)]

    def snapshot(self) -> dict:
        """Numeric-only per-edge accounting for ``engine.metrics()``."""
        out = {"alloc_failures": list(self.tier_alloc_failures),
               "quarantine_enabled": self.quarantine_enabled}
        for e, st in enumerate(self.edges):
            name = (self.edge_names[e] if e < len(self.edge_names)
                    else f"edge{e}")
            out[name] = {
                "errors": st.errors, "successes": st.successes,
                "quarantines": st.quarantines, "readmits": st.readmits,
                "level": st.level,
                "quarantined_until": st.quarantined_until,
            }
        return out
