"""Failure containment: seeded fault injection, tier-link health with
exponential-backoff quarantine, and runtime policy-program supervision.

A misbehaving program, link or tier degrades the system, never crashes it.
Everything is keyed on the MODELED clock, so a seeded failure schedule
replays bit-identically across the scalar and batched fault routes, and
against the reference package.
"""

from .faults import (FLAP_WINDOW_NS, SITE_CACHE_CORRUPT, SITE_HOOK_RUN,
                     SITE_LINK_FLAP, SITE_MIGRATE_COPY, SITE_TIER_ALLOC,
                     SITES, FailureInjector)
from .health import (BACKOFF_BASE_NS, BACKOFF_MAX_LEVEL,
                     QUARANTINE_THRESHOLD, BackoffState, TierHealthMonitor)
from .supervisor import (DETACH_THRESHOLD, RB_STREAK_LIMIT,
                         REASON_INVALID_RETURN, REASON_NAMES,
                         REASON_RB_EXHAUSTION, REASON_RUNTIME_ERROR,
                         REASON_SEGMENT_BLOWUP, HookDiscipline,
                         PolicySupervisor)

__all__ = [
    "FailureInjector", "SITES", "SITE_MIGRATE_COPY", "SITE_TIER_ALLOC",
    "SITE_LINK_FLAP", "SITE_HOOK_RUN", "SITE_CACHE_CORRUPT",
    "FLAP_WINDOW_NS",
    "BackoffState", "TierHealthMonitor", "QUARANTINE_THRESHOLD",
    "BACKOFF_BASE_NS", "BACKOFF_MAX_LEVEL",
    "PolicySupervisor", "HookDiscipline", "DETACH_THRESHOLD",
    "RB_STREAK_LIMIT", "REASON_INVALID_RETURN",
    "REASON_RUNTIME_ERROR", "REASON_RB_EXHAUSTION", "REASON_SEGMENT_BLOWUP",
    "REASON_NAMES",
]
