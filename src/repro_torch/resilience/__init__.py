"""Resilience layer, ported subset: the policy supervisor, the tier-link
health monitor and the failure-injection site names the hook dispatcher
and the tiering engine check."""

from .faults import (SITE_CACHE_CORRUPT, SITE_HOOK_RUN, SITE_LINK_FLAP,
                     SITE_MIGRATE_COPY, SITE_TIER_ALLOC, SITES)
from .health import BackoffState, TierHealthMonitor
from .supervisor import (DETACH_THRESHOLD, RB_STREAK_LIMIT,
                         REASON_INVALID_RETURN, REASON_RB_EXHAUSTION,
                         REASON_RUNTIME_ERROR, PolicySupervisor)

__all__ = [name for name in dir() if not name.startswith("_")]
