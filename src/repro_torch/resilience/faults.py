"""Failure-injection site names.

The seeded ``FailureInjector`` of ``repro.resilience.faults`` is not ported
yet (ROADMAP, "Modules still to port": resilience).  The hook dispatcher
already keys its containment checks on these names, so they live here.
"""

SITE_MIGRATE_COPY = "migrate_copy"
SITE_TIER_ALLOC = "tier_alloc"
SITE_LINK_FLAP = "link_flap"
SITE_HOOK_RUN = "hook_run"
SITE_CACHE_CORRUPT = "cache_corrupt"

SITES = (SITE_MIGRATE_COPY, SITE_TIER_ALLOC, SITE_LINK_FLAP,
         SITE_HOOK_RUN, SITE_CACHE_CORRUPT)
