"""The policy catalog: a serving engine's memory-management plane, built
from its policy keywords (:func:`build_plane`), and the names its
``tier_policy`` and ``evict_policy`` take.
"""

from __future__ import annotations

from .cost import default_tier_chain
from .hooks import HOOK_FAULT, HOOK_PROFILE, HOOK_TIER
from .khugepaged import Khugepaged, KhugepagedConfig
from .mm import MemoryManager
from .profiles import MAX_PROFILE_REGIONS, Profile
from .programs import (ebpf_mm_program, evict_ghost_program,
                       evict_lfu_program, evict_lru_program, never_program,
                       profile_wss_program, reclaim_lru_program,
                       thp_always_program, tier_damon_program,
                       tier_edge_admission_program, tier_heat_band_program,
                       tier_lru_program, tier_never_program)
from .tiering import TieredMemoryManager
from .wss import ProfileSynthesizer

# tier_policy name -> mm_tier program factory (None = kernel default)
TIER_PROGRAMS = {
    "ebpf-tier": tier_damon_program,
    "lru-tier": tier_lru_program,
    "never-tier": tier_never_program,
    "heat-tier": tier_heat_band_program,
    "edge-tier": tier_edge_admission_program,
    "default": None,
}
# 2-tier baselines: their demote target never passes tier 1, so on a
# deeper chain they strand tiers 2.. — the pairing is rejected
TWO_TIER_POLICIES = frozenset({"ebpf-tier", "lru-tier"})
# evict_policy name -> mm_evict program factory (None = kernel default:
# the cache's built-in conservative LRU fallback, no program attached)
EVICT_PROGRAMS = {
    "lru-evict": evict_lru_program,
    "lfu-evict": evict_lfu_program,
    "ghost-evict": evict_ghost_program,
    "default": None,
}


def build_plane(num_blocks: int, cost, hw, *, policy: str, profile,
                profile_period: int, tier_blocks: tuple, tier_policy: str,
                khugepaged: bool, seed: int, batch_faults: bool,
                max_batch: int, telemetry, injector, containment: bool,
                device) -> tuple:
    """``(mm, profiler, khugepaged)``: the memory manager over
    ``num_blocks`` HBM blocks (tiered when ``tier_blocks``, the spill
    tiers' capacities down the chain, is not empty) with its reclaim,
    tier, fault and profile programs attached and its hooks warmed (the
    fault and tier hooks at ``max_batch`` rows with ``batch_faults``), the
    online profiler (``profile="auto"``) and khugepaged
    (``policy="ebpf"``).  Raises ``ValueError`` for an unknown name, for
    ``policy="ebpf"`` without a profile and for a 2-tier baseline on a
    deeper chain."""
    default_mode = {"never": "never", "never-prog": "never"}.get(policy,
                                                                 "thp")
    # the policy programs' batch executor runs on the engine's device
    mm_kw = dict(default_mode=default_mode, damon_seed=seed,
                 telemetry=telemetry, injector=injector,
                 containment=containment, device=device)
    if tier_blocks:
        # tiered pool: HBM buddy + one buddy per spill tier; the device
        # cache is materialized over the COMBINED index space so tier
        # crossings are ordinary block_copy moves
        mm = TieredMemoryManager(num_blocks, cost,
                                 tiers=default_tier_chain(hw, tier_blocks),
                                 **mm_kw)
        if tier_policy not in TIER_PROGRAMS:
            raise ValueError(f"unknown tier_policy {tier_policy!r}")
        if len(tier_blocks) > 1 and tier_policy in TWO_TIER_POLICIES:
            raise ValueError(
                f"tier_policy {tier_policy!r} is a 2-tier baseline that "
                f"can never demote past tier 1; use 'heat-tier' or "
                f"'edge-tier' for a {len(tier_blocks) + 1}-tier chain")
        prog = TIER_PROGRAMS[tier_policy]
        if prog is not None:
            mm.attach_tier_program(prog())
    else:
        mm = MemoryManager(num_blocks, cost, **mm_kw)
    mm.attach_reclaim_program(reclaim_lru_program())
    profiler = None
    if policy == "ebpf":
        if profile is None:
            raise ValueError(
                "policy='ebpf' needs a profile (or list, or 'auto')")
        if isinstance(profile, str):
            if profile != "auto":
                raise ValueError(f"unknown profile mode {profile!r}")
            # Online profiling: start with NO profile loaded.  The profiler
            # program samples the live DAMON regions on the mm tick
            # (HOOK_PROFILE) and the ProfileSynthesizer hot-reloads
            # synthesized profiles mid-run.  max_regions=8 keeps the fault
            # program's search loop the shape of a small offline profile's;
            # an EMPTY profile registers the map slot the verifier's
            # indirect-load check needs, and the reloads are map WRITEs
            # into slots registered the same way.
            bound = 8
            mm.load_profile(Profile("_default", []))
            mm.attach_fault_program(ebpf_mm_program(max_regions=bound))
            mm.attach_profile_program(profile_wss_program())
            profiler = ProfileSynthesizer(mm, cost, period=profile_period,
                                          max_regions=bound,
                                          telemetry=telemetry)
            mm.hooks.warm(HOOK_PROFILE, max_batch=16)
        else:
            profiles = profile if isinstance(profile, (list, tuple)) \
                else [profile]
            for prof in profiles:
                mm.load_profile(prof)
            # One program serves every app via the indirect profile-map
            # load; its verified search loop is right-sized to the profiles
            # loaded (rounded up to a power of two), as the reference does.
            nreg = max((len(p.regions) for p in profiles), default=0)
            bound = min(max(8, 1 << max(0, nreg - 1).bit_length()),
                        MAX_PROFILE_REGIONS)
            mm.attach_fault_program(ebpf_mm_program(max_regions=bound))
    elif policy == "thp-prog":
        mm.attach_fault_program(thp_always_program())
    elif policy == "never-prog":
        mm.attach_fault_program(never_program())
    elif policy not in ("thp", "never"):
        raise ValueError(f"unknown policy {policy!r}")
    if batch_faults:
        # build the batch executors now (decode-sized bucket), not on the
        # first faulting step or the first batched tier placement
        mm.hooks.warm(HOOK_FAULT, max_batch=max_batch)
        mm.hooks.warm(HOOK_TIER, max_batch=max_batch)
    khd = (Khugepaged(mm, KhugepagedConfig())
           if khugepaged and policy == "ebpf" else None)
    return mm, profiler, khd
