"""Built-in policy programs, written in the eBPF-flavored ISA.

``ebpf_mm_program()`` is the paper's Figure-1 program:

    1. check the faulting process has a loaded profile,
    2. search the profile for a region containing the faulting address
       (bounded loop over the profile map — the eBPF-map search),
    3. compute the promotion cost for each feasible size from real-time
       system data (bpf_mm_promotion_cost helper: zeroing + compaction),
    4. combine with the profiled benefit + live DAMON heat and choose the
       most beneficial page size.

``thp_always_program`` / ``never_program`` reproduce the kernel baselines
(THP greedily maps PMD-size = order 2; never = base pages only) as loadable
programs so the hook overhead itself can be benchmarked.

``tier_damon_program`` / ``tier_lru_program`` / ``tier_never_program`` are
mm_tier-hook policies for the tiered-memory subsystem (:mod:`repro.core.
tiering`): DAMON-heat admission control, an LRU-demote baseline, and a
never-tier baseline that forces the preemption fallback.  A tier program's
return value is the TARGET TIER id for the candidate page (0 = HBM,
1..NTIERS-1 = spill tiers; the manager clamps and migrates hop by hop).
``tier_heat_band_program`` and ``tier_edge_admission_program`` are the
N-tier policies: heat-banded direct placement (including prefill-time
cold-prefix placement across the spill chain) and TierBPF-style single-hop
per-edge admission control.
"""

from __future__ import annotations

from .context import (CTX, EVICT_DROP, FaultKind, POLICY_FALLBACK,
                      TIER_DEMOTE, TIER_KEEP)
from .isa import Asm, Program
from .profiles import MAX_PROFILE_REGIONS, REGION_STRIDE
from .vm import (HELPER_MIGRATE_COST, HELPER_PROMOTION_COST,
                 HELPER_RINGBUF_OUTPUT)
from ..obs.ringbuf import (EV_PROG_BASE, PROF_TAG_BENEFIT, PROF_TAG_HEAT,
                           PROF_TAG_WSS)


def ebpf_mm_program(profile_map_id: int | None = None,
                    heat_weight_milli: int = 1000,
                    max_regions: int = MAX_PROFILE_REGIONS,
                    trace: bool = False) -> Program:
    """The paper's fault-hook program.

    profile map layout per region (REGION_STRIDE int64s):
        [start, end, benefit_o0, benefit_o1, benefit_o2, benefit_o3]

    The profile map id is read from ctx (PROFILE_MAP_ID) via the indirect
    LDMAPX load — one loaded program serves every application's profile
    (map-in-map, like the userspace framework registering one map per app).
    Passing ``profile_map_id`` pins a static map instead (single-app mode).
    ``max_regions`` bounds the verified search loop; lowering it keeps the
    unrolled (predicated) compile small when profiles are known to be short.
    ``trace=True`` appends a bpf_ringbuf_output emission of every decision
    (tag EV_PROG_BASE, args addr/decision/fault_max_order) — the same event
    stream on all three executors, at the cost of one event slot per lane.

    Register plan:
        r1 addr / helper arg     r2 nregions / fault_max_order / map id
        r3 loop bound counter    r4 region index
        r5 scratch / net benefit r6 best net benefit / map id
        r7 best order            r8 matched region base (-1 = none)
        r9, r10 scratch
    """
    a = Asm()

    def ld_profile(dst, idx_reg):
        if profile_map_id is None:
            a.ldmapx(dst, "r6", idx_reg)
        else:
            a.ldmap(dst, profile_map_id, idx_reg)

    a.ldctx("r1", CTX.ADDR)
    a.ldctx("r2", CTX.HAS_PROFILE)
    a.jeqi("r2", 0, "fallback")
    a.ldctx("r6", CTX.PROFILE_MAP_ID)
    a.ldctx("r2", CTX.PROFILE_NREGIONS)
    a.jeqi("r2", 0, "fallback")

    # ---- profile region search (bounded loop) ----
    a.movi("r8", -1)
    a.movi("r4", 0)
    a.movi("r3", max_regions)
    a.label("loop")
    a.jge("r4", "r2", "next_iter")          # idx >= nregions: nothing left
    a.mov("r9", "r4")
    a.muli("r9", REGION_STRIDE)
    ld_profile("r5", "r9")                  # region.start
    a.jgt("r5", "r1", "next_iter")          # start > addr
    a.mov("r10", "r9")
    a.addi("r10", 1)
    ld_profile("r5", "r10")                 # region.end
    a.jle("r5", "r1", "next_iter")          # end <= addr
    a.mov("r8", "r9")                        # match
    a.ja("search_done")
    a.label("next_iter")
    a.addi("r4", 1)
    a.jnzdec("r3", "loop")
    a.label("search_done")
    a.jlti("r8", 0, "fallback")             # unprofiled address -> default path

    # ---- per-order cost/benefit, unrolled for orders 1..3 ----
    # r6 keeps the profile map id alive for the indirect loads below.
    a.ldctx("r2", CTX.FAULT_MAX_ORDER)
    a.movi("r10", 0)                         # best net benefit
    a.movi("r7", 0)                          # best order
    for k in (1, 2, 3):
        skip = f"skip_{k}"
        a.jlti("r2", k, skip)                # infeasible at this fault
        # profiled benefit
        a.mov("r9", "r8")
        a.addi("r9", 2 + k)
        ld_profile("r5", "r9")
        # + live DAMON heat bonus: heat_k * descriptor_ns * (4^k - 1)
        a.ldctx("r9", CTX.HEAT_O0 + k)
        a.muli("r9", heat_weight_milli)
        a.divi("r9", 1000)
        a.ldctx("r4", CTX.DESCRIPTOR_NS)
        a.mul("r9", "r4")
        a.muli("r9", (4 ** k) - 1)
        a.add("r5", "r9")
        # - promotion cost (zeroing + compaction, from real-time buddy state)
        a.movi("r1", k)
        a.call(HELPER_PROMOTION_COST)        # r0 = cost ns
        a.sub("r5", "r0")
        a.jle("r5", "r10", skip)
        a.mov("r10", "r5")
        a.movi("r7", k)
        a.label(skip)
    a.mov("r0", "r7")
    if not trace:
        a.exit()
        a.label("fallback")
        a.movi("r0", POLICY_FALLBACK)
        a.exit()
        return a.build("ebpf_mm")

    a.ja("emit")
    a.label("fallback")
    a.movi("r0", POLICY_FALLBACK)
    # shared emit tail: bpf_ringbuf_output(tag, addr, decision, max_order)
    a.label("emit")
    a.mov("r9", "r0")                        # decision survives the call
    a.movi("r1", EV_PROG_BASE)
    a.ldctx("r2", CTX.ADDR)
    a.mov("r3", "r9")
    a.ldctx("r4", CTX.FAULT_MAX_ORDER)
    a.call(HELPER_RINGBUF_OUTPUT)
    a.mov("r0", "r9")
    a.exit()
    return a.build("ebpf_mm_traced")


def thp_always_program() -> Program:
    """Linux THP greedy baseline: PMD-size (order 2) whenever feasible."""
    a = Asm()
    a.ldctx("r0", CTX.FAULT_MAX_ORDER)
    a.mini("r0", 2)
    a.maxi("r0", 0)
    a.exit()
    return a.build("thp_always")


def never_program() -> Program:
    """Base pages only (THP=never)."""
    a = Asm()
    a.movi("r0", 0)
    a.exit()
    return a.build("thp_never")


def tier_damon_program(cold_heat_milli: int = 100, promote_horizon: int = 4,
                       pressure_milli: int = 700) -> Program:
    """DAMON-heat admission control for the mm_tier hook (TierBPF-style).

    For an HBM candidate: under soft pressure, approve demotion only when the
    page's own DAMON heat (FIXED_POINT-scaled accesses/window) is below
    ``cold_heat_milli`` — hot pages are vetoed, which is exactly the
    admission control that keeps proactive migration from thrashing.  Under
    HARD pressure (pool effectively full) the veto is waived: reclaim offers
    pages coldest-first and the alternative is whole-sequence preemption.
    For a spill-tier candidate: promote only when there is HBM headroom AND
    the modeled link penalty it pays per aggregation window, amortized over
    ``promote_horizon`` windows, exceeds the one-off migration cost
    (bpf_mm_migrate_cost helper over the page's tier -> HBM path).
    """
    a = Asm()
    a.ldctx("r1", CTX.PAGE_TIER)
    a.jgei("r1", 1, "spill_resident")
    # ---- HBM page: demote-admission control ----
    a.ldctx("r4", CTX.TIER_FREE_BLOCKS)
    a.jeqi("r4", 0, "keep")                  # host tier full -> nothing to gain
    a.ldctx("r3", CTX.MEM_PRESSURE)
    a.jlti("r3", pressure_milli, "keep")     # no real pressure -> keep in HBM
    # hard pressure (pool effectively full): reclaim is demoting coldest-first
    # and the alternative is whole-sequence preemption — admit unconditionally
    a.jgei("r3", 990, "demote")
    a.ldctx("r2", CTX.PAGE_HEAT)
    a.jgei("r2", cold_heat_milli, "keep")    # hot -> veto proactive demotion
    a.label("demote")
    a.movi("r0", TIER_DEMOTE)                # one tier down from HBM
    a.exit()
    a.label("keep")
    a.movi("r0", TIER_KEEP)
    a.exit()
    # ---- spill page: promote when the link tax beats the move cost ----
    a.label("spill_resident")
    a.ldctx("r6", CTX.MEM_PRESSURE)
    a.jgei("r6", 900, "stay")                # no HBM headroom -> avoid churn
    a.ldctx("r7", CTX.PAGE_HEAT)
    a.jeqi("r7", 0, "stay")                  # untouched -> stay demoted
    a.ldctx("r1", CTX.PAGE_ORDER)
    a.ldctx("r2", CTX.PAGE_TIER)
    a.movi("r3", 0)
    a.call(HELPER_MIGRATE_COST)              # r0 = cost(order, tier -> HBM)
    a.mov("r4", "r0")
    # per-window link tax ~= heat * pcie_ns_per_block * 4^order (heat is
    # FIXED_POINT-scaled, so divide it back out at the end)
    a.ldctx("r3", CTX.PCIE_NS_PER_BLOCK)
    a.mul("r3", "r7")
    a.muli("r3", promote_horizon)
    a.ldctx("r5", CTX.PAGE_ORDER)
    a.muli("r5", 2)
    a.lsh("r3", "r5")                        # * 4^order == << 2*order
    a.divi("r3", 1000)
    a.jgt("r3", "r4", "promote")
    a.label("stay")
    a.ldctx("r0", CTX.PAGE_TIER)             # stay where it lives
    a.exit()
    a.label("promote")
    a.movi("r0", TIER_KEEP)
    a.exit()
    return a.build("tier_damon")


def tier_lru_program(min_age_ticks: int = 1) -> Program:
    """LRU-demote baseline: sink any page that has not changed tiers for
    ``min_age_ticks`` engine ticks one tier down the chain, regardless of
    heat; never proactively promote (demoted pages pay the link tax until
    reclaim churn brings them back) — the classic kernel-default weakness
    eBPF tiering fixes.  In a 2-tier topology this is exactly the old
    KEEP/DEMOTE behavior (the manager clamps the bottom tier in place)."""
    a = Asm()
    a.ldctx("r0", CTX.PAGE_TIER)
    a.ldctx("r2", CTX.PAGE_AGE)
    a.jlti("r2", min_age_ticks, "keep")
    a.addi("r0", 1)                          # aged: one tier down
    a.label("keep")
    a.exit()
    return a.build("tier_lru")


def tier_never_program() -> Program:
    """Never-tier baseline: veto every demotion, so reclaim must fall back to
    whole-process preemption — the seed's behavior, as a loadable program."""
    a = Asm()
    a.movi("r0", TIER_KEEP)
    a.exit()
    return a.build("tier_never")


def tier_heat_band_program(hot_milli: int = 1500, warm_milli: int = 400,
                           cool_milli: int = 50,
                           place_pressure_milli: int = 600,
                           recent_blocks: int = 8) -> Program:
    """Heat-banded N-tier placement.

    Scan queries: the page's own DAMON heat (FIXED_POINT-scaled) picks a
    band — hot -> HBM, warm -> tier 1, cool -> tier 2, cold -> the deepest
    tier of the live topology (NTIERS from ctx; shallower topologies clamp).

    Prefill placement queries (FAULT_KIND == PREFILL): with HBM headroom
    everything defaults to HBM (zero behavior change when idle); under
    pressure the most recent ``recent_blocks`` of the prompt stay in HBM and
    the cold prefix spreads across the spill chain oldest-deepest, so cold
    prompts land directly in host/NVMe tiers instead of bouncing through
    reclaim.
    """
    a = Asm()
    a.ldctx("r9", CTX.NTIERS)
    a.subi("r9", 1)                          # deepest tier id
    a.ldctx("r1", CTX.FAULT_KIND)
    a.jnei("r1", int(FaultKind.PREFILL), "scan")
    # ---- prefill placement: cold-prefix spread across the spill chain ----
    a.ldctx("r3", CTX.MEM_PRESSURE)
    a.jlti("r3", place_pressure_milli, "t0")   # headroom -> default to HBM
    a.ldctx("r4", CTX.SEQ_LEN)
    a.subi("r4", recent_blocks)                # cold-prefix end
    a.ldctx("r5", CTX.ADDR)
    a.jge("r5", "r4", "t0")                    # recent tail stays in HBM
    # tier = deepest - floor(addr * deepest / cold_end): oldest prefix lowest
    a.mov("r6", "r5")
    a.mul("r6", "r9")
    a.div("r6", "r4")
    a.mov("r0", "r9")
    a.sub("r0", "r6")
    a.maxi("r0", 1)                            # always a spill tier here
    a.exit()
    # ---- scan path: band by the page's own heat ----
    a.label("scan")
    a.ldctx("r2", CTX.PAGE_HEAT)
    a.jgei("r2", hot_milli, "t0")
    a.jgei("r2", warm_milli, "t1")
    a.jgei("r2", cool_milli, "t2")
    a.mov("r0", "r9")                        # cold -> deepest tier
    a.exit()
    a.label("t2")
    a.movi("r0", 2)
    a.min_("r0", "r9")
    a.exit()
    a.label("t1")
    a.movi("r0", 1)
    a.min_("r0", "r9")
    a.exit()
    a.label("t0")
    a.movi("r0", 0)
    a.exit()
    return a.build("tier_heat_band")


def tier_edge_admission_program(promote_horizon: int = 4,
                                pressure_milli: int = 700) -> Program:
    """Per-edge admission control à la TierBPF: decisions are SINGLE-HOP —
    a page may only cross one edge of the tier graph per decision, and every
    crossing must pass that edge's own cost test via the
    bpf_mm_migrate_cost(order, src, dst) helper.

    The page's per-window link-tax proxy (heat x pcie_ns_per_block x 4^order
    x horizon) is compared against the edge cost both ways: promote one hop
    up when the tax it keeps paying exceeds the up-edge cost; admit a
    one-hop demotion under HBM pressure only when the tax is BELOW the
    down-edge cost (a hotter page would bounce straight back — the classic
    migration-thrash TierBPF's admission control kills).  Hard pressure
    (>= 990 milli) admits demotion unconditionally, and prefill placements
    (heat 0) admit one hop down under pressure — cold prompts enter the
    spill chain at tier 1 and sink edge by edge.

    Promotions additionally gate on the TARGET pool's ACTUAL free list: the
    register-indexed ``LDCTXR`` reads ``TIER_FREE_T{t-1}`` for the page's
    own up-edge and vetoes the hop unless the pool can back the page
    (4^order base blocks) — before the ISA grew a register-indexed ctx
    load, this program could only gate on global HBM pressure, so a hop
    toward a full intermediate pool was approved and then stalled or hopped
    over in the migration engine (the ROADMAP per-tier free-gating item).
    """
    a = Asm()
    a.ldctx("r8", CTX.PAGE_TIER)
    a.ldctx("r9", CTX.NTIERS)
    a.subi("r9", 1)                          # deepest tier id
    # r7 = per-window link-tax proxy, FIXED_POINT divided back out
    a.ldctx("r7", CTX.PAGE_HEAT)
    a.ldctx("r3", CTX.PCIE_NS_PER_BLOCK)
    a.mul("r7", "r3")
    a.muli("r7", promote_horizon)
    a.ldctx("r5", CTX.PAGE_ORDER)
    a.muli("r5", 2)
    a.lsh("r7", "r5")                        # * 4^order == << 2*order
    a.divi("r7", 1000)
    a.jeqi("r8", 0, "demote_side")
    # ---- spill page: promote admission over edge (t, t-1) ----
    a.ldctx("r6", CTX.MEM_PRESSURE)
    a.jgei("r6", 900, "demote_side")         # no HBM headroom -> consider down
    # free-list gate on the TARGET pool: TIER_FREE_T{t-1}, read through the
    # register-indexed ctx load, must cover the page's 4^order base blocks
    a.mov("r4", "r8")
    a.addi("r4", int(CTX.TIER_FREE_T0) - 1)  # ctx offset of TIER_FREE_T{t-1}
    a.ldctxr("r5", "r4")
    a.ldctx("r1", CTX.PAGE_ORDER)
    a.muli("r1", 2)
    a.movi("r4", 1)
    a.lsh("r4", "r1")                        # 4^order == 1 << 2*order
    a.jlt("r5", "r4", "demote_side")         # target pool cannot back it
    a.ldctx("r1", CTX.PAGE_ORDER)
    a.mov("r2", "r8")
    a.mov("r3", "r8")
    a.subi("r3", 1)
    a.call(HELPER_MIGRATE_COST)              # r0 = cost of one hop up
    a.jle("r7", "r0", "demote_side")         # tax under the edge cost: not up
    a.mov("r0", "r8")
    a.subi("r0", 1)
    a.exit()
    # ---- demote admission over edge (t, t+1) ----
    a.label("demote_side")
    a.jge("r8", "r9", "stay")                # already in the deepest tier
    a.ldctx("r6", CTX.MEM_PRESSURE)
    a.jlti("r6", pressure_milli, "stay")     # no pressure -> nothing to gain
    a.jgei("r6", 990, "admit")               # hard pressure: unconditional
    a.ldctx("r1", CTX.PAGE_ORDER)
    a.mov("r2", "r8")
    a.mov("r3", "r8")
    a.addi("r3", 1)
    a.call(HELPER_MIGRATE_COST)              # r0 = cost of one hop down
    a.jgt("r7", "r0", "stay")                # it would bounce back -> veto
    a.label("admit")
    a.mov("r0", "r8")
    a.addi("r0", 1)
    a.exit()
    a.label("stay")
    a.mov("r0", "r8")
    a.exit()
    return a.build("tier_edge_admission")


def evict_lru_program(min_age_ticks: int = 2) -> Program:
    """LRU eviction for the mm_evict hook (prefix-cache reclaim).

    Evict ctx rows are cached prefix entries: PAGE_TIER / PAGE_AGE /
    PAGE_HEAT carry the entry's tier, ticks since its last admission hit and
    DAMON heat; CACHE_* columns carry refcount/hit/size facts plus the
    cache-global budget state.  The return value is the TARGET TIER for the
    entry (its current tier = keep) or EVICT_DROP to free it outright.

    Policy: never touch pinned entries; do nothing while the cache is under
    its HBM budget; over budget, sink entries idle for ``min_age_ticks``
    one tier down the chain, dropping only past the end of the chain.
    """
    a = Asm()
    a.ldctx("r1", CTX.CACHE_REFCOUNT)
    a.jgei("r1", 1, "keep")                  # pinned: borrowers hold it
    a.ldctx("r2", CTX.CACHE_USED_BLOCKS)
    a.ldctx("r3", CTX.CACHE_CAP_BLOCKS)
    a.jle("r2", "r3", "keep")                # under budget: nothing to do
    a.ldctx("r4", CTX.PAGE_AGE)
    a.jlti("r4", min_age_ticks, "keep")      # recently hit: protect
    a.ldctx("r0", CTX.PAGE_TIER)
    a.addi("r0", 1)                          # one tier down the chain
    a.ldctx("r5", CTX.NTIERS)
    a.jlt("r0", "r5", "done")                # still a live tier: demote
    a.movi("r0", EVICT_DROP)                 # past the chain end: drop
    a.label("done")
    a.exit()
    a.label("keep")
    a.ldctx("r0", CTX.PAGE_TIER)
    a.exit()
    return a.build("evict_lru")


def evict_lfu_program(protect_hits: int = 2, min_age_ticks: int = 1) -> Program:
    """LFU eviction for the mm_evict hook: frequency protects.

    Entries that have served at least ``protect_hits`` admissions stay put
    (frequently reused system prompts survive bursts of one-off traffic);
    low-frequency entries idle for ``min_age_ticks`` sink one tier, dropping
    only off the end of the chain.  Pinned entries and an under-budget cache
    are untouchable, as in :func:`evict_lru_program`.
    """
    a = Asm()
    a.ldctx("r1", CTX.CACHE_REFCOUNT)
    a.jgei("r1", 1, "keep")
    a.ldctx("r2", CTX.CACHE_USED_BLOCKS)
    a.ldctx("r3", CTX.CACHE_CAP_BLOCKS)
    a.jle("r2", "r3", "keep")
    a.ldctx("r4", CTX.CACHE_HITS)
    a.jgei("r4", protect_hits, "keep")       # proven reuse: protect
    a.ldctx("r4", CTX.PAGE_AGE)
    a.jlti("r4", min_age_ticks, "keep")
    a.ldctx("r0", CTX.PAGE_TIER)
    a.addi("r0", 1)
    a.ldctx("r5", CTX.NTIERS)
    a.jlt("r0", "r5", "done")
    a.movi("r0", EVICT_DROP)
    a.label("done")
    a.exit()
    a.label("keep")
    a.ldctx("r0", CTX.PAGE_TIER)
    a.exit()
    return a.build("evict_lfu")


def evict_ghost_program(retain_milli: int = 150,
                        min_age_ticks: int = 1) -> Program:
    """Ghost-hit-rate adaptive eviction (the Cache-is-King feedback loop).

    The cache keeps a ghost list of recently evicted keys; a lookup that
    would have hit a ghost entry is an eviction the policy got wrong.  The
    per-entry ghost pressure proxy ``ghost_hits * 1000 / (ghost_hits +
    live_entries + 1)`` rises when evicted prefixes keep coming back:

      * pressure >= ``retain_milli`` — the policy is over-evicting, so stop
        destroying state: demote one hop down the tier chain and PARK at the
        deepest tier instead of dropping (a later hit re-promotes for one
        link-speed copy instead of a full prefill);
      * pressure below it — evicted prefixes are not returning, so stale
        entries are genuinely dead: drop them outright and skip the
        demotion churn.

    Pinned entries and an under-budget cache are untouchable.
    """
    a = Asm()
    a.ldctx("r1", CTX.CACHE_REFCOUNT)
    a.jgei("r1", 1, "keep")
    a.ldctx("r2", CTX.CACHE_USED_BLOCKS)
    a.ldctx("r3", CTX.CACHE_CAP_BLOCKS)
    a.jle("r2", "r3", "keep")
    a.ldctx("r4", CTX.PAGE_AGE)
    a.jlti("r4", min_age_ticks, "keep")
    # ghost pressure (milli) = ghost * 1000 / (ghost + entries + 1)
    a.ldctx("r5", CTX.CACHE_GHOST_HITS)
    a.mov("r6", "r5")
    a.muli("r6", 1000)
    a.ldctx("r7", CTX.CACHE_ENTRIES)
    a.add("r7", "r5")
    a.addi("r7", 1)
    a.div("r6", "r7")
    a.jgei("r6", retain_milli, "park")
    a.movi("r0", EVICT_DROP)                 # nothing comes back: drop
    a.exit()
    a.label("park")
    a.ldctx("r0", CTX.PAGE_TIER)
    a.addi("r0", 1)
    a.ldctx("r8", CTX.NTIERS)
    a.jlt("r0", "r8", "done")
    a.subi("r0", 1)                          # deepest already: stay parked
    a.label("done")
    a.exit()
    a.label("keep")
    a.ldctx("r0", CTX.PAGE_TIER)
    a.exit()
    return a.build("evict_ghost")


def profile_wss_program(idle_milli: int = 50) -> Program:
    """Per-region WSS / idle-page estimator for the mm_profile hook.

    Profile ctx rows are live DAMON regions (PROF_* columns); the program
    classifies each region against an idle threshold the way the WSS paper's
    in-kernel estimator classifies idle pages: a region whose access EMA is
    below ``idle_milli`` (FIXED_POINT-scaled accesses/window) contributes 0
    blocks to the working set, anything else contributes its full span.  The
    per-region contribution is emitted through bpf_ringbuf_output
    (PROF_TAG_WSS) so the host synthesizer can fold the samples into a WSS
    curve; the return value is the region's hot score (its heat, or
    PROFILE_COLD for idle regions).
    """
    a = Asm()
    a.ldctx("r6", CTX.PROF_REGION_END)
    a.ldctx("r7", CTX.PROF_REGION_START)
    a.sub("r6", "r7")                        # region span, blocks
    a.ldctx("r8", CTX.PROF_REGION_HEAT)
    a.movi("r5", 0)                          # WSS contribution
    a.movi("r9", 0)                          # hot score (PROFILE_COLD)
    a.jlti("r8", idle_milli, "emit")         # idle: contributes nothing
    a.mov("r5", "r6")
    a.mov("r9", "r8")
    a.label("emit")
    a.movi("r1", PROF_TAG_WSS)
    a.ldctx("r2", CTX.PID)
    a.mov("r3", "r5")
    a.mov("r4", "r6")
    a.call(HELPER_RINGBUF_OUTPUT)
    a.mov("r0", "r9")
    a.exit()
    return a.build("profile_wss")


def profile_heat_histogram_program() -> Program:
    """Log2 heat-histogram accumulator for the mm_profile hook.

    Buckets each DAMON region by ``floor(log2(heat))`` with a verified
    bounded loop (the shift-count idiom an in-kernel histogram program
    uses), and emits (pid, bucket, region blocks) through
    bpf_ringbuf_output (PROF_TAG_HEAT) — one histogram sample per region
    per aggregation window.  Returns the bucket index.
    """
    a = Asm()
    a.ldctx("r2", CTX.PROF_REGION_HEAT)
    a.ldctx("r6", CTX.PROF_REGION_END)
    a.ldctx("r7", CTX.PROF_REGION_START)
    a.sub("r6", "r7")                        # region span, blocks
    a.movi("r5", 0)                          # bucket = floor(log2(heat))
    a.movi("r3", 31)                         # verifier loop bound
    a.label("log2")
    a.jlei("r2", 1, "emit")
    a.divi("r2", 2)
    a.addi("r5", 1)
    a.jnzdec("r3", "log2")
    a.label("emit")
    a.movi("r1", PROF_TAG_HEAT)
    a.ldctx("r2", CTX.PID)
    a.mov("r3", "r5")
    a.mov("r4", "r6")
    a.call(HELPER_RINGBUF_OUTPUT)
    a.mov("r0", "r5")
    a.exit()
    return a.build("profile_heat_hist")


def profile_benefit_program(heat_weight_milli: int = 1000) -> Program:
    """Promotion-benefit scorer for the mm_profile hook (CBMM mold).

    For each DAMON region, estimates what a profile entry is worth: the
    per-window TLB/descriptor saving of mapping the region at order k
    (heat x descriptor_ns x (4^k - 1), heat FIXED_POINT-divided back out)
    minus the live promotion cost from real-time buddy state
    (bpf_mm_promotion_cost) — the same cost/benefit arithmetic the Fig-1
    fault program applies at fault time, run SPECULATIVELY over the region
    stream so the synthesizer can write the winning benefit into the
    region's profile entry before any fault touches it.  Emits
    (region start, best order, net benefit) via bpf_ringbuf_output
    (PROF_TAG_BENEFIT); returns the best net benefit (0 = not worth it).
    """
    a = Asm()
    a.ldctx("r8", CTX.PROF_REGION_HEAT)
    a.movi("r10", 0)                         # best net benefit
    a.movi("r7", 0)                          # best order
    for k in (1, 2, 3):
        skip = f"skip_{k}"
        a.ldctx("r6", CTX.PROF_REGION_END)
        a.ldctx("r5", CTX.PROF_REGION_START)
        a.sub("r6", "r5")
        a.jlti("r6", 4 ** k, skip)           # order must fit in the region
        a.mov("r9", "r8")
        a.muli("r9", heat_weight_milli)
        a.divi("r9", 1000)
        a.ldctx("r4", CTX.DESCRIPTOR_NS)
        a.mul("r9", "r4")
        a.muli("r9", (4 ** k) - 1)
        a.divi("r9", 1000)                   # heat is FIXED_POINT-scaled
        a.movi("r1", k)
        a.call(HELPER_PROMOTION_COST)        # r0 = cost ns
        a.sub("r9", "r0")
        a.jle("r9", "r10", skip)
        a.mov("r10", "r9")
        a.movi("r7", k)
        a.label(skip)
    a.movi("r1", PROF_TAG_BENEFIT)
    a.ldctx("r2", CTX.PROF_REGION_START)
    a.mov("r3", "r7")
    a.mov("r4", "r10")
    a.call(HELPER_RINGBUF_OUTPUT)
    a.mov("r0", "r10")
    a.exit()
    return a.build("profile_benefit")


def reclaim_lru_program() -> Program:
    """Default reclaim-hook program: pick the coldest candidate.

    Reclaim ctx reuses the fault ctx layout: HEAT_O0..O3 carry the heat of up
    to 4 victim candidates and ADDR carries the candidate count; returns the
    index of the victim (lowest heat), or FALLBACK when no candidates.
    """
    a = Asm()
    a.ldctx("r1", CTX.ADDR)                 # candidate count
    a.jeqi("r1", 0, "none")
    a.movi("r0", 0)                          # best idx
    a.ldctx("r2", CTX.HEAT_O0)               # best heat
    for i in (1, 2, 3):
        a.jlei("r1", i, "done")              # fewer than i+1 candidates
        a.ldctx("r3", CTX.HEAT_O0 + i)
        a.jge("r3", "r2", f"skip_{i}")
        a.mov("r2", "r3")
        a.movi("r0", i)
        a.label(f"skip_{i}")
    a.label("done")
    a.exit()
    a.label("none")
    a.movi("r0", POLICY_FALLBACK)
    a.exit()
    return a.build("reclaim_lru")
