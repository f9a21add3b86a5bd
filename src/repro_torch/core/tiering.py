"""Tiered memory: eBPF-guided placement over an N-pool tier graph.

The paper names page placement across memory tiers as the natural next hook
after the fault-path page-size hook and stubs it as ``HOOK_TIER``.  This
module implements that subsystem over an N-pool tier chain — local HBM
(tier 0) plus up to three spill tiers (peer-HBM over ICI, host DRAM over
PCIe, NVMe), each with its own buddy allocator — a
:class:`TieredMemoryManager` over :class:`~repro.core.mm.MemoryManager`
whose :class:`PageMapping`\\ s carry a tier id, and a migration engine that
emits explicit move lists the device executes with the block_copy kernel,
with per-edge bandwidth/setup costs accounted in the
:class:`~repro.core.cost.CostModel` edge table.

Device addressing: the engine materializes ONE combined pool of
``sum(pool sizes)`` base blocks.  Indices ``[0, num_blocks)`` are HBM; each
spill tier occupies the next contiguous span (pinned mirrors the device can
DMA from at that tier's link bandwidth — charged by the cost model, while
the copies themselves stay exact).  Tier crossings are therefore ordinary
``(src, dst, order)`` moves in combined coordinates and reuse the existing
``drain_moves`` / block_copy path unchanged.  Multi-hop crossings
(NVMe -> DRAM -> HBM) chain through intermediate pools hop by hop when they
have room — each hop is its own move, batched through the same pre-kernel
flush — and hop OVER a full intermediate tier (the link is still traversed
and charged) when they don't.

Policy: every migration/placement decision is delegated to the verified
program attached to ``HOOK_TIER`` (TierBPF-style per-edge admission
control).  The program sees a :class:`~repro.core.context.FaultContext`
describing the candidate page (tier, order, DAMON heat, age) plus every
pool's real-time state and the cumulative per-edge migration cost tables,
and returns the TARGET TIER id the page should live in (0 = HBM; the
manager clamps to the live topology and migrates hop by hop).  Prefill-time
placement: ``fault_batch``/``ensure_range`` consult ``HOOK_TIER`` once per
prefill batch so profiles can place cold prefixes directly in the far tiers
instead of defaulting to HBM.  With nothing attached, a kernel-default
policy runs without building the ctx at all — the paper's zero-overhead
property, extended to the new hook.  Decisions over many candidates run
through the vectorized JIT batch path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .buddy import BuddyAllocator, BuddyError, order_blocks
from .context import (CTX, FIXED_POINT, MAX_TIERS, NUM_ORDERS,
                      POLICY_DETACHED, POLICY_FALLBACK, TIER_KEEP,
                      FaultContext, FaultKind, ctx_batch, fill_system_columns)
from .cost import CostModel, TierSpec, host_dram_tier
from .hooks import HOOK_TIER
from .mm import MemoryManager, PageMapping, ProcessState
from ..obs.ringbuf import EV_MIGRATE_HOP, EV_QUARANTINE, EV_READMIT, EV_RETRY
from ..resilience.faults import SITE_MIGRATE_COPY, SITE_TIER_ALLOC
from ..resilience.health import TierHealthMonitor

TIER_HBM = 0
TIER_HOST = 1     # the first spill tier of the classic 2-pool topology

# Bounded migration retry: a hop copy that fails (injected link error or a
# flap window) is retried up to this many times, each failed attempt
# charging exponentially growing backoff in MODELED time before the next.
# The no-containment baseline (containment=False) gets a single shot.
MIGRATE_MAX_ATTEMPTS = 3
RETRY_BACKOFF_NS = 500_000      # first-retry backoff; doubles per attempt


@dataclass
class TierConfig:
    """Migration-engine knobs (throttles, like khugepaged's)."""
    promote_blocks_per_tick: int = 16    # promotion-scan budget per engine tick
    demote_chunk_blocks: int = 16        # min HBM blocks to free per reclaim event
    batch_threshold: int = 4             # >= this many candidates -> JIT batch path


class TieredMemoryManager(MemoryManager):
    """MemoryManager with an N-pool tier chain behind HOOK_TIER.

    HBM pages live in ``self.pools[0]`` (== ``self.buddy``, tier 0), spill
    tiers 1..N-1 in ``self.pools[1:]`` (peer-HBM / host DRAM / NVMe — the
    topology comes from ``tiers`` or defaults to the classic single
    host-DRAM pool of ``host_blocks``).  ``phys_start`` of a mapping is
    always an index within its own tier's pool; :meth:`_device_index` folds
    all pools into the combined device pool the engine materializes.
    """

    def __init__(self, num_blocks: int, cost: CostModel, *,
                 host_blocks: int = 0, tiers=None,
                 tier_cfg: TierConfig | None = None, **kw) -> None:
        super().__init__(num_blocks, cost, **kw)
        if tiers is None:
            if host_blocks <= 0:
                raise ValueError("host_blocks must be positive (use "
                                 "MemoryManager for an untiered pool)")
            tiers = (host_dram_tier(cost.hw, host_blocks),)
        tiers = tuple(tiers)
        if not 1 <= len(tiers) <= MAX_TIERS - 1:
            raise ValueError(f"need 1..{MAX_TIERS - 1} spill tiers")
        if any(s.blocks <= 0 for s in tiers):
            raise ValueError("every spill tier needs positive capacity")
        # the cost model's per-edge table must describe the same chain the
        # pools are built from (bpf_mm_migrate_cost == engine accounting);
        # a CostModel already bound to a DIFFERENT chain would silently
        # re-cost another manager's pools, so that reuse is rejected
        if cost.topology is not None and tuple(cost.topology) != tiers:
            raise ValueError(
                "CostModel is already bound to a different tier topology; "
                "use a fresh CostModel per tier chain")
        cost.topology = tiers
        self.tier_specs: tuple[TierSpec, ...] = tiers
        self.pools: list[BuddyAllocator] = [self.buddy] + [
            BuddyAllocator(s.blocks, max_order=self.max_order) for s in tiers]
        # device base-block offset of each tier in the combined pool
        self._tier_base = [0]
        for p in self.pools[:-1]:
            self._tier_base.append(self._tier_base[-1] + p.num_blocks)
        self.tier_cfg = tier_cfg or TierConfig()
        # Per-edge link health: error counters + exponential-backoff
        # quarantine keyed on the modeled clock; quarantine routing (and the
        # degraded demote fallback) is disabled on the no-containment
        # baseline but errors are still counted.
        self.health = TierHealthMonitor(len(tiers), cost.edge_names(),
                                        quarantine=self.containment)
        # (pid, logical_start) -> ktime_ns of the last tier change / install
        self._tier_stamp: dict[tuple[int, int], int] = {}
        # Scan-ctx cache: the per-candidate columns of a tier-scan ctx matrix
        # (heat, identity, geometry) are reused across ticks while the
        # candidate set and every involved DAMON monitor are unchanged; only
        # the time-varying columns (clock, age, pool state) are refreshed.
        self._scan_ctx_cache: dict[str, tuple] = {}
        self.ctx_cache_hits = 0
        self.ctx_cache_misses = 0

    # --------------------------------------------------------------- geometry
    @property
    def ntiers(self) -> int:
        return len(self.pools)

    @property
    def host_buddy(self) -> BuddyAllocator:
        """The first spill pool (the classic host-DRAM tier)."""
        return self.pools[TIER_HOST]

    @property
    def host_blocks(self) -> int:
        return self.pools[TIER_HOST].num_blocks

    @property
    def device_pool_blocks(self) -> int:
        """Size of the combined device pool (HBM + every spill mirror)."""
        return sum(p.num_blocks for p in self.pools)

    def _device_index(self, m: PageMapping) -> int:
        return self._tier_base[m.tier] + m.phys_start

    def _free_phys(self, m: PageMapping) -> None:
        # shared (prefix-cache-borrowed) pages belong to the cache, not the
        # borrower's page table — same contract as the base manager
        if m.shared:
            return
        self.pools[m.tier].free(m.phys_start)

    def free_process(self, pid: int) -> None:
        super().free_process(pid)
        self._tier_stamp = {k: v for k, v in self._tier_stamp.items()
                            if k[0] != pid}

    def unmap(self, pid: int, logical_start: int) -> None:
        super().unmap(pid, logical_start)
        self._tier_stamp.pop((pid, logical_start), None)

    def _install(self, st, addr, order, hinted):
        r = super()._install(st, addr, order, hinted)
        a = (addr // order_blocks(r.order)) * order_blocks(r.order)
        self._tier_stamp[(st.pid, a)] = self.ktime_ns
        return r

    def collapse(self, pid: int, addr: int, to_order: int):
        r = super().collapse(pid, addr, to_order)
        if r is not None:
            a = (addr // order_blocks(r.order)) * order_blocks(r.order)
            self._tier_stamp[(pid, a)] = self.ktime_ns
        return r

    # ------------------------------------------------------------ tier policy
    def _page_age_ticks(self, pid: int, logical_start: int) -> int:
        born = self._tier_stamp.get((pid, logical_start), 0)
        return max(0, (self.ktime_ns - born) // 1_000_000)

    def _tier_columns(self, pstats) -> dict:
        """Per-tier pool state + cumulative edge-cost tables for ctx fill
        (``pstats`` = one BuddyStats per pool, computed once per call)."""
        free = [0] * MAX_TIERS
        total = [0] * MAX_TIERS
        for t, s in enumerate(pstats):
            free[t] = s.free_blocks
            total[t] = s.total_blocks
        cum_setup, cum_ns = self.cost.migrate_cum_tables()
        levels = [es.level for es in self.health.edges]
        if any(levels):
            # Flap-aware DECISION costs: an edge with a nonzero backoff level
            # has flapped recently — even while up it is a bad bet, so the
            # cost the policy sees is inflated by (1 + level) on that edge.
            # Applied on top of the memoized physical tables (never inside
            # their memo — the physical accounting in migrate_ns stays
            # health-independent), rebuilt per call as levels decay.
            cs = np.asarray(cum_setup, dtype=np.int64)
            cn = np.asarray(cum_ns, dtype=np.int64)
            mul = np.ones(cs.size - 1, dtype=np.int64)
            mul[:len(levels)] += np.asarray(levels, dtype=np.int64)
            cum_setup = tuple(np.concatenate(
                [cs[:1], cs[0] + np.cumsum(np.diff(cs) * mul)]).tolist())
            cum_ns = tuple(np.concatenate(
                [cn[:1], cn[0] + np.cumsum(np.diff(cn) * mul)]).tolist())
        return dict(ntiers=self.ntiers, tier_free=tuple(free),
                    tier_total=tuple(total), mig_cum_setup=cum_setup,
                    mig_cum_ns=cum_ns)

    def _tier_ctx(self, st: ProcessState, m: PageMapping,
                  kind: int = int(FaultKind.FIRST_TOUCH),
                  seq_len: int | None = None) -> np.ndarray:
        pstats = [p.stats() for p in self.pools]
        bstats = pstats[0]
        hstats = pstats[TIER_HOST]
        tc = self._tier_columns(pstats)
        fc = FaultContext(
            addr=m.logical_start, pid=st.pid, vma_start=0, vma_end=st.vma_end,
            fault_max_order=m.order, has_profile=0, profile_map_id=0,
            profile_nregions=0,
            free_blocks=bstats.free_per_order,
            frag=bstats.frag_index_milli,
            heat=st.damon.heat_vector(m.logical_start),
            zero_ns_per_block=self.cost.zero_ns_per_block(),
            compact_ns_per_block=self.cost.compact_ns_per_block(),
            descriptor_ns=int(self.cost.hw.descriptor_ns),
            block_bytes=self.cost.block_bytes,
            ktime_ns=self.ktime_ns,
            mem_pressure=bstats.utilization_milli,
            fault_kind=int(kind),
            seq_len=st.vma_end if seq_len is None else seq_len,
            tier_free_blocks=hstats.free_blocks,
            tier_total_blocks=hstats.total_blocks,
            tier_pressure=hstats.utilization_milli,
            pcie_ns_per_block=self.cost.pcie_ns_per_block(),
            page_tier=m.tier,
            page_order=m.order,
            page_age=self._page_age_ticks(st.pid, m.logical_start),
            page_heat=int(st.damon.heat_at(m.logical_start, m.order)
                          * FIXED_POINT),
            migrate_setup_ns=self.cost.migrate_setup_ns(0, 1),
            migrate_ns_per_block=self.cost.migrate_ns_per_block(0, 1),
            **tc,
        )
        return fc.vector()

    def _default_tier_decision(self, st: ProcessState, m: PageMapping) -> int:
        """Kernel-default tiering with no program attached: approve one-hop
        demotion of whatever reclaim nominated (candidates arrive
        coldest-first), and bring spill-tier pages that have been touched
        since demotion back to HBM."""
        if m.tier == TIER_HBM:
            return min(m.tier + 1, self.ntiers - 1)
        return (TIER_KEEP if st.damon.heat_at(m.logical_start, m.order) > 0
                else m.tier)

    def _build_tier_mat(self, cands: list[tuple[ProcessState, PageMapping]]
                        ) -> np.ndarray:
        """Vectorized per-candidate ctx columns (identity, geometry, DAMON
        heat) — the part of the matrix the scan cache can reuse across
        ticks.  Time-varying columns are filled by the caller."""
        n = len(cands)
        mat = ctx_batch(n)
        pids = np.fromiter((st.pid for st, _ in cands), np.int64, n)
        addrs = np.fromiter((m.logical_start for _, m in cands), np.int64, n)
        orders = np.fromiter((m.order for _, m in cands), np.int64, n)
        tiers = np.fromiter((m.tier for _, m in cands), np.int64, n)
        mat[:, CTX.ADDR] = addrs
        mat[:, CTX.PID] = pids
        mat[:, CTX.FAULT_MAX_ORDER] = orders
        mat[:, CTX.PAGE_ORDER] = orders
        mat[:, CTX.PAGE_TIER] = tiers
        for pid in np.unique(pids):
            st = self.procs[int(pid)]
            sel = pids == pid
            mat[sel, CTX.VMA_END] = st.vma_end
            mat[sel, CTX.SEQ_LEN] = st.vma_end
            mat[sel, CTX.HEAT_O0:CTX.HEAT_O0 + NUM_ORDERS] = \
                st.damon.heat_matrix(addrs[sel])
            for k in np.unique(orders[sel]):
                s2 = sel & (orders == k)
                heat = st.damon.heat_many(addrs[s2], int(k)) * FIXED_POINT
                mat[s2, CTX.PAGE_HEAT] = heat.astype(np.int64)
        return mat

    def _tier_ctx_batch(self, cands: list[tuple[ProcessState, PageMapping]],
                        *, cache: str | None = None,
                        kind: int = int(FaultKind.FIRST_TOUCH),
                        seq_lens: dict[int, int] | None = None) -> np.ndarray:
        """Ctx matrix for a candidate batch; row ``i`` equals
        ``_tier_ctx(*cands[i])``.  With ``cache`` set, the per-candidate
        columns are reused across ticks while the candidate set and the
        involved DAMON monitors are unchanged (the ROADMAP's promotion-scan
        cost item); the clock/age/pool-state columns refresh every call.
        ``seq_lens`` (pid -> logical extent) overrides the SEQ_LEN column —
        placement queries pass the PREFILL SPAN extent, not the VMA end, so
        programs anchor "recent tail" logic to the prompt actually mapped;
        it is incompatible with ``cache`` (the override would poison the
        cached per-candidate columns)."""
        assert not (cache and seq_lens), "seq_lens would poison the scan cache"
        key = (tuple((st.pid, m.logical_start, m.tier, m.order)
                     for st, m in cands),
               tuple(sorted({(st.pid, st.damon.version) for st, _ in cands})))
        cached = self._scan_ctx_cache.get(cache) if cache else None
        if cached is not None and cached[0] == key:
            mat = cached[1]
            self.ctx_cache_hits += 1
        else:
            mat = self._build_tier_mat(cands)
            self.ctx_cache_misses += 1
            if cache:
                self._scan_ctx_cache[cache] = (key, mat)
        pstats = [p.stats() for p in self.pools]
        bstats = pstats[0]
        hstats = pstats[TIER_HOST]
        fill_system_columns(
            mat,
            free_blocks=bstats.free_per_order,
            frag=bstats.frag_index_milli,
            zero_ns_per_block=self.cost.zero_ns_per_block(),
            compact_ns_per_block=self.cost.compact_ns_per_block(),
            descriptor_ns=int(self.cost.hw.descriptor_ns),
            block_bytes=self.cost.block_bytes,
            ktime_ns=self.ktime_ns,
            mem_pressure=bstats.utilization_milli,
            tier_free_blocks=hstats.free_blocks,
            tier_total_blocks=hstats.total_blocks,
            tier_pressure=hstats.utilization_milli,
            pcie_ns_per_block=self.cost.pcie_ns_per_block(),
            migrate_setup_ns=self.cost.migrate_setup_ns(0, 1),
            migrate_ns_per_block=self.cost.migrate_ns_per_block(0, 1),
            **self._tier_columns(pstats))
        mat[:, CTX.FAULT_KIND] = int(kind)
        if seq_lens is not None:
            mat[:, CTX.SEQ_LEN] = np.fromiter(
                (seq_lens.get(st.pid, st.vma_end) for st, _ in cands),
                np.int64, len(cands))
        mat[:, CTX.PAGE_AGE] = np.fromiter(
            (self._page_age_ticks(st.pid, m.logical_start)
             for st, m in cands), np.int64, len(cands))
        return mat

    def tier_decisions(self, cands: list[tuple[ProcessState, PageMapping]],
                       *, scan: str | None = None,
                       kind: int = int(FaultKind.FIRST_TOUCH),
                       force_batch: bool = False,
                       seq_lens: dict[int, int] | None = None) -> list[int]:
        """Run HOOK_TIER over candidate pages; returns one TARGET TIER id per
        candidate, clamped to the live topology.  Vectorized when the batch
        is large enough to amortize the XLA dispatch (``force_batch`` pins
        the batch route — ONE program invocation however small the batch).
        ``scan`` names the ctx cache slot the batch matrix may be reused
        from across ticks."""
        if not cands:
            return []
        if not self.hooks.attached(HOOK_TIER):
            # zero-overhead default path: no ctx build, no VM run
            return [self._default_tier_decision(st, m) for st, m in cands]
        if force_batch or len(cands) >= self.tier_cfg.batch_threshold:
            mat = self._tier_ctx_batch(cands, cache=scan, kind=kind,
                                       seq_lens=seq_lens)
            raw = self.hooks.run_batch(HOOK_TIER, mat)
            decisions = [int(d) for d in raw]
        else:
            decisions = []
            for st, m in cands:
                r = self.hooks.run(HOOK_TIER, self._tier_ctx(
                    st, m, kind,
                    seq_len=seq_lens.get(st.pid) if seq_lens else None))
                # None: the supervisor detached the hook mid-loop — the
                # remaining candidates take the kernel default, matching the
                # batched route's POLICY_DETACHED tail rows
                decisions.append(POLICY_DETACHED if r is None else int(r))
        last = self.ntiers - 1
        return [self._default_tier_decision(st, m)
                if d in (POLICY_FALLBACK, POLICY_DETACHED)
                else max(0, min(d, last))
                for (st, m), d in zip(cands, decisions)]

    def system_ctx_columns(self) -> dict:
        pstats = [p.stats() for p in self.pools]
        hstats = pstats[TIER_HOST]
        cols = super().system_ctx_columns()
        cols.update(
            tier_free_blocks=hstats.free_blocks,
            tier_total_blocks=hstats.total_blocks,
            tier_pressure=hstats.utilization_milli,
            pcie_ns_per_block=self.cost.pcie_ns_per_block(),
            migrate_setup_ns=self.cost.migrate_setup_ns(0, 1),
            migrate_ns_per_block=self.cost.migrate_ns_per_block(0, 1),
            **self._tier_columns(pstats))
        return cols

    # ----------------------------------------------- prefix-cache integration
    def cache_alloc_block(self) -> int | None:
        return self._alloc_in_tier(0, 0)

    def cache_free_block(self, tier: int, phys: int) -> None:
        self.pools[tier].free(phys)

    def cache_device_index(self, tier: int, phys: int) -> int:
        return self._tier_base[tier] + phys

    def migrate_cache_block(self, blk, dst_tier: int) -> bool:
        """Hop-by-hop migration for one cache-owned base block that lives in
        NO page table (prefix-cache demotion/promotion).  Same routing rules
        as :meth:`migrate_page` — nearest tier toward the target with room,
        quarantined edges hopped over — but the only bookkeeping is the move
        list, the per-edge cost, and ``blk``'s own (tier, phys).  Entries
        with live borrowers are never offered here (the evict scan only
        nominates refcount-0 entries), so no page table needs repointing."""
        dst_tier = max(0, min(dst_tier, self.ntiers - 1))
        h = self.health
        tel = self.telemetry
        while blk.tier != dst_tier:
            step = 1 if dst_tier > blk.tier else -1
            placed = False
            for t in range(blk.tier + step, dst_tier + step, step):
                if h.active and not h.path_ok(blk.tier, t, self.ktime_ns):
                    continue
                phys = self._alloc_in_tier(t, 0)
                if phys is None:
                    continue
                src_dev = self._tier_base[blk.tier] + blk.phys
                self._move_log.append((src_dev, self._tier_base[t] + phys, 0))
                self.pools[blk.tier].free(blk.phys)
                hop_ns = self.cost.migrate_ns(0, blk.tier, t)
                self.stats.mgmt_ns += hop_ns
                if tel is not None and tel.enabled:
                    tel.observe_migrate(hop_ns)
                    tel.emit(EV_MIGRATE_HOP, (blk.tier << 8) | t,
                             self.cost.block_bytes, hop_ns, ts=self.ktime_ns)
                if t > blk.tier:
                    self.stats.demotions += 1
                    self.stats.demotion_blocks += 1
                else:
                    self.stats.tier_promotions += 1
                    self.stats.tier_promotion_blocks += 1
                blk.tier, blk.phys = t, phys
                placed = True
                break
            if not placed:
                return False
        return True

    # -------------------------------------------------------------- migration
    def _alloc_in_tier(self, tier: int, order: int, *, pid: int = -1,
                       addr: int = -1) -> int | None:
        """Allocate an order-k page in ``tier``'s pool, compacting it once if
        fragmented; None when the pool genuinely cannot back the page (or an
        injected SITE_TIER_ALLOC fault transiently fails it — the caller
        hops over, same as a full pool)."""
        inj = self.injector
        if inj is not None and inj.fires(SITE_TIER_ALLOC, tier, pid, addr,
                                         self.ktime_ns):
            self.stats.tier_alloc_failures += 1
            self.health.record_alloc_failure(tier)
            return None
        pool = self.pools[tier]
        try:
            return pool.alloc(order)
        except BuddyError:
            plan = pool.plan_compaction(order)
            if plan is None:
                return None
            self._apply_compaction(plan, tier=tier,
                                   device_offset=self._tier_base[tier])
            try:
                return pool.alloc(order)
            except BuddyError:
                return None

    def _hop(self, st: ProcessState, m: PageMapping, dst_tier: int,
             phys: int) -> None:
        """Bookkeeping for one committed hop: emit the device copy, release
        the old block, charge the per-edge path cost, bump the stats."""
        n = order_blocks(m.order)
        src_dev = self._device_index(m)
        self._move_log.append((src_dev, self._tier_base[dst_tier] + phys,
                               m.order))
        self.pools[m.tier].free(m.phys_start)
        hop_ns = self.cost.migrate_ns(m.order, m.tier, dst_tier)
        self.stats.mgmt_ns += hop_ns
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.observe_migrate(hop_ns)
            tel.emit(EV_MIGRATE_HOP, (m.tier << 8) | dst_tier,
                     n * self.cost.block_bytes, hop_ns, ts=self.ktime_ns)
        if dst_tier > m.tier:
            self.stats.demotions += 1
            self.stats.demotion_blocks += n
        else:
            self.stats.tier_promotions += 1
            self.stats.tier_promotion_blocks += n
        m.phys_start = phys
        m.tier = dst_tier
        self._note_mapped(st, m)
        self._tier_stamp[(st.pid, m.logical_start)] = self.ktime_ns

    def _copy_fail_edge(self, st: ProcessState, m: PageMapping, t: int,
                        attempt: int) -> int:
        """First edge on the ``m.tier -> t`` crossing that fails this copy
        attempt (injected link flap or copy error), or -1 when the copy
        succeeds.  Keyed on stable page identity + modeled time so the
        schedule replays identically across fault routes and executors."""
        inj = self.injector
        if inj is None:
            return -1
        lo, hi = sorted((m.tier, t))
        for e in range(lo, hi):
            if inj.link_down(e, self.ktime_ns) or inj.fires(
                    SITE_MIGRATE_COPY, st.pid, m.logical_start, e, attempt,
                    self.ktime_ns):
                return e
        return -1

    def _attempt_copy(self, st: ProcessState, m: PageMapping, t: int,
                      phys: int) -> bool:
        """Bounded-retry copy for one hop (single shot when containment is
        off).  Each failed attempt records the error against the failing
        edge — feeding its quarantine state machine — and charges
        exponentially growing backoff in MODELED time; exhausting the
        budget rolls the destination allocation back, so the page stays
        put and its KV bytes are never touched by a failed copy."""
        h = self.health
        tel = self.telemetry
        attempts = MIGRATE_MAX_ATTEMPTS if self.containment else 1
        for attempt in range(1, attempts + 1):
            edge = self._copy_fail_edge(st, m, t, attempt)
            if edge < 0:
                if h.active:
                    lo, hi = sorted((m.tier, t))
                    for e in range(lo, hi):
                        if h.record_edge_success(e, self.ktime_ns) \
                                and tel is not None and tel.enabled:
                            es = h.edges[e]
                            tel.emit(EV_READMIT, e, es.errors, es.successes,
                                     ts=self.ktime_ns)
                self._hop(st, m, t, phys)
                return True
            newly_quarantined = h.record_edge_error(edge, self.ktime_ns)
            if newly_quarantined and tel is not None and tel.enabled:
                es = h.edges[edge]
                tel.emit(EV_QUARANTINE, edge, es.backoff_ns(), es.level,
                         ts=self.ktime_ns)
                tel.inc("edge_quarantines")
            if attempt < attempts:
                backoff = RETRY_BACKOFF_NS << (attempt - 1)
                self.stats.migrate_retries += 1
                self.stats.mgmt_ns += backoff
                if tel is not None and tel.enabled:
                    tel.emit(EV_RETRY, edge, attempt, backoff,
                             ts=self.ktime_ns)
        self.stats.migrate_aborts += 1
        self.pools[t].free(phys)
        return False

    def migrate_page(self, pid: int, logical_start: int,
                     dst_tier: int) -> bool:
        """Move one mapping toward ``dst_tier``, hop by adjacent hop.  Each
        hop allocates in the nearest tier toward the target with room
        (compacting it if fragmented), emits one device copy and charges the
        per-edge path cost — so an NVMe->HBM promotion chains
        NVMe->DRAM->HBM when the intermediates have room and hops over them
        (still paying their link crossings) when they don't.  A quarantined
        edge is hopped over the same way; a hop whose copy keeps failing
        (see :meth:`_attempt_copy`) is abandoned with the page left where it
        was.  Returns True iff the page ends in ``dst_tier``; partial
        progress (it moved but stalled short) leaves the page at the tier
        it reached."""
        st = self.procs[pid]
        m = st.page_table[logical_start]
        if m.shared:
            return False    # cache-owned phys: only the cache migrates it
        dst_tier = max(0, min(dst_tier, self.ntiers - 1))
        h = self.health
        while m.tier != dst_tier:
            step = 1 if dst_tier > m.tier else -1
            placed = False
            for t in range(m.tier + step, dst_tier + step, step):
                if h.active and not h.path_ok(m.tier, t, self.ktime_ns):
                    continue    # a quarantined edge on the way: hop over
                phys = self._alloc_in_tier(t, m.order, pid=pid,
                                           addr=m.logical_start)
                if phys is None:
                    continue
                if self._attempt_copy(st, m, t, phys):
                    placed = True
                    break
            if not placed:
                return False
        return True

    def demote_page(self, pid: int, logical_start: int) -> bool:
        """Move one mapping one tier down the chain (HBM -> host in the
        2-pool topology). Returns False if the page is already in the
        deepest tier or no pool below can back it."""
        m = self.procs[pid].page_table[logical_start]
        if m.tier >= self.ntiers - 1:
            return False
        return self.migrate_page(pid, logical_start, m.tier + 1)

    def promote_page(self, pid: int, logical_start: int) -> bool:
        """Move one mapping one tier up the chain (host -> HBM in the 2-pool
        topology), compacting the destination pool if needed."""
        m = self.procs[pid].page_table[logical_start]
        if m.tier == TIER_HBM:
            return False
        return self.migrate_page(pid, logical_start, m.tier - 1)

    # ---------------------------------------------------------- reclaim entry
    def demote_cold_global(self, need_blocks: int | None = None,
                           prefer_pid: int | None = None) -> int:
        """Global reclaim scan (the kswapd analogue): nominate HBM pages from
        EVERY process coldest-first — the reclaim victim's pages win ties —
        and demote HOOK_TIER-approved ones toward their target tiers until
        ``need_blocks`` HBM blocks are freed.  A victim that is already fully
        spilled then simply contributes no candidates instead of stalling
        reclaim."""
        need = need_blocks if need_blocks is not None \
            else self.tier_cfg.demote_chunk_blocks
        cands = [(st, m) for st in self.procs.values()
                 for m in st.mappings_sorted()
                 if m.tier == TIER_HBM and not m.shared]
        if not cands:
            return 0
        cands.sort(key=lambda sm: (
            sm[0].damon.heat_at(sm[1].logical_start, sm[1].order),
            0 if sm[0].pid == prefer_pid else 1,
            sm[0].pid, -sm[1].logical_start))
        decisions = self.tier_decisions(cands, scan="demote")
        freed = 0
        for (st, m), d in zip(cands, decisions):
            if freed >= need:
                break
            if d > m.tier:
                self.migrate_page(st.pid, m.logical_start, d)
                if m.tier == TIER_HBM and self.containment:
                    # degraded mode: the approved target (or every path to
                    # it) could not take the page — demote-before-preempt
                    # retries against the REMAINING deeper tiers before
                    # giving up on this page; total blockage leaves freed
                    # short and falls through to the engine's preempt-only
                    # fallback, preserving the demote-then-preempt order
                    for d2 in range(d + 1, self.ntiers):
                        self.migrate_page(st.pid, m.logical_start, d2)
                        if m.tier != TIER_HBM:
                            break
                if m.tier != TIER_HBM:      # left HBM (even if short of d)
                    freed += order_blocks(m.order)
        return freed

    def promotion_scan(self, budget_blocks: int | None = None) -> int:
        """Background promotion (khugepaged-style): offer every spill-tier
        page to HOOK_TIER; pages the policy wants in a faster tier are moved
        up, hottest-first, under a per-tick block budget."""
        budget = budget_blocks if budget_blocks is not None \
            else self.tier_cfg.promote_blocks_per_tick
        # age > 0: never bounce a page demoted within the current tick (the
        # demote and promote copies would otherwise land in one device batch)
        cands = [(st, m) for st in self.procs.values()
                 for m in st.mappings_sorted()
                 if m.tier != TIER_HBM and not m.shared
                 and self._page_age_ticks(st.pid, m.logical_start) > 0]
        if not cands:
            return 0
        cands.sort(key=lambda sm: -sm[0].damon.heat_at(
            sm[1].logical_start, sm[1].order))
        decisions = self.tier_decisions(cands, scan="promote")
        promoted = 0
        for (st, m), d in zip(cands, decisions):
            if promoted >= budget:
                break
            if d < m.tier:
                was = m.tier
                self.migrate_page(st.pid, m.logical_start, d)
                if m.tier < was:            # moved up (even if short of d)
                    promoted += order_blocks(m.order)
        return promoted

    # -------------------------------------------- prefill-time tier placement
    def _mapping_at(self, st: ProcessState, addr: int) -> PageMapping | None:
        """The mapping covering logical block ``addr`` (None if unmapped)."""
        for k in range(self.max_order + 1):
            size = order_blocks(k)
            m = st.page_table.get((addr // size) * size)
            if m is not None and m.order == k:
                return m
        return None

    def _place(self, reqs, kind: FaultKind) -> None:
        """Fold tier placement into a fault batch: ONE ``HOOK_TIER`` consult
        over the pages of ``kind`` the batch mapped, after all installs.
        PREFILL: profiles can place cold prefixes directly in the far tiers
        instead of defaulting to HBM; FIRST_TOUCH (decode): a pressured (or
        degraded) HBM pool can place decode installs directly in a spill
        tier instead of waiting for the reclaim scan.  Only demotions are
        applied (promotion is the background scan's job); with no program
        attached this is a no-op — placement stays the zero-overhead HBM
        default."""
        if not self.hooks.attached(HOOK_TIER):
            return
        seen: set[tuple[int, int]] = set()
        cands: list[tuple[ProcessState, PageMapping]] = []
        last: dict[int, PageMapping] = {}     # skip probes inside known spans
        extent: dict[int, int] = {}           # pid -> prefill-span extent
        for pid, addr, k in reqs:
            if int(k) != int(kind):
                continue
            st = self.procs.get(pid)
            if st is None or addr not in st.mapped:
                continue
            extent[pid] = max(extent.get(pid, 0), addr + 1)
            m = last.get(pid)
            if m is not None and m.logical_start <= addr \
                    < m.logical_start + order_blocks(m.order):
                continue
            m = self._mapping_at(st, addr)
            if m is None or m.shared or (pid, m.logical_start) in seen:
                continue
            seen.add((pid, m.logical_start))
            last[pid] = m
            cands.append((st, m))
        if not cands:
            return
        decisions = self.tier_decisions(
            cands, kind=int(kind), force_batch=True,
            seq_lens=extent if kind == FaultKind.PREFILL else None)
        for (st, m), d in zip(cands, decisions):
            if d > m.tier:
                self.migrate_page(st.pid, m.logical_start, d)

    def place_decode(self, reqs) -> None:
        self._place(reqs, FaultKind.FIRST_TOUCH)

    def fault_batch(self, reqs):
        results = super().fault_batch(reqs)
        self._place(reqs, FaultKind.PREFILL)
        self._place(reqs, FaultKind.FIRST_TOUCH)
        return results

    def ensure_range(self, pid: int, start: int, end: int):
        results = super().ensure_range(pid, start, end)
        self._place([(pid, a, FaultKind.PREFILL) for a in range(start, end)],
                    FaultKind.PREFILL)
        return results

    # ----------------------------------------------------------------- state
    def resident_blocks(self, tier: int) -> int:
        return sum(order_blocks(o)
                   for o in self.pools[tier].allocated.values())

    def host_resident_blocks(self) -> int:
        return self.resident_blocks(TIER_HOST)

    def tier_snapshot(self) -> dict:
        """Pool-state snapshot: the per-tier ``tiers`` list is the API.

        The pre-N-pool ``host_*`` keys (which hard-coded "the spill tier"
        as tier 1 — silently the wrong pool on a deeper chain) went through
        a DeprecationWarning cycle and are now REMOVED; consumers index
        ``snapshot["tiers"][t]``."""
        out = {
            "pcie_ns_per_block": self.cost.pcie_ns_per_block(),
            "ntiers": self.ntiers,
            "tiers": [],
        }
        for t, (spec, pool) in enumerate(zip(("hbm",) + tuple(
                s.name for s in self.tier_specs), self.pools)):
            s = pool.stats()
            out["tiers"].append({
                "tier": t, "name": spec, "blocks": pool.num_blocks,
                "free_blocks": s.free_blocks,
                "resident_blocks": self.resident_blocks(t),
                "utilization_milli": s.utilization_milli,
            })
        return out
