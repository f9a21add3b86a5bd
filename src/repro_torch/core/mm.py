"""The framework memory manager — eBPF-mm's kernel side, adapted to a TPU pool.

Owns the HBM block pool (buddy allocator), per-process page tables, the DAMON
monitors, and the hook points.  The serving engine calls ``ensure_mapped`` /
``ensure_range`` as sequences grow (the page-fault analogue); the decision of
*which page size backs the fault* is delegated to the attached policy program
exactly as in the paper, with the kernel-default path (THP-greedy or
base-pages-only) when no program/profile is present.

All costs are accounted in modeled target-TPU nanoseconds via the CostModel,
so policies can be compared quantitatively on a CPU-only host; the physical
copies (zeroing, migration, compaction) are emitted as explicit move lists
that the device executes with the block_copy Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..obs.ringbuf import (EV_COLLAPSE, EV_COMPACT, EV_FAULT, EV_RECLAIM)
from ..resilience.supervisor import PolicySupervisor
from .buddy import RADIX, BuddyAllocator, BuddyError, order_blocks
from .context import (CTX, CTX_LEN, FIXED_POINT, MAX_TIERS, NUM_ORDERS,
                      POLICY_DETACHED, POLICY_FALLBACK, FaultContext,
                      FaultKind, ctx_batch, fill_system_columns)
from .cost import CostModel
from .damon import Damon
from .hooks import (HOOK_EVICT, HOOK_FAULT, HOOK_PROFILE, HOOK_RECLAIM,
                    HOOK_TIER, HookRegistry)
from .maps import ArrayMap, MapRegistry
from .profiles import MAX_PROFILE_REGIONS, Profile


class MMError(Exception):
    pass


class MMOutOfMemory(MMError):
    def __init__(self, msg: str, victim_pid: int | None = None) -> None:
        super().__init__(msg)
        self.victim_pid = victim_pid


@dataclass
class PageMapping:
    logical_start: int
    phys_start: int               # block index within the owning tier's pool
    order: int
    # Tier id in the N-pool chain, 0..MAX_TIERS-1 ordered fastest to slowest
    # (0 = local HBM; 1.. = peer-HBM / host DRAM / NVMe — see core.tiering).
    tier: int = 0
    # Read-only borrow of a prefix-cache block: the physical page belongs to
    # the cache (refcounted there), not to this process — frees skip it,
    # collapse/tier scans leave it alone, and the first write goes through
    # ``cow_break`` (copy-on-write) instead of mutating the shared page.
    shared: bool = False


@dataclass
class ProcessState:
    pid: int
    app: str | None
    vma_end: int                      # logical blocks, VMA is [0, vma_end)
    damon: Damon
    page_table: dict[int, PageMapping] = field(default_factory=dict)
    mapped: set = field(default_factory=set)   # logical block indices
    accesses: int = 0
    # Incremental device-visible block table: logical block -> combined
    # device index (-1 = unmapped).  Updated in place at install/unmap/
    # collapse/compaction/migration time by the MemoryManager — never
    # rebuilt per step.  Mutate mappings only through MemoryManager APIs
    # (install/unmap/collapse/migrate) or the table goes stale.
    blocktab: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.int32))
    # Monotonic generation counter for ``blocktab``: bumped on EVERY span
    # write or unmap (install/compaction/collapse/tier migration included),
    # so a device-resident table row is stale iff its recorded version
    # differs.  This is what makes dirty-row uploads safe against same-step
    # migrations: _note_mapped goes through _set_span, which bumps it.
    table_version: int = 0
    # Mapping-metadata arrays (sorted starts/sizes/orders/tiers/device
    # indices) for the vectorized access-accounting path; rebuilt lazily
    # when a mapping changes.
    meta_dirty: bool = True
    meta: tuple | None = None

    def mappings_sorted(self) -> list[PageMapping]:
        return [self.page_table[k] for k in sorted(self.page_table)]


@dataclass
class MMStats:
    faults: int = 0
    hinted_faults: int = 0
    fallback_faults: int = 0
    pages_per_order: list[int] = field(default_factory=lambda: [0] * NUM_ORDERS)
    blocks_zeroed: int = 0
    compactions: int = 0
    compaction_blocks_moved: int = 0
    promotions: int = 0
    promotion_blocks_copied: int = 0
    evictions: int = 0
    mgmt_ns: int = 0                  # modeled time spent on zero/compact/migrate
    access_ns: int = 0                # modeled time streaming pages for attention
    descriptors_touched: int = 0      # TLB-miss analogue
    # Tiered-memory counters (HBM <-> host DRAM; see core.tiering)
    demotions: int = 0                # pages moved HBM -> host tier
    demotion_blocks: int = 0
    tier_promotions: int = 0          # pages moved host tier -> HBM
    tier_promotion_blocks: int = 0
    tier_reads: int = 0               # attention reads served from the host tier
    # Resilience counters (see core.tiering migration retry/abort paths and
    # the per-tier injected allocation failures)
    migrate_retries: int = 0          # failed copy attempts that were retried
    migrate_aborts: int = 0           # hops abandoned after retry exhaustion
    tier_alloc_failures: int = 0      # injected transient per-tier alloc fails

    def snapshot(self) -> dict:
        return {
            "faults": self.faults,
            "hinted_faults": self.hinted_faults,
            "fallback_faults": self.fallback_faults,
            "pages_per_order": list(self.pages_per_order),
            "blocks_zeroed": self.blocks_zeroed,
            "compactions": self.compactions,
            "compaction_blocks_moved": self.compaction_blocks_moved,
            "promotions": self.promotions,
            "promotion_blocks_copied": self.promotion_blocks_copied,
            "evictions": self.evictions,
            "mgmt_ns": self.mgmt_ns,
            "access_ns": self.access_ns,
            "descriptors_touched": self.descriptors_touched,
            "demotions": self.demotions,
            "demotion_blocks": self.demotion_blocks,
            "tier_promotions": self.tier_promotions,
            "tier_promotion_blocks": self.tier_promotion_blocks,
            "tier_reads": self.tier_reads,
            "migrate_retries": self.migrate_retries,
            "migrate_aborts": self.migrate_aborts,
            "tier_alloc_failures": self.tier_alloc_failures,
        }


@dataclass
class FaultResult:
    order: int
    phys_start: int
    hinted: bool
    compacted: bool
    moves: list                       # [(src_start, dst_start, order)] for device


class MemoryManager:
    def __init__(self, num_blocks: int, cost: CostModel, *,
                 default_mode: str = "thp", max_order: int = NUM_ORDERS - 1,
                 damon_seed: int = 0, telemetry=None, injector=None,
                 containment: bool = True, device=None) -> None:
        if default_mode not in ("thp", "never"):
            raise ValueError("default_mode must be 'thp' or 'never'")
        self.buddy = BuddyAllocator(num_blocks, max_order=max_order)
        self.cost = cost
        self.default_mode = default_mode
        self.max_order = max_order
        # telemetry hub (repro.obs.Telemetry) or None (default, zero cost):
        # tracepoints below fire framework events with the MODELED clock so
        # streams stay deterministic; wall-time observations never land in
        # MMStats (the differential harness asserts snapshot equality
        # across replicas — telemetry keeps its own books).
        self.telemetry = telemetry
        # seeded chaos injector (repro.resilience.FailureInjector) or None;
        # containment=False is the no-containment baseline: faults still
        # fire but the supervisor never detaches, migrations never retry,
        # quarantine never routes around a bad edge.
        self.injector = injector
        self.containment = bool(containment)
        # device: where the hook registry's batch executors run (None =
        # CUDA, checked at their first use; the scalar route never needs it)
        self.hooks = HookRegistry(
            telemetry=telemetry, injector=injector,
            supervisor=PolicySupervisor(enabled=self.containment),
            device=device)
        self.maps = MapRegistry()
        self.procs: dict[int, ProcessState] = {}
        self.profiles: dict[str, tuple[Profile, int]] = {}   # app -> (profile, map_id)
        self.stats = MMStats()
        self.ktime_ns = 0
        self._damon_seed = damon_seed
        self._move_log: list[tuple[int, int, int]] = []   # pending device copies
        self._access_tab: tuple[np.ndarray, np.ndarray] | None = None
        # Physical-placement listeners: callables ``cb(tier, remap)`` invoked
        # whenever compaction relocates blocks within a tier's pool.  The
        # prefix cache registers one — its idle (refcount-0) blocks live in
        # no page table, so the page-table remap loop alone would strand them.
        self.compaction_listeners: list = []

    # ------------------------------------------------------------- userspace
    def load_profile(self, profile: Profile) -> int:
        """Userspace loads an application profile into an eBPF map.

        Reloading the same app's profile reuses its existing map slot (found
        by name) — a reload is a map WRITE, not a new map, so attached
        programs keep their verified map ids and the executors only refresh
        cached map arguments."""
        cap = MAX_PROFILE_REGIONS * (2 + NUM_ORDERS)
        name = f"profile:{profile.app}"
        map_id = self.maps.find(name)
        if map_id is None:
            map_id = self.maps.register(ArrayMap(cap, name=name))
        profile.load_into(self.maps[map_id])
        self.profiles[profile.app] = (profile, map_id)
        return map_id

    def attach_fault_program(self, program) -> None:
        self.hooks.attach(HOOK_FAULT, program, self.maps)

    def attach_reclaim_program(self, program) -> None:
        self.hooks.attach(HOOK_RECLAIM, program, self.maps)

    def attach_tier_program(self, program) -> None:
        self.hooks.attach(HOOK_TIER, program, self.maps)

    def attach_evict_program(self, program) -> None:
        self.hooks.attach(HOOK_EVICT, program, self.maps)

    def attach_profile_program(self, program) -> None:
        self.hooks.attach(HOOK_PROFILE, program, self.maps)

    # ------------------------------------------------------- online profiling
    def profile_scan(self, pid: int) -> list[tuple] | None:
        """One batched ``HOOK_PROFILE`` invocation over ``pid``'s live DAMON
        regions — the sampled profiler surface on the aggregation tick.

        Each ctx row is one region (PROF_* columns: bounds, FIXED_POINT
        access EMA, age, the pid's mapped-block count and the DAMON window
        counter) over the usual shared system snapshot, mirroring the
        tier/evict scan builders.  Returns rows aligned with the region
        snapshot, ``(start, end, heat_milli, age, score)`` where ``score``
        is the program's return value (POLICY_FALLBACK rows defer to
        host-side synthesis from raw heat; POLICY_DETACHED rows follow a
        mid-scan supervisor detach).  Returns None when no profiler program
        is attached — the scan builds no ctx at all, the zero-overhead
        property every hook keeps."""
        if not self.hooks.attached(HOOK_PROFILE):
            return None
        st = self.procs[pid]
        regions = st.damon.regions
        n = len(regions)
        if n == 0:
            return []
        mat = ctx_batch(n)
        fill_system_columns(mat, **self.system_ctx_columns())
        mat[:, CTX.PID] = st.pid
        mat[:, CTX.VMA_END] = st.vma_end
        mat[:, CTX.SEQ_LEN] = st.vma_end
        mat[:, CTX.PROF_MAPPED_BLOCKS] = len(st.mapped)
        mat[:, CTX.PROF_WINDOW] = st.damon.version
        mat[:, CTX.PROF_REGION_START] = \
            np.fromiter((r.start for r in regions), np.int64, n)
        mat[:, CTX.PROF_REGION_END] = \
            np.fromiter((r.end for r in regions), np.int64, n)
        mat[:, CTX.PROF_REGION_HEAT] = np.fromiter(
            (int(r.nr_accesses * FIXED_POINT) for r in regions), np.int64, n)
        mat[:, CTX.PROF_REGION_AGE] = \
            np.fromiter((r.age for r in regions), np.int64, n)
        decisions = self.hooks.run_batch(HOOK_PROFILE, mat)
        return [(int(mat[i, CTX.PROF_REGION_START]),
                 int(mat[i, CTX.PROF_REGION_END]),
                 int(mat[i, CTX.PROF_REGION_HEAT]),
                 int(mat[i, CTX.PROF_REGION_AGE]),
                 int(decisions[i])) for i in range(n)]

    # ------------------------------------------------------------- processes
    def create_process(self, pid: int, *, app: str | None = None,
                       vma_blocks: int = 0) -> ProcessState:
        if pid in self.procs:
            raise MMError(f"pid {pid} already exists")
        st = ProcessState(pid=pid, app=app, vma_end=vma_blocks,
                          damon=Damon(max(1, vma_blocks), seed=self._damon_seed + pid))
        self.procs[pid] = st
        return st

    def grow_vma(self, pid: int, new_end: int) -> None:
        st = self.procs[pid]
        if new_end > st.vma_end:
            st.vma_end = new_end
            st.damon.grow(new_end)

    def free_process(self, pid: int) -> None:
        st = self.procs.pop(pid)
        for m in st.page_table.values():
            self._free_phys(m)

    def unmap(self, pid: int, logical_start: int) -> None:
        """Drop one mapping and release its physical page (partial free —
        e.g. punching holes to fragment a pool).  Goes through the manager
        so the incremental block table stays in sync."""
        st = self.procs[pid]
        m = st.page_table.pop(logical_start)
        size = order_blocks(m.order)
        st.mapped.difference_update(range(m.logical_start,
                                          m.logical_start + size))
        self._free_phys(m)
        self._note_unmapped(st, m.logical_start, m.order)

    def _free_phys(self, m: PageMapping) -> None:
        """Release a mapping's physical page into its tier's allocator.

        Shared (prefix-cache-borrowed) pages are NOT freed here: the cache
        owns the physical blocks and releases them when the entry's refcount
        drops and the eviction policy says so."""
        if m.shared:
            return
        self.buddy.free(m.phys_start)

    def _device_index(self, m: PageMapping) -> int:
        """Base-block index of ``m`` in the device-visible (combined) pool."""
        return m.phys_start

    # ------------------------------------------- prefix-cache integration
    # The cache owns physical blocks OUTSIDE any page table (allocated via
    # cache_alloc_block, refcounted in serving.prefix_cache); borrowers get
    # order-0 ``shared=True`` mappings that point at them read-only.

    def cache_alloc_block(self) -> int | None:
        """Allocate one cache-owned base block in tier 0 (HBM).  Returns the
        tier-local phys index, or None when the pool can't supply it — cache
        insertion is opportunistic and must never OOM a live sequence."""
        try:
            return self.buddy.alloc(0)
        except BuddyError:
            return None

    def cache_free_block(self, tier: int, phys: int) -> None:
        """Release one cache-owned base block back to ``tier``'s pool."""
        if tier != 0:
            raise MMError(f"untiered manager holds no tier-{tier} blocks")
        self.buddy.free(phys)

    def cache_device_index(self, tier: int, phys: int) -> int:
        """Combined device index of a cache-owned block (tier-aware in the
        tiered subclass)."""
        if tier != 0:
            raise MMError(f"untiered manager holds no tier-{tier} blocks")
        return phys

    def migrate_cache_block(self, blk, dst_tier: int) -> bool:
        """Move one cache-owned block toward ``dst_tier``.  The untiered
        manager has nowhere to put it — eviction decisions degrade to
        keep-or-drop (the tiered subclass migrates for real)."""
        return False

    def map_shared(self, pid: int, logical_start: int,
                   blocks: list[tuple[int, int]]) -> None:
        """Install read-only borrows of cache-owned blocks as consecutive
        order-0 mappings starting at ``logical_start``.  ``blocks`` is
        ``[(tier, phys), ...]`` in logical order.  No zeroing, no fault
        accounting — the KV content already exists; this is the page-table
        surgery of a cache hit."""
        st = self.procs[pid]
        for i, (tier, phys) in enumerate(blocks):
            a = logical_start + i
            if a in st.mapped:
                raise MMError(f"pid {pid}: shared map over mapped block {a}")
            m = PageMapping(logical_start=a, phys_start=phys, order=0,
                            tier=tier, shared=True)
            st.page_table[a] = m
            st.mapped.add(a)
            self._note_installed(st, m)
            self.stats.descriptors_touched += 1

    def cow_break(self, pid: int, logical_block: int) -> list[tuple[int, int, int]]:
        """Copy-on-write barrier: repoint one shared mapping at a freshly
        allocated private tier-0 page, emitting the block copy on the move
        list (the existing migration machinery executes it pre-kernel).
        Returns the emitted moves.  No-op for a non-shared mapping."""
        st = self.procs[pid]
        m = st.page_table[logical_block]
        if not m.shared:
            return []
        size = order_blocks(m.order)
        src_dev = self._device_index(m)
        phys = None
        compacted = False
        while phys is None:
            try:
                phys = self.buddy.alloc(m.order)
            except BuddyError:
                plan = self.buddy.plan_compaction(m.order)
                if plan is not None and not compacted:
                    self._apply_compaction(plan)
                    compacted = True
                    continue
                victim = self._pick_reclaim_victim(exclude=st.pid)
                raise MMOutOfMemory(
                    f"pool exhausted on copy-on-write (pid {st.pid})",
                    victim_pid=victim)
        src_tier = m.tier
        m.phys_start = phys
        m.tier = 0
        m.shared = False
        self._note_mapped(st, m)
        moves = [(src_dev, self._device_index(m), m.order)]
        self._move_log.extend(moves)
        if src_tier == 0:
            self.stats.mgmt_ns += self.cost.compact_ns_per_block() * size
        else:
            self.stats.mgmt_ns += int(self.cost.migrate_ns(m.order,
                                                           src_tier, 0))
        return moves

    def queue_block_copy(self, src_dev: int, dst_dev: int,
                         order: int = 0) -> None:
        """Queue one device block copy on the move list.  Prefix-cache insert
        copies ride the same pre-kernel flush as migrations/compactions, so
        the engine's hazard segmentation orders them against any same-drain
        move that touches the donor block."""
        self._move_log.append((src_dev, dst_dev, order))
        self.stats.mgmt_ns += \
            self.cost.compact_ns_per_block() * order_blocks(order)

    # ------------------------------------------------ incremental block table
    def _table(self, st: ProcessState) -> np.ndarray:
        """The process's cached logical->device table, grown to the VMA."""
        if st.blocktab.size < st.vma_end:
            t = np.full(max(st.vma_end, 1), -1, dtype=np.int32)
            t[:st.blocktab.size] = st.blocktab
            st.blocktab = t
        return st.blocktab

    def _set_span(self, st: ProcessState, m: PageMapping) -> int:
        t = self._table(st)
        size = order_blocks(m.order)
        base = self._device_index(m)
        t[m.logical_start:m.logical_start + size] = \
            base + np.arange(size, dtype=np.int32)
        st.table_version += 1
        return base

    def _note_installed(self, st: ProcessState, m: PageMapping) -> None:
        """A NEW mapping: extend the table span; append to the metadata
        arrays in place when the mapping lands past the current tail (the
        decode-growth pattern), full rebuild otherwise."""
        base = self._set_span(st, m)
        if st.meta is not None and not st.meta_dirty:
            starts, sizes, orders, tiers, dev = st.meta
            if starts.size == 0 or m.logical_start > starts[-1]:
                st.meta = (np.append(starts, m.logical_start),
                           np.append(sizes, order_blocks(m.order)),
                           np.append(orders, m.order),
                           np.append(tiers, m.tier),
                           np.append(dev, base))
                return
        st.meta_dirty = True

    def _note_mapped(self, st: ProcessState, m: PageMapping) -> None:
        """An EXISTING mapping changed physical placement (compaction, tier
        migration): refresh its table span; patch the metadata arrays in
        place when its geometry is unchanged."""
        base = self._set_span(st, m)
        if st.meta is not None and not st.meta_dirty:
            starts, sizes, orders, tiers, dev = st.meta
            idx = int(np.searchsorted(starts, m.logical_start))
            if idx < starts.size and starts[idx] == m.logical_start \
                    and orders[idx] == m.order:
                tiers[idx] = m.tier
                dev[idx] = base
                return
        st.meta_dirty = True

    def _note_unmapped(self, st: ProcessState, logical_start: int,
                       order: int) -> None:
        t = self._table(st)
        t[logical_start:logical_start + order_blocks(order)] = -1
        st.table_version += 1
        st.meta_dirty = True

    def _mapping_arrays(self, st: ProcessState) -> tuple:
        """(starts, sizes, orders, tiers, dev) int64 arrays sorted by start,
        rebuilt lazily when a mapping changed (dirty tracking)."""
        if st.meta_dirty or st.meta is None:
            ms = st.mappings_sorted()
            n = len(ms)
            starts = np.fromiter((m.logical_start for m in ms), np.int64, n)
            orders = np.fromiter((m.order for m in ms), np.int64, n)
            tiers = np.fromiter((m.tier for m in ms), np.int64, n)
            dev = np.fromiter((self._device_index(m) for m in ms), np.int64, n)
            st.meta = (starts, RADIX ** orders, orders, tiers, dev)
            st.meta_dirty = False
        return st.meta

    # ---------------------------------------------------------------- faults
    def fault_max_order(self, st: ProcessState, addr: int) -> int:
        k = self.max_order
        while k > 0:
            size = order_blocks(k)
            a = (addr // size) * size
            if a + size <= st.vma_end and not any(
                    b in st.mapped for b in range(a, a + size)):
                return k
            k -= 1
        return 0

    def _build_ctx(self, st: ProcessState, addr: int, kind: FaultKind) -> np.ndarray:
        bstats = self.buddy.stats()
        has_profile = int(st.app in self.profiles) if st.app else 0
        map_id, nregions = 0, 0
        if has_profile:
            prof, map_id = self.profiles[st.app]
            nregions = len(prof.regions)
        fc = FaultContext(
            addr=addr, pid=st.pid, vma_start=0, vma_end=st.vma_end,
            fault_max_order=self.fault_max_order(st, addr),
            has_profile=has_profile, profile_map_id=map_id,
            profile_nregions=nregions,
            free_blocks=bstats.free_per_order,
            frag=bstats.frag_index_milli,
            heat=st.damon.heat_vector(addr),
            zero_ns_per_block=self.cost.zero_ns_per_block(),
            compact_ns_per_block=self.cost.compact_ns_per_block(),
            descriptor_ns=int(self.cost.hw.descriptor_ns),
            block_bytes=self.cost.block_bytes,
            ktime_ns=self.ktime_ns,
            mem_pressure=bstats.utilization_milli,
            fault_kind=int(kind),
            seq_len=st.vma_end,
        )
        return fc.vector()

    def _default_order(self, fmax: int) -> int:
        return min(2, fmax) if self.default_mode == "thp" else 0

    def system_ctx_columns(self) -> dict:
        """One system-state snapshot as :func:`fill_system_columns` kwargs —
        the shared columns of any batched ctx build (the evict scan uses
        this; the fault/tier builders keep their fused inline versions).
        The tiered subclass extends it with per-tier pool state and the
        edge-cost tables."""
        bstats = self.buddy.stats()
        return dict(
            free_blocks=bstats.free_per_order,
            frag=bstats.frag_index_milli,
            zero_ns_per_block=self.cost.zero_ns_per_block(),
            compact_ns_per_block=self.cost.compact_ns_per_block(),
            descriptor_ns=int(self.cost.hw.descriptor_ns),
            block_bytes=self.cost.block_bytes,
            ktime_ns=self.ktime_ns,
            mem_pressure=bstats.utilization_milli)

    def ensure_mapped(self, pid: int, addr: int,
                      kind: FaultKind = FaultKind.FIRST_TOUCH) -> FaultResult | None:
        """The page-fault entry point. Returns None if already mapped."""
        st = self.procs[pid]
        if addr >= st.vma_end:
            raise MMError(f"pid {pid}: fault at {addr} beyond VMA end {st.vma_end}")
        if addr in st.mapped:
            return None
        if not self.hooks.attached(HOOK_FAULT):
            # the paper's zero-overhead property: with no program attached the
            # default path runs without building the eBPF context at all
            fmax = self.fault_max_order(st, addr)
            return self._install(st, addr, self._default_order(fmax), False)
        ctx = self._build_ctx(st, addr, kind)
        fmax = int(ctx[CTX.FAULT_MAX_ORDER])
        decision = self.hooks.run(HOOK_FAULT, ctx)
        hinted = decision is not None and decision != POLICY_FALLBACK
        if not hinted:
            order = self._default_order(fmax)
            if decision == POLICY_FALLBACK:
                self.stats.fallback_faults += 1
        else:
            order = max(0, min(int(decision), fmax))
        return self._install(st, addr, order, hinted)

    def ensure_range(self, pid: int, start: int, end: int) -> list[FaultResult]:
        """Bulk fault (prefill/mmap population), scalar path: one policy
        invocation per fault.  Kept as the reference/no-program route; the
        engine's hot path uses :meth:`fault_range`."""
        results = []
        st = self.procs[pid]
        addr = start
        while addr < end:
            r = self.ensure_mapped(pid, addr, FaultKind.PREFILL)
            if r is None:
                addr += 1
            else:
                size = order_blocks(r.order)
                addr = (addr // size) * size + size
                results.append(r)
        return results

    # --------------------------------------------------------- batched faults
    def fault_batch(self, reqs: list[tuple[int, int, FaultKind]]
                    ) -> list[FaultResult | None]:
        """Resolve many faults through ONE policy invocation.

        ``reqs`` is ``[(pid, addr, kind), ...]``; the return list is aligned
        with it (``None`` = already mapped, or covered by an earlier grant in
        the same batch).  The ctx matrix is built from one system-state
        snapshot (one ``buddy.stats()``, vectorized DAMON heat) and decided
        by a single ``hooks.run_batch`` call; installs then run in request
        order with install-time conflict resolution — an earlier grant that
        covers a later request skips it, one that overlaps a later request's
        window shrinks its feasible order (the grant is clamped to a freshly
        computed ``fault_max_order``).  OOM/degrade/compaction semantics are
        identical to the scalar path: the first request that cannot be
        satisfied raises :class:`MMOutOfMemory` with earlier installs kept,
        exactly like the scalar loop.  With no program attached the default
        path installs directly — no ctx is built (zero-overhead property).
        """
        results: list[FaultResult | None] = [None] * len(reqs)
        pend: list[int] = []
        for i, (pid, addr, _kind) in enumerate(reqs):
            st = self.procs[pid]
            if addr >= st.vma_end:
                raise MMError(
                    f"pid {pid}: fault at {addr} beyond VMA end {st.vma_end}")
            if addr not in st.mapped:
                pend.append(i)
        if not pend:
            return results
        if not self.hooks.attached(HOOK_FAULT):
            for i in pend:
                pid, addr, _kind = reqs[i]
                st = self.procs[pid]
                if addr in st.mapped:          # covered by an earlier install
                    continue
                fmax = self.fault_max_order(st, addr)
                results[i] = self._install(st, addr,
                                           self._default_order(fmax), False)
            return results
        ctx_mat = self._build_ctx_batch([reqs[i] for i in pend])
        # raw decisions: rows covered by an earlier grant are never consumed
        # (the scalar route never faults them), so the misbehavior pass runs
        # per CONSUMED row below — strikes stay identical across routes
        decisions = self.hooks.run_batch(HOOK_FAULT, ctx_mat,
                                         discipline=False)
        row_disc = self.hooks.row_discipline_needed(HOOK_FAULT, decisions)
        # fault_max_order depends only on the pid's own mapped set, which the
        # ctx build just scanned (vectorized): recompute per row only when an
        # EARLIER install in this batch touched the same pid.  Engine decode
        # batches carry distinct pids, so the hot path reuses every row.
        touched: set[int] = set()
        for row, i in enumerate(pend):
            pid, addr, _kind = reqs[i]
            st = self.procs[pid]
            if addr in st.mapped:              # conflict: earlier grant won
                continue
            fmax = self.fault_max_order(st, addr) if pid in touched \
                else int(ctx_mat[row, CTX.FAULT_MAX_ORDER])
            touched.add(pid)
            decision = int(decisions[row])
            if row_disc:
                decision = self.hooks.discipline_row(HOOK_FAULT,
                                                     ctx_mat[row], decision)
            if decision == POLICY_DETACHED:
                # the supervisor detached the program mid-batch: this row
                # takes the unattached default path — no fallback accounting,
                # exactly like the scalar route where post-detach faults
                # never reach the hook
                results[i] = self._install(st, addr,
                                           self._default_order(fmax), False)
                continue
            hinted = decision != POLICY_FALLBACK
            if not hinted:
                order = self._default_order(fmax)
                self.stats.fallback_faults += 1
            else:
                order = max(0, min(decision, fmax))
            results[i] = self._install(st, addr, order, hinted)
        return results

    def fault_range(self, pid: int, start: int, end: int,
                    kind: FaultKind = FaultKind.PREFILL) -> list[FaultResult]:
        """Batched :meth:`ensure_range`: the whole span resolves through one
        policy invocation (every unmapped block is a candidate; blocks
        covered by an earlier grant in the batch are skipped at install)."""
        res = self.fault_batch([(pid, a, kind) for a in range(start, end)])
        return [r for r in res if r is not None]

    # The tier chain's entry points, so a caller need not ask which manager
    # it holds: one pool (HBM) here, nothing to place, demote or promote;
    # the tiered subclass runs them.
    def place_decode(self, reqs: list[tuple[int, int, FaultKind]]) -> None:
        """Decode-time tier placement, called once after a SCALAR route's
        ``ensure_mapped`` loop with the same requests (``fault_batch``
        places its own), so both routes consult placement at the same
        post-install state."""

    @property
    def ntiers(self) -> int:
        return 1

    def demote_cold_global(self, need_blocks: int | None = None,
                           prefer_pid: int | None = None) -> int:
        """HBM blocks freed by demotion: none without spill tiers."""
        return 0

    def promotion_scan(self, budget_blocks: int | None = None) -> int:
        """Blocks promoted back to HBM: none without spill tiers."""
        return 0

    def _build_ctx_batch(self, reqs: list[tuple[int, int, FaultKind]]
                         ) -> np.ndarray:
        """Vectorized :meth:`_build_ctx`: one buddy snapshot shared by every
        row, per-pid vectorized DAMON heat and feasible-order computation.
        Row ``i`` equals ``_build_ctx(procs[pid_i], addr_i, kind_i)`` built
        at batch-start state."""
        bstats = self.buddy.stats()
        n = len(reqs)
        mat = ctx_batch(n)
        fill_system_columns(
            mat,
            free_blocks=bstats.free_per_order,
            frag=bstats.frag_index_milli,
            zero_ns_per_block=self.cost.zero_ns_per_block(),
            compact_ns_per_block=self.cost.compact_ns_per_block(),
            descriptor_ns=int(self.cost.hw.descriptor_ns),
            block_bytes=self.cost.block_bytes,
            ktime_ns=self.ktime_ns,
            mem_pressure=bstats.utilization_milli)
        pids = np.fromiter((r[0] for r in reqs), np.int64, n)
        addrs = np.fromiter((r[1] for r in reqs), np.int64, n)
        kinds = np.fromiter((int(r[2]) for r in reqs), np.int64, n)
        mat[:, CTX.ADDR] = addrs
        mat[:, CTX.PID] = pids
        mat[:, CTX.FAULT_KIND] = kinds
        # Per-process state is gathered through concatenated cumsum tables so
        # the whole batch resolves in a fixed number of numpy ops, however
        # many processes it spans.
        upids, inv = np.unique(pids, return_inverse=True)
        sts = [self.procs[int(p)] for p in upids]
        g = len(sts)
        ves = np.fromiter((st.vma_end for st in sts), np.int64, g)
        mat[:, CTX.VMA_END] = ves[inv]
        mat[:, CTX.SEQ_LEN] = ves[inv]
        has, mapid, nreg = np.zeros(g, np.int64), np.zeros(g, np.int64), \
            np.zeros(g, np.int64)
        for j, st in enumerate(sts):
            if st.app and st.app in self.profiles:
                prof, map_id = self.profiles[st.app]
                has[j], mapid[j], nreg[j] = 1, map_id, len(prof.regions)
        mat[:, CTX.HAS_PROFILE] = has[inv]
        mat[:, CTX.PROFILE_MAP_ID] = mapid[inv]
        mat[:, CTX.PROFILE_NREGIONS] = nreg[inv]
        sizes = self._ORDER_SIZES[:NUM_ORDERS]
        a = (addrs[:, None] // sizes) * sizes                     # [N, K]
        # --- DAMON heat, all rows/orders at once ---
        csums = [st.damon._heat_csum() for st in sts]
        offs = np.zeros(g, np.int64)
        offs[1:] = np.cumsum([c.size for c in csums])[:-1]
        heat_cat = np.concatenate(csums)
        spaces = np.fromiter((st.damon.space_blocks for st in sts),
                             np.int64, g)
        row_space = spaces[inv][:, None]
        row_off = offs[inv][:, None]
        lo = np.minimum(a, row_space)
        hi = np.minimum(a + sizes, row_space)
        total = heat_cat[row_off + hi] - heat_cat[row_off + lo]
        covered = hi - lo
        heat = np.where(covered > 0, total / np.maximum(covered, 1), 0.0)
        mat[:, CTX.HEAT_O0:CTX.HEAT_O0 + NUM_ORDERS] = \
            heat.astype(np.int64)
        # --- feasible order (vectorized fault_max_order), same pattern;
        #     candidate orders stop at self.max_order like the scalar path ---
        frees = [np.concatenate(
            [[0], np.cumsum(self._table(st)[:st.vma_end] == -1)])
            for st in sts]
        foffs = np.zeros(g, np.int64)
        foffs[1:] = np.cumsum([f.size for f in frees])[:-1]
        free_cat = np.concatenate(frees)
        row_ve = ves[inv][:, None]
        row_foff = foffs[inv][:, None]
        ks = self.max_order + 1
        fsizes = sizes[:ks]
        af = a[:, :ks]
        flo = np.minimum(af, row_ve)
        fhi = np.minimum(af + fsizes, row_ve)
        span_free = free_cat[row_foff + fhi] - free_cat[row_foff + flo]
        ok = (af + fsizes <= row_ve) & (span_free == fsizes)
        mat[:, CTX.FAULT_MAX_ORDER] = \
            (ok * np.arange(ks, dtype=np.int64)).max(axis=1)
        # Within-batch free-list reservation: every row of a batch shares the
        # batch-start buddy snapshot, so a budget-aware program could commit
        # the same free blocks N times over.  Row i's BATCH_RESERVED is an
        # upper bound on what rows 0..i-1 can consume (each grant is clamped
        # to its fault_max_order, i.e. at most 4^fmax base blocks) — programs
        # subtract it from the FREE_BLOCKS_* columns to see within-batch
        # grants.  Optimality only: installs already clamp on the live buddy.
        grants = sizes[mat[:, CTX.FAULT_MAX_ORDER]]
        mat[1:, CTX.BATCH_RESERVED] = np.cumsum(grants[:-1])
        return mat

    _ORDER_SIZES = RADIX ** np.arange(NUM_ORDERS, dtype=np.int64)

    def _install(self, st: ProcessState, addr: int, order: int,
                 hinted: bool) -> FaultResult:
        size = order_blocks(order)
        a = (addr // size) * size
        compacted = False
        moves: list[tuple[int, int, int]] = []
        phys = None
        while phys is None:
            try:
                phys = self.buddy.alloc(order)
            except BuddyError:
                plan = self.buddy.plan_compaction(order)
                if plan is not None and not compacted:
                    self._apply_compaction(plan)
                    moves.extend(plan)
                    compacted = True
                    continue
                if order > 0:           # degrade, like a failed THP allocation
                    order = order - 1
                    size = order_blocks(order)
                    a = (addr // size) * size
                    continue
                victim = self._pick_reclaim_victim(exclude=st.pid)
                raise MMOutOfMemory(
                    f"pool exhausted on order-0 fault (pid {st.pid})",
                    victim_pid=victim)
        m = PageMapping(logical_start=a, phys_start=phys, order=order)
        st.page_table[a] = m
        st.mapped.update(range(a, a + size))
        self._note_installed(st, m)
        self.stats.faults += 1
        if hinted:
            self.stats.hinted_faults += 1
        self.stats.pages_per_order[order] += 1
        self.stats.blocks_zeroed += size
        self.stats.mgmt_ns += self.cost.zero_ns_per_block() * size
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.emit(EV_FAULT, st.pid, a, order | (int(hinted) << 8),
                     ts=self.ktime_ns)
        return FaultResult(order=order, phys_start=phys, hinted=hinted,
                           compacted=compacted, moves=moves)

    def _apply_compaction(self, plan: list[tuple[int, int, int]], *,
                          tier: int = 0, device_offset: int = 0) -> None:
        """Buddy already mutated its allocation map; fix page tables and
        account the migration cost + device move list.  ``tier`` selects
        which tier's mappings the plan refers to (each tier's pool has its
        own phys numbering) and ``device_offset`` shifts the emitted moves
        into combined device coordinates."""
        self.stats.compactions += 1
        remap = {src: dst for src, dst, _ in plan}
        for st in self.procs.values():
            for m in st.page_table.values():
                if m.tier == tier and m.phys_start in remap:
                    m.phys_start = remap[m.phys_start]
                    self._note_mapped(st, m)
        for cb in self.compaction_listeners:
            cb(tier, remap)
        blocks = sum(order_blocks(o) for _, _, o in plan)
        self.stats.compaction_blocks_moved += blocks
        self.stats.mgmt_ns += self.cost.compact_ns_per_block() * blocks
        self._move_log.extend((device_offset + s, device_offset + d, o)
                              for s, d, o in plan)
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.emit(EV_COMPACT, tier, blocks,
                     self.cost.compact_ns_per_block() * blocks,
                     ts=self.ktime_ns)

    # ---------------------------------------------------------- khugepaged
    def collapse(self, pid: int, addr: int, to_order: int) -> FaultResult | None:
        """Promote the aligned window around ``addr`` to one order-k page
        (async promotion — the khugepaged analogue).  Existing data is
        migrated via the device copy list; holes are zero-filled."""
        st = self.procs[pid]
        size = order_blocks(to_order)
        a = (addr // size) * size
        if a + size > st.vma_end:
            return None
        # every mapping OVERLAPPING the window: a page of order >= to_order
        # whose start lies outside [a, a+size) still contains the window
        # (alignment), and collapsing "through" it would double-map the span
        # and zero-fill live KV — the differential harness caught exactly
        # that with a window inside an existing larger page.
        old = [m for m in st.page_table.values()
               if m.logical_start < a + size
               and m.logical_start + order_blocks(m.order) > a]
        if any(m.order >= to_order for m in old):
            return None   # already backed at >= target order
        if any(m.tier != 0 for m in old):
            return None   # demoted pages must be promoted before collapsing
        if any(m.shared for m in old):
            return None   # never collapse through cache-shared pages: the
            #               big page would alias refcounted cache blocks
        try:
            phys = self.buddy.alloc(to_order)
        except BuddyError:
            plan = self.buddy.plan_compaction(to_order)
            if plan is None:
                return None
            self._apply_compaction(plan)
            try:
                phys = self.buddy.alloc(to_order)
            except BuddyError:
                return None
        moves = []
        copied = 0
        for m in old:
            dst = phys + (m.logical_start - a)
            moves.append((m.phys_start, dst, m.order))
            copied += order_blocks(m.order)
            self.buddy.free(m.phys_start)
            del st.page_table[m.logical_start]
        big = PageMapping(a, phys, to_order)
        st.page_table[a] = big
        st.mapped.update(range(a, a + size))
        self._set_span(st, big)        # covers the holes + migrated spans
        st.meta_dirty = True           # structural change: old pages removed
        self.stats.promotions += 1
        self.stats.promotion_blocks_copied += copied
        self.stats.blocks_zeroed += size - copied
        self.stats.mgmt_ns += (self.cost.compact_ns_per_block() * copied
                               + self.cost.zero_ns_per_block() * (size - copied))
        self._move_log.extend(moves)
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.emit(EV_COLLAPSE, pid, a, to_order, ts=self.ktime_ns)
        return FaultResult(order=to_order, phys_start=phys, hinted=True,
                           compacted=False, moves=moves)

    # ------------------------------------------------------------- reclaim
    def _pick_reclaim_victim(self, exclude: int) -> int | None:
        cands = [st for pid, st in self.procs.items()
                 if pid != exclude and st.page_table]
        if not cands:
            return None
        cands = sorted(cands, key=lambda s: s.pid)[:4]
        ctx = np.zeros(CTX_LEN, dtype=np.int64)
        ctx[CTX.ADDR] = len(cands)
        for i, st in enumerate(cands):
            mean_heat = (sum(r.nr_accesses for r in st.damon.regions)
                         / max(1, len(st.damon.regions)))
            ctx[CTX.HEAT_O0 + i] = int(mean_heat)
        choice = self.hooks.run(HOOK_RECLAIM, ctx)
        if choice is None or choice == POLICY_FALLBACK:
            # default: lowest pid (FIFO-ish)
            return cands[0].pid
        return cands[max(0, min(int(choice), len(cands) - 1))].pid

    def evict_process(self, pid: int) -> None:
        self.free_process(pid)
        self.stats.evictions += 1
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.emit(EV_RECLAIM, pid, 0, 0, ts=self.ktime_ns)
            tel.inc("evictions")

    # -------------------------------------------------------------- access
    def _access_ns_tables(self) -> np.ndarray:
        """Per-(tier, order) access cost matrix, cached — the constants
        behind the vectorized access accounting.  Row 0 is HBM; rows 1..
        charge each spill tier's link bandwidth."""
        if self._access_tab is None:
            ks = range(self.max_order + 1)
            self._access_tab = np.stack([
                np.fromiter((int(self.cost.tier_access_ns(k, t)) for k in ks),
                            np.int64, self.max_order + 1)
                for t in range(MAX_TIERS)])
        return self._access_tab

    def record_access(self, pid: int, heat_per_block: np.ndarray) -> None:
        """Called once per engine step with the kernel-emitted heat stats.

        Access cost is charged only for mappings that were actually READ this
        step (nonzero attention mass over their span) — sliding-window and
        sparse-attention models do not stream their cold blocks.  The
        per-mapping accounting runs as numpy segment sums over the cached
        mapping arrays, not a Python loop."""
        st = self.procs[pid]
        heat = np.asarray(heat_per_block, dtype=np.float64)
        st.damon.record(heat)
        st.accesses += 1
        starts, sizes, orders, tiers, _ = self._mapping_arrays(st)
        if starts.size == 0:
            return
        csum = np.concatenate([[0.0], np.cumsum(heat)])
        lo = np.minimum(starts, heat.size)
        hi = np.minimum(starts + sizes, heat.size)
        read = (hi > lo) & ((csum[hi] - csum[lo]) > 0)
        self.stats.descriptors_touched += int(read.sum())
        acc = self._access_ns_tables()
        rt = np.minimum(tiers[read], MAX_TIERS - 1)
        self.stats.tier_reads += int((rt != 0).sum())
        self.stats.access_ns += int(acc[rt, orders[read]].sum())

    def descriptors_for(self, pid: int) -> int:
        return len(self.procs[pid].page_table)

    # ---------------------------------------------------- device integration
    def block_table(self, pid: int, max_blocks: int) -> np.ndarray:
        """Flattened logical->physical base-block map (-1 = unmapped).

        Served from the per-process incremental table — an O(max_blocks)
        numpy copy, not a per-mapping Python rebuild."""
        st = self.procs[pid]
        t = self._table(st)
        out = np.full(max_blocks, -1, dtype=np.int32)
        n = min(max_blocks, t.size)
        out[:n] = t[:n]
        return out

    def table_version(self, pid: int) -> int:
        """Generation counter of ``pid``'s incremental block table — changes
        exactly when any row of :meth:`block_table` would.  A device-resident
        mirror is fresh iff the version it recorded at upload still matches
        (the dirty-row protocol in :mod:`repro.serving.tables`)."""
        return self.procs[pid].table_version

    def page_lists_by_order(self, pids: list[int]) -> dict[int, np.ndarray]:
        """Per-order page lists for the multi-size paged-attention kernel.

        Returns {order: int32[[seq_slot, logical_page_idx, phys_page_start]]}.
        seq_slot is the position of the pid in ``pids``.  Assembled from the
        cached mapping arrays (dirty-tracked), vectorized per order.
        """
        out: dict[int, list] = {k: [] for k in range(self.max_order + 1)}
        for slot, pid in enumerate(pids):
            starts, _sizes, orders, _tiers, dev = \
                self._mapping_arrays(self.procs[pid])
            for k in range(self.max_order + 1):
                sel = orders == k
                if not sel.any():
                    continue
                rows = np.stack([
                    np.full(int(sel.sum()), slot, dtype=np.int64),
                    starts[sel] // order_blocks(k),
                    dev[sel]], axis=1)
                out[k].append(rows)
        return {k: (np.concatenate(v).astype(np.int32) if v
                    else np.zeros((0, 3), dtype=np.int32))
                for k, v in out.items()}

    def drain_moves(self) -> list[tuple[int, int, int]]:
        """Pending (src, dst, order) physical copies for the device."""
        mv, self._move_log = self._move_log, []
        return mv

    # ------------------------------------------------------------- misc
    def tick(self, ns: int = 1_000_000) -> None:
        tel = self.telemetry
        if tel is not None and tel.enabled:
            # per-(tier, order) residency sample, one block-tick per mapped
            # block per tick — the occupancy matrix behind the metrics
            # snapshot's residency_block_ticks
            for st in self.procs.values():
                _starts, sizes, orders, tiers, _dev = self._mapping_arrays(st)
                if sizes.size:
                    tel.observe_residency(tiers, orders, sizes)
        self.ktime_ns += ns

    def hugepage_block_fraction(self) -> float:
        """Fraction of mapped blocks backed by order>0 pages (Fig 2 metric)."""
        huge = base = 0
        for st in self.procs.values():
            for m in st.page_table.values():
                n = order_blocks(m.order)
                if m.order > 0:
                    huge += n
                else:
                    base += n
        total = huge + base
        return huge / total if total else 0.0
