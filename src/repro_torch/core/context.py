"""FaultContext — the flat "ctx" struct visible to policy programs.

The Linux eBPF-mm hook hands the program a context describing the faulting
address, the VMA, and real-time system state (buddy free lists, fragmentation,
DAMON heat, profile hints).  We mirror that as a fixed int64 vector so both the
host interpreter and the vectorized jnp JIT can consume it.

All "time" quantities are modeled nanoseconds on the target TPU (v5e), all
"heat" quantities are DAMON-style access counts per aggregation window, and
fractional quantities use FIXED_POINT scaling.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

NUM_ORDERS = 4          # page-size classes: 4^order base blocks
FIXED_POINT = 1000      # scale for fractional ctx fields
MAX_TIERS = 4           # tier ids 0..3: local HBM, and up to 3 spill tiers


class CTX(enum.IntEnum):
    """Offsets into the flat context vector."""
    ADDR = 0                 # faulting logical block index (within VMA space)
    PID = 1
    VMA_START = 2            # VMA bounds, in logical blocks
    VMA_END = 3
    FAULT_MAX_ORDER = 4      # max order feasible at ADDR (alignment + VMA fit)
    HAS_PROFILE = 5          # 1 if the faulting pid has a loaded profile
    PROFILE_MAP_ID = 6       # map id holding this pid's profile regions
    PROFILE_NREGIONS = 7
    # Buddy allocator state (per order)
    FREE_BLOCKS_O0 = 8
    FREE_BLOCKS_O1 = 9
    FREE_BLOCKS_O2 = 10
    FREE_BLOCKS_O3 = 11
    # Fragmentation index per order, FIXED_POINT-scaled (0 = none, 1000 = full)
    FRAG_O0 = 12
    FRAG_O1 = 13
    FRAG_O2 = 14
    FRAG_O3 = 15
    # DAMON heat of the aligned region enclosing ADDR, per candidate order
    HEAT_O0 = 16
    HEAT_O1 = 17
    HEAT_O2 = 18
    HEAT_O3 = 19
    # Cost-model constants (calibrated, modeled ns)
    ZERO_NS_PER_BLOCK = 20
    COMPACT_NS_PER_BLOCK = 21
    DESCRIPTOR_NS = 22       # per page-table-entry / DMA-descriptor overhead
    BLOCK_BYTES = 23
    # Misc real-time state
    KTIME_NS = 24
    MEM_PRESSURE = 25        # FIXED_POINT-scaled pool utilization
    FAULT_KIND = 26          # FaultKind enum value
    SEQ_LEN = 27             # current logical length of the owning sequence
    # Tiered-memory state (host-DRAM second pool behind the mm_tier hook)
    TIER_FREE_BLOCKS = 28    # free base blocks in the host-DRAM tier
    TIER_TOTAL_BLOCKS = 29   # capacity of the host-DRAM tier
    TIER_PRESSURE = 30       # FIXED_POINT-scaled host-tier utilization
    PCIE_NS_PER_BLOCK = 31   # modeled ns to move one base block across PCIe
    # Candidate page under a tier decision (mm_tier hook only)
    PAGE_TIER = 32           # current tier of the candidate page (0=HBM, 1..=spill)
    PAGE_ORDER = 33          # order of the candidate page
    PAGE_AGE = 34            # engine ticks since the page last changed tiers
    PAGE_HEAT = 35           # DAMON heat of the page's own span, FIXED_POINT-scaled
    MIGRATE_SETUP_NS = 36    # fixed setup cost of the tier-0<->1 edge (legacy)
    MIGRATE_NS_PER_BLOCK = 37  # per-block cost of the tier-0<->1 edge (legacy)
    # N-pool tier graph (HBM / peer-HBM over ICI / host DRAM / NVMe); the
    # tier id in PAGE_TIER is 0..NTIERS-1, ordered fastest to slowest.
    NTIERS = 38              # live tier count of the topology (0 = untiered ctx)
    # Per-tier pool state (free / total base blocks; unused tiers stay 0)
    TIER_FREE_T0 = 39
    TIER_FREE_T1 = 40
    TIER_FREE_T2 = 41
    TIER_FREE_T3 = 42
    TIER_TOTAL_T0 = 43
    TIER_TOTAL_T1 = 44
    TIER_TOTAL_T2 = 45
    TIER_TOTAL_T3 = 46
    # Cumulative per-edge migration cost tables: entry t is the summed cost of
    # crossing every edge between tier 0 and tier t, so the cost of a
    # (src, dst) path is table[max]-table[min] — the form the
    # bpf_mm_migrate_cost helper evaluates identically on the interpreter,
    # JIT and predicated backends.
    MIG_CUM_SETUP_T0 = 47
    MIG_CUM_SETUP_T1 = 48
    MIG_CUM_SETUP_T2 = 49
    MIG_CUM_SETUP_T3 = 50
    MIG_CUM_NS_T0 = 51
    MIG_CUM_NS_T1 = 52
    MIG_CUM_NS_T2 = 53
    MIG_CUM_NS_T3 = 54
    # Within-batch free-list reservation: base blocks the EARLIER rows of the
    # same fault batch may consume (upper bound: each earlier pending fault
    # takes at most 4^fault_max_order blocks).  Budget-aware programs subtract
    # this from FREE_BLOCKS_* / add it to MEM_PRESSURE reasoning so they see
    # within-batch grants instead of batch-start buddy state.  Always 0 on the
    # scalar path (a scalar fault has no earlier grants to account for).
    BATCH_RESERVED = 55
    # Prefix-cache candidate state (mm_evict hook only).  The candidate entry
    # reuses PAGE_TIER / PAGE_AGE / PAGE_HEAT for its tier, ticks since last
    # hit, and DAMON heat; the columns below carry the cache-specific facts.
    CACHE_REFCOUNT = 56      # sequences currently borrowing the entry (pinned)
    CACHE_HITS = 57          # cumulative admissions served by this entry
    CACHE_BLOCKS = 58        # entry size in base blocks
    # Cache-global state shared by every row of an evict batch
    CACHE_GHOST_HITS = 59    # ghost-list hits (re-requested after eviction)
    CACHE_ENTRIES = 60       # live entries in the cache index
    CACHE_CAP_BLOCKS = 61    # configured HBM budget for cached prefixes
    CACHE_USED_BLOCKS = 62   # HBM blocks currently held by cached prefixes
    # Online-profiler candidate state (mm_profile hook only).  One batch row
    # per live DAMON region of the sampled pid; PID / KTIME_NS / the buddy +
    # tier columns carry the usual system snapshot.
    PROF_REGION_START = 63   # region start, logical blocks
    PROF_REGION_END = 64     # region end (exclusive), logical blocks
    PROF_REGION_HEAT = 65    # region nr_accesses EMA, FIXED_POINT-scaled
    PROF_REGION_AGE = 66     # aggregation windows since the region changed
    PROF_MAPPED_BLOCKS = 67  # blocks currently mapped for the sampled pid
    PROF_WINDOW = 68         # DAMON aggregation window counter (version)
    CTX_LEN = 69             # number of fields; keep last


CTX_LEN = int(CTX.CTX_LEN)


class FaultKind(enum.IntEnum):
    FIRST_TOUCH = 0      # decode crossed into an unmapped logical block
    PREFILL = 1          # bulk mapping at prefill/mmap time
    PROMOTION_SCAN = 2   # khugepaged-style async scan considering a collapse


@dataclass
class FaultContext:
    """Structured view; ``.vector()`` flattens for the VM."""
    addr: int
    pid: int
    vma_start: int
    vma_end: int
    fault_max_order: int
    has_profile: int
    profile_map_id: int
    profile_nregions: int
    free_blocks: tuple[int, int, int, int]
    frag: tuple[int, int, int, int]
    heat: tuple[int, int, int, int]
    zero_ns_per_block: int
    compact_ns_per_block: int
    descriptor_ns: int
    block_bytes: int
    ktime_ns: int = 0
    mem_pressure: int = 0
    fault_kind: int = int(FaultKind.FIRST_TOUCH)
    seq_len: int = 0
    tier_free_blocks: int = 0
    tier_total_blocks: int = 0
    tier_pressure: int = 0
    pcie_ns_per_block: int = 0
    page_tier: int = 0
    page_order: int = 0
    page_age: int = 0
    page_heat: int = 0
    migrate_setup_ns: int = 0
    migrate_ns_per_block: int = 0
    ntiers: int = 0
    tier_free: tuple[int, int, int, int] = (0, 0, 0, 0)
    tier_total: tuple[int, int, int, int] = (0, 0, 0, 0)
    mig_cum_setup: tuple[int, int, int, int] = (0, 0, 0, 0)
    mig_cum_ns: tuple[int, int, int, int] = (0, 0, 0, 0)
    batch_reserved: int = 0
    cache_refcount: int = 0
    cache_hits: int = 0
    cache_blocks: int = 0
    cache_ghost_hits: int = 0
    cache_entries: int = 0
    cache_cap_blocks: int = 0
    cache_used_blocks: int = 0
    prof_region_start: int = 0
    prof_region_end: int = 0
    prof_region_heat: int = 0
    prof_region_age: int = 0
    prof_mapped_blocks: int = 0
    prof_window: int = 0

    def vector(self) -> np.ndarray:
        v = np.zeros(CTX_LEN, dtype=np.int64)
        v[CTX.ADDR] = self.addr
        v[CTX.PID] = self.pid
        v[CTX.VMA_START] = self.vma_start
        v[CTX.VMA_END] = self.vma_end
        v[CTX.FAULT_MAX_ORDER] = self.fault_max_order
        v[CTX.HAS_PROFILE] = self.has_profile
        v[CTX.PROFILE_MAP_ID] = self.profile_map_id
        v[CTX.PROFILE_NREGIONS] = self.profile_nregions
        v[CTX.FREE_BLOCKS_O0:CTX.FREE_BLOCKS_O0 + 4] = self.free_blocks
        v[CTX.FRAG_O0:CTX.FRAG_O0 + 4] = self.frag
        v[CTX.HEAT_O0:CTX.HEAT_O0 + 4] = self.heat
        v[CTX.ZERO_NS_PER_BLOCK] = self.zero_ns_per_block
        v[CTX.COMPACT_NS_PER_BLOCK] = self.compact_ns_per_block
        v[CTX.DESCRIPTOR_NS] = self.descriptor_ns
        v[CTX.BLOCK_BYTES] = self.block_bytes
        v[CTX.KTIME_NS] = self.ktime_ns
        v[CTX.MEM_PRESSURE] = self.mem_pressure
        v[CTX.FAULT_KIND] = self.fault_kind
        v[CTX.SEQ_LEN] = self.seq_len
        v[CTX.TIER_FREE_BLOCKS] = self.tier_free_blocks
        v[CTX.TIER_TOTAL_BLOCKS] = self.tier_total_blocks
        v[CTX.TIER_PRESSURE] = self.tier_pressure
        v[CTX.PCIE_NS_PER_BLOCK] = self.pcie_ns_per_block
        v[CTX.PAGE_TIER] = self.page_tier
        v[CTX.PAGE_ORDER] = self.page_order
        v[CTX.PAGE_AGE] = self.page_age
        v[CTX.PAGE_HEAT] = self.page_heat
        v[CTX.MIGRATE_SETUP_NS] = self.migrate_setup_ns
        v[CTX.MIGRATE_NS_PER_BLOCK] = self.migrate_ns_per_block
        v[CTX.NTIERS] = self.ntiers
        v[CTX.TIER_FREE_T0:CTX.TIER_FREE_T0 + MAX_TIERS] = self.tier_free
        v[CTX.TIER_TOTAL_T0:CTX.TIER_TOTAL_T0 + MAX_TIERS] = self.tier_total
        v[CTX.MIG_CUM_SETUP_T0:CTX.MIG_CUM_SETUP_T0 + MAX_TIERS] = \
            self.mig_cum_setup
        v[CTX.MIG_CUM_NS_T0:CTX.MIG_CUM_NS_T0 + MAX_TIERS] = self.mig_cum_ns
        v[CTX.BATCH_RESERVED] = self.batch_reserved
        v[CTX.CACHE_REFCOUNT] = self.cache_refcount
        v[CTX.CACHE_HITS] = self.cache_hits
        v[CTX.CACHE_BLOCKS] = self.cache_blocks
        v[CTX.CACHE_GHOST_HITS] = self.cache_ghost_hits
        v[CTX.CACHE_ENTRIES] = self.cache_entries
        v[CTX.CACHE_CAP_BLOCKS] = self.cache_cap_blocks
        v[CTX.CACHE_USED_BLOCKS] = self.cache_used_blocks
        v[CTX.PROF_REGION_START] = self.prof_region_start
        v[CTX.PROF_REGION_END] = self.prof_region_end
        v[CTX.PROF_REGION_HEAT] = self.prof_region_heat
        v[CTX.PROF_REGION_AGE] = self.prof_region_age
        v[CTX.PROF_MAPPED_BLOCKS] = self.prof_mapped_blocks
        v[CTX.PROF_WINDOW] = self.prof_window
        return v


# --------------------------------------------------------------------------
# Batched ctx assembly.  A batch built from one snapshot shares all of the
# system-state columns (buddy free lists, fragmentation, cost constants,
# clock, pressure); only the per-fault columns differ per row.  These helpers
# are the column-wise (vectorized) counterpart of FaultContext.vector() and
# are used by both the fault-path and tier-scan batch builders.
# --------------------------------------------------------------------------

def ctx_batch(n: int) -> np.ndarray:
    """A zeroed ``[n, CTX_LEN]`` int64 ctx matrix (one row per fault)."""
    return np.zeros((n, CTX_LEN), dtype=np.int64)


def fill_system_columns(mat: np.ndarray, *,
                        free_blocks, frag,
                        zero_ns_per_block: int, compact_ns_per_block: int,
                        descriptor_ns: int, block_bytes: int,
                        ktime_ns: int, mem_pressure: int,
                        tier_free_blocks: int = 0, tier_total_blocks: int = 0,
                        tier_pressure: int = 0, pcie_ns_per_block: int = 0,
                        migrate_setup_ns: int = 0,
                        migrate_ns_per_block: int = 0,
                        ntiers: int = 0, tier_free=(0, 0, 0, 0),
                        tier_total=(0, 0, 0, 0),
                        mig_cum_setup=(0, 0, 0, 0),
                        mig_cum_ns=(0, 0, 0, 0),
                        cache_ghost_hits: int = 0, cache_entries: int = 0,
                        cache_cap_blocks: int = 0,
                        cache_used_blocks: int = 0) -> np.ndarray:
    """Broadcast one system-state snapshot into every row of ``mat``.

    ``free_blocks``/``frag`` may be shorter than ``NUM_ORDERS`` when the
    allocator runs with a reduced ``max_order``; the tail columns stay 0.
    """
    fb = np.asarray(free_blocks, dtype=np.int64)
    fr = np.asarray(frag, dtype=np.int64)
    mat[:, CTX.FREE_BLOCKS_O0:CTX.FREE_BLOCKS_O0 + fb.size] = fb
    mat[:, CTX.FRAG_O0:CTX.FRAG_O0 + fr.size] = fr
    mat[:, CTX.ZERO_NS_PER_BLOCK] = zero_ns_per_block
    mat[:, CTX.COMPACT_NS_PER_BLOCK] = compact_ns_per_block
    mat[:, CTX.DESCRIPTOR_NS] = descriptor_ns
    mat[:, CTX.BLOCK_BYTES] = block_bytes
    mat[:, CTX.KTIME_NS] = ktime_ns
    mat[:, CTX.MEM_PRESSURE] = mem_pressure
    mat[:, CTX.TIER_FREE_BLOCKS] = tier_free_blocks
    mat[:, CTX.TIER_TOTAL_BLOCKS] = tier_total_blocks
    mat[:, CTX.TIER_PRESSURE] = tier_pressure
    mat[:, CTX.PCIE_NS_PER_BLOCK] = pcie_ns_per_block
    mat[:, CTX.MIGRATE_SETUP_NS] = migrate_setup_ns
    mat[:, CTX.MIGRATE_NS_PER_BLOCK] = migrate_ns_per_block
    mat[:, CTX.NTIERS] = ntiers
    mat[:, CTX.TIER_FREE_T0:CTX.TIER_FREE_T0 + MAX_TIERS] = \
        np.asarray(tier_free, dtype=np.int64)
    mat[:, CTX.TIER_TOTAL_T0:CTX.TIER_TOTAL_T0 + MAX_TIERS] = \
        np.asarray(tier_total, dtype=np.int64)
    mat[:, CTX.MIG_CUM_SETUP_T0:CTX.MIG_CUM_SETUP_T0 + MAX_TIERS] = \
        np.asarray(mig_cum_setup, dtype=np.int64)
    mat[:, CTX.MIG_CUM_NS_T0:CTX.MIG_CUM_NS_T0 + MAX_TIERS] = \
        np.asarray(mig_cum_ns, dtype=np.int64)
    mat[:, CTX.CACHE_GHOST_HITS] = cache_ghost_hits
    mat[:, CTX.CACHE_ENTRIES] = cache_entries
    mat[:, CTX.CACHE_CAP_BLOCKS] = cache_cap_blocks
    mat[:, CTX.CACHE_USED_BLOCKS] = cache_used_blocks
    return mat


# Return-value convention for fault-hook programs.
POLICY_FALLBACK = -1     # defer to the kernel default policy

# Sentinel the BATCHED discipline pass writes into decision rows AFTER a
# mid-batch supervisor detach: the row takes the kernel-default path with NO
# fallback accounting, matching the scalar route where post-detach faults
# never reach the (now-detached) hook at all.  Never a valid program return.
POLICY_DETACHED = -2

# Return-value convention for tier-hook (mm_tier) programs: the return value
# is the TARGET TIER id the candidate page should live in (0 = local HBM,
# 1..NTIERS-1 = spill tiers ordered fastest to slowest; the manager clamps to
# the live topology and migrates hop by hop).  FALLBACK defers to the
# kernel-default tiering policy.  TIER_KEEP / TIER_DEMOTE are the two-pool
# names for targets 0 and 1 — in a 2-tier topology they mean exactly what
# they did before the N-pool generalization (live in HBM / live in host).
TIER_KEEP = 0
TIER_DEMOTE = 1

# Return-value convention for evict-hook (mm_evict) programs: the return value
# is the TARGET TIER the cached prefix entry should live in (its current tier
# = keep where it is; a slower tier = demote hop-by-hop through the chain) or
# EVICT_DROP to free the entry's blocks outright.  EVICT_DROP deliberately
# equals MAX_TIERS: any tier id the topology can't hold already clamps to the
# slowest live tier downstream, so a drop sentinel one past the last tier is
# the natural "past the end of the chain" encoding and is always a VALID
# program return (the supervisor only strikes sub-FALLBACK sentinels).
EVICT_DROP = MAX_TIERS

# Return-value convention for profiler (mm_profile) programs: the return
# value is the region's HOT SCORE (>= 0, FIXED_POINT-scaled) — 0 marks the
# region cold; the ProfileSynthesizer folds positive scores (plus whatever
# the program emitted through bpf_ringbuf_output) into the online profile.
# FALLBACK defers the region to host-side synthesis from raw DAMON heat.
PROFILE_COLD = 0
