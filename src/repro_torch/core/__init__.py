"""eBPF-mm core, ported: the policy pipeline and the memory-management
plane.

  * :mod:`isa` / :mod:`verifier` / :mod:`lower` / :mod:`vm` /
    :mod:`predicate` / :mod:`jit` — restricted bytecode, load-time
    verifier, the shared lowering IR, the host interpreter (int64
    wraparound ALU, as the reference), the predicated batch executor over
    int64 torch lanes (CUDA by default) and its pc-walking fallback.
  * :mod:`cache` — cross-session artifact cache for the unroll (pickles
    under ``<root>/ebpf_torch``).
  * :mod:`maps` / :mod:`profiles` — eBPF maps and the userspace profile format.
  * :mod:`damon` — access monitoring with adaptive regions (benefit signal).
  * :mod:`cost` — calibrated promotion cost and the access-benefit model.
  * :mod:`buddy` / :mod:`mm` — the block-pool allocator and the memory
    manager with the fault hook.
  * :mod:`programs` — Figure-1 policy + THP/never baselines as bytecode.
  * :mod:`khugepaged` — background promotion (async collapse).
  * :mod:`tiering` — N-pool tiered placement behind ``HOOK_TIER``.
  * :mod:`wss` — online profile synthesis: the host consumer of the sampled
    ``HOOK_PROFILE`` surface, hot-reloading synthesized profiles mid-run.
"""

from .buddy import BuddyAllocator, BuddyError, BuddyStats, order_blocks
from .cache import ArtifactCache, artifact_cache
from .context import (CTX, CTX_LEN, EVICT_DROP, FIXED_POINT, MAX_TIERS,
                      NUM_ORDERS, POLICY_DETACHED, POLICY_FALLBACK,
                      TIER_DEMOTE, TIER_KEEP, FaultContext, FaultKind)
from .cost import (CostModel, HWSpec, TierSpec, default_tier_chain,
                   host_dram_tier, make_cost_model, nvme_tier, peer_hbm_tier)
from .damon import Damon, Region
from .hooks import (HOOK_EVICT, HOOK_FAULT, HOOK_PROFILE, HOOK_RECLAIM,
                    HOOK_TIER, HookRegistry)
from .isa import Asm, Insn, Op, Program
from .jit import JitPolicy
from .khugepaged import Khugepaged, KhugepagedConfig
from .lower import (MAX_UNROLLED, LIns, LoweredProgram, lower,
                    plan_scan_stages, segment_code, unroll_lowered)
from .maps import ArrayMap, MapRegistry
from .mm import (FaultResult, MemoryManager, MMError, MMOutOfMemory, MMStats,
                 PageMapping, ProcessState)
from .predicate import PredicatedPolicy
from .profiles import (MAX_PROFILE_REGIONS, REGION_STRIDE, Profile,
                       ProfileRegion, profile_from_heat)
from .programs import (ebpf_mm_program, evict_ghost_program,
                       evict_lfu_program, evict_lru_program, never_program,
                       profile_benefit_program, profile_heat_histogram_program,
                       profile_wss_program, reclaim_lru_program,
                       thp_always_program, tier_damon_program,
                       tier_edge_admission_program, tier_heat_band_program,
                       tier_lru_program, tier_never_program)
from .tiering import TIER_HBM, TIER_HOST, TierConfig, TieredMemoryManager
from .verifier import VerifierError, verify
from .wss import ProfileSynthesizer
from .vm import (HELPER_IDS, HELPER_KTIME, HELPER_MIGRATE_COST,
                 HELPER_PROMOTION_COST, HELPER_RINGBUF_OUTPUT, HELPER_TRACE,
                 PolicyVM, RunResult, VMFault)

__all__ = [name for name in dir() if not name.startswith("_")]
