"""Continuous-batching serving engine with an eBPF-mm-managed paged KV cache.

The main path of ``repro.serving.engine`` on PyTorch:

  * every sequence is a "process" with a growing KV address space;
  * each decode step that crosses a block boundary is a PAGE FAULT — the
    MemoryManager runs the attached policy program (profile search +
    cost/benefit, the paper's Figure 1) to pick the page size backing the
    new mapping;
  * the paged-attention kernel emits per-block attention mass, which feeds
    the per-process DAMON monitors (the benefit signal);
  * the khugepaged analogue runs between engine steps, collapsing hot
    regions into larger pages; collapses and compactions come back as
    explicit block-copy move lists applied to the device pools by the
    block-copy kernel.

  * pool exhaustion triggers the reclaim hook; with spill tiers configured
    (``host_blocks`` / ``tier_blocks``) the engine DEMOTES cold blocks down
    the tier chain instead of evicting the whole process
    (demote-before-preempt): the mm_tier program vets each candidate,
    approved pages migrate through the same block-copy move lists over one
    combined pool, and a background promotion scan brings re-heated pages
    back to HBM between steps;
  * with ``prefix_cache`` on, admissions borrow the longest cached prompt
    prefix read-only and prefill only the uncached suffix (flash attention
    with a query offset); the HOOK_EVICT program decides evictions.

Policies (``policy=``): "ebpf" (profile + Figure-1 program), "thp"
(kernel-default greedy PMD-size), "never" (base pages), "thp-prog" /
"never-prog" (the same baselines as loaded programs).  Faults take the
batched route by default — one policy invocation per decode step over every
faulting sequence, run by the predicated executor on the engine's device;
``batch_faults=False`` keeps the scalar route (one invocation per fault).
``tier_policy`` selects the mm_tier program, ``evict_policy`` the mm_evict
program, as in the reference.  ``profile="auto"`` starts with no profile
and lets the online profiler (``HOOK_PROFILE`` + ``ProfileSynthesizer``)
synthesize and hot-reload one; ``telemetry``/``trace`` attach the telemetry
hub and the Chrome-trace spans; ``chaos`` arms the seeded failure
injector.  All default to off, where each site costs one ``is None``
check.

Departure from the JAX engine: the KV pools and the persistent block-table
buffer are updated IN PLACE on the device (JAX threads them functionally
through its jitted entries).
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import (MAX_PROFILE_REGIONS, FaultKind, HWSpec, Khugepaged,
                    KhugepagedConfig, MemoryManager, MMOutOfMemory, Profile,
                    ProfileSynthesizer, TieredMemoryManager,
                    default_tier_chain, ebpf_mm_program, evict_ghost_program,
                    evict_lfu_program, evict_lru_program, make_cost_model,
                    never_program, profile_wss_program, reclaim_lru_program,
                    thp_always_program, tier_damon_program,
                    tier_edge_admission_program, tier_heat_band_program,
                    tier_lru_program, tier_never_program)
from ..core.buddy import order_blocks
from ..core.hooks import HOOK_EVICT, HOOK_FAULT, HOOK_PROFILE, HOOK_TIER
from ..kernels.block_copy.ops import block_copy, pool_pointers
from ..models.common import BF16
from ..models.decode import (PagedLayout, cache_init, decode_step,
                             pool_leaves, prefill_step, prefill_suffix_step)
from ..obs import (Telemetry, flatten_metrics, render_prometheus,
                   write_chrome_trace)
from ..obs.ringbuf import EV_PREEMPT
from ..resilience import FailureInjector
from .prefix_cache import PrefixCache
from .sampler import Sampler
from .tables import DeviceBlockTables

Pytree = Any


def split_move_batches(moves) -> list[list[tuple[int, int, int]]]:
    """Segment one drain's ``(src, dst, order)`` moves into batches whose
    copies may run concurrently and in place; batches apply in order.

    A chain within one drain (compact A->B, then demote B->H) would copy
    stale data, and a repeated destination (block freed and re-allocated
    within the drain) makes the winner undefined, so no batch reads OR
    writes a block an earlier move of the batch wrote.  The reference's
    scatter reads every source before it writes, so it stops there;
    concurrent in-place copies also race when a move WRITES a block an
    earlier move of the batch READS (two collapses in one drain, or a
    promotion into blocks a demotion of the same drain just vacated), so
    that case splits too."""
    batches: list[list[tuple[int, int, int]]] = [[]]
    written: set[int] = set()
    read: set[int] = set()
    for s, d, o in moves:
        n = order_blocks(o)
        if any(b in written for b in range(s, s + n)) or \
                any(b in written or b in read for b in range(d, d + n)):
            batches.append([])
            written = set()
            read = set()
        batches[-1].append((s, d, o))
        written.update(range(d, d + n))
        read.update(range(s, s + n))
    return batches


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16       # reserved capacity (VMA is sized for this)
    app: str | None = None
    temperature: float = 0.0
    stop_after: int | None = None  # EOS point; None = runs to max_new_tokens


@dataclass
class SeqState:
    req: Request
    pid: int
    slot: int
    generated: list = field(default_factory=list)
    length: int = 0           # tokens currently in KV (prompt + generated)
    prefix: Any = None        # pinned PrefixMatch when admitted via the cache


@dataclass
class EngineStats:
    steps: int = 0
    prefills: int = 0
    prefill_tokens: int = 0        # tokens actually run through the kernel
    decode_tokens: int = 0
    preemptions: int = 0
    tier_reliefs: int = 0          # OOMs resolved by demotion, not preemption
    wall_host_s: float = 0.0
    completed: int = 0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


class ServingEngine:
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

    def __init__(self, cfg: ModelConfig, params: Pytree, layout: PagedLayout,
                 *, max_batch: int = 4, policy: str = "ebpf",
                 profile: "Profile | list | str | None" = None,
                 profile_period: int = 4, hw: HWSpec | None = None,
                 khugepaged: bool = True, seed: int = 0, cache_dtype=BF16,
                 host_blocks: int = 0, tier_blocks=None,
                 tier_policy: str = "ebpf-tier",
                 prefix_cache: "bool | int" = False,
                 evict_policy: str = "lru-evict",
                 batch_faults: bool = True,
                 telemetry: "Telemetry | bool | None" = None,
                 trace: bool = False,
                 chaos: "int | FailureInjector | None" = None,
                 chaos_rate: float = 0.02,
                 containment: bool = True, device=None):
        # telemetry: None (default — zero-overhead no-op), True (counters/
        # histograms/ring), or a repro_torch.obs.Telemetry instance.
        # trace=True additionally records engine spans for the Chrome-trace
        # exporter (and implies telemetry when none was passed).
        if telemetry is True or (telemetry is None and trace):
            telemetry = Telemetry(trace=trace)
        elif telemetry is not None and trace:
            telemetry.trace_enabled = telemetry.enabled
        self.telemetry: Telemetry | None = telemetry or None
        # chaos: None (default — no injection, zero overhead), an int seed
        # (uniform chaos_rate at every failure site), or a pre-configured
        # FailureInjector.  containment=False keeps the injector but turns
        # OFF the resilience responses (supervisor detach, migration retry,
        # quarantine routing, degraded demote).
        if chaos is None or isinstance(chaos, FailureInjector):
            self.injector = chaos
        else:
            self.injector = FailureInjector.uniform(int(chaos),
                                                    float(chaos_rate))
        self.containment = bool(containment)
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingEngine runs on CUDA by default and no "
                               "GPU is visible; pass device='cpu' to run the "
                               "plain PyTorch versions on the CPU")
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.layout = layout
        self.max_batch = max_batch
        self.policy = policy
        # tier_blocks: spill-tier capacities walking down the chain — 1 pool
        # = (host-DRAM,), 2 = (peer-HBM, host-DRAM), 3 = (peer-HBM,
        # host-DRAM, NVMe).  host_blocks is the classic 2-pool shorthand.
        if tier_blocks is None and host_blocks > 0:
            tier_blocks = (host_blocks,)
        self.tier_blocks = tuple(int(b) for b in tier_blocks) \
            if tier_blocks else ()
        tiered = bool(self.tier_blocks)
        self.tier_policy = tier_policy if tiered else None
        # batch_faults=False keeps the scalar fault path (one policy
        # invocation per fault)
        self.batch_faults = batch_faults
        hw = hw or HWSpec()

        n_attn = sum(1 for k in cfg.layer_kinds() if k == "a")
        slab = cfg.kv_heads * cfg.head_dim * 2
        cost = make_cost_model(hw, kv_heads=1, head_dim=1,
                               block_tokens=layout.block_tokens)
        cost.block_bytes = layout.block_tokens * slab * 2 * max(1, n_attn)

        default_mode = {"never": "never", "never-prog": "never"}.get(policy,
                                                                     "thp")
        # the policy programs' batch executor runs on the engine's device
        mm_kw = dict(default_mode=default_mode, damon_seed=seed,
                     telemetry=self.telemetry, injector=self.injector,
                     containment=self.containment, device=self.device)
        if tiered:
            # tiered pool: HBM buddy + one buddy per spill tier; the device
            # cache below is materialized over the COMBINED index space so
            # tier crossings are ordinary block_copy moves
            self.mm = TieredMemoryManager(
                layout.num_blocks, cost,
                tiers=default_tier_chain(hw, self.tier_blocks), **mm_kw)
            if tier_policy not in self.TIER_PROGRAMS:
                raise ValueError(f"unknown tier_policy {tier_policy!r}")
            if len(self.tier_blocks) > 1 \
                    and tier_policy in self.TWO_TIER_POLICIES:
                raise ValueError(
                    f"tier_policy {tier_policy!r} is a 2-tier baseline that "
                    f"can never demote past tier 1; use 'heat-tier' or "
                    f"'edge-tier' for a {len(self.tier_blocks) + 1}-tier "
                    f"chain")
            prog = self.TIER_PROGRAMS[tier_policy]
            if prog is not None:
                self.mm.attach_tier_program(prog())
        else:
            self.mm = MemoryManager(layout.num_blocks, cost, **mm_kw)
        self._pool_blocks = layout.num_blocks + sum(self.tier_blocks)
        self.mm.attach_reclaim_program(reclaim_lru_program())
        self.profiler: ProfileSynthesizer | None = None
        if policy == "ebpf":
            if profile is None:
                raise ValueError(
                    "policy='ebpf' needs a profile (or list, or 'auto')")
            if isinstance(profile, str):
                if profile != "auto":
                    raise ValueError(f"unknown profile mode {profile!r}")
                # Online profiling: start with NO profile loaded.  The
                # profiler program samples the live DAMON regions on the mm
                # tick (HOOK_PROFILE) and the ProfileSynthesizer hot-reloads
                # synthesized profiles mid-run.  max_regions=8 keeps the
                # fault program's search loop the shape of a small offline
                # profile's; an EMPTY profile registers the map slot the
                # verifier's indirect-load check needs, and the reloads are
                # map WRITEs into slots registered the same way.
                bound = 8
                self.mm.load_profile(Profile("_default", []))
                self.mm.attach_fault_program(
                    ebpf_mm_program(max_regions=bound))
                self.mm.attach_profile_program(profile_wss_program())
                self.profiler = ProfileSynthesizer(
                    self.mm, cost, period=profile_period,
                    max_regions=bound, telemetry=self.telemetry)
                self.mm.hooks.warm(HOOK_PROFILE, max_batch=16)
            else:
                profiles = profile if isinstance(profile, (list, tuple)) \
                    else [profile]
                for prof in profiles:
                    self.mm.load_profile(prof)
                # One program serves every app via the indirect profile-map
                # load; its verified search loop is right-sized to the
                # profiles loaded (rounded up to a power of two), as the
                # reference does.
                nreg = max((len(p.regions) for p in profiles), default=0)
                bound = min(max(8, 1 << max(0, nreg - 1).bit_length()),
                            MAX_PROFILE_REGIONS)
                self.mm.attach_fault_program(
                    ebpf_mm_program(max_regions=bound))
        elif policy == "thp-prog":
            self.mm.attach_fault_program(thp_always_program())
        elif policy == "never-prog":
            self.mm.attach_fault_program(never_program())
        elif policy not in ("thp", "never"):
            raise ValueError(f"unknown policy {policy!r}")
        if self.batch_faults:
            # build the batch executors now (decode-sized bucket), not on
            # the first faulting step or the first batched tier placement
            self.mm.hooks.warm(HOOK_FAULT, max_batch=max_batch)
            self.mm.hooks.warm(HOOK_TIER, max_batch=max_batch)

        # Cross-request KV prefix cache: content-addressed shared prefix
        # blocks, admission via read-only borrows + CoW, HOOK_EVICT-driven
        # eviction into the tier chain.  prefix_cache=True sizes the budget
        # at a quarter of HBM; an int is an explicit cap in blocks.
        self.prefix_cache: PrefixCache | None = None
        if prefix_cache:
            cap = (int(prefix_cache) if not isinstance(prefix_cache, bool)
                   else max(1, layout.num_blocks // 4))
            self.prefix_cache = PrefixCache(self.mm, layout.block_tokens,
                                            cap_blocks=cap,
                                            telemetry=self.telemetry)
            if evict_policy not in self.EVICT_PROGRAMS:
                raise ValueError(f"unknown evict_policy {evict_policy!r}")
            eprog = self.EVICT_PROGRAMS[evict_policy]
            if eprog is not None:
                self.mm.attach_evict_program(eprog())
                # a scan's ctx batch is ONE ROW PER ENTRY, and the entry
                # count can transiently reach ~2x the budget between scans
                warm_to = 1 << max(4, (2 * cap - 1).bit_length())
                self.mm.hooks.warm(HOOK_EVICT, max_batch=min(512, warm_to))
        self.evict_policy = evict_policy if self.prefix_cache else None

        self.khugepaged = (Khugepaged(self.mm, KhugepagedConfig())
                           if (khugepaged and policy == "ebpf") else None)
        pool_layout = layout if not tiered else PagedLayout(
            num_blocks=self._pool_blocks, block_tokens=layout.block_tokens,
            max_blocks=layout.max_blocks)
        self.cache = cache_init(cfg, pool_layout, max_batch, cache_dtype,
                                device=self.device)
        self._pool_leaves = pool_leaves(self.cache)
        # the pools (HBM and every spill tier, one combined index space)
        # live as long as the engine: one pointer table for the block-copy
        # kernel, built once
        self._pool_ptrs = (pool_pointers(self._pool_leaves)
                           if self.device.type == "cuda" else None)
        self.sampler = Sampler(seed=seed)
        self.stats = EngineStats()

        self.waiting: list[Request] = []
        self.active: dict[int, SeqState] = {}    # slot -> seq
        self._next_pid = 1
        self.finished: dict[int, list[int]] = {}
        # rid -> [trace-clock t0, wall t0 or None once TTFT was observed]:
        # per-request serving-latency bookkeeping (telemetry only)
        self._req_t0: dict[int, list] = {}
        # per-app aggregate per-logical-block heat — the DAMON trace used by
        # offline profiling (profile_from_heat)
        self.heat_histograms: dict[str, np.ndarray] = {}

        # Device-resident block table: a persistent [B, max_blocks] buffer
        # on the device; the host ships only dirty rows (version-tracked in
        # DeviceBlockTables) and installs them in place before each kernel.
        self._tables = DeviceBlockTables(max_batch, layout.max_blocks)
        self._table_buf = torch.full((max_batch, layout.max_blocks), -1,
                                     dtype=torch.int32, device=self.device)

    # ----------------------------------------------------------------- admin
    def _span(self, name: str, tid: str = "engine"):
        tel = self.telemetry
        if tel is None or not tel.trace_enabled:
            return nullcontext()
        return tel.span(name, cat="engine", tid=tid)

    def submit(self, req: Request) -> None:
        tel = self.telemetry
        if tel is not None and tel.enabled and req.rid not in self._req_t0:
            self._req_t0[req.rid] = [tel.now(), time.perf_counter_ns()]
        self.waiting.append(req)

    def _free_slots(self) -> list[int]:
        return [s for s in range(self.max_batch) if s not in self.active]

    def _blocks_needed(self, tokens: int) -> int:
        return -(-tokens // self.layout.block_tokens)

    # --------------------------------------------------------------- prefill
    def _admit(self) -> None:
        for slot in self._free_slots():
            if not self.waiting:
                break
            req = self.waiting.pop(0)
            pid = self._next_pid
            self._next_pid += 1
            total = len(req.prompt) + req.max_new_tokens
            vma_blocks = min(self._blocks_needed(total) + 1,
                             self.layout.max_blocks)
            app = req.app
            if app is None and self.profiler is not None:
                # auto-profiling keys synthesized profiles by app — give
                # unlabeled requests the shared default bucket so the
                # profile map lookup has something to hit
                app = "_default"
            self.mm.create_process(pid, app=app, vma_blocks=vma_blocks)
            nblocks = self._blocks_needed(len(req.prompt))
            # prefix-cache admission: borrow the longest cached prefix
            # read-only (page-table surgery, no kernel work), fault only the
            # uncached suffix blocks, CoW-break a partially shared tail
            match = (self.prefix_cache.acquire(pid, req.prompt)
                     if self.prefix_cache is not None else None)
            n_shared = 0
            if match is not None:
                self.mm.map_shared(pid, 0, match.blocks)
                n_shared = len(match.blocks)
            if self.batch_faults:
                # the whole prefill span resolves through ONE policy
                # invocation (bulk FaultKind.PREFILL placement hints)
                fault_fn = lambda p=pid, s=n_shared, n=nblocks: \
                    self.mm.fault_range(p, s, n)  # noqa: E731
            else:
                fault_fn = lambda p=pid, s=n_shared, n=nblocks: \
                    self.mm.ensure_range(p, s, n)  # noqa: E731
            ok = self._ensure_with_reclaim(fault_fn, pid, nblocks - n_shared,
                                           allow_preempt=False)
            if ok and match is not None and match.cow_logical is not None:
                # the suffix prefill writes INSIDE the last borrowed block —
                # break the share first (private copy rides the move list)
                ok = self._ensure_with_reclaim(
                    lambda p=pid, a=match.cow_logical: self.mm.cow_break(p, a),
                    pid, 1, allow_preempt=False)
            if not ok:
                if match is not None:
                    self.prefix_cache.release(match)
                self.mm.free_process(pid)
                self.waiting.insert(0, req)
                break
            # land any demotion/compaction/CoW copies before prefill writes
            # the pool (same pre-kernel ordering as the decode path)
            self._apply_pending_moves()
            seq = SeqState(req=req, pid=pid, slot=slot,
                           length=len(req.prompt), prefix=match)
            self.active[slot] = seq
            with self._span(f"prefill rid={req.rid}"):
                self._run_prefill(seq)
            tel = self.telemetry
            rec = self._req_t0.get(req.rid)
            if tel is not None and rec is not None and rec[1] is not None:
                # the prefill above sampled the request's first token
                tel.observe_ttft(time.perf_counter_ns() - rec[1])
                rec[1] = None
            if self.prefix_cache is not None:
                # cache every whole block of the freshly prefilled prompt
                # (copies ride the next move-list drain, before any kernel
                # can touch the donor)
                self.prefix_cache.insert(pid, req.prompt)
            self.stats.prefills += 1

    def _slot_pids(self) -> list:
        """Current slot -> pid assignment (None for empty slots)."""
        sp: list = [None] * self.max_batch
        for slot, seq in self.active.items():
            sp[slot] = seq.pid
        return sp

    def _sync_tables(self, slot_pids) -> np.ndarray:
        """Dirty-row sync of the device-resident block table: full rows
        first, then the (row, col, value) delta triples, written in place.
        Returns the ``active`` mask."""
        idx, rows, active, tri = self._tables.sync(self.mm, slot_pids)
        dev = self.device
        if len(idx):
            self._table_buf[torch.from_numpy(idx).to(dev).long()] = \
                torch.from_numpy(rows).to(dev)
        if len(tri):
            t = torch.from_numpy(tri).to(dev)
            self._table_buf[t[:, 0].long(), t[:, 1].long()] = t[:, 2]
        return active

    def _run_prefill(self, seq: SeqState) -> None:
        bt = self.layout.block_tokens
        prompt = np.asarray(seq.req.prompt, np.int32)
        match = seq.prefix
        if match is not None and match.tokens > 0:
            self._run_prefill_suffix(seq, match)
            return
        S_pad = self._blocks_needed(len(prompt)) * bt
        toks = np.zeros((1, S_pad), np.int32)
        toks[0, :len(prompt)] = prompt
        # the new pid's row arrives as a dirty-row upload; the prefill reads
        # the slot's row of the persistent buffer
        self._sync_tables(self._slot_pids())
        dev = self.device
        logits, _ = prefill_step(
            self.params, self.cfg, self.cache,
            torch.from_numpy(toks).to(dev),
            self._table_buf[seq.slot:seq.slot + 1], self.layout, chunk=256,
            last_index=torch.tensor([len(prompt) - 1], device=dev))
        self.mm.record_access(seq.pid,
                              np.ones(self._blocks_needed(len(prompt))))
        self.stats.prefill_tokens += len(prompt)
        tok = self.sampler.sample(logits.cpu().numpy()[0],
                                  self.cfg.vocab, seq.req.temperature)
        seq.generated.append(int(tok))

    def _run_prefill_suffix(self, seq: SeqState, match) -> None:
        """Cache-hit prefill: the first ``match.tokens`` tokens' KV is
        already in the pool (shared mappings + a CoW-broken tail), so only
        the suffix runs through the kernel, attending over the full-length
        key stream (pool-gathered prefix + computed suffix) with the SAME
        padded key length as the full prefill — what keeps its outputs
        equal to the full path's suffix rows."""
        bt = self.layout.block_tokens
        prompt = np.asarray(seq.req.prompt, np.int32)
        L = len(prompt)
        S0 = match.tokens
        KB = self._blocks_needed(L)         # the whole prompt's blocks
        SB = self._blocks_needed(L - S0) * bt
        toks = np.zeros((1, SB), np.int32)
        toks[0, :L - S0] = prompt[S0:]
        self._sync_tables(self._slot_pids())
        dev = self.device
        logits, _ = prefill_suffix_step(
            self.params, self.cfg, self.cache,
            torch.from_numpy(toks).to(dev),
            self._table_buf[seq.slot:seq.slot + 1], self.layout,
            prefix_len=S0, key_blocks=KB, chunk=256,
            last_index=torch.tensor([L - S0 - 1], device=dev))
        self.mm.record_access(seq.pid, np.ones(KB))
        self.stats.prefill_tokens += L - S0
        tok = self.sampler.sample(logits.cpu().numpy()[0],
                                  self.cfg.vocab, seq.req.temperature)
        seq.generated.append(int(tok))

    # ---------------------------------------------------------------- reclaim
    def _ensure_with_reclaim(self, fault_fn, faulting_pid: int,
                             need_blocks: int, *,
                             allow_preempt: bool = True) -> bool:
        """Run a fault entry point, relieving pressure on MMOutOfMemory.

        Cheapest relief first: evict/demote unpinned prefix-cache entries;
        then demote cold blocks down the tier chain (all processes,
        coldest-first, the nominated victim's pages preferred), retried as
        long as demotion makes progress; whole-sequence preemption is the
        fallback and fires AT MOST ONCE per fault.  Admission passes
        ``allow_preempt=False`` (the waiting-queue watermark): a request
        that does not fit waits for completions instead of evicting the
        running batch."""
        preempted = False
        for _ in range(4 + 2 * need_blocks + self.max_batch):
            try:
                fault_fn()
                return True
            except MMOutOfMemory as oom:
                if self.prefix_cache is not None and \
                        self.prefix_cache.scan(max(1, need_blocks)) > 0:
                    continue
                if isinstance(self.mm, TieredMemoryManager) and \
                        self.mm.demote_cold_global(
                            need_blocks, prefer_pid=oom.victim_pid) > 0:
                    self.stats.tier_reliefs += 1
                    continue
                if not allow_preempt or preempted or oom.victim_pid is None:
                    return False
                self._preempt(oom.victim_pid)
                preempted = True
        return False

    # ---------------------------------------------------------------- decode
    def _preempt(self, victim_pid: int | None) -> None:
        if victim_pid is None:
            raise MMOutOfMemory("pool exhausted and nothing to evict")
        tel = self.telemetry
        for slot, seq in list(self.active.items()):
            if seq.pid == victim_pid:
                if seq.prefix is not None:
                    self.prefix_cache.release(seq.prefix)
                self.mm.evict_process(victim_pid)
                del self.active[slot]
                self.waiting.insert(0, seq.req)   # recompute-from-scratch
                self.stats.preemptions += 1
                if tel is not None and tel.enabled:
                    tel.emit(EV_PREEMPT, victim_pid, seq.req.rid, seq.length,
                             ts=self.mm.ktime_ns)
                return
        self.mm.evict_process(victim_pid)

    def step(self) -> bool:
        """One engine iteration. Returns False when all work is done."""
        t0 = time.monotonic()
        tel = self.telemetry
        with self._span(f"step {self.stats.steps}"):
            self._admit()
            if not self.active and not self.waiting:
                return False
            if self.active:
                tok0 = self.stats.decode_tokens
                d0 = time.perf_counter_ns()
                # the decode span ends after the logits' device-to-host
                # copy, so it covers the device work queued before it
                with self._span("decode"):
                    self._decode_once()
                if tel is not None and tel.enabled:
                    tel.observe_decode_token(
                        time.perf_counter_ns() - d0,
                        self.stats.decode_tokens - tok0)
            # the mm-tick span launches its move drain's block copies
            # without waiting for them (their device time lands in the next
            # span that waits on the device)
            with self._span("mm-tick", tid="mm"):
                if self.khugepaged is not None:
                    self.khugepaged.tick()
                if isinstance(self.mm, TieredMemoryManager):
                    # background promotion: bring re-heated spill-tier pages
                    # back
                    self.mm.promotion_scan()
                if self.prefix_cache is not None:
                    # periodic eviction cadence (batched HOOK_EVICT scan)
                    self.prefix_cache.tick()
                self._apply_pending_moves()
                self.mm.tick()
                if self.profiler is not None and self.active:
                    # sampled HOOK_PROFILE scan + profile synthesis/reload
                    self.profiler.tick(
                        [(seq.pid, self.mm.procs[seq.pid].app)
                         for seq in self.active.values()
                         if seq.pid in self.mm.procs])
        self.stats.steps += 1
        dt = time.monotonic() - t0
        self.stats.wall_host_s += dt
        if tel is not None and tel.enabled:
            tel.mgmt_step_ns.observe(int(dt * 1e9))
        return bool(self.active or self.waiting)

    def _fault_slots_batched(self) -> set[int]:
        """Resolve every active slot's potential boundary crossing through a
        single ``fault_batch`` — with a fault program attached, a decode
        step runs exactly ONE policy invocation.  OOM relief mirrors the
        scalar path: prefix-cache scan, then demote-before-preempt on a
        tiered pool (retrying while demotion makes progress, preempting at
        most once), plain preemption otherwise.  Returns the slots whose
        block is mapped (safe to decode)."""
        bt = self.layout.block_tokens
        tiered = isinstance(self.mm, TieredMemoryManager)
        pending = [(slot, seq.pid, seq.length // bt)
                   for slot, seq in sorted(self.active.items())]
        preempted = False
        for _ in range(4 + 2 * len(pending) + self.max_batch):
            pending = [(s, p, a) for s, p, a in pending
                       if s in self.active and self.active[s].pid == p]
            if not pending:
                break
            try:
                self.mm.fault_batch([(p, a, FaultKind.FIRST_TOUCH)
                                     for _, p, a in pending])
                break
            except MMOutOfMemory as oom:
                if self.prefix_cache is not None and \
                        self.prefix_cache.scan(1) > 0:
                    continue
                if tiered and self.mm.demote_cold_global(
                        1, prefer_pid=oom.victim_pid) > 0:
                    self.stats.tier_reliefs += 1
                    continue
                if oom.victim_pid is None or (tiered and preempted):
                    break
                self._preempt(oom.victim_pid)
                preempted = True
        return {slot for slot, seq in self.active.items()
                if (seq.length // bt) in self.mm.procs[seq.pid].mapped}

    def _fault_slots_scalar(self) -> set[int]:
        """One ``ensure_mapped`` (one ctx build, one policy invocation) per
        faulting slot.  Returns the slots whose block is mapped."""
        tiered = isinstance(self.mm, TieredMemoryManager)
        ok: set[int] = set()
        for slot, seq in list(self.active.items()):
            if slot not in self.active:       # preempted earlier this pass
                continue
            addr = seq.length // self.layout.block_tokens
            if tiered:
                good = self._ensure_with_reclaim(
                    lambda p=seq.pid, a=addr: self.mm.ensure_mapped(p, a),
                    seq.pid, 1)
                if good:
                    ok.add(slot)
                continue
            try:
                self.mm.ensure_mapped(seq.pid, addr)
                ok.add(slot)
            except MMOutOfMemory as oom:
                self._preempt(oom.victim_pid)
        # drop slots preempted while relieving a later slot's fault
        ok = {s for s in ok if s in self.active}
        if tiered and ok:
            # decode-time tier placement: consult HOOK_TIER for the blocks
            # this step just installed, mirroring the batched route (where
            # fault_batch runs the first-touch placement pass itself)
            bt = self.layout.block_tokens
            self.mm.place_decode(
                [(self.active[s].pid, self.active[s].length // bt,
                  FaultKind.FIRST_TOUCH) for s in sorted(ok)])
        return ok

    def _decode_once(self) -> None:
        B = self.max_batch
        tokens = np.zeros(B, np.int32)
        lengths = np.zeros(B, np.int32)
        # page-fault path: each active slot's new token may cross a block
        # boundary; the batched route resolves the whole step in one policy
        # invocation
        if self.batch_faults:
            ok_slots = self._fault_slots_batched()
        else:
            ok_slots = self._fault_slots_scalar()
        # Flush demotion/promotion/compaction/collapse copies BEFORE the
        # kernel touches the pool and BEFORE syncing the device table: a
        # fault above may have freed and re-allocated a block, and a remap
        # bumps table_version so the sync below re-uploads the moved rows.
        self._apply_pending_moves()
        skipped: set[int] = set()     # slots that must not advance this step
        slot_pids: list = [None] * B
        for slot, seq in self.active.items():
            if slot not in ok_slots:
                skipped.add(slot)
                continue
            tokens[slot] = seq.generated[-1]
            lengths[slot] = seq.length
            slot_pids[slot] = seq.pid
        # skipped slots sync as vacant so their rows cannot alias live blocks
        active = self._sync_tables(slot_pids)
        dev = self.device
        logits, _, heat = decode_step(
            self.params, self.cfg, self.cache, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(lengths).to(dev), self._table_buf, self.layout,
            active=torch.from_numpy(active).to(dev))
        logits_np = logits.cpu().numpy()
        heat_np = heat.cpu().numpy()
        for slot, seq in list(self.active.items()):
            if slot in skipped:
                # no block table this step: the row's logits are garbage; the
                # sequence stays put and refaults next step
                continue
            nb = self._blocks_needed(seq.length + 1)
            self.mm.record_access(seq.pid, heat_np[slot, :nb])
            if seq.prefix is not None:
                # fold the borrower's attention mass over the shared span
                # into the matched entries' heat (what the eviction
                # programs read as PAGE_HEAT)
                self.prefix_cache.note_heat(seq.prefix, heat_np[slot, :nb])
            app = seq.req.app or "_default"
            if app not in self.heat_histograms:
                self.heat_histograms[app] = np.zeros(self.layout.max_blocks,
                                                     np.float64)
            self.heat_histograms[app][:nb] += heat_np[slot, :nb]
            tok = self.sampler.sample(logits_np[slot], self.cfg.vocab,
                                      seq.req.temperature)
            seq.generated.append(int(tok))
            seq.length += 1
            self.stats.decode_tokens += 1
            limit = seq.req.max_new_tokens
            if seq.req.stop_after is not None:
                limit = min(limit, seq.req.stop_after)
            if len(seq.generated) >= limit:
                self.finished[seq.req.rid] = list(seq.generated)
                if seq.prefix is not None:
                    self.prefix_cache.release(seq.prefix)
                self.mm.free_process(seq.pid)
                del self.active[slot]
                self.stats.completed += 1
                tel = self.telemetry
                rec = self._req_t0.pop(seq.req.rid, None)
                if rec is not None and tel is not None and tel.trace_enabled:
                    # whole-request span (submit -> last token) on its own
                    # trace row
                    tel.spans.append((f"req {seq.req.rid}", "request",
                                      "requests", rec[0],
                                      tel.now() - rec[0]))

    def _apply_pending_moves(self) -> None:
        moves = self.mm.drain_moves()
        if not moves:
            return
        for batch in split_move_batches(moves):
            self._apply_move_batch(batch)

    def _apply_move_batch(self, moves: list[tuple[int, int, int]]) -> None:
        src = np.concatenate([np.arange(s, s + order_blocks(o))
                              for s, _, o in moves]).astype(np.int32)
        dst = np.concatenate([np.arange(d, d + order_blocks(o))
                              for _, d, o in moves]).astype(np.int32)
        # one launch moves the rows of every pool leaf (K and V, all layers)
        block_copy(self._pool_leaves, src, dst, ptrs=self._pool_ptrs)

    # ------------------------------------------------------------------ run
    def run(self, max_steps: int = 10_000) -> dict:
        steps = 0
        while self.step():
            steps += 1
            if steps >= max_steps:
                break
        out = {"engine": self.stats.snapshot(), "mm": self.mm.stats.snapshot(),
               "huge_fraction": self.mm.hugepage_block_fraction(),
               "tables": {"syncs": self._tables.syncs,
                          "synced_rows": self._tables.synced_rows,
                          "blank_rows": self._tables.blank_rows,
                          "full_rows": self._tables.full_rows,
                          "delta_rows": self._tables.delta_rows,
                          "delta_cells": self._tables.delta_cells}}
        if isinstance(self.mm, TieredMemoryManager):
            out["tier"] = self.mm.tier_snapshot()
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.snapshot()
        if self.khugepaged is not None:
            out["khugepaged"] = {"collapsed": self.khugepaged.collapsed,
                                 "considered": self.khugepaged.considered}
        if self.profiler is not None:
            out["profiler"] = self.profiler.snapshot()
        if self.telemetry is not None and self.telemetry.enabled:
            out["telemetry"] = self.telemetry.snapshot()
        return out

    # ------------------------------------------------------------ telemetry
    def write_trace(self, path) -> None:
        """Write the Chrome trace-event JSON (load in Perfetto / chrome://
        tracing): engine spans on the wall-clock track, mm/program ring
        events on the modeled-clock track."""
        if self.telemetry is None:
            raise ValueError("engine was built without telemetry "
                             "(pass trace=True or telemetry=...)")
        write_chrome_trace(self.telemetry, path)

    def write_wss_curve(self, path) -> None:
        """Dump the online profiler's per-process WSS curve as JSON
        (samples of modeled time / WSS blocks / mapped blocks)."""
        if self.profiler is None:
            raise ValueError("engine has no online profiler "
                             "(pass profile='auto')")
        self.profiler.write_wss_curve(path)

    def metrics(self) -> dict:
        """Flat ``{metric_name: number}`` snapshot across every subsystem:
        engine stats, mm stats, hook counters, artifact-cache stats, tier
        pools, and (when telemetry is on) histograms/counters/ring stats."""
        sections = {
            "engine": self.stats.snapshot(),
            "mm": self.mm.stats.snapshot(),
            "huge_fraction": self.mm.hugepage_block_fraction(),
            "hooks": {"invocations": self.mm.hooks.invocations,
                      "calls": self.mm.hooks.calls,
                      "batch_calls": self.mm.hooks.batch_calls},
            "cache": self.mm.hooks._artifact_cache().stats,
        }
        res: dict = {"supervisor": self.mm.hooks.supervisor.snapshot()}
        if self.injector is not None:
            res["injector"] = self.injector.snapshot()
        if isinstance(self.mm, TieredMemoryManager):
            sections["tier"] = self.mm.tier_snapshot()
            res["health"] = self.mm.health.snapshot()
        if self.prefix_cache is not None:
            sections["prefix_cache"] = self.prefix_cache.snapshot()
        if self.profiler is not None:
            sections["profiler"] = self.profiler.snapshot()
        sections["resilience"] = res
        if self.telemetry is not None and self.telemetry.enabled:
            sections["telemetry"] = self.telemetry.snapshot()
        return flatten_metrics(sections)

    def metrics_text(self) -> str:
        """Prometheus-style text exposition of :meth:`metrics`."""
        return render_prometheus(self.metrics())

    def poll_events(self) -> list[dict]:
        """Drain and decode any ring events published since the last poll —
        the LIVE consumer path (mid-run), as opposed to the end-of-run
        ``write_trace`` export.  ``[]`` when telemetry is off."""
        if self.telemetry is None:
            return []
        return self.telemetry.poll_events()
