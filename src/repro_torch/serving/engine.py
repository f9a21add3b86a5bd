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
program, as in the reference (the names' catalog: :mod:`..core.plane`).
``profile="auto"`` starts with no profile and lets the online profiler
(``HOOK_PROFILE`` + ``ProfileSynthesizer``) synthesize and hot-reload one;
``telemetry``/``trace`` attach the telemetry hub and the Chrome-trace
spans; ``chaos`` arms the seeded failure injector.  All default to off,
where each site costs one ``is None`` check.

Spans (``trace=True``; Chrome trace by :meth:`ServingEngine.write_trace`),
by category: ``engine`` — ``step N``, ``decode``, ``mm-tick``, ``prefill
rid=N`` (the reference's spans); ``request`` — ``req N``, submit to last
token; ``phase`` — the host's work inside them: ``admit`` (one per step's
admission pass) with ``prefix`` (cache lookup and mapping, and the insert
after the prefill), ``fault-range`` (the prompt's faults and a CoW break)
and ``moves``; in each prefill ``tables``, ``graph`` (the entry's host
wall), ``access``, ``sample``; in ``decode`` ``faults``, ``moves``,
``tables``, ``graph``, ``sample``, ``access``; ``moves`` again in
``mm-tick``; ``wait`` — ``queue rid=N``, from a request's submit (or its
requeue after a preemption) to the start of its prefill; ``device`` — the
device's own time on the same clock (``dev decode``, ``dev prefill``,
``dev copy`` per block-copy launch, ``dev policy`` per policy batch;
:meth:`~repro_torch.obs.Telemetry.device_span`); ``setup`` — each graph
capture (``capture``, ``capture-warm``, ``capture-graph``).

Departure from the JAX engine: the KV pools and the persistent block-table
buffer are updated IN PLACE on the device (JAX threads them functionally
through its jitted entries).  The compiled entries are CUDA graphs
(:mod:`repro_torch.serving.compiled`): the decode entry one graph per
engine (:class:`~repro_torch.serving.compiled.DecodeGraph`), captured at
construction and replayed every step; the prefill entries
(:class:`~repro_torch.serving.compiled.PrefillGraphs`) one graph per
padded block count for a full prefill and one per (suffix blocks,
key_blocks) for a prefix-cache hit, each captured the first time its shape
is admitted and replayed after.  The table's dirty rows are installed
eagerly before a replay.  On the CPU the same objects run the entries
eagerly.  To run the entries eagerly on the card (for a comparison), build
the engine with ``engine.DecodeGraph`` / ``engine.PrefillGraphs`` patched
to a subclass whose ``_capture`` captures nothing (returns None).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import FaultKind, HWSpec, MMOutOfMemory, Profile, make_cost_model
from ..core.buddy import order_blocks
from ..core.plane import build_plane
from ..kernels.block_copy.ops import block_copy, pool_pointers
from ..models.common import BF16
from ..models.decode import PagedLayout, cache_init, pool_leaves
from ..obs import (Telemetry, flatten_metrics, render_prometheus,
                   write_chrome_trace)
from ..obs.ringbuf import EV_PREEMPT
from ..obs.telemetry import NO_SPAN
from ..resilience import FailureInjector
from .compiled import DecodeGraph, PrefillGraphs
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
        # stub modality inputs (Whisper frames, VLM patches), drawn once
        self._modal: dict[str, torch.Tensor] = {}
        hw = hw or HWSpec()

        n_attn = sum(1 for k in cfg.layer_kinds() if k == "a")
        if cfg.mla is not None:           # the latent slab of one token
            slab = cfg.mla.kv_lora + cfg.mla.qk_rope
        else:
            slab = cfg.kv_heads * cfg.head_dim * 2
        cost = make_cost_model(hw, kv_heads=1, head_dim=1,
                               block_tokens=layout.block_tokens)
        cost.block_bytes = layout.block_tokens * slab * 2 * max(1, n_attn)

        # the memory-management plane: the manager, its programs and warm
        # hooks, the online profiler and khugepaged (core.plane)
        self.mm, self.profiler, self.khugepaged = build_plane(
            layout.num_blocks, cost, hw, policy=policy, profile=profile,
            profile_period=profile_period, tier_blocks=self.tier_blocks,
            tier_policy=tier_policy, khugepaged=khugepaged, seed=seed,
            batch_faults=batch_faults, max_batch=max_batch,
            telemetry=self.telemetry, injector=self.injector,
            containment=self.containment, device=self.device)
        self._pool_blocks = layout.num_blocks + sum(self.tier_blocks)
        # the fault route, chosen once: a prefill span's faults (the batched
        # route resolves the span through ONE policy invocation, bulk
        # FaultKind.PREFILL placement hints) and a decode step's fault pass
        if batch_faults:
            self._fault_span = self.mm.fault_range
            self._fault_slots = self._fault_slots_batched
        else:
            self._fault_span = self.mm.ensure_range
            self._fault_slots = self._fault_slots_scalar

        # Cross-request KV prefix cache: content-addressed shared prefix
        # blocks, admission via read-only borrows + CoW, HOOK_EVICT-driven
        # eviction into the tier chain.  prefix_cache=True sizes the budget
        # at a quarter of HBM; an int is an explicit cap in blocks.
        self.prefix_cache: PrefixCache | None = None
        if prefix_cache:
            bad = [k for k in cfg.layer_kinds() if k != "a"]
            if bad or cfg.enc_dec or cfg.vlm_patches \
                    or cfg.attn.mrope_sections is not None:
                raise ValueError(
                    "prefix_cache requires a plain all-attention decoder "
                    "(sequential state — mamba/enc-dec/vlm — cannot skip "
                    "prefix compute)")
            cap = (int(prefix_cache) if not isinstance(prefix_cache, bool)
                   else max(1, layout.num_blocks // 4))
            self.prefix_cache = PrefixCache(self.mm, layout.block_tokens,
                                            cap_blocks=cap,
                                            telemetry=self.telemetry,
                                            evict_policy=evict_policy)
        self.evict_policy = evict_policy if self.prefix_cache else None

        pool_layout = layout if not tiered else PagedLayout(
            num_blocks=self._pool_blocks, block_tokens=layout.block_tokens,
            max_blocks=layout.max_blocks)
        self.cache = cache_init(cfg, pool_layout, max_batch, cache_dtype,
                                device=self.device)
        self._pool_leaves = pool_leaves(self.cache)
        # the pools (HBM and every spill tier, one combined index space)
        # live as long as the engine: one pointer table for the block-copy
        # kernel, built once (none for a model with no paged pool)
        self._pool_ptrs = (pool_pointers(self._pool_leaves)
                           if self.device.type == "cuda" and self._pool_leaves
                           else None)
        self.sampler = Sampler(seed=seed)
        self.stats = EngineStats()

        self.waiting: list[Request] = []
        self.active: dict[int, SeqState] = {}    # slot -> seq
        self._next_pid = 1
        self.finished: dict[int, list[int]] = {}
        # rid -> [trace-clock t0, wall t0 or None once TTFT was observed]:
        # per-request serving-latency bookkeeping (telemetry only)
        self._req_t0: dict[int, list] = {}
        # rid -> trace-clock time it (re)entered the waiting queue (trace
        # only): the start of its ``queue rid=N`` span
        self._queued: dict[int, int] = {}
        # per-app aggregate per-logical-block heat — the DAMON trace used by
        # offline profiling (profile_from_heat)
        self.heat_histograms: dict[str, np.ndarray] = {}

        # Device-resident block table: a persistent [B, max_blocks] buffer
        # on the device; the host ships only dirty rows (version-tracked in
        # DeviceBlockTables) and installs them in place before each kernel.
        self._tables = DeviceBlockTables(max_batch, layout.max_blocks)
        self._table_buf = torch.full((max_batch, layout.max_blocks), -1,
                                     dtype=torch.int32, device=self.device)
        # The decode entry (the reference's jax.jit(_decode_entry)): on
        # CUDA one graph, captured here and replayed every decode step; it
        # reads the params, the cache and the table above by address.
        self._decode = DecodeGraph(cfg, params, self.cache, self._table_buf,
                                   layout, telemetry=self.telemetry)
        # The prefill entries (jax.jit(_prefill_entry) and
        # jax.jit(_prefill_sfx_entry)): on CUDA one graph per padded
        # shape, captured at its first admission.
        self._prefill = PrefillGraphs(cfg, params, self.cache,
                                      self._table_buf, layout,
                                      self._modality_kwargs,
                                      telemetry=self.telemetry)

    # ----------------------------------------------------------------- admin
    def _span(self, name: str, key=None, *, cat: str = "engine",
              tid: str = "engine"):
        """A host span ``name`` (``name`` followed by ``key`` when given:
        formatted only under tracing), or the shared no-op context."""
        tel = self.telemetry
        if tel is None or not tel.trace_enabled:
            return NO_SPAN
        return tel.span(name if key is None else f"{name}{key}", cat=cat,
                        tid=tid)

    def _phase(self, name: str, tid: str = "engine"):
        return self._span(name, cat="phase", tid=tid)

    def submit(self, req: Request) -> None:
        tel = self.telemetry
        if tel is not None and tel.enabled:
            if req.rid not in self._req_t0:
                self._req_t0[req.rid] = [tel.now(), time.perf_counter_ns()]
            if tel.trace_enabled:
                self._queued[req.rid] = tel.now()
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
            match, n_shared = None, 0
            if self.prefix_cache is not None:
                with self._phase("prefix"):
                    match = self.prefix_cache.acquire(pid, req.prompt)
                    if match is not None:
                        self.mm.map_shared(pid, 0, match.blocks)
                        n_shared = len(match.blocks)
            with self._phase("fault-range"):
                ok = self._ensure_with_reclaim(
                    lambda p=pid, s=n_shared, n=nblocks:
                    self._fault_span(p, s, n),
                    pid, nblocks - n_shared, allow_preempt=False)
                if ok and match is not None and \
                        match.cow_logical is not None:
                    # the suffix prefill writes INSIDE the last borrowed
                    # block — break the share first (private copy rides the
                    # move list)
                    ok = self._ensure_with_reclaim(
                        lambda p=pid, a=match.cow_logical:
                        self.mm.cow_break(p, a),
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
            tel = self.telemetry
            if tel is not None and tel.trace_enabled:
                q0 = self._queued.pop(req.rid, None)
                if q0 is not None:
                    tel.spans.append((f"queue rid={req.rid}", "wait",
                                      "queue", q0, tel.now() - q0))
            with self._span("prefill rid=", req.rid):
                self._run_prefill(seq)
            rec = self._req_t0.get(req.rid)
            if tel is not None and rec is not None and rec[1] is not None:
                # the prefill above sampled the request's first token
                tel.observe_ttft(time.perf_counter_ns() - rec[1])
                rec[1] = None
            if self.prefix_cache is not None:
                # cache every whole block of the freshly prefilled prompt
                # (copies ride the next move-list drain, before any kernel
                # can touch the donor)
                with self._phase("prefix"):
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
        """One admission's prefill and first token.  The new pid's row
        arrives as a dirty-row upload; the entry reads the slot's row of
        the persistent buffer, and writes the per-slot state (mamba,
        cross-attention K/V) into the slot; the pools are shared.  A
        prefix-cache hit's first ``match.tokens`` tokens' KV is already
        in the pool (shared mappings + a CoW-broken tail), so only the
        suffix runs through the kernel, attending over the full-length key
        stream (pool-gathered prefix + computed suffix) with the SAME
        padded key length as the full prefill — what keeps its outputs
        equal to the full path's suffix rows."""
        prompt = np.asarray(seq.req.prompt, np.int32)
        match = seq.prefix
        S0 = match.tokens if match is not None else 0
        with self._phase("tables"):
            self._sync_tables(self._slot_pids())
        with self._phase("graph"):
            logits = (self._prefill.suffix(prompt, seq.slot, S0) if S0 > 0
                      else self._prefill.full(prompt, seq.slot))
        with self._phase("access"):
            self.mm.record_access(seq.pid,
                                  np.ones(self._blocks_needed(len(prompt))))
        self.stats.prefill_tokens += len(prompt) - S0
        with self._phase("sample"):
            tok = self.sampler.sample(logits, self.cfg.vocab,
                                      seq.req.temperature)
            seq.generated.append(int(tok))

    def _modality_kwargs(self, seq_len: int) -> dict:
        """Synthetic modality inputs of a one-sequence prefill of
        ``seq_len`` padded tokens: Whisper's audio frames, a VLM's vision
        patches and M-RoPE positions.

        They are the reference's: one ``np.random.default_rng(0)`` stream
        made once, frames ``[1, enc_frames, d_model]`` drawn first, then
        patches ``[1, vlm_patches, d_model]``, sliced per call, so both
        packages feed the same inputs; the three position streams are all
        the token index, as in the reference."""
        cfg = self.cfg
        if not (cfg.enc_dec or cfg.vlm_patches):
            return {}
        dev = self.device
        if not self._modal:
            rng = np.random.default_rng(0)
            for name, n in (("frames", cfg.enc_frames if cfg.enc_dec else 0),
                            ("patches", cfg.vlm_patches)):
                if n:
                    self._modal[name] = torch.from_numpy(rng.normal(
                        size=(1, n, cfg.d_model)).astype(np.float32)).to(dev)
        kw = {}
        if cfg.enc_dec:
            kw["frames"] = self._modal["frames"]
        if cfg.vlm_patches:
            P = min(cfg.vlm_patches, seq_len)
            kw["patches"] = self._modal["patches"][:, :P]
            kw["pos3d"] = torch.arange(seq_len, device=dev).expand(3, 1,
                                                                   seq_len)
        return kw

    # ---------------------------------------------------------------- reclaim
    def _ensure_with_reclaim(self, fault_fn, faulting_pid: int,
                             need_blocks: int, *,
                             allow_preempt: bool = True) -> bool:
        """Run a fault entry point, relieving pressure on MMOutOfMemory.

        The relief ladder (:meth:`_relieve`) is retried as long as it makes
        progress; whole-sequence preemption is the fallback and fires AT
        MOST ONCE per fault.  Admission passes ``allow_preempt=False`` (the
        waiting-queue watermark): a request that does not fit waits for
        completions instead of evicting the running batch."""
        preempted = False
        for _ in range(4 + 2 * need_blocks + self.max_batch):
            try:
                fault_fn()
                return True
            except MMOutOfMemory as oom:
                if self._relieve(oom, need_blocks):
                    continue
                if not allow_preempt or preempted or oom.victim_pid is None:
                    return False
                self._preempt(oom.victim_pid)
                preempted = True
        return False

    def _relieve(self, oom: MMOutOfMemory, need: int) -> bool:
        """The relief ladder's non-preempting rungs, cheapest first: the
        prefix cache's eviction scan (unpinned entries evicted or demoted),
        then demotion of cold blocks down the tier chain (every process,
        coldest first, the nominated victim's pages preferred; nothing on
        an untiered pool).  True when a rung freed something, so the fault
        is worth retrying."""
        if self.prefix_cache is not None and \
                self.prefix_cache.scan(max(1, need)) > 0:
            return True
        if self.mm.demote_cold_global(need, prefer_pid=oom.victim_pid) > 0:
            self.stats.tier_reliefs += 1
            return True
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
                    if tel.trace_enabled:
                        self._queued[seq.req.rid] = tel.now()
                return
        self.mm.evict_process(victim_pid)

    def step(self) -> bool:
        """One engine iteration. Returns False when all work is done."""
        t0 = time.monotonic()
        tel = self.telemetry
        with self._span("step ", self.stats.steps):
            with self._phase("admit"):
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
                # background promotion: bring re-heated spill-tier pages
                # back (nothing on an untiered pool)
                self.mm.promotion_scan()
                if self.prefix_cache is not None:
                    # periodic eviction cadence (batched HOOK_EVICT scan)
                    self.prefix_cache.tick()
                self._apply_pending_moves(tid="mm")
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
        step runs exactly ONE policy invocation.  OOM relief: the ladder
        (:meth:`_relieve`), retried while it makes progress, then
        preemption, at most once on a tiered pool, as often as the loop
        allows on an untiered one.  Returns the slots whose block is mapped
        (safe to decode)."""
        bt = self.layout.block_tokens
        tiered = self.mm.ntiers > 1
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
                if self._relieve(oom, 1):
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
        tiered = self.mm.ntiers > 1
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
            # untiered: preemption with no prefix-cache rung, as the
            # reference's scalar route does (the parity tests hold it)
            try:
                self.mm.ensure_mapped(seq.pid, addr)
                ok.add(slot)
            except MMOutOfMemory as oom:
                self._preempt(oom.victim_pid)
        # drop slots preempted while relieving a later slot's fault
        ok = {s for s in ok if s in self.active}
        if ok:
            # decode-time tier placement: consult HOOK_TIER for the blocks
            # this step just installed, mirroring the batched route (where
            # fault_batch runs the first-touch placement pass itself); a
            # no-op on an untiered pool
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
        with self._phase("faults"):
            ok_slots = self._fault_slots()
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
        with self._phase("tables"):
            active = self._sync_tables(slot_pids)
        with self._phase("graph"):
            logits_np, heat_np = self._decode(tokens, lengths, active)
        # a skipped slot had no block table this step: its row's logits are
        # garbage; the sequence stays put and refaults next step.  Two
        # passes over the same rows in the same order: the sampler touches
        # no MM state, so every call keeps its order among its kind
        rows = [(slot, seq) for slot, seq in self.active.items()
                if slot not in skipped]
        with self._phase("sample"):
            for slot, seq in rows:
                tok = self.sampler.sample(logits_np[slot], self.cfg.vocab,
                                          seq.req.temperature)
                seq.generated.append(int(tok))
        with self._phase("access"):
            self._account_rows(rows, heat_np)

    def _account_rows(self, rows, heat_np) -> None:
        """After a decode step's sampling: each row's heat to the MM
        plane, its length, and its end when it reached its limit."""
        for slot, seq in rows:
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

    def _apply_pending_moves(self, tid: str = "engine") -> None:
        with self._phase("moves", tid):
            moves = self.mm.drain_moves()
            for batch in (split_move_batches(moves) if moves else ()):
                self._apply_move_batch(batch)

    def _apply_move_batch(self, moves: list[tuple[int, int, int]]) -> None:
        src = np.concatenate([np.arange(s, s + order_blocks(o))
                              for s, _, o in moves]).astype(np.int32)
        dst = np.concatenate([np.arange(d, d + order_blocks(o))
                              for _, d, o in moves]).astype(np.int32)
        # one launch moves the rows of every pool leaf (K and V, all layers)
        tel = self.telemetry
        with (tel.device_span("dev copy", self.device)
              if tel is not None and tel.trace_enabled else NO_SPAN):
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
        if self.mm.ntiers > 1:
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
        if self.mm.ntiers > 1:
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
