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

Policies (``policy=``): "ebpf" (profile + Figure-1 program), "thp"
(kernel-default greedy PMD-size) and "never" (base pages).  Faults take the
scalar route — one policy invocation per fault, the reference's
``batch_faults=False``.  The other reference options and policies raise
``NotImplementedError`` naming their ROADMAP item.

Departure from the JAX engine: the KV pools and the persistent block-table
buffer are updated IN PLACE on the device (JAX threads them functionally
through its jitted entries).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import (MAX_PROFILE_REGIONS, HWSpec, Khugepaged, KhugepagedConfig,
                    MemoryManager, MMOutOfMemory, Profile, ebpf_mm_program,
                    make_cost_model, reclaim_lru_program)
from ..core.buddy import order_blocks
from ..kernels.block_copy.ops import block_copy, pool_pointers
from ..models.common import BF16
from ..models.decode import (PagedLayout, cache_init, decode_step,
                             pool_leaves, prefill_step)
from .sampler import Sampler
from .tables import DeviceBlockTables

Pytree = Any

# reference option -> (value that keeps the ported path, ROADMAP item)
_NOT_PORTED = {
    "batch_faults": (False, "5 (batched policy executor)"),
    "host_blocks": (0, "6 (tiering)"),
    "tier_blocks": (None, "6 (tiering)"),
    "tier_policy": ("ebpf-tier", "6 (tiering)"),
    "prefix_cache": (False, "7 (prefix cache)"),
    "evict_policy": ("lru-evict", "7 (prefix cache)"),
    "telemetry": (None, "8 (observability)"),
    "trace": (False, "8 (observability)"),
    "chaos": (None, "9 (resilience)"),
    "chaos_rate": (0.02, "9 (resilience)"),
    "containment": (True, "9 (resilience)"),
    "profile_period": (4, "10 (online profiling)"),
}


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


@dataclass
class EngineStats:
    steps: int = 0
    prefills: int = 0
    prefill_tokens: int = 0        # tokens actually run through the kernel
    decode_tokens: int = 0
    preemptions: int = 0
    tier_reliefs: int = 0          # OOMs resolved by demotion (tiering: 0)
    wall_host_s: float = 0.0
    completed: int = 0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: Pytree, layout: PagedLayout,
                 *, max_batch: int = 4, policy: str = "ebpf",
                 profile: "Profile | list | None" = None,
                 hw: HWSpec | None = None, khugepaged: bool = True,
                 seed: int = 0, cache_dtype=BF16, device=None,
                 **reference_options):
        for name, value in reference_options.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected keyword argument {name!r}")
            keep, item = _NOT_PORTED[name]
            if value != keep:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet: ROADMAP "
                    f"'Modules still to port' item {item}")
        if isinstance(profile, str):
            raise NotImplementedError(
                f"profile={profile!r} is not ported yet: ROADMAP 'Modules "
                f"still to port' item 10 (online profiling)")
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
        hw = hw or HWSpec()

        n_attn = sum(1 for k in cfg.layer_kinds() if k == "a")
        slab = cfg.kv_heads * cfg.head_dim * 2
        cost = make_cost_model(hw, kv_heads=1, head_dim=1,
                               block_tokens=layout.block_tokens)
        cost.block_bytes = layout.block_tokens * slab * 2 * max(1, n_attn)

        if policy in ("thp-prog", "never-prog"):
            raise NotImplementedError(
                f"policy={policy!r} is not ported yet: ROADMAP 'Modules "
                f"still to port' item 5 (batched policy executor)")
        default_mode = "never" if policy == "never" else "thp"
        self.mm = MemoryManager(layout.num_blocks, cost,
                                default_mode=default_mode, damon_seed=seed)
        self.mm.attach_reclaim_program(reclaim_lru_program())
        if policy == "ebpf":
            if profile is None:
                raise ValueError("policy='ebpf' needs a profile (or list)")
            profiles = profile if isinstance(profile, (list, tuple)) \
                else [profile]
            for prof in profiles:
                self.mm.load_profile(prof)
            # One program serves every app via the indirect profile-map
            # load; its verified search loop is right-sized to the profiles
            # loaded (rounded up to a power of two), as the reference does.
            nreg = max((len(p.regions) for p in profiles), default=0)
            bound = min(max(8, 1 << max(0, nreg - 1).bit_length()),
                        MAX_PROFILE_REGIONS)
            self.mm.attach_fault_program(ebpf_mm_program(max_regions=bound))
        elif policy not in ("thp", "never"):
            raise ValueError(f"unknown policy {policy!r}")

        self.khugepaged = (Khugepaged(self.mm, KhugepagedConfig())
                           if (khugepaged and policy == "ebpf") else None)
        self.cache = cache_init(cfg, layout, max_batch, cache_dtype,
                                device=self.device)
        self._pool_leaves = pool_leaves(self.cache)
        # the pools live as long as the engine: one pointer table for the
        # block-copy kernel, built once
        self._pool_ptrs = (pool_pointers(self._pool_leaves)
                           if self.device.type == "cuda" else None)
        self.sampler = Sampler(seed=seed)
        self.stats = EngineStats()

        self.waiting: list[Request] = []
        self.active: dict[int, SeqState] = {}    # slot -> seq
        self._next_pid = 1
        self.finished: dict[int, list[int]] = {}
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
    def submit(self, req: Request) -> None:
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
            self.mm.create_process(pid, app=req.app, vma_blocks=vma_blocks)
            nblocks = self._blocks_needed(len(req.prompt))
            ok = self._ensure_with_reclaim(
                lambda p=pid, n=nblocks: self.mm.ensure_range(p, 0, n),
                pid, nblocks, allow_preempt=False)
            if not ok:
                self.mm.free_process(pid)
                self.waiting.insert(0, req)
                break
            # land any compaction copies before prefill writes the pool
            # (same pre-kernel ordering as the decode path)
            self._apply_pending_moves()
            seq = SeqState(req=req, pid=pid, slot=slot,
                           length=len(req.prompt))
            self.active[slot] = seq
            self._run_prefill(seq)
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

    # ---------------------------------------------------------------- reclaim
    def _ensure_with_reclaim(self, fault_fn, faulting_pid: int,
                             need_blocks: int, *,
                             allow_preempt: bool = True) -> bool:
        """Run a fault entry point, preempting on MMOutOfMemory at most once
        per fault.  Admission passes ``allow_preempt=False`` (the
        waiting-queue watermark): a request that does not fit waits for
        completions instead of evicting the running batch."""
        preempted = False
        for _ in range(4 + 2 * need_blocks + self.max_batch):
            try:
                fault_fn()
                return True
            except MMOutOfMemory as oom:
                if not allow_preempt or preempted or oom.victim_pid is None:
                    return False
                self._preempt(oom.victim_pid)
                preempted = True
        return False

    # ---------------------------------------------------------------- decode
    def _preempt(self, victim_pid: int | None) -> None:
        if victim_pid is None:
            raise MMOutOfMemory("pool exhausted and nothing to evict")
        for slot, seq in list(self.active.items()):
            if seq.pid == victim_pid:
                self.mm.evict_process(victim_pid)
                del self.active[slot]
                self.waiting.insert(0, seq.req)   # recompute-from-scratch
                self.stats.preemptions += 1
                return
        self.mm.evict_process(victim_pid)

    def step(self) -> bool:
        """One engine iteration. Returns False when all work is done."""
        t0 = time.monotonic()
        self._admit()
        if not self.active and not self.waiting:
            return False
        if self.active:
            self._decode_once()
        if self.khugepaged is not None:
            self.khugepaged.tick()
        self._apply_pending_moves()
        self.mm.tick()
        self.stats.steps += 1
        self.stats.wall_host_s += time.monotonic() - t0
        return bool(self.active or self.waiting)

    def _fault_slots_scalar(self) -> set[int]:
        """One ``ensure_mapped`` (one ctx build, one policy invocation) per
        faulting slot.  Returns the slots whose block is mapped."""
        ok: set[int] = set()
        for slot, seq in list(self.active.items()):
            if slot not in self.active:       # preempted earlier this pass
                continue
            addr = seq.length // self.layout.block_tokens
            try:
                self.mm.ensure_mapped(seq.pid, addr)
                ok.add(slot)
            except MMOutOfMemory as oom:
                self._preempt(oom.victim_pid)
        # drop slots preempted while relieving a later slot's fault
        return {s for s in ok if s in self.active}

    def _decode_once(self) -> None:
        B = self.max_batch
        tokens = np.zeros(B, np.int32)
        lengths = np.zeros(B, np.int32)
        ok_slots = self._fault_slots_scalar()
        # Flush compaction/collapse copies BEFORE the kernel touches the pool
        # and BEFORE syncing the device table: a fault above may have freed
        # and re-allocated a block, and a compaction remap bumps
        # table_version so the sync below re-uploads the moved rows.
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
                self.mm.free_process(seq.pid)
                del self.active[slot]
                self.stats.completed += 1

    def _apply_pending_moves(self) -> None:
        moves = self.mm.drain_moves()
        if not moves:
            return
        # The copies of one batch run concurrently and in place, so a chain
        # within one drain (compact A->B, then move B->C) would copy stale
        # data, and a repeated destination (block freed and re-allocated
        # within the drain) makes the winner undefined.  Segment the list so
        # no batch reads OR writes a block an earlier move in the same batch
        # wrote; batches apply in order.  The reference's scatter reads every
        # source before it writes, so it stops there; concurrent in-place
        # copies also race when a move WRITES a block an earlier move of the
        # batch READS (two collapses in one drain: the second's new page can
        # reuse blocks the first one just freed), so that case splits too.
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
        for batch in batches:
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
        if self.khugepaged is not None:
            out["khugepaged"] = {"collapsed": self.khugepaged.collapsed,
                                 "considered": self.khugepaged.considered}
        return out
