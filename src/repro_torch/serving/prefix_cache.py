"""Cross-request KV prefix cache with verified HOOK_EVICT eviction.

Serving traffic is dominated by shared prefixes — system prompts, few-shot
preambles, multi-turn histories.  This module keeps a CONTENT-ADDRESSED
index over KV blocks: prompts are chunked into token blocks, each chunk
keyed by a rolling hash of its contents chained through its predecessor
(so a chunk key commits to the entire prefix, not just its own tokens),
and each live entry owns one physical device block holding that chunk's
prefilled KV.

Admission (:meth:`PrefixCache.acquire`) walks the chain and returns the
longest cached prefix — whole blocks plus an optional partial tail — which
the engine maps READ-ONLY into the new sequence's page table
(``mm.map_shared``) and skips in prefill; only the uncached suffix runs
through the kernel.  A partial-tail share means the suffix prefill must
write into the shared block, so the engine breaks it first via
``mm.cow_break`` — the genuine copy-on-write path.  Entries are pinned
(refcounted) for the borrower's lifetime; insertion after a prefill COPIES
the new blocks into cache-owned storage (`mm.queue_block_copy` on the same
move list as migrations), so a donor finishing never invalidates the cache.

Eviction is a BPF decision, not a built-in heuristic: one batched
``HOOK_EVICT`` invocation per reclaim scan, each ctx row carrying the
entry's DAMON-style heat, refcount, age, hit count and size plus
cache-global budget/ghost state, each decision a TARGET TIER (demote cold
prefixes down the N-pool chain via ``mm.migrate_cache_block``) or
``EVICT_DROP``.  Entries are dropped ONLY when the program says so; with no
program attached a conservative LRU demote-then-drop default applies.  A
ghost FIFO of recently dropped keys measures over-eviction (the
Cache-is-King feedback signal surfaced to programs as CACHE_GHOST_HITS).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from ..core.context import (CTX, EVICT_DROP, FIXED_POINT, POLICY_DETACHED,
                            POLICY_FALLBACK, ctx_batch, fill_system_columns)
from ..core.hooks import HOOK_EVICT
from ..obs.ringbuf import EV_CACHE_HIT, EV_EVICT

_ROOT = b"prefix-root"


def chunk_keys(tokens, block_tokens: int) -> list[bytes]:
    """Rolling-hash chain over whole token blocks.

    Key ``i`` digests (key ``i-1``, tokens of block ``i``), so equal keys
    imply equal FULL prefixes up to that block boundary (modulo hash
    collision — entries also store their tokens and lookups verify them,
    so a collision costs a miss, never a wrong share)."""
    toks = np.asarray(tokens, np.int64)
    n = toks.size // block_tokens
    keys: list[bytes] = []
    prev = _ROOT
    for i in range(n):
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(toks[i * block_tokens:(i + 1) * block_tokens].tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


@dataclass
class CacheBlock:
    """One cache-owned physical block (tier-local coordinates)."""
    tier: int
    phys: int


@dataclass
class CacheEntry:
    key: bytes
    parent: bytes | None         # chain predecessor (None = first block)
    depth: int                   # logical block index within the prefix
    tokens: np.ndarray           # the block's tokens (collision guard)
    blk: CacheBlock
    eid: int                     # stable id for tracepoints
    refcount: int = 0
    hits: int = 0
    heat: float = 0.0            # EMA of forwarded attention mass
    last_hit_ns: int = 0
    created_ns: int = 0


@dataclass
class PrefixMatch:
    """A pinned admission-time match: release() exactly once."""
    pid: int
    entries: list[CacheEntry]
    tokens: int                  # shared token count (always <= prompt - 1)
    blocks: list[tuple[int, int]] = field(default_factory=list)
    cow_logical: int | None = None   # block the suffix will write into
    released: bool = False


class PrefixCache:
    """Content-addressed cross-request KV prefix cache.

    ``mm`` is the (possibly tiered) MemoryManager; physical blocks are
    allocated from its pools (``cache_alloc_block``) and live OUTSIDE any
    page table — borrowers reference them through ``shared=True`` mappings
    and compaction remaps arrive through the registered listener.
    """

    def __init__(self, mm, block_tokens: int, *, cap_blocks: int,
                 scan_period: int = 8, ghost_capacity: int = 1024,
                 doorkeeper: bool = True, door_capacity: int | None = None,
                 telemetry=None) -> None:
        self.mm = mm
        self.bt = int(block_tokens)
        self.cap_blocks = int(cap_blocks)
        self.scan_period = int(scan_period)
        self.telemetry = telemetry
        self.entries: dict[bytes, CacheEntry] = {}
        self.children: dict[bytes, set[bytes]] = {}
        self.ghost: OrderedDict[bytes, int] = OrderedDict()
        self.ghost_capacity = int(ghost_capacity)
        # TinyLFU-style doorkeeper: a chunk key must be SEEN once (or sit in
        # the ghost list — i.e. was cached before) before its block is
        # admitted.  One-hit-wonder prompts then cost two dict probes instead
        # of a device block copy each, and never churn the eviction scan.
        self.doorkeeper = bool(doorkeeper)
        self.door: OrderedDict[bytes, None] = OrderedDict()
        self.door_capacity = int(door_capacity if door_capacity is not None
                                 else max(4 * int(cap_blocks), 256))
        self.ntiers = len(getattr(mm, "pools", ())) or 1
        self._next_eid = 1
        self._ticks = 0
        self._last_scan = 0
        # stats (snapshot() exports)
        self.lookups = 0
        self.hits = 0                 # admissions that shared >= 1 block
        self.misses = 0
        self.ghost_hits = 0
        self.tokens_skipped = 0
        self.blocks_reused = 0
        self.inserted_blocks = 0
        self.door_rejects = 0
        self.evict_drops = 0
        self.evict_demotions = 0
        self.scans = 0
        mm.compaction_listeners.append(self._on_compaction)

    # ------------------------------------------------------------- accounting
    def _inc(self, name: str, v: int = 1) -> None:
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.inc(name, v)

    def used_blocks(self, tier: int = 0) -> int:
        return sum(1 for e in self.entries.values() if e.blk.tier == tier)

    def _on_compaction(self, tier: int, remap: dict) -> None:
        """Cache-owned blocks live in no page table, so the compaction pass
        can't repoint them — this listener does."""
        for e in self.entries.values():
            if e.blk.tier == tier and e.blk.phys in remap:
                e.blk.phys = remap[e.blk.phys]

    # ----------------------------------------------------------------- lookup
    def _walk(self, tokens) -> tuple[list[CacheEntry], bytes | None]:
        """Longest verified chain for ``tokens``; also the first missing
        key (ghost probe)."""
        toks = np.asarray(tokens, np.int64)
        chain: list[CacheEntry] = []
        for i, key in enumerate(chunk_keys(toks, self.bt)):
            e = self.entries.get(key)
            if e is None:
                return chain, key
            blk = toks[i * self.bt:(i + 1) * self.bt]
            if not np.array_equal(e.tokens, blk):      # hash collision
                return chain, None
            chain.append(e)
        return chain, None

    def acquire(self, pid: int, tokens) -> PrefixMatch | None:
        """Longest cached prefix for a prompt, pinned for the borrower.

        The shared span is capped at ``len(tokens) - 1``: at least one
        token ALWAYS prefills, so the admission logits come off the same
        suffix-prefill path every time (never a special full-coverage
        decode).  Whole matched blocks are borrowed as-is; when the next
        chain entry matches a partial tail, its block is borrowed too and
        ``cow_logical`` names it — the suffix prefill will write inside
        it, so the engine must copy-on-write it first.  Returns None on a
        complete miss (nothing pinned)."""
        self.lookups += 1
        toks = np.asarray(tokens, np.int64)
        L = int(toks.size)
        if L < 2 or not self.entries:
            if L >= 2:
                self._ghost_probe(toks)
            self.misses += 1
            self._inc("prefix_cache_misses")
            return None
        chain, missing = self._walk(toks)
        if missing is not None and missing in self.ghost:
            self.ghost_hits += 1
            self._inc("prefix_cache_ghost_hits")
            self.ghost.move_to_end(missing)
        whole = min(len(chain), (L - 1) // self.bt)
        shared = whole * self.bt
        cow = None
        entries = chain[:whole]
        # partial tail: the NEXT chain entry may cover a few more tokens
        if whole < len(chain):
            nxt = chain[whole]
            rem = L - shared
            p = 0
            lim = min(rem - 1, self.bt)
            while p < lim and nxt.tokens[p] == toks[shared + p]:
                p += 1
            if p > 0:
                entries = chain[:whole] + [nxt]
                shared += p
                cow = whole
        if shared == 0:
            self.misses += 1
            self._inc("prefix_cache_misses")
            return None
        now = self.mm.ktime_ns
        for e in entries:
            e.refcount += 1
            e.hits += 1
            e.last_hit_ns = now
        self.hits += 1
        self.tokens_skipped += shared
        self.blocks_reused += len(entries)
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.emit(EV_CACHE_HIT, pid, len(entries), shared, ts=now)
            tel.inc("prefix_cache_hits")
            tel.inc("prefix_tokens_skipped", shared)
        return PrefixMatch(pid=pid, entries=entries, tokens=shared,
                           blocks=[(e.blk.tier, e.blk.phys) for e in entries],
                           cow_logical=cow)

    def _ghost_probe(self, toks) -> None:
        keys = chunk_keys(toks, self.bt)
        if keys and keys[0] in self.ghost:
            self.ghost_hits += 1
            self._inc("prefix_cache_ghost_hits")
            self.ghost.move_to_end(keys[0])

    def release(self, match: PrefixMatch) -> None:
        """Unpin a borrower's chain (completion, preemption or failed
        admission)."""
        if match.released:
            return
        match.released = True
        for e in match.entries:
            e.refcount -= 1

    # ----------------------------------------------------------------- insert
    def _door_mark(self, key: bytes) -> None:
        door = self.door
        if key in door:
            door.move_to_end(key)
            return
        door[key] = None
        while len(door) > self.door_capacity:
            door.popitem(last=False)

    def insert(self, pid: int, tokens) -> int:
        """Cache the whole blocks of a freshly prefilled prompt.

        New entries get cache-owned HBM blocks and a queued device copy
        from the donor's pool blocks (flushed with the next move drain,
        before any kernel can overwrite the donor).  With the doorkeeper
        on (the default) an unseen chunk key is only NOTED on first sight
        and admitted when it shows up again (or was cached before — ghost
        hit): one-hit-wonder prompts never pay the copy or churn the scan.
        Insertion is opportunistic: when the pool can't supply a block the
        remaining chunks are skipped — never an OOM.  Returns blocks
        inserted."""
        toks = np.asarray(tokens, np.int64)
        n = toks.size // self.bt
        if n == 0:
            return 0
        table = self.mm.block_table(pid, n)
        keys = chunk_keys(toks, self.bt)
        inserted = 0
        parent: bytes | None = None
        now = self.mm.ktime_ns
        rejected = False            # chain invariant: once one chunk is
        for i, key in enumerate(keys):  # held at the door, descendants
            e = self.entries.get(key)   # have no parent to attach to
            if e is not None:
                parent = key
                continue
            if rejected or (self.doorkeeper and key not in self.door
                            and key not in self.ghost):
                self._door_mark(key)
                self.door_rejects += 1
                self._inc("prefix_cache_door_rejects")
                rejected = True
                continue
            if int(table[i]) < 0:       # unmapped (shouldn't happen post-
                break                   # prefill, but never trust a table)
            phys = self.mm.cache_alloc_block()
            if phys is None:
                break
            blk = CacheBlock(tier=0, phys=phys)
            self.mm.queue_block_copy(int(table[i]),
                                     self.mm.cache_device_index(0, phys))
            e = CacheEntry(key=key, parent=parent, depth=i,
                           tokens=toks[i * self.bt:(i + 1) * self.bt].copy(),
                           blk=blk, eid=self._next_eid, created_ns=now,
                           last_hit_ns=now)
            self._next_eid += 1
            self.entries[key] = e
            if parent is not None:
                self.children.setdefault(parent, set()).add(key)
            self.ghost.pop(key, None)
            self.door.pop(key, None)
            parent = key
            inserted += 1
        self.inserted_blocks += inserted
        if inserted:
            self._inc("prefix_cache_inserts", inserted)
        if self.used_blocks(0) > self.cap_blocks:
            self.scan()
        return inserted

    # ------------------------------------------------------------------- heat
    def note_heat(self, match: PrefixMatch, heat_rows) -> None:
        """Fold a borrower's per-logical-block attention mass into the
        matched entries' heat EMAs.  The engine calls this per decode step
        — entry ``i`` of the chain backs logical block ``i``, so the
        mapping is positional."""
        h = np.asarray(heat_rows, np.float64)
        for i, e in enumerate(match.entries):
            if i >= h.size:
                break
            e.heat = 0.5 * e.heat + float(h[i])

    # ---------------------------------------------------------------- faults
    def tick(self) -> None:
        """Reclaim cadence, driven from the engine's mm-tick.  Scans fire
        only over the HBM budget — every shipped program (and the kernel
        default) keeps entries while ``used <= cap``, so an under-budget
        scan is a guaranteed no-op whose batched dispatch would tax every
        serving step for nothing.  ``scan_period`` rate-limits the
        over-budget case (pinned entries can hold the pool over budget for
        many ticks; re-scanning every step won't free them any sooner)."""
        self._ticks += 1
        if self.used_blocks(0) > self.cap_blocks and \
                self._ticks - self._last_scan >= self.scan_period:
            self.scan()

    # --------------------------------------------------------------- eviction
    def _build_evict_ctx(self, cands: list[CacheEntry]) -> np.ndarray:
        mat = ctx_batch(len(cands))
        cols = self.mm.system_ctx_columns()
        fill_system_columns(mat, **cols,
                            cache_ghost_hits=self.ghost_hits,
                            cache_entries=len(self.entries),
                            cache_cap_blocks=self.cap_blocks,
                            cache_used_blocks=self.used_blocks(0))
        if not cols.get("ntiers"):
            # the untiered snapshot leaves NTIERS 0; evict programs need the
            # live chain length to detect "past the end" (drop)
            mat[:, CTX.NTIERS] = self.ntiers
        now = self.mm.ktime_ns
        tick_ns = 1_000_000
        for row, e in enumerate(cands):
            mat[row, CTX.ADDR] = e.eid
            mat[row, CTX.PAGE_TIER] = e.blk.tier
            mat[row, CTX.PAGE_ORDER] = 0
            mat[row, CTX.PAGE_AGE] = max(0, (now - e.last_hit_ns) // tick_ns)
            mat[row, CTX.PAGE_HEAT] = int(min(e.heat, 1 << 40) * FIXED_POINT)
            mat[row, CTX.CACHE_REFCOUNT] = e.refcount
            mat[row, CTX.CACHE_HITS] = e.hits
            mat[row, CTX.CACHE_BLOCKS] = 1
        return mat

    def scan(self, need_blocks: int = 0) -> int:
        """One eviction pass: ONE batched HOOK_EVICT invocation over every
        entry, decisions applied to unpinned entries (demote via the tier
        chain, drop only on EVICT_DROP).  With no program attached, a
        conservative LRU default demotes (dropping only when there is
        nowhere left to demote to) until the budget and ``need_blocks``
        are satisfied.  Returns HBM base blocks freed."""
        self._last_scan = self._ticks
        if not self.entries:
            return 0
        self.scans += 1
        self._inc("prefix_cache_scans")
        cands = sorted(self.entries.values(), key=lambda e: e.eid)
        decisions = None
        if self.mm.hooks.attached(HOOK_EVICT):
            mat = self._build_evict_ctx(cands)
            decisions = self.mm.hooks.run_batch(HOOK_EVICT, mat)
            self._tally_decisions(cands, decisions)
        freed = 0
        if decisions is not None:
            dropped: set[bytes] = set()
            for e, d in zip(cands, np.asarray(decisions)):
                if e.refcount > 0 or e.key in dropped:
                    continue
                d = int(d)
                if d in (POLICY_FALLBACK, POLICY_DETACHED):
                    d = self._default_decision(e, need_blocks - freed)
                if d >= EVICT_DROP:
                    freed += self._drop(e, dropped)
                else:
                    freed += self._demote(e, min(max(d, 0), self.ntiers - 1))
            return freed
        # kernel-default policy: LRU demote-then-drop, only under pressure
        over = self.used_blocks(0) - self.cap_blocks
        target = max(over, need_blocks)
        if target <= 0:
            return 0
        dropped = set()
        for e in sorted(self.entries.values(), key=lambda e: e.last_hit_ns):
            if freed >= target:
                break
            if e.refcount > 0 or e.key in dropped:
                continue
            d = self._default_decision(e, target - freed)
            if d >= EVICT_DROP:
                freed += self._drop(e, dropped)
            else:
                freed += self._demote(e, d)
        return freed

    def _tally_decisions(self, cands: list[CacheEntry], decisions) -> None:
        """Telemetry tally of the raw HOOK_EVICT verdicts of one scan —
        keep / demote / drop / fallback counters for the Prometheus export
        (tallied before pinning filters what actually gets applied)."""
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return
        d = np.asarray(decisions)
        tiers = np.fromiter((e.blk.tier for e in cands), np.int64, len(cands))
        acted = (d >= 0) & (d < EVICT_DROP)
        tel.inc("evict_decision_fallback", int(np.sum(d < 0)))
        tel.inc("evict_decision_drop", int(np.sum(d >= EVICT_DROP)))
        tel.inc("evict_decision_keep", int(np.sum(acted & (d == tiers))))
        tel.inc("evict_decision_demote", int(np.sum(acted & (d != tiers))))

    def _default_decision(self, e: CacheEntry, still_needed: int) -> int:
        """The no-program policy for one entry: demote one tier when the
        chain has room, drop only off the end — and only under pressure."""
        if still_needed <= 0 and self.used_blocks(0) <= self.cap_blocks:
            return e.blk.tier
        nxt = e.blk.tier + 1
        return nxt if nxt < self.ntiers else EVICT_DROP

    def _demote(self, e: CacheEntry, dst: int) -> int:
        if dst == e.blk.tier:
            return 0
        was_hbm = e.blk.tier == 0
        if not self.mm.migrate_cache_block(e.blk, dst):
            return 0
        self.evict_demotions += 1
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.emit(EV_EVICT, e.eid, 1, e.blk.tier, ts=self.mm.ktime_ns)
            tel.inc("prefix_cache_demotions")
        return 1 if was_hbm and e.blk.tier != 0 else 0

    def _drop(self, e: CacheEntry, dropped: set) -> int:
        """Drop an entry AND its cached descendants (a chain with a missing
        link is unreachable).  Chain pinning — borrowers pin every entry on
        their path — guarantees an unpinned entry has only unpinned
        descendants."""
        freed = 0
        stack = [e.key]
        tel = self.telemetry
        while stack:
            key = stack.pop()
            ent = self.entries.pop(key, None)
            if ent is None or key in dropped:
                continue
            dropped.add(key)
            stack.extend(self.children.pop(key, ()))
            self.mm.cache_free_block(ent.blk.tier, ent.blk.phys)
            if ent.blk.tier == 0:
                freed += 1
            if ent.parent is not None and ent.parent in self.children:
                self.children[ent.parent].discard(key)
            self.ghost[key] = self.mm.ktime_ns
            self.evict_drops += 1
            if tel is not None and tel.enabled:
                tel.emit(EV_EVICT, ent.eid, 1, ent.blk.tier | (1 << 8),
                         ts=self.mm.ktime_ns)
                tel.inc("prefix_cache_drops")
        while len(self.ghost) > self.ghost_capacity:
            self.ghost.popitem(last=False)
        return freed

    # ---------------------------------------------------------------- exports
    def snapshot(self) -> dict:
        per_tier = {}
        for e in self.entries.values():
            per_tier[e.blk.tier] = per_tier.get(e.blk.tier, 0) + 1
        return {
            "entries": len(self.entries),
            "cap_blocks": self.cap_blocks,
            "used_hbm_blocks": self.used_blocks(0),
            "tier_blocks": {f"t{t}": n for t, n in sorted(per_tier.items())},
            "lookups": self.lookups,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate_milli": (self.hits * 1000) // max(1, self.lookups),
            "ghost_hits": self.ghost_hits,
            "tokens_skipped": self.tokens_skipped,
            "blocks_reused": self.blocks_reused,
            "inserted_blocks": self.inserted_blocks,
            "door_rejects": self.door_rejects,
            "evict_drops": self.evict_drops,
            "evict_demotions": self.evict_demotions,
            "scans": self.scans,
        }
