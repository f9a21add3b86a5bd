"""DAMON-analogue: data-access monitoring with controlled overhead.

The paper profiles workloads with DAMON to find hot regions and, online,
uses DAMON access frequency as the promotion-benefit proxy.  Our signal
source is better than sampled page faults: the paged-attention Pallas kernel
emits per-physical-block attention mass (softmax probability summed over the
block) essentially for free, and decode accesses are counted by the engine.

The region machinery is a faithful port of DAMON's design:
  * the monitored "address space" is a process's logical block range;
  * regions carry ``nr_accesses`` aggregated per sampling window;
  * adaptive regions: random split (budgeted by ``max_nr_regions``) and
    merge of adjacent regions whose access counts differ less than a
    threshold — this is what keeps monitoring overhead controlled and
    independent of address-space size.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .context import NUM_ORDERS


@dataclass
class Region:
    start: int            # logical block, inclusive
    end: int              # exclusive
    nr_accesses: float = 0.0
    age: int = 0          # aggregation windows since last split/merge change

    def __len__(self) -> int:
        return self.end - self.start


class Damon:
    """Per-process access monitor over logical blocks."""

    def __init__(self, space_blocks: int, *, min_nr_regions: int = 10,
                 max_nr_regions: int = 100, merge_threshold: float = 0.15,
                 ema: float = 0.5, seed: int = 0) -> None:
        self.space_blocks = max(1, space_blocks)
        self.min_nr = min_nr_regions
        self.max_nr = max_nr_regions
        self.merge_threshold = merge_threshold
        self.ema = ema
        self._rng = np.random.default_rng(seed)
        n0 = min(self.min_nr, self.space_blocks)
        bounds = np.linspace(0, self.space_blocks, n0 + 1).astype(int)
        self.regions: list[Region] = [
            Region(int(a), int(b)) for a, b in zip(bounds, bounds[1:]) if b > a
        ]
        self.windows = 0
        # bumped whenever the region state changes; lets consumers (batched
        # ctx builders, the tier-scan ctx cache) reuse heat snapshots
        self.version = 0
        self._csum_cache: tuple[int, np.ndarray] | None = None

    # ----------------------------------------------------------- aggregation
    def record(self, heat_per_block: np.ndarray) -> None:
        """Aggregate one window of per-block heat into the regions.

        ``heat_per_block`` may be shorter than the space (tail = 0).  The
        per-region EMA runs as one vectorized pass (this is on the engine's
        per-step path, once per active sequence).
        """
        heat = np.asarray(heat_per_block, dtype=np.float64)
        csum = np.concatenate([[0.0], np.cumsum(heat)])
        n = len(self.regions)
        starts = np.fromiter((r.start for r in self.regions), np.int64, n)
        ends = np.fromiter((r.end for r in self.regions), np.int64, n)
        lo = np.minimum(starts, heat.size)
        hi = np.minimum(ends, heat.size)
        means = (csum[hi] - csum[lo]) / np.maximum(1, ends - starts)
        for r, mean in zip(self.regions, means):
            r.nr_accesses = self.ema * mean + (1 - self.ema) * r.nr_accesses
            r.age += 1
        self.windows += 1
        self._merge_regions()
        self._split_regions()
        self.version += 1

    def grow(self, new_space_blocks: int) -> None:
        """The monitored VMA grew (sequence got longer)."""
        if new_space_blocks <= self.space_blocks:
            return
        self.regions.append(Region(self.space_blocks, new_space_blocks))
        self.space_blocks = new_space_blocks
        self.version += 1

    # --------------------------------------------------- adaptive regions
    def _merge_regions(self) -> None:
        if len(self.regions) <= self.min_nr:
            return
        merged: list[Region] = []
        for r in sorted(self.regions, key=lambda x: x.start):
            if merged:
                prev = merged[-1]
                denom = max(prev.nr_accesses, r.nr_accesses, 1e-9)
                if (prev.end == r.start
                        and abs(prev.nr_accesses - r.nr_accesses) / denom
                        <= self.merge_threshold
                        and len(merged) + (len(self.regions) - len(merged)) > self.min_nr):
                    w1, w2 = len(prev), len(r)
                    prev.nr_accesses = (prev.nr_accesses * w1 + r.nr_accesses * w2) / (w1 + w2)
                    prev.end = r.end
                    prev.age = 0
                    continue
            merged.append(r)
        self.regions = merged

    def _split_regions(self) -> None:
        budget = self.max_nr - len(self.regions)
        if budget <= 0:
            return
        # DAMON splits at a random offset to discover sub-structure; all cut
        # offsets for this pass are drawn in one vectorized call
        splittable = [i for i, r in enumerate(self.regions)
                      if len(r) >= 2][:budget]
        if not splittable:
            return
        lens = np.fromiter((len(self.regions[i]) for i in splittable),
                           np.int64, len(splittable))
        cuts = self._rng.integers(1, lens)    # in [1, len)
        cut_at = dict(zip(splittable, cuts))
        out: list[Region] = []
        for i, r in enumerate(self.regions):
            if i in cut_at:
                cut = r.start + int(cut_at[i])
                out.append(Region(r.start, cut, r.nr_accesses, 0))
                out.append(Region(cut, r.end, r.nr_accesses, 0))
            else:
                out.append(r)
        self.regions = out

    # ------------------------------------------------------------- queries
    def _heat_csum(self) -> np.ndarray:
        """Cumulative per-block heat (``csum[i]`` = heat over blocks
        ``[0, i)``), cached per region-state version.  This is the single
        heat source both the scalar and the batched query paths read, so the
        two agree bit-for-bit."""
        if self._csum_cache is None or self._csum_cache[0] != self.version:
            dense = np.zeros(self.space_blocks, dtype=np.float64)
            for r in self.regions:
                dense[r.start:r.end] = r.nr_accesses
            csum = np.concatenate([[0.0], np.cumsum(dense)])
            self._csum_cache = (self.version, csum)
        return self._csum_cache[1]

    _SIZES = 4 ** np.arange(NUM_ORDERS, dtype=np.int64)   # [1, 4, 16, 64]

    def heat_many(self, addrs: np.ndarray, order: int) -> np.ndarray:
        """Vectorized ``heat_at`` over many addresses at one order."""
        addrs = np.asarray(addrs, dtype=np.int64)
        size = 4 ** order
        a = (addrs // size) * size
        csum = self._heat_csum()
        lo = np.minimum(a, self.space_blocks)
        hi = np.minimum(a + size, self.space_blocks)
        total = csum[hi] - csum[lo]
        covered = hi - lo
        return np.where(covered > 0, total / np.maximum(covered, 1), 0.0)

    def heat_at(self, addr: int, order: int) -> float:
        """Mean access count over the aligned order-k page enclosing ``addr``
        (area-weighted across overlapping monitor regions)."""
        return float(self.heat_many(np.asarray([addr]), order)[0])

    def heat_matrix(self, addrs: np.ndarray) -> np.ndarray:
        """``int64[N, NUM_ORDERS]`` heat of every address at every order —
        the batched-ctx-build form of ``heat_vector``, all orders in one
        broadcasted pass."""
        addrs = np.asarray(addrs, dtype=np.int64)[:, None]     # [N, 1]
        a = (addrs // self._SIZES) * self._SIZES               # [N, K]
        csum = self._heat_csum()
        lo = np.minimum(a, self.space_blocks)
        hi = np.minimum(a + self._SIZES, self.space_blocks)
        total = csum[hi] - csum[lo]
        covered = hi - lo
        heat = np.where(covered > 0, total / np.maximum(covered, 1), 0.0)
        return heat.astype(np.int64)

    def heat_vector(self, addr: int) -> tuple[int, ...]:
        return tuple(int(self.heat_at(addr, k)) for k in range(NUM_ORDERS))

    def snapshot(self) -> list[tuple[int, int, float]]:
        return [(r.start, r.end, r.nr_accesses)
                for r in sorted(self.regions, key=lambda x: x.start)]
