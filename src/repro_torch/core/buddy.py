"""Buddy allocator over the HBM block pool, with fragmentation metrics.

The pool is ``num_blocks`` base blocks; an order-k page is 4^k contiguous
base blocks aligned to 4^k (radix-4 buddies — chosen over Linux's radix-2
because the resulting page sizes 16/64/256/1024 tokens are TPU-tile aligned;
see DESIGN.md §Hardware adaptation).

Provides the real-time state the fault hook exposes to policies:
free-list counts per order and a Linux-style unusable-free-space
fragmentation index, plus a compaction planner that emits an explicit block
move list the device executes with the block_copy Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .context import NUM_ORDERS

RADIX = 4


def order_blocks(order: int) -> int:
    return RADIX ** order


class BuddyError(Exception):
    pass


@dataclass
class BuddyStats:
    free_per_order: tuple[int, ...]
    frag_index_milli: tuple[int, ...]   # 0..1000 per order
    free_blocks: int
    total_blocks: int

    @property
    def utilization_milli(self) -> int:
        if self.total_blocks == 0:
            return 0
        return 1000 * (self.total_blocks - self.free_blocks) // self.total_blocks


class BuddyAllocator:
    """Radix-4 buddy allocator; addresses are base-block indices."""

    def __init__(self, num_blocks: int, max_order: int = NUM_ORDERS - 1) -> None:
        if num_blocks <= 0:
            raise ValueError("num_blocks must be positive")
        self.max_order = max_order
        self.num_blocks = num_blocks
        # free_lists[k] = set of start blocks of free order-k pages
        self.free_lists: list[set[int]] = [set() for _ in range(max_order + 1)]
        # allocated[start] = order, for every live allocation
        self.allocated: dict[int, int] = {}
        self._seed_free_space()

    def _seed_free_space(self) -> None:
        """Carve the pool into maximal aligned free pages."""
        pos = 0
        while pos < self.num_blocks:
            k = self.max_order
            while k > 0 and (pos % order_blocks(k) != 0
                             or pos + order_blocks(k) > self.num_blocks):
                k -= 1
            self.free_lists[k].add(pos)
            pos += order_blocks(k)

    # ------------------------------------------------------------------ alloc
    def alloc(self, order: int) -> int:
        """Allocate an order-k page; raises BuddyError if impossible without
        compaction (the fault path turns that into a compact-or-fallback)."""
        if not 0 <= order <= self.max_order:
            raise ValueError(f"bad order {order}")
        k = order
        while k <= self.max_order and not self.free_lists[k]:
            k += 1
        if k > self.max_order:
            raise BuddyError(f"no free page of order >= {order}")
        start = min(self.free_lists[k])  # deterministic: lowest address first
        self.free_lists[k].discard(start)
        # split down to the requested order
        while k > order:
            k -= 1
            step = order_blocks(k)
            for i in range(1, RADIX):
                self.free_lists[k].add(start + i * step)
        self.allocated[start] = order
        return start

    def free(self, start: int) -> None:
        if start not in self.allocated:
            raise BuddyError(f"double free / unknown allocation at {start}")
        order = self.allocated.pop(start)
        self._free_page(start, order)

    def _free_page(self, start: int, order: int) -> None:
        k = order
        while k < self.max_order:
            step = order_blocks(k)
            group = (start // (step * RADIX)) * (step * RADIX)
            buddies = [group + i * step for i in range(RADIX)]
            if all(b == start or b in self.free_lists[k] for b in buddies):
                for b in buddies:
                    self.free_lists[k].discard(b)
                start = group
                k += 1
            else:
                break
        self.free_lists[k].add(start)

    # ------------------------------------------------------------------ state
    def free_blocks_total(self) -> int:
        return sum(len(fl) * order_blocks(k) for k, fl in enumerate(self.free_lists))

    def stats(self) -> BuddyStats:
        free_per_order = tuple(
            sum(len(self.free_lists[j]) * (order_blocks(j) // order_blocks(k))
                for j in range(k, self.max_order + 1))
            for k in range(self.max_order + 1))
        total_free = self.free_blocks_total()
        frag = []
        for k in range(self.max_order + 1):
            if total_free == 0:
                frag.append(1000)
                continue
            # Linux extfrag-style: fraction of free memory NOT usable for an
            # order-k request.
            usable = free_per_order[k] * order_blocks(k)
            frag.append(int(1000 * (1 - usable / total_free)))
        return BuddyStats(free_per_order=free_per_order,
                          frag_index_milli=tuple(frag),
                          free_blocks=total_free,
                          total_blocks=self.num_blocks)

    # ------------------------------------------------------------- compaction
    def plan_compaction(self, order: int) -> list[tuple[int, int, int]] | None:
        """Plan moves to create one free aligned order-k page.

        Returns a move list [(src_start, dst_start, order_moved), ...] or None
        if impossible (not enough total free space).  Strategy mirrors Linux
        compaction's two scanners: find the aligned candidate window with the
        fewest allocated blocks, then relocate those allocations into free
        pages outside the window (lowest-address-first).
        """
        need = order_blocks(order)
        if self.free_blocks_total() < need:
            return None
        # Candidate windows: aligned order-k ranges. Score = allocated blocks inside.
        best_window, best_allocs, best_score = None, None, None
        for wstart in range(0, self.num_blocks - need + 1, need):
            allocs_in = [(s, o) for s, o in self.allocated.items()
                         if s < wstart + need and s + order_blocks(o) > wstart]
            # reject windows where an allocation straddles the boundary
            if any(s < wstart or s + order_blocks(o) > wstart + need
                   for s, o in allocs_in):
                continue
            score = sum(order_blocks(o) for _, o in allocs_in)
            free_outside = self.free_blocks_total() - (need - score)
            if free_outside < score:
                continue
            if best_score is None or score < best_score:
                best_window, best_allocs, best_score = wstart, allocs_in, score
            if score == 0:
                break
        if best_window is None:
            return None

        moves: list[tuple[int, int, int]] = []
        # simulate: free everything in the window, then re-alloc outside it
        saved_free = [set(fl) for fl in self.free_lists]
        saved_alloc = dict(self.allocated)
        try:
            for s, o in best_allocs:
                self.free(s)
            # reserve the window so re-allocs land outside
            reserved = self._reserve_range(best_window, need)
            for s, o in sorted(best_allocs, key=lambda x: -x[1]):
                dst = self.alloc(o)
                moves.append((s, dst, o))
            self._unreserve(reserved)
        except BuddyError:
            self.free_lists = saved_free
            self.allocated = saved_alloc
            return None
        return moves

    def _reserve_range(self, start: int, nblocks: int) -> list[tuple[int, int]]:
        """Temporarily remove free pages inside [start, start+nblocks) from
        the free lists. Returns what was removed for later restoration.

        Free pages that CONTAIN the window (possible after coalescing) are
        split down first so every overlapping free page lies strictly inside.
        """
        changed = True
        while changed:
            changed = False
            for k in range(self.max_order, 0, -1):
                step = order_blocks(k)
                for s in list(self.free_lists[k]):
                    overlaps = s < start + nblocks and s + step > start
                    inside = s >= start and s + step <= start + nblocks
                    if overlaps and not inside:
                        self.free_lists[k].discard(s)
                        child = order_blocks(k - 1)
                        for i in range(RADIX):
                            self.free_lists[k - 1].add(s + i * child)
                        changed = True
        removed = []
        for k, fl in enumerate(self.free_lists):
            step = order_blocks(k)
            inside = [s for s in fl if s >= start and s + step <= start + nblocks]
            for s in inside:
                fl.discard(s)
                removed.append((s, k))
        return removed

    def _unreserve(self, removed: list[tuple[int, int]]) -> None:
        # re-add with coalescing so the window comes back as maximal pages
        for s, k in removed:
            self._free_page(s, k)

    def check_invariants(self) -> None:
        """Exhaustive consistency check (used by property tests)."""
        seen: set[int] = set()
        for k, fl in enumerate(self.free_lists):
            step = order_blocks(k)
            for s in fl:
                if s % step != 0:
                    raise AssertionError(f"free page {s} misaligned for order {k}")
                rng = set(range(s, s + step))
                if rng & seen:
                    raise AssertionError(f"overlap in free lists at {s}")
                seen |= rng
        for s, o in self.allocated.items():
            step = order_blocks(o)
            if s % step != 0:
                raise AssertionError(f"allocation {s} misaligned for order {o}")
            rng = set(range(s, s + step))
            if rng & seen:
                raise AssertionError(f"allocation {s} overlaps free space")
            seen |= rng
        if len(seen) != self.num_blocks:
            raise AssertionError(
                f"accounting leak: {len(seen)} != {self.num_blocks} blocks")
