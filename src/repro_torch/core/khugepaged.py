"""Background promoter — the khugepaged analogue (paper's "future work",
implemented here as a beyond-paper feature).

Periodically scans processes' DAMON state for hot regions currently backed by
small pages and collapses them into larger pages when the cost model says the
migration pays for itself.  Runs synchronously from the engine loop
(``tick()``) so behaviour is deterministic and testable; the serving engine
calls it between decode steps, which is exactly where an async kernel thread
would get cycles on a real deployment.
"""

from __future__ import annotations

from dataclasses import dataclass

from .buddy import order_blocks
from .context import NUM_ORDERS
from .mm import MemoryManager


@dataclass
class KhugepagedConfig:
    scan_processes_per_tick: int = 4
    pages_per_scan: int = 8          # collapse budget per tick (throttled, like Linux)
    min_net_benefit_ns: int = 0      # require benefit - cost > this
    target_order: int = 2            # PMD-analogue default target
    heat_horizon: float = 16.0       # windows over which benefit amortizes


class Khugepaged:
    def __init__(self, mm: MemoryManager, cfg: KhugepagedConfig | None = None) -> None:
        self.mm = mm
        self.cfg = cfg or KhugepagedConfig()
        self._cursor = 0
        self.collapsed = 0
        self.considered = 0

    def tick(self) -> int:
        """One scan pass; returns number of collapses performed."""
        cfg = self.cfg
        pids = sorted(self.mm.procs)
        if not pids:
            return 0
        done = 0
        nscan = min(cfg.scan_processes_per_tick, len(pids))
        for i in range(nscan):
            pid = pids[(self._cursor + i) % len(pids)]
            done += self._scan_process(pid, cfg.pages_per_scan - done)
            if done >= cfg.pages_per_scan:
                break
        self._cursor = (self._cursor + nscan) % max(1, len(pids))
        return done

    def _scan_process(self, pid: int, budget: int) -> int:
        if budget <= 0:
            return 0
        mm, cfg = self.mm, self.cfg
        st = mm.procs[pid]
        k = min(cfg.target_order, NUM_ORDERS - 1)
        size = order_blocks(k)
        done = 0
        # candidate windows: aligned order-k ranges fully mapped at lower orders
        windows = sorted({(m.logical_start // size) * size
                          for m in st.page_table.values()
                          if m.order < k and m.tier == 0})
        bstats = mm.buddy.stats()
        for a in windows:
            if done >= budget:
                break
            if a + size > st.vma_end:
                continue
            inside = [m for m in st.page_table.values()
                      if a <= m.logical_start < a + size]
            if not inside or any(m.order >= k for m in inside):
                continue
            self.considered += 1
            heat = st.damon.heat_at(a, k)
            benefit = mm.cost.access_benefit_ns(k, heat * cfg.heat_horizon)
            free_k = bstats.free_per_order[k]
            cost = mm.cost.promotion_cost_ns(k, free_k, bstats.frag_index_milli[k])
            # migration adds copy cost on top of the paper's zero+compact terms
            copied = sum(order_blocks(m.order) for m in inside)
            cost += mm.cost.compact_ns_per_block() * copied
            if benefit - cost > cfg.min_net_benefit_ns:
                if mm.collapse(pid, a, k) is not None:
                    done += 1
                    self.collapsed += 1
                    bstats = mm.buddy.stats()
        return done
