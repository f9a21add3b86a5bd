"""Promotion cost/benefit model + target-hardware constants.

The paper: "we assume that the primary contributors to this cost are the time
required to prepare a huge page (zeroing) and the time needed to locate an
available one (compaction).  We empirically calculate a fixed cost for both."

TPU adaptation: the pool lives in HBM and is framework-managed, so "zeroing"
is an HBM-bandwidth-bound memset of the page, and "compaction" is block
migration (read+write over HBM) directed by the buddy allocator.  The
*benefit* side replaces TLB-miss reduction with DMA-descriptor / page-table
indirection reduction inside the paged-attention kernel: a page of order k
covers 4^k base blocks with ONE descriptor, and larger contiguous reads get
closer to peak HBM bandwidth (small-transfer overhead amortizes).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .context import MAX_TIERS, NUM_ORDERS


@dataclass(frozen=True)
class HWSpec:
    """TPU v5e-class target constants (also used by the roofline analysis)."""
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12          # per chip
    hbm_bw: float = 819e9                    # bytes/s
    ici_bw_per_link: float = 50e9            # bytes/s/link
    # Fixed per-crossing setup cost of an ICI hop (peer-HBM tier edge).
    ici_setup_ns: float = 1_000.0
    # Host<->device interconnect (PCIe Gen4 x16 class): the bandwidth the
    # host-DRAM KV tier is demoted to / promoted from.
    pcie_bw: float = 32e9                    # bytes/s
    # Fixed per-migration setup cost (DMA programming, sync) per tier crossing.
    pcie_setup_ns: float = 2_000.0
    # NVMe tier (Gen4 x4 class): streaming bandwidth and per-IO setup cost of
    # the host-DRAM <-> NVMe edge.
    nvme_bw: float = 7e9                     # bytes/s
    nvme_setup_ns: float = 10_000.0
    # Per-DMA-descriptor fixed overhead for a paged KV read. Order-of-magnitude
    # of a small async copy issue + bookkeeping. Empirically calibrated on the
    # kernel microbench; exposed so profiles can be recalibrated per platform.
    descriptor_ns: float = 800.0
    # Effective bandwidth derate for small contiguous reads: a transfer of B
    # bytes achieves hbm_bw * B / (B + small_read_crossover_bytes).
    small_read_crossover_bytes: float = 64 * 1024.0
    # Fixed per-page setup cost besides the memset (table update, sync).
    page_setup_ns: float = 300.0

    def effective_bw(self, transfer_bytes: float) -> float:
        b = float(transfer_bytes)
        return self.hbm_bw * b / (b + self.small_read_crossover_bytes)


@dataclass(frozen=True)
class TierSpec:
    """One spill tier of the N-pool topology (tier 0 = local HBM is implicit).

    ``link_bw``/``link_setup_ns`` describe the EDGE connecting this tier to
    the next-faster one (the per-edge bandwidth table the migrate-cost helper
    charges); ``read_bw`` is the bandwidth the attention kernel streams at
    when KV resides here (defaults to the link bandwidth)."""
    name: str
    blocks: int                      # pool capacity in base blocks
    link_bw: float                   # bytes/s across the edge to tier-1 side
    link_setup_ns: float             # fixed per-crossing setup of that edge
    read_bw: float | None = None

    @property
    def stream_bw(self) -> float:
        return self.read_bw if self.read_bw is not None else self.link_bw


def peer_hbm_tier(hw: HWSpec, blocks: int) -> TierSpec:
    """Peer-device HBM reached over ICI."""
    return TierSpec("peer-hbm", blocks, link_bw=hw.ici_bw_per_link,
                    link_setup_ns=hw.ici_setup_ns,
                    read_bw=hw.ici_bw_per_link)


def host_dram_tier(hw: HWSpec, blocks: int) -> TierSpec:
    """Pinned host DRAM reached over PCIe (the original 2-pool spill tier)."""
    return TierSpec("host-dram", blocks, link_bw=hw.pcie_bw,
                    link_setup_ns=hw.pcie_setup_ns, read_bw=hw.pcie_bw)


def nvme_tier(hw: HWSpec, blocks: int) -> TierSpec:
    """NVMe-backed tier behind host DRAM."""
    return TierSpec("nvme", blocks, link_bw=hw.nvme_bw,
                    link_setup_ns=hw.nvme_setup_ns, read_bw=hw.nvme_bw)


def default_tier_chain(hw: HWSpec, tier_blocks) -> tuple[TierSpec, ...]:
    """Spill tiers for a chain of 1..3 capacities: (peer-HBM[, host-DRAM
    [, NVMe]]) for 3+ pools, plain (host-DRAM) for the classic 2-pool case."""
    blocks = [int(b) for b in tier_blocks]
    if not 1 <= len(blocks) <= MAX_TIERS - 1:
        raise ValueError(f"tier chain needs 1..{MAX_TIERS - 1} spill tiers")
    if len(blocks) == 1:
        makers = [host_dram_tier]
    else:
        makers = [peer_hbm_tier, host_dram_tier, nvme_tier][:len(blocks)]
    return tuple(mk(hw, b) for mk, b in zip(makers, blocks))


@dataclass
class CostModel:
    """Calibrated promotion cost + access benefit, all in modeled ns."""
    hw: HWSpec
    block_bytes: int                 # bytes of one base block (KV slab)
    block_tokens: int = 16
    # Spill-tier topology (tier ids 1..len(topology)); None = the classic
    # single host-DRAM tier over PCIe, capacity supplied by the manager.
    topology: tuple[TierSpec, ...] | None = None
    # (key, cum_setup, cum_ns) memo for migrate_cum_tables — the tables sit
    # on the migration hot path and in every tier ctx build.
    _cum_cache: tuple | None = field(default=None, repr=False, compare=False)

    # ---- cost side (paper: zeroing + compaction) -------------------------
    def zero_ns_per_block(self) -> int:
        memset = self.block_bytes / self.hw.hbm_bw * 1e9
        return int(memset + self.hw.page_setup_ns / 4)  # setup amortized

    def compact_ns_per_block(self) -> int:
        # migration = read + write of one block over HBM
        return int(2 * self.block_bytes / self.hw.hbm_bw * 1e9)

    # ---- tiering side (per-edge cost table over the N-pool tier graph) ----
    @property
    def tier_specs(self) -> tuple[TierSpec, ...]:
        """Spill tiers 1..N-1 of the live topology (default: host DRAM)."""
        if self.topology:
            return self.topology
        return (host_dram_tier(self.hw, 0),)

    @property
    def ntiers(self) -> int:
        return 1 + len(self.tier_specs)

    def pcie_ns_per_block(self) -> int:
        """Modeled ns to move one base block across the host interconnect."""
        return int(self.block_bytes / self.hw.pcie_bw * 1e9)

    def _edges(self) -> list[tuple[int, int]]:
        """(setup_ns, ns_per_block) for every adjacent tier edge; edge ``i``
        connects tier ``i`` to tier ``i+1``.  Per-block edge cost is the link
        transfer plus the faster side's read-or-write touch."""
        edges = []
        faster_bw = self.hw.hbm_bw
        for spec in self.tier_specs:
            per_block = (self.block_bytes / spec.link_bw
                         + self.block_bytes / faster_bw) * 1e9
            edges.append((int(spec.link_setup_ns), int(per_block)))
            faster_bw = spec.stream_bw
        return edges

    def edge_names(self) -> tuple[str, ...]:
        """Human-readable label per tier edge (``"hbm->host_dram"``); edge
        ``i`` connects tier ``i`` to tier ``i+1``.  The health monitor and
        resilience metrics key their per-edge state on these."""
        names = ["hbm"] + [s.name for s in self.tier_specs]
        return tuple(f"{a}->{b}" for a, b in zip(names[:-1], names[1:]))

    def migrate_cum_tables(self) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """Cumulative edge-cost tables padded to MAX_TIERS: entry ``t`` is
        the summed (setup, per-block) cost of every edge between tier 0 and
        tier ``t``.  The form the ctx exposes to bpf_mm_migrate_cost.
        Memoized — every migration hop and tier ctx build reads them."""
        key = (self.topology, self.block_bytes, self.hw)
        if self._cum_cache is not None and self._cum_cache[0] == key:
            return self._cum_cache[1], self._cum_cache[2]
        setup, per = [0], [0]
        for s, p in self._edges():
            setup.append(setup[-1] + s)
            per.append(per[-1] + p)
        while len(setup) < MAX_TIERS:      # pad: unreachable tiers add 0 cost
            setup.append(setup[-1])
            per.append(per[-1])
        out = tuple(setup[:MAX_TIERS]), tuple(per[:MAX_TIERS])
        self._cum_cache = (key, out[0], out[1])
        return out

    def migrate_setup_ns(self, src: int = 0, dst: int = 1) -> int:
        """Summed fixed setup cost of every edge on the src->dst path."""
        cum, _ = self.migrate_cum_tables()
        lo, hi = sorted((max(0, src), max(0, dst)))
        return cum[min(hi, MAX_TIERS - 1)] - cum[min(lo, MAX_TIERS - 1)]

    def migrate_ns_per_block(self, src: int = 0, dst: int = 1) -> int:
        """Per-block cost of a src->dst tier crossing: summed per-edge link
        transfers + faster-side touches along the path.  Exposed to tier
        programs via the cumulative ctx tables so the bpf_mm_migrate_cost
        helper charges exactly what the engine accounts."""
        _, cum = self.migrate_cum_tables()
        lo, hi = sorted((max(0, src), max(0, dst)))
        return cum[min(hi, MAX_TIERS - 1)] - cum[min(lo, MAX_TIERS - 1)]

    def migrate_ns(self, order: int, src: int = 0, dst: int = 1) -> int:
        """One src->dst crossing of an order-k page: per-block path cost plus
        the fixed per-edge setup costs."""
        return int(self.migrate_setup_ns(src, dst)
                   + (4 ** order) * self.migrate_ns_per_block(src, dst))

    def tier_access_ns(self, order: int, tier: int = 1) -> float:
        """Modeled ns to stream one order-k page resident in ``tier`` through
        the attention kernel (link-bound, not HBM-bound)."""
        if tier <= 0:
            return self.access_ns(order)
        specs = self.tier_specs
        spec = specs[min(tier, len(specs)) - 1]
        page_bytes = self.block_bytes * (4 ** order)
        return self.hw.descriptor_ns + page_bytes / spec.stream_bw * 1e9

    def promotion_cost_ns(self, order: int, free_blocks: int, frag_milli: int) -> int:
        nblocks = 4 ** order
        cost = self.zero_ns_per_block() * nblocks
        if free_blocks <= 0:
            cost += self.compact_ns_per_block() * nblocks * (1000 + frag_milli) // 1000
        return int(cost)

    # ---- benefit side (TLB-reach analogue) --------------------------------
    def access_ns(self, order: int) -> float:
        """Modeled ns to stream one order-k page through the attention kernel."""
        page_bytes = self.block_bytes * (4 ** order)
        return self.hw.descriptor_ns + page_bytes / self.hw.effective_bw(page_bytes) * 1e9

    def access_benefit_ns(self, order: int, heat: float = 1.0) -> int:
        """ns saved per aggregation window if the region is backed at
        ``order`` instead of order 0, given ``heat`` accesses per window."""
        if order == 0:
            return 0
        per_page_o0 = self.access_ns(0) * (4 ** order)   # 4^k descriptors
        per_page_ok = self.access_ns(order)              # 1 descriptor
        return int(max(0.0, heat * (per_page_o0 - per_page_ok)))

    def descriptor_count(self, orders: list[int]) -> int:
        """Page-table entries touched to read a mapping = TLB-miss analogue."""
        return len(orders)


def make_cost_model(hw: HWSpec, kv_heads: int, head_dim: int, *,
                    block_tokens: int = 16, dtype_bytes: int = 2,
                    layers_fused: int = 1) -> CostModel:
    """Cost model for a KV pool slab: K+V for ``layers_fused`` layers."""
    block_bytes = block_tokens * kv_heads * head_dim * 2 * dtype_bytes * layers_fused
    return CostModel(hw=hw, block_bytes=block_bytes, block_tokens=block_tokens)
