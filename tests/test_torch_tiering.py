"""The port's N-tier tiering against the reference, bit for bit.

* Manager level: the ``TieredMemoryManager`` scripts of
  ``tests/test_tiering.py`` (demote/promote round trips, huge pages, a full
  host tier, frees, the never-tier veto, the cross-process cold scan, the
  promotion scan) plus a 4-tier heat-band chain replay through both
  packages: stats, page tables, block tables, tier snapshots and every
  drained move list must be identical.  The tier decisions that batch run
  through each package's batch executor (the port's on the CPU).
* Engine level: the ``TestEngineTiering`` workload (48 HBM blocks of 4
  tokens, 6 requests of prompt 56 + 40 new, ``max_batch=6``) with
  ``host_blocks=192`` on both fault routes, ``host_blocks=8`` and
  ``never-tier``: tokens, engine stats, ``MMStats``, moves, hook counters
  and the tier snapshot identical step by step (``test_torch_engine``'s
  ``drive``, the reference in a child process).
* The move-batch split: a drain that mixes a khugepaged collapse with
  demote and promote hops of the same blocks leaves the pool exactly as the
  reference engine's scatter does, and every batch of the split is safe to
  copy concurrently in place (any copy order gives the same pool).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from test_torch_engine import assert_same_run, drive, run_reference
from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

TIER_BASE = {"num_blocks": 48, "n_req": 6, "prompt": 56, "new": 40,
             "max_batch": 6, "policy": "never"}


def _spec_cases() -> dict:
    return {
        "ebpf-tier/192/batch": dict(TIER_BASE, max_steps=280, engine={
            "host_blocks": 192, "tier_policy": "ebpf-tier"}),
        "ebpf-tier/192/scalar": dict(TIER_BASE, max_steps=280, engine={
            "host_blocks": 192, "tier_policy": "ebpf-tier",
            "batch_faults": False}),
        "ebpf-tier/8/batch": dict(TIER_BASE, max_steps=80, engine={
            "host_blocks": 8, "tier_policy": "ebpf-tier"}),
        "never-tier/192/batch": dict(TIER_BASE, max_steps=60, engine={
            "host_blocks": 192, "tier_policy": "never-tier"}),
    }


# ------------------------------------------------------------ manager level
def _tmm(pkg, hbm=32, host=64, default="never", tiers=None):
    c = importlib.import_module(f"{pkg}.core")
    cost = c.make_cost_model(c.HWSpec(), kv_heads=8, head_dim=128)
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    if tiers is not None:
        return c, c.TieredMemoryManager(
            hbm, cost, tiers=c.default_tier_chain(c.HWSpec(), tiers),
            default_mode=default, **kw)
    return c, c.TieredMemoryManager(hbm, cost, host_blocks=host,
                                    default_mode=default, **kw)


def _state(mm, rec: dict, pids) -> dict:
    rec["stats"] = mm.stats.snapshot()
    rec["tier"] = mm.tier_snapshot()
    rec["tables"] = {str(p): mm.block_table(p, 32).tolist() for p in pids
                     if p in mm.procs}
    rec["pages"] = {str(p): sorted((m.logical_start, m.phys_start, m.order,
                                    m.tier)
                                   for m in mm.procs[p].page_table.values())
                    for p in pids if p in mm.procs}
    return rec


def _script_roundtrip(pkg, default="never", n=16):
    c, mm = _tmm(pkg, hbm=64 if default == "thp" else 32,
                 host=64 if default == "thp" else 32, default=default)
    mm.create_process(1, vma_blocks=n)
    mm.ensure_range(1, 0, n)
    rec = {"moves": [mm.drain_moves()]}
    rec["demote"] = [mm.demote_page(1, lg)
                     for lg in sorted(mm.procs[1].page_table)]
    rec["moves"].append(mm.drain_moves())
    rec["promote"] = [mm.promote_page(1, lg)
                      for lg in sorted(mm.procs[1].page_table)]
    rec["moves"].append(mm.drain_moves())
    return _state(mm, rec, [1])


def _script_host_full(pkg):
    c, mm = _tmm(pkg, hbm=32, host=4)
    mm.create_process(1, vma_blocks=16)
    mm.ensure_range(1, 0, 16)
    rec = {"demote": [mm.demote_page(1, lg)
                      for lg in sorted(mm.procs[1].page_table)],
           "moves": mm.drain_moves()}
    return _state(mm, rec, [1])


def _script_free_both(pkg):
    c, mm = _tmm(pkg, hbm=16, host=16)
    mm.create_process(1, vma_blocks=8)
    mm.ensure_range(1, 0, 8)
    for lg in list(mm.procs[1].page_table)[:4]:
        mm.demote_page(1, lg)
    rec = {"moves": mm.drain_moves()}
    mm.free_process(1)
    rec["free"] = [mm.buddy.free_blocks_total(),
                   mm.host_buddy.free_blocks_total()]
    return _state(mm, rec, [1])


def _script_never_veto(pkg):
    c, mm = _tmm(pkg, hbm=16, host=16)
    mm.attach_tier_program(c.tier_never_program())
    mm.create_process(1, vma_blocks=16)
    mm.ensure_range(1, 0, 16)
    rec = {"freed": mm.demote_cold_global(8), "moves": mm.drain_moves()}
    return _state(mm, rec, [1])


def _script_cold_global(pkg):
    c, mm = _tmm(pkg, hbm=32, host=64)
    for pid in (1, 2):
        mm.create_process(pid, vma_blocks=16)
        mm.ensure_range(pid, 0, 16)
    mm.attach_tier_program(c.tier_damon_program())
    rec = {"freed": mm.demote_cold_global(24, prefer_pid=1),
           "moves": mm.drain_moves()}
    return _state(mm, rec, [1, 2])


def _script_promotion(pkg):
    c, mm = _tmm(pkg, hbm=32, host=64)
    mm.create_process(1, vma_blocks=32)
    mm.ensure_range(1, 0, 32)
    for lg in list(mm.procs[1].page_table)[:12]:
        mm.demote_page(1, lg)
    mm.tick()
    mm.record_access(1, np.ones(32) * 3)
    rec = {"promoted": mm.promotion_scan(4), "moves": mm.drain_moves(),
           "host_resident": mm.host_resident_blocks()}
    return _state(mm, rec, [1])


def _script_four_tier(pkg):
    """A 4-tier chain (peer-HBM, host DRAM, NVMe) under the heat-band
    program: prefill placement, a cold scan down the chain, heat, then the
    promotion scan back up — every hop a batched HOOK_TIER decision."""
    c, mm = _tmm(pkg, hbm=32, tiers=(16, 32, 16))
    mm.attach_tier_program(c.tier_heat_band_program())
    rng = np.random.default_rng(5)
    for pid in (1, 2, 3):
        mm.create_process(pid, vma_blocks=16)
        mm.fault_range(pid, 0, 10)
        mm.record_access(pid, rng.random(16) * 2)
    mm.tick()
    rec = {"freed": mm.demote_cold_global(12, prefer_pid=2),
           "moves": [mm.drain_moves()]}
    for _ in range(3):
        for pid in (1, 2, 3):
            mm.record_access(pid, rng.random(16) * 4)
        mm.tick()
        rec.setdefault("promoted", []).append(mm.promotion_scan())
        rec["moves"].append(mm.drain_moves())
    return _state(mm, rec, [1, 2, 3])


SCRIPTS = {
    "roundtrip": _script_roundtrip,
    "roundtrip_huge": lambda pkg: _script_roundtrip(pkg, "thp", 32),
    "host_full": _script_host_full,
    "free_both_tiers": _script_free_both,
    "never_tier_veto": _script_never_veto,
    "cold_global": _script_cold_global,
    "promotion_scan": _script_promotion,
    "four_tier": _script_four_tier,
}


def _json(x):
    import json
    return json.loads(json.dumps(x, default=int))


# ------------------------------------------------------- move-batch split
def split_drain(pkg):
    """A drain mixing a khugepaged collapse with demote and promote hops of
    the same blocks (and a promotion into a block a demotion of the same
    drain just read).  Returns ``(hbm, host, moves)``."""
    c, mm = _tmm(pkg, hbm=32, host=32)
    mm.create_process(1, vma_blocks=16)
    mm.ensure_range(1, 0, 16)
    mm.create_process(2, vma_blocks=16)
    mm.ensure_range(2, 0, 16)
    mm.demote_page(2, 8)
    mm.demote_page(2, 9)
    mm.drain_moves()
    for lg in range(4):
        mm.demote_page(1, lg)
    mm.promote_page(2, 8)
    mm.collapse(1, 4, 1)
    mm.demote_page(1, 4)
    mm.promote_page(1, 4)
    mm.promote_page(1, 1)
    mm.promote_page(2, 9)
    return 32, 32, [tuple(int(x) for x in m) for m in mm.drain_moves()]


def _reference_split_pool(params) -> list:
    """The reference engine's own drain (its batch split and ``_moves_entry``
    scatter) on a combined pool whose every block holds its index."""
    import jax.numpy as jnp
    from repro.configs.base import get_smoke_config
    from repro.models import PagedLayout
    from repro.serving import ServingEngine
    hbm, host, moves = split_drain("repro")
    eng = ServingEngine(get_smoke_config("deepseek_7b"), params,
                        PagedLayout(num_blocks=hbm, block_tokens=4,
                                    max_blocks=32),
                        policy="never", host_blocks=host, max_batch=2)

    def fill(path, leaf):
        key = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        if key not in ("pool_k", "pool_v"):
            return leaf
        nb = leaf.shape[-4]
        ids = jnp.arange(nb, dtype=leaf.dtype).reshape(nb, 1, 1, 1)
        return jnp.broadcast_to(ids, leaf.shape).astype(leaf.dtype)
    import jax
    eng.cache = jax.tree_util.tree_map_with_path(fill, eng.cache)
    eng.mm.drain_moves = lambda: list(moves)
    eng._apply_pending_moves()
    leaf = eng.cache["s0"]["m0"]["pool_k"] if "s0" in eng.cache else \
        eng.cache["p0"]["pool_k"]
    blocks = np.asarray(leaf, np.float32).reshape(-1, hbm + host,
                                                  *leaf.shape[-3:])
    return blocks[0, :, 0, 0, 0].astype(int).tolist()


def _reference_extra(params) -> dict:
    return {"scripts": {name: _json(fn("repro"))
                        for name, fn in SCRIPTS.items()},
            "split_drain": _json(split_drain("repro")),
            "split_pool": _reference_split_pool(params)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "test_torch_tiering")


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_manager_scripts_match_reference(reference, name):
    results, _ = reference
    assert _json(SCRIPTS[name]("repro_torch")) == \
        results["extra"]["scripts"][name]


@pytest.mark.parametrize("case", list(_spec_cases()))
def test_engine_tiering_matches_reference(reference, case):
    results, params = reference
    ref = results[case]
    port = drive("repro_torch", _spec_cases()[case], params,
                 replay=ref["samples"])
    assert_same_run(ref, port, replayed=True)
    last = ref["final"]
    if case.startswith("ebpf-tier/192"):
        # the acceptance workload: demotion absorbs the pressure
        assert last["engine"]["preemptions"] == 0
        assert last["engine"]["completed"] == 6
        assert last["mm"]["demotions"] > 0
    elif case == "ebpf-tier/8/batch":
        assert last["mm"]["demotions"] > 0
        assert last["engine"]["preemptions"] > 0
    else:
        assert last["mm"]["demotions"] == 0
        assert last["engine"]["preemptions"] > 0


def test_move_split_matches_reference_scatter(reference):
    """The port's split of a collapse + demote/promote drain leaves the pool
    as the reference's scatter does, and each batch is race-free: copying
    its rows forward, backward or all-reads-first gives one pool."""
    from repro_torch.core.buddy import order_blocks
    from repro_torch.serving.engine import split_move_batches
    results, _ = reference
    hbm, host, moves = split_drain("repro_torch")
    assert [list(m) for m in moves] == results["extra"]["split_drain"][2]
    batches = split_move_batches(moves)
    # the drain needs the write-after-read rule: a move writes a block an
    # earlier move of the same reference batch read
    assert len(batches) >= 4
    pool = np.arange(hbm + host)
    for batch in batches:
        src = np.concatenate([np.arange(s, s + order_blocks(o))
                              for s, _, o in batch])
        dst = np.concatenate([np.arange(d, d + order_blocks(o))
                              for _, d, o in batch])
        outs = []
        for order in (range(len(src)), reversed(range(len(src)))):
            p = pool.copy()
            for i in order:
                p[dst[i]] = p[src[i]]
            outs.append(p)
        p = pool.copy()
        p[dst] = pool[src]
        outs.append(p)
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])
        pool = outs[0]
    assert pool.tolist() == results["extra"]["split_pool"]
    # and the port engine's own drain path lands the same pool
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import PagedLayout
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(get_smoke_config("deepseek_7b"), reference[1],
                        PagedLayout(num_blocks=hbm, block_tokens=4,
                                    max_blocks=32),
                        policy="never", host_blocks=host, max_batch=2,
                        device="cpu")
    for leaf in eng._pool_leaves:
        leaf.copy_(torch.arange(hbm + host, dtype=leaf.dtype).reshape(
            1, -1, 1, 1, 1).expand_as(leaf))
    eng.mm.drain_moves = lambda: list(moves)
    eng._apply_pending_moves()
    got = eng._pool_leaves[0][0, :, 0, 0, 0].float().int().tolist()
    assert got == results["extra"]["split_pool"]


def test_two_tier_baselines_rejected_on_deep_chains(reference):
    """ebpf-tier / lru-tier never demote past tier 1: the port's engine
    refuses them on a deeper chain, as the reference does, and takes an
    N-tier policy there."""
    _, params = reference
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import PagedLayout
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config("deepseek_7b")
    layout = PagedLayout(num_blocks=48, block_tokens=4, max_blocks=32)
    for policy in ("ebpf-tier", "lru-tier"):
        with pytest.raises(ValueError, match="2-tier baseline"):
            ServingEngine(cfg, params, layout, policy="never",
                          tier_blocks=(16, 96, 80), tier_policy=policy,
                          device="cpu")
    eng = ServingEngine(cfg, params, layout, policy="never",
                        tier_blocks=(16, 96, 80), tier_policy="heat-tier",
                        device="cpu")
    assert eng.mm.ntiers == 4
    assert eng._pool_leaves[0].shape[1] == 48 + 16 + 96 + 80
