"""The port's resilience layer against the reference, bit for bit.

* ``FailureInjector``: ``fires`` and ``link_down`` over a grid of seeds,
  sites and keys (ints, negatives, words past 64 bits, strings), and the
  ``snapshot`` accounting, equal to the reference's.
* The chaos differential (``tests/test_differential.py``'s chaos lane):
  ``make_script`` under its ``CHAOS_RATES`` through the 2-tier and 4-tier
  managers on the scalar and batched fault routes (the port's batch
  executor on the CPU), one injector per replica.  Every step's page
  tables, mapped sets, tier occupancy, ``MMStats`` and ``injector.fired``
  equal the reference manager's, the port's two routes equal each other,
  and the KV-content oracle holds: a modeled device pool applies every
  drained move list and each block reads back the value written into it.
* The engine: the tiered workload of ``test_torch_tiering.py`` with
  ``chaos=<seed>`` on both fault routes against the reference's, fed the
  reference's tokens and DAMON heat (``drive``'s replay): tokens,
  engine, mm and tier stats, ``injector.fired``, the supervisor and health
  ledgers, the ring's modeled-clock events and every modeled metric; every
  supervisor strike is explained by an injected ``hook_run`` failure; the
  chaos run's tokens equal the clean run's (failures change placement,
  never data).  At a higher rate (``SPLIT_RATE``) link flaps leave HBM full
  with no demotion possible, and the reference's two routes part: the
  batched route preempts at most once per step, the scalar route at most
  once per faulting sequence.  The port parts the same way on each route.
"""

from __future__ import annotations

import importlib
import itertools

import numpy as np
import pytest

from test_differential import (CHAOS_RATES, HBM_BLOCKS, VMA_MAX, _kv_value,
                               make_script)
from test_torch_engine import (assert_replay_agrees, assert_same_observed,
                               assert_same_run, drive, run_reference)
from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tiering import TIER_BASE

from repro_torch.obs import EV_DETACH, EV_MIGRATE_HOP, EV_RETRY

PKGS = ("repro", "repro_torch")
TOPOLOGIES = ("2tier", "4tier")
SEEDS = (0, 1)
CHAOS_SEED, CHAOS_RATE = 1, 0.05
SPLIT_RATE = 0.1          # the routes part at this rate (and seed)


def _tier_spec(batch: bool, rate: float | None) -> dict:
    eng = {"host_blocks": 192, "tier_policy": "ebpf-tier",
           "batch_faults": batch}
    if rate is not None:
        eng.update(chaos=CHAOS_SEED, chaos_rate=rate, telemetry=True)
    return dict(TIER_BASE, max_steps=280, engine=eng)


def _spec_cases() -> dict:
    cases = {}
    for b in (True, False):
        route = "batch" if b else "scalar"
        cases[f"chaos/{route}"] = _tier_spec(b, CHAOS_RATE)
        cases[f"split/{route}"] = _tier_spec(b, SPLIT_RATE)
    cases["clean/batch"] = _tier_spec(True, None)
    return cases


def _reference_extra(params) -> dict:
    return {"differential": {f"{t}/{s}/{r}": replay("repro", t, s, r)
                             for t in TOPOLOGIES for s in SEEDS
                             for r in ("scalar", "batch")}}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "test_torch_resilience")


@pytest.fixture
def fresh_artifact_cache(tmp_path, monkeypatch):
    """An empty artifact cache for the port, like the reference child's:
    ``cache_corrupt`` is checked only on a disk hit, so a pickle left by an
    earlier session would add checks the reference never makes."""
    from repro_torch.core import cache
    monkeypatch.setattr(cache, "artifact_cache",
                        cache.ArtifactCache(root=tmp_path))


def faults(pkg: str):
    return importlib.import_module(f"{pkg}.resilience")


# --------------------------------------------------------------- injector
KEYS = [(), (0,), (7, 3), (-1, 2 ** 64 + 5), ("edge", 12, -(2 ** 63)),
        ("ab", "ba"), (1, 1, 1, 1, 1)]


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 63 - 1])
def test_injector_matches_reference(seed):
    got = {}
    for pkg in PKGS:
        R = faults(pkg)
        inj = R.FailureInjector(seed, {s: r for s, r in zip(
            R.SITES, (0.5, 0.25, 0.1, 0.9, 1.0))})
        fires = [inj.fires(site, *key) for site in R.SITES for key in KEYS]
        flaps = [inj.link_down(edge, t) for edge in range(4)
                 for t in range(0, 40_000_000, 1_300_000)]
        uni = R.FailureInjector.uniform(seed, 0.3, flap_window_ns=1000)
        ufires = [uni.fires(s, k) for s in R.SITES for k in range(50)]
        got[pkg] = [fires, flaps, inj.snapshot(), ufires, uni.snapshot(),
                    inj.armed, uni.site_armed("hook_run"),
                    R.FailureInjector(seed).armed]
    assert got["repro_torch"] == got["repro"]


def test_injector_rejects_unknown_sites_and_ignores_zero_rates():
    R = faults("repro_torch")
    with pytest.raises(ValueError, match="unknown failure sites"):
        R.FailureInjector(0, {"migrate_copy": 0.1, "disk": 0.5})
    inj = R.FailureInjector(0, {"migrate_copy": 0.0})
    assert not inj.armed and not inj.fires("migrate_copy", 1)
    assert inj.checks["migrate_copy"] == 0


# ------------------------------------------------------ chaos differential
def _manager(pkg: str, topology: str, injector):
    c = importlib.import_module(f"{pkg}.core")
    hw = c.HWSpec()
    cost = c.make_cost_model(hw, kv_heads=4, head_dim=64)
    kw = dict(default_mode="thp", injector=injector)
    if pkg == "repro_torch":
        kw["device"] = "cpu"
    if topology == "2tier":
        mm = c.TieredMemoryManager(HBM_BLOCKS[topology], cost,
                                   host_blocks=128, **kw)
        mm.attach_tier_program(c.tier_damon_program())
    else:
        mm = c.TieredMemoryManager(
            HBM_BLOCKS[topology], cost,
            tiers=c.default_tier_chain(hw, (32, 64, 32)), **kw)
        mm.attach_tier_program(c.tier_heat_band_program())
    mm.load_profile(c.Profile("app", [
        c.ProfileRegion(0, 8, (0, 150_000, 600_000, 0)),
        c.ProfileRegion(8, VMA_MAX, (0, 0, 0, 0))]))
    mm.attach_fault_program(c.ebpf_mm_program(max_regions=8))
    return c, mm


def replay(pkg: str, topology: str, seed: int, route: str) -> list:
    """Drive ``make_script(seed)`` through one replica of package ``pkg``
    (as ``test_differential``'s ``Replica``/``run_step`` do) and return
    each step's state.  After every step the drained moves land on a
    modeled device pool, every newly mapped block gets its oracle value,
    and every block any process maps must read back its value."""
    c, mm = _manager(pkg, topology, faults(pkg).FailureInjector(
        seed, dict(CHAOS_RATES)))
    order_blocks = importlib.import_module(f"{pkg}.core.buddy").order_blocks
    batched = route == "batch"
    pool = np.full(mm.device_pool_blocks, -1, np.int64)
    expected: dict = {}
    vma: dict = {}

    def relieve(need):
        if mm.demote_cold_global(need) > 0:
            return
        victim = max(mm.procs, key=lambda p: (len(mm.procs[p].page_table),
                                              -p))
        st = mm.procs[victim]
        freed = 0
        for lg in sorted(st.page_table, reverse=True):
            if freed >= need:
                break
            n = order_blocks(st.page_table[lg].order)
            freed += n
            for b in range(lg, lg + n):
                expected.pop((victim, b), None)
            mm.unmap(victim, lg)

    def with_relief(fn, need):
        for _ in range(12):
            try:
                return fn()
            except c.MMOutOfMemory:
                relieve(need)
        raise AssertionError("workload does not fit")

    def scalar_decode(reqs):
        for pid, addr, kind in reqs:
            mm.ensure_mapped(pid, addr, kind)
        mm.place_decode(reqs)

    steps = []
    for i, s in enumerate(make_script(seed)):
        for pid in s.completes:
            if pid in vma:
                mm.free_process(pid)
                del vma[pid]
                expected = {k: v for k, v in expected.items() if k[0] != pid}
        for pid, v, prompt in s.admits:
            mm.create_process(pid, app="app", vma_blocks=v)
            vma[pid] = v
            fn = mm.fault_range if batched else mm.ensure_range
            with_relief(lambda p=pid, n=prompt: fn(p, 0, n), prompt)
        reqs = []
        for pid in (p for p in s.decodes if p in vma):
            st = mm.procs[pid]
            free = [a for a in range(st.vma_end) if a not in st.mapped]
            if free:
                reqs.append((pid, free[0], c.FaultKind.FIRST_TOUCH))
        if reqs:
            with_relief((lambda: mm.fault_batch(reqs)) if batched else
                        (lambda: scalar_decode(reqs)), len(reqs))
        for pid, heat in s.heats.items():
            if pid in vma:
                mm.record_access(pid, heat)
        for pid, addr, order in s.collapses:
            if pid in vma and addr < vma[pid]:
                mm.collapse(pid, addr, order)
        if s.spike:
            mm.demote_cold_global(s.spike)
        mm.promotion_scan()
        mm.tick()
        for src, dst, o in mm.drain_moves():
            n = order_blocks(o)
            pool[dst:dst + n] = pool[src:src + n]
        for pid in sorted(mm.procs):
            table = mm.block_table(pid, vma[pid])
            for lg in sorted(mm.procs[pid].mapped):
                if (pid, lg) not in expected:
                    expected[(pid, lg)] = _kv_value(pid, lg)
                    pool[table[lg]] = expected[(pid, lg)]
        for (pid, lg), val in expected.items():
            got = pool[mm.block_table(pid, vma[pid])[lg]]
            assert got == val, f"{pkg} step {i}: KV of pid {pid} block " \
                f"{lg} lost ({got} != {val})"
        steps.append({
            "tables": {str(p): sorted([m.logical_start, m.phys_start,
                                       m.order, m.tier]
                                      for m in st.page_table.values())
                       for p, st in mm.procs.items()},
            "mapped": {str(p): sorted(st.mapped)
                       for p, st in mm.procs.items()},
            "occupancy": [sorted([int(a), int(b)] for a, b in
                                 p.allocated.items()) for p in mm.pools],
            "stats": mm.stats.snapshot(), "fired": dict(mm.injector.fired),
            "supervisor": mm.hooks.supervisor.snapshot(),
            "health": mm.health.snapshot()})
    return steps


def _first_difference(a: list, b: list) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"step {i}: " + ", ".join(k for k in x if x[k] != y[k])
    return f"lengths {len(a)} / {len(b)}"


@pytest.mark.parametrize("topology,seed", list(itertools.product(
    TOPOLOGIES, SEEDS)))
def test_chaos_differential_matches_reference(reference, topology, seed):
    results, _ = reference
    port = {}
    for route in ("scalar", "batch"):
        ref = results["extra"]["differential"][f"{topology}/{seed}/{route}"]
        port[route] = replay("repro_torch", topology, seed, route)
        assert port[route] == ref, _first_difference(ref, port[route])
    assert port["batch"] == port["scalar"], \
        _first_difference(port["scalar"], port["batch"])
    last = port["batch"][-1]
    assert last["stats"]["demotions"] > 0
    assert all(last["fired"][site] > 0 for site in
               ("migrate_copy", "tier_alloc", "hook_run")), last["fired"]


def test_chaos_lane_fires_every_site(reference):
    """Over the lane's cases every armed site fired: copy errors,
    allocation failures, link flaps and hook runtime errors."""
    results, _ = reference
    fired = {site: sum(steps[-1]["fired"][site] for steps in
                       results["extra"]["differential"].values())
             for site in CHAOS_RATES}
    assert all(n > 0 for n in fired.values()), fired


# ----------------------------------------------------------------- engine
def _strikes_explained(out: dict) -> None:
    """Every supervisor strike is an injected ``hook_run`` failure: each
    hook's strikes are all runtime errors, and they add up to the
    injector's ``hook_run`` fires."""
    sup, inj = out["obs"]["supervisor"], out["obs"]["injector"]
    hooks = {h: v for h, v in sup.items() if isinstance(v, dict)}
    assert all(v["strikes"] == v["runtime_error"] for v in hooks.values())
    assert sum(v["runtime_error"] for v in hooks.values()) == \
        inj["hook_run"]["fired"] > 0


@pytest.mark.parametrize("route", ["batch", "scalar"])
def test_engine_chaos_matches_reference(reference, fresh_artifact_cache,
                                        route):
    results, params = reference
    ref = results[f"chaos/{route}"]
    port = drive("repro_torch", _tier_spec(route == "batch", CHAOS_RATE),
                 params, replay=ref["samples"], replay_heat=ref["accesses"])
    assert_same_run(ref, port, replayed=True)
    assert_same_observed(ref, port)
    inj = port["obs"]["injector"]
    assert inj["migrate_copy"]["fired"] > 0 and inj["hook_run"]["fired"] > 0
    assert port["obs"]["metrics"]["resilience_injector_seed"] == CHAOS_SEED
    tags = {e[1] for e in port["obs"]["ring"]}
    assert {EV_DETACH, EV_MIGRATE_HOP, EV_RETRY} <= tags
    _strikes_explained(port)
    # failures change placement, never data
    assert ref["finished"] == results["clean/batch"]["finished"]
    assert port["final"]["engine"]["completed"] == 6


def test_engine_chaos_routes_agree(reference, fresh_artifact_cache):
    """The port's two fault routes under one failure schedule: equal
    tokens, stats, tier snapshot, injector and supervisor state."""
    results, params = reference
    ref = results["chaos/batch"]
    runs = [drive("repro_torch", _tier_spec(b, CHAOS_RATE), params,
                  replay=ref["samples"], replay_heat=ref["accesses"])
            for b in (True, False)]
    for a in runs:
        assert_replay_agrees(ref, a)
    a, b = runs
    assert a["final"] == b["final"] and a["finished"] == b["finished"]
    assert a["tier"] == b["tier"]
    for key in ("injector", "supervisor"):
        assert a["obs"][key] == b["obs"][key], key


@pytest.mark.parametrize("route", ["batch", "scalar"])
def test_engine_chaos_route_split_matches_reference(reference,
                                                    fresh_artifact_cache,
                                                    route):
    """Where the reference's two routes part under chaos, each of the
    port's routes still equals the reference's same route."""
    results, params = reference
    ref = results[f"split/{route}"]
    assert results["split/batch"]["final"] != \
        results["split/scalar"]["final"]
    port = drive("repro_torch", _tier_spec(route == "batch", SPLIT_RATE),
                 params, replay=ref["samples"], replay_heat=ref["accesses"])
    assert_same_run(ref, port, replayed=True)
    assert_same_observed(ref, port)
    _strikes_explained(port)
    assert ref["finished"] == results["clean/batch"]["finished"]
