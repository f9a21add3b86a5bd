"""The port's online profiling plane against the reference, bit for bit.

* A scripted ``MemoryManager`` in both packages: three processes of two
  apps, a moving hot span of DAMON heat, the profiler program on
  ``HOOK_PROFILE`` and a ``ProfileSynthesizer`` ticking every other round,
  fault batches between rounds.  ``profile_scan`` rows, the synthesized
  profiles, the apps reloaded and their versions, the ``EV_WSS`` /
  ``EV_PROFILE`` and program ring events, the WSS curve, ``snapshot()`` and
  the manager's stats must equal the reference's, for each of the three
  profiler programs (the port's batch executor on the CPU).
* A reload in the middle of a run: the port's batched fault decisions (the
  predicated executor, and the pc-walking fallback built before the
  reload) follow the reloaded map and equal ``PolicyVM``'s.
* The engine: W1 with ``policy="ebpf", profile="auto"`` (and telemetry) on
  both fault routes against the reference's: engine and mm stats, the
  profiler snapshot, profiles and WSS curve, the ring's modeled-clock events
  and every modeled metric.
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest

from test_torch_engine import (assert_same_observed, assert_same_run, drive,
                               modeled_ring, run_reference, workload_spec)
from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

PROGRAMS = ("profile_wss_program", "profile_heat_histogram_program",
            "profile_benefit_program")
APPS = ((1, "chat"), (2, "chat"), (3, "code"))


def _auto_spec(batch: bool) -> dict:
    spec = workload_spec("W1", "ebpf", batch)
    spec["profile"] = "auto"
    spec["engine"]["telemetry"] = True
    return spec


def _spec_cases() -> dict:
    return {f"W1/auto/{'batch' if b else 'scalar'}": _auto_spec(b)
            for b in (True, False)}


def _reference_extra(params) -> dict:
    return {"scripts": {p: profiler_script("repro", p) for p in PROGRAMS}}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "test_torch_profiler")


def _mm(pkg: str, **kw):
    c = importlib.import_module(f"{pkg}.core")
    if pkg == "repro_torch":
        kw["device"] = "cpu"
    cost = c.make_cost_model(c.HWSpec(), kv_heads=4, head_dim=64)
    return c, c.MemoryManager(256, cost, **kw)


def profiler_script(pkg: str, program: str) -> dict:
    o = importlib.import_module(f"{pkg}.obs")
    tel = o.Telemetry()
    c, mm = _mm(pkg, telemetry=tel)
    mm.load_profile(c.Profile("_default", []))
    mm.attach_fault_program(c.ebpf_mm_program(max_regions=8))
    mm.attach_profile_program(getattr(c, program)())
    syn = c.ProfileSynthesizer(mm, mm.cost, period=2, max_regions=8,
                               telemetry=tel)
    for pid, app in APPS:
        mm.create_process(pid, app=app, vma_blocks=64)
        mm.fault_range(pid, 0, 16)
    rng = np.random.default_rng(11)
    rounds = []
    for rnd in range(10):
        for pid, _ in APPS:
            heat = rng.random(64) * 0.2
            lo = (4 * rnd + 8 * pid) % 48
            heat[lo:lo + 12 + pid] += 3.0 + pid     # the moving hot span
            heat[rng.random(64) < 0.3] = 0.0
            mm.record_access(pid, heat)
        mm.tick()
        reloaded = syn.tick(list(APPS))
        mm.fault_batch([(pid, 16 + 2 * rnd, c.FaultKind.FIRST_TOUCH)
                        for pid, _ in APPS])
        rounds.append({
            "reloaded": reloaded, "versions": dict(syn.versions),
            "profiles": {app: [[r.start, r.end, list(r.benefit)]
                               for r in p.regions]
                         for app, p in syn.profiles.items()},
            "maps": [list(m.as_array()) for m in
                     (mm.maps[i] for i in range(len(mm.maps)))],
            "scan": mm.profile_scan(1 + rnd % 3)})
    return json.loads(json.dumps({
        "rounds": rounds, "ring": modeled_ring(tel.ring.peek().tolist()),
        "curve": syn.wss_curve_doc(), "snapshot": syn.snapshot(),
        "stats": mm.stats.snapshot(), "counters": tel.counters,
        "invocations": mm.hooks.invocations,
        "supervisor": mm.hooks.supervisor.snapshot()}, default=int))


@pytest.mark.parametrize("program", PROGRAMS)
def test_profiler_script_matches_reference(reference, program):
    results, _ = reference
    ref = results["extra"]["scripts"][program]
    port = profiler_script("repro_torch", program)
    for i, (a, b) in enumerate(zip(ref["rounds"], port["rounds"])):
        assert b == a, f"round {i}: " + ", ".join(k for k in a if a[k] != b[k])
    for key in ("ring", "curve", "snapshot", "stats", "counters",
                "invocations", "supervisor"):
        assert port[key] == ref[key], key
    if program == "profile_wss_program":
        assert port["snapshot"]["reloads"] >= 2
        assert any(r["reloaded"] for r in port["rounds"][4:])


def _reload(c, mm, hot: slice) -> int:
    """One synthesizer tick over ``chat`` with heat hot on ``hot``;
    returns the reloaded map's version."""
    syn = c.ProfileSynthesizer(mm, mm.cost, period=1, max_regions=8)
    heat = np.zeros(64)
    heat[hot] = 9.0
    for _ in range(6):
        mm.record_access(1, heat)
        mm.tick()
    assert syn.tick([(1, "chat")]) == ["chat"]
    return mm.maps.version()


def check_reload_follows(device: str) -> None:
    """The predicated executor caches its ``device`` copy of the maps by
    ``maps.version()``: after a hot reload its decisions, and those of a
    pc-walking executor built before the reload, follow the new profile
    and equal the interpreter's (as does the scalar route)."""
    from repro_torch.core.hooks import HOOK_FAULT
    c = importlib.import_module("repro_torch.core")
    mm = c.MemoryManager(256, c.make_cost_model(c.HWSpec(), kv_heads=4,
                                                head_dim=64), device=device)
    mm.load_profile(c.Profile("chat", []))
    prog = c.ebpf_mm_program(max_regions=8)
    mm.attach_fault_program(prog)
    mm.attach_profile_program(c.profile_wss_program())
    mm.create_process(1, app="chat", vma_blocks=64)
    jit = c.JitPolicy(prog, mm.maps, device=device)
    reqs = [(1, a, c.FaultKind.FIRST_TOUCH) for a in range(0, 64, 3)]
    seen = []
    for hot in (None, slice(0, 24), slice(32, 64)):
        if hot is not None:
            v = _reload(c, mm, hot)
            assert v != seen[-1][0]
        mat = mm._build_ctx_batch(reqs)
        vm = c.PolicyVM(prog, mm.maps)
        want = np.asarray([vm.run(row).ret for row in mat], np.int64)
        got = mm.hooks.run_batch(HOOK_FAULT, mat)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(jit.run_batch(mat), want)
        assert [mm.hooks.run(HOOK_FAULT, row) for row in mat] == \
            want.tolist()
        seen.append((mm.maps.version(), want.tolist()))
    decisions = [d for _, d in seen]
    assert decisions[0] != decisions[1] != decisions[2]
    assert mm.hooks._hooks[HOOK_FAULT].pred.device.type == device


def test_reload_mid_run_batched_decisions_follow():
    check_reload_follows("cpu")


@pytest.mark.parametrize("case", list(_spec_cases()))
def test_engine_auto_profile_matches_reference(reference, case):
    results, params = reference
    ref = results[case]
    port = drive("repro_torch", _spec_cases()[case], params)
    assert_same_run(ref, port)
    assert_same_observed(ref, port)
    prof = port["obs"]["profiler"]
    assert prof["reloads"] >= 1 and prof["apps"]["chat"]["regions"] >= 1
    assert port["final"]["mm"]["hinted_faults"] > 0
    assert port["obs"]["supervisor"]["detaches"] == 0
    tags = {e[1] for e in port["obs"]["ring"]}
    assert {17, 18} <= tags                     # EV_PROFILE, EV_WSS


def test_engine_wss_curve_export(reference, tmp_path):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.hooks import HOOK_PROFILE
    from repro_torch.models import PagedLayout
    from repro_torch.serving import Request, ServingEngine
    _, params = reference
    cfg = get_smoke_config("deepseek_7b")
    eng = ServingEngine(cfg, params, PagedLayout(num_blocks=64,
                                                 block_tokens=4,
                                                 max_blocks=16),
                        max_batch=2, policy="ebpf", profile="auto",
                        profile_period=1, device="cpu")
    assert eng.profiler.period == 1
    assert eng.mm.hooks._hooks[HOOK_PROFILE].pred is not None
    rng = np.random.default_rng(2)
    eng.submit(Request(rid=0, prompt=rng.integers(1, cfg.vocab, 24).tolist(),
                       max_new_tokens=8))          # no app: "_default"
    out = eng.run()
    assert out["profiler"]["scans"] > 0
    assert eng.mm.procs == {} and "_default" in eng.mm.profiles
    eng.write_wss_curve(tmp_path / "wss.json")
    curve = json.loads((tmp_path / "wss.json").read_text())
    assert list(curve) == ["1"] and all(len(s) == 3 for s in curve["1"])
    with pytest.raises(ValueError, match="unknown profile mode"):
        ServingEngine(cfg, params, PagedLayout(64, 4, 16), policy="ebpf",
                      profile="offline", device="cpu")
