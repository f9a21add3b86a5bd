"""The port's observability and artifact cache against the reference.

* ``Log2Hist``, ``flatten_metrics`` / ``render_prometheus``, the
  ``Telemetry`` hub and the Chrome-trace exporter: the same inputs through
  both packages give the same buckets, percentiles, text, snapshots and
  trace events.
* The artifact cache: LRU eviction under the size cap, a corrupt pickle and
  an injected ``cache_corrupt`` both recompile, a pickle the reference wrote
  under the same root is never read, and ``warm`` hits on a second
  registry.
* The engine: W1 with ``telemetry=True, trace=True`` on both fault routes,
  and the prefix-cache workloads of ``test_torch_prefix.py`` (hits,
  evictions) with telemetry, against the reference's (``test_torch_engine``'s
  ``drive``, the reference in a child process): stats, tokens, moves, the
  metric key set and every modeled metric value, and the ring's
  modeled-clock events bit for bit; telemetry on or off leaves the port's
  run unchanged.
* The port's own tracing (no counterpart in the reference): device spans
  on the telemetry's clock (the anchor arithmetic on a fake device clock,
  resolved only after a synchronisation, nothing recorded without
  tracing), the host phases' nesting in a traced engine, the device's
  idle time by host phase, and the Chrome trace's device track.
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest

from test_torch_engine import (_smoke_engine_args, assert_same_observed,
                               assert_same_run, drive, modeled_ring,
                               run_reference, workload_spec)
from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)
from test_torch_prefix import _spec_cases as prefix_cases

PKGS = ("repro", "repro_torch")


def _spec(batch: bool, workload: str = "W1") -> dict:
    spec = workload_spec(workload, "ebpf", batch)
    spec["engine"].update(telemetry=True, trace=True)
    return spec


def _spec_cases() -> dict:
    cases = {f"W1/ebpf/{'batch' if b else 'scalar'}/trace": _spec(b)
             for b in (True, False)}
    cases["W2/ebpf/batch/trace"] = _spec(True, "W2")     # preemptions
    for name in ("prefix/on", "prefix/mixed"):
        spec = dict(prefix_cases()[name])
        spec["engine"] = dict(spec["engine"], telemetry=True)
        cases[f"{name}/telemetry"] = spec
    return cases


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "test_torch_obs")


def obs(pkg: str):
    return importlib.import_module(f"{pkg}.obs")


# ------------------------------------------------------------- histograms
HIST_VALUES = {
    "edges": [0, -5, 1, 2, 3, 4, 7, 8, 1023, 1024, 1025],
    "wide": [2 ** k - 1 for k in range(1, 63)] + [2 ** 62, 2 ** 63 - 1],
    "random": np.random.default_rng(0).integers(-10, 10 ** 9, 500).tolist(),
}


@pytest.mark.parametrize("values", list(HIST_VALUES))
def test_log2hist_matches_reference(values):
    vals = HIST_VALUES[values]
    snaps = {}
    for pkg in PKGS:
        H = obs(pkg).Log2Hist
        one, many = H(), H()
        for v in vals:
            one.observe(v)
        many.observe_many(vals)
        many.observe_many([])
        assert [H.bucket(v) for v in vals] == \
            [obs("repro").Log2Hist.bucket(v) for v in vals]
        snaps[pkg] = [one.snapshot(), many.snapshot(),
                      [one.percentile(p) for p in (0, 1, 50, 90, 99, 100)],
                      [H.bucket_hi(k) for k in range(64)]]
    assert snaps["repro_torch"] == snaps["repro"]


# ---------------------------------------------------------------- metrics
def test_metrics_text_matches_reference():
    sections = {"engine": {"steps": 3, "wall": 0.125, "ok": True},
                "mm": {"faults": 7, "name": "skipped", "none": None},
                "tiers": [{"free": 4, "used": 2}, {"free": 9, "used": 0}],
                "vec": [1, 2.5, True, "x"], "odd key-1": {"a.b": 1e-9},
                "huge": 2 ** 62}
    out = {pkg: (obs(pkg).flatten_metrics(sections),
                 obs(pkg).render_prometheus(
                     obs(pkg).flatten_metrics(sections)),
                 obs(pkg).render_prometheus({"x": 1}, namespace="ns"))
           for pkg in PKGS}
    assert out["repro_torch"] == out["repro"]


# -------------------------------------------------------------- telemetry
def _populated(pkg: str):
    """A hub fed the same producer calls, spans with fixed times."""
    o = obs(pkg)
    tel = o.Telemetry(ring_capacity=16, trace=True)
    for i in range(20):                         # overflows the ring
        tel.emit(o.EV_FAULT, i, 2 * i, 3, ts=1000 + i)
    tel.ring.drain()
    events = [(5_000, o.EV_MIGRATE_HOP, (0 << 8) | 1, 131072, 40_000),
              (6_000, o.EV_MIGRATE_HOP, (1 << 8) | 2, 131072, 900_000),
              (7_000, o.EV_WSS, 3, 12, 40), (7_500, o.EV_WSS, 3, 50, 20),
              (8_000, o.PROF_TAG_HEAT, 3, 4, 16),
              (9_000, o.EV_PROFILE, 3, 2, 1),
              (9_500, o.EV_PREEMPT, 2, 7, 96),
              (9_700, o.EV_PROG_BASE + 9, 1, 2, 3)]
    for ts, tag, a0, a1, a2 in events:
        tel.emit(tag, a0, a1, a2, ts=ts)
    tel.inc("profile_scans")
    tel.inc("profile_scans", 4)
    for hook, ns, b in (("mm_fault", 1500, 4), ("mm_fault", 90_000, 16),
                        ("mm_tier", 7, 1)):
        tel.observe_hook(hook, ns, b)
    tel.observe_migrate(40_000)
    tel.observe_ttft(123_456)
    tel.observe_decode_token(1_000_000, 3)
    tel.observe_decode_token(5, 0)
    tel.observe_residency([0, 0, 1], [0, 2, 1], [1, 16, 4])
    tel.observe_residency([2], [3], [64])
    tel.observe_residency([], [], [])
    tel.mgmt_step_ns.observe(77)
    tel.prog_lane_drops += 2
    tel.spans += [("step 0", "engine", "engine", 0, 2_500),
                  ("decode", "engine", "engine", 100, 1_900),
                  ("mm-tick", "engine", "mm", 2_000, 400),
                  ("req 0", "request", "requests", 0, 9_999)]
    return tel


def test_telemetry_snapshot_matches_reference():
    snaps = {}
    for pkg in PKGS:
        tel = _populated(pkg)
        off = obs(pkg).Telemetry.disabled()
        off.emit(1, 2, 3, 4)
        off.inc("x")
        off.observe_hook("mm_fault", 5, 1)
        with off.span("step"):
            pass
        snaps[pkg] = [tel.snapshot(), off.snapshot(), off.poll_events(),
                      off.spans, tel.poll_events(), tel.snapshot()["ring"]]
    assert snaps["repro_torch"] == snaps["repro"]


def test_chrome_trace_matches_reference(tmp_path):
    traces = {pkg: obs(pkg).chrome_trace(_populated(pkg)) for pkg in PKGS}
    assert traces["repro_torch"] == traces["repro"]
    path = tmp_path / "trace.json"
    obs("repro_torch").write_chrome_trace(_populated("repro_torch"), path)
    assert json.loads(path.read_text()) == json.loads(json.dumps(
        traces["repro"]))
    names = {e["name"] for e in traces["repro_torch"]["traceEvents"]}
    assert {"hop t0->t1", "hop t1->t2", "wss pid3", "heat b4 pid3",
            "profile reload v1", "decode", "mm-tick"} <= names


def test_span_is_free_without_trace():
    tel = obs("repro_torch").Telemetry()
    with tel.span("step"):
        pass
    assert tel.spans == [] and not tel.trace_enabled
    tel = obs("repro_torch").Telemetry(trace=True)
    with tel.span("step", tid="mm"):
        pass
    (name, cat, tid, t0, dur), = tel.spans
    assert (name, cat, tid) == ("step", "engine", "mm") and dur >= 0


# --------------------------------------------------------- artifact cache
def _lowered(pkg: str, cap: int = 600):
    """The Figure-1 program lowered against one map of ``cap`` slots: the
    capacity is part of the digest, not of the unroll's size."""
    c = importlib.import_module(f"{pkg}.core")
    maps = c.MapRegistry()
    maps.register(c.ArrayMap(cap, name="profile:x"))
    return c, c.lower(c.ebpf_mm_program(max_regions=8), maps)


def _cache(root, **kw):
    from repro_torch.core.cache import ArtifactCache
    return ArtifactCache(root=root, **kw)


def test_cache_lru_evicts_oldest_under_cap(tmp_path):
    import os
    lps = [_lowered("repro_torch", cap)[1] for cap in (600, 601, 602, 603)]
    probe = _cache(tmp_path / "probe")
    probe.unrolled(lps[0])
    one = next((tmp_path / "probe" / "ebpf_torch").glob("*.pkl"))
    cache = _cache(tmp_path, max_bytes=int(one.stat().st_size * 2.5))
    for i, lp in enumerate(lps):
        cache.unrolled(lp)
        p = tmp_path / "ebpf_torch" / f"unroll-{lp.digest()}.pkl"
        os.utime(p, (1_000_000 + i, 1_000_000 + i))   # distinct last-used
    left = sorted(p.name for p in (tmp_path / "ebpf_torch").glob("*.pkl"))
    assert cache.stats["evictions"] == 2
    assert left == sorted(f"unroll-{lp.digest()}.pkl" for lp in lps[2:])
    roomy = _cache(tmp_path / "roomy")
    for lp in lps:
        roomy.unrolled(lp)
    assert roomy.stats["evictions"] == 0
    assert len(list((tmp_path / "roomy" / "ebpf_torch").glob("*.pkl"))) == 4


def test_cache_corrupt_pickle_recompiles(tmp_path):
    c, lp = _lowered("repro_torch")
    want = c.unroll_lowered(lp)
    _cache(tmp_path).unrolled(lp)
    path = tmp_path / "ebpf_torch" / f"unroll-{lp.digest()}.pkl"
    path.write_bytes(path.read_bytes()[:40])            # truncated
    cold = _cache(tmp_path)
    assert cold.unrolled(lp) == want
    assert (cold.stats["unroll_misses"], cold.stats["miss_corrupt"],
            cold.stats["miss_absent"]) == (1, 1, 0)
    healed = _cache(tmp_path)                   # the rewrite healed it
    assert healed.unrolled(lp) == want
    assert healed.stats["unroll_disk_hits"] == 1
    off = _cache("")                            # persistence off
    assert off.unrolled(lp) == want and not off.enabled
    assert off.stats["miss_absent"] == 1


def test_cache_injected_corruption_recompiles(tmp_path):
    from repro_torch.resilience import FailureInjector
    c, lp = _lowered("repro_torch")
    _cache(tmp_path).unrolled(lp)
    inj = FailureInjector(0, {"cache_corrupt": 1.0})
    cold = _cache(tmp_path)
    assert cold.unrolled(lp, injector=inj) == c.unroll_lowered(lp)
    assert cold.stats["miss_corrupt"] == 1
    assert inj.fired["cache_corrupt"] == inj.checks["cache_corrupt"] == 1
    cold.unrolled(lp, injector=inj)             # in-process hit: no check
    assert inj.checks["cache_corrupt"] == 1


def test_cache_never_reads_reference_pickle(tmp_path):
    """The two packages' digests agree, so the reference's pickle sits at
    ``<root>/ebpf/unroll-<digest>.pkl``; the port looks only under
    ``<root>/ebpf_torch`` and unrolls for itself."""
    from repro.core.cache import ArtifactCache as RefCache
    from repro_torch.core.lower import LIns
    _, ref_lp = _lowered("repro")
    c, lp = _lowered("repro_torch")
    assert lp.digest() == ref_lp.digest()
    RefCache(root=tmp_path).unrolled(ref_lp)
    ref_pkl = tmp_path / "ebpf" / f"unroll-{lp.digest()}.pkl"
    assert ref_pkl.exists()
    port = _cache(tmp_path)
    code, cuts = port.unrolled(lp)
    assert (port.stats["miss_absent"], port.stats["unroll_disk_hits"]) == \
        (1, 0)
    again = _cache(tmp_path)
    code2, _ = again.unrolled(lp)
    assert again.stats["unroll_disk_hits"] == 1
    assert all(type(i) is LIns for i in code + code2)
    assert sorted(p.name for p in (tmp_path / "ebpf_torch").iterdir()) == \
        [ref_pkl.name]
    assert ref_pkl.exists()


def test_warm_hits_on_second_registry(tmp_path):
    """``warm`` builds through the cache: a second registry on the same
    cache hits in memory, one on a fresh cache over the same root hits on
    disk, one whose injector corrupts the read recompiles; each build
    emits EV_COMPILE and EV_CACHE."""
    from repro_torch.core import (HOOK_FAULT, ArrayMap, HookRegistry,
                                  MapRegistry, ebpf_mm_program)
    from repro_torch.obs import EV_CACHE, EV_COMPILE, Telemetry
    from repro_torch.resilience import FailureInjector
    cache = _cache(tmp_path)
    tel = Telemetry()

    def registry(cache, injector=None):
        reg = HookRegistry(cache=cache, telemetry=tel, injector=injector,
                           device="cpu")
        maps = MapRegistry()
        maps.register(ArrayMap(600, name="profile:x"))
        reg.attach(HOOK_FAULT, ebpf_mm_program(max_regions=8), maps)
        reg.warm(HOOK_FAULT, max_batch=16)
        return reg
    registry(cache)
    assert (cache.stats["unroll_misses"], cache.stats["unroll_hits"]) == \
        (1, 0)
    registry(cache)
    assert (cache.stats["unroll_misses"], cache.stats["unroll_hits"]) == \
        (1, 1)
    disk = _cache(tmp_path)
    registry(disk)
    assert disk.stats["unroll_disk_hits"] == 1
    # the registry's injector reaches the cache: an injected corrupt read
    # recompiles, and EV_CACHE carries the corrupt miss in a1's high bits
    corrupt = _cache(tmp_path)
    inj = FailureInjector(0, {"cache_corrupt": 1.0})
    registry(corrupt, inj)
    assert corrupt.stats["miss_corrupt"] == 1
    assert inj.fired["cache_corrupt"] == 1
    ring = tel.ring.peek()
    assert [int(t) for t in ring[:, 1]] == [EV_COMPILE, EV_CACHE] * 4
    assert ring[-1, 3] == 1 | (1 << 24)
    assert tel.counters["backend_builds"] == 4


# ----------------------------------------------------------------- engine
@pytest.mark.parametrize("case", [c for c in _spec_cases()
                                  if c.startswith("prefix/")])
def test_prefix_cache_events_match_reference(reference, case):
    """The prefix cache's EV_CACHE_HIT / EV_EVICT tracepoints (the runs
    replay the reference's tokens, as ``test_torch_prefix`` does)."""
    from repro_torch.obs import EV_CACHE_HIT, EV_EVICT
    results, params = reference
    ref = results[case]
    port = drive("repro_torch", _spec_cases()[case], params,
                 replay=ref["samples"])
    assert_same_run(ref, port, replayed=True)
    assert_same_observed(ref, port)
    tags = [e[1] for e in port["obs"]["ring"]]
    assert EV_CACHE_HIT in tags
    if case == "prefix/mixed/telemetry":
        assert EV_EVICT in tags


@pytest.mark.parametrize("case", [c for c in _spec_cases()
                                  if c.startswith("W")])
def test_engine_telemetry_matches_reference(reference, case):
    results, params = reference
    ref = results[case]
    port = drive("repro_torch", _spec_cases()[case], params)
    assert_same_run(ref, port)
    assert_same_observed(ref, port)
    o = port["obs"]
    names = {s[0] for s in o["spans"]}
    assert {"decode", "mm-tick", "step 0", "prefill rid=0",
            "req 0"} <= names
    m = o["metrics"]
    # one first token per request: a preempted request's second prefill
    # does not count again
    assert m["telemetry_request_ttft_ns_count"] == len(port["finished"])
    if case.startswith("W2"):
        from repro_torch.obs import EV_PREEMPT
        assert port["final"]["engine"]["preemptions"] > 0
        assert EV_PREEMPT in {e[1] for e in o["ring"]}
    assert m["telemetry_decode_token_ns_count"] == \
        port["final"]["engine"]["decode_tokens"]
    assert m["telemetry_ring_emitted"] == len(o["ring"]) > 0
    assert m["telemetry_ring_dropped"] == 0


def _untraced(spec: dict, telemetry: bool) -> dict:
    spec = dict(spec, engine=dict(spec["engine"]))
    spec["engine"].pop("trace", None)
    spec["engine"].pop("telemetry", None)
    if telemetry:
        spec["engine"]["telemetry"] = True
    return spec


def test_telemetry_leaves_run_unchanged(reference):
    """Telemetry and trace on or off: the same tokens, stats, moves and hook
    counters; trace on or off under telemetry: the same modeled-clock ring
    events.  W1 on both routes, W2 (preemptions) and the prefix-cache
    workloads, each traced."""
    _, params = reference
    for case in ("W1/ebpf/batch/trace", "W1/ebpf/scalar/trace",
                 "W2/ebpf/batch/trace", "prefix/on/telemetry",
                 "prefix/mixed/telemetry"):
        spec = _spec_cases()[case]
        traced = dict(spec, engine=dict(spec["engine"], trace=True))
        on = drive("repro_torch", traced, params)
        tel = drive("repro_torch", _untraced(spec, True), params)
        off = drive("repro_torch", _untraced(spec, False), params)
        assert_same_run(on, off)
        assert_same_run(tel, off)
        assert modeled_ring(on["obs"]["ring"]) == \
            modeled_ring(tel["obs"]["ring"])
        assert on["obs"]["spans"] and tel["obs"]["spans"] == []
        assert "ring" not in off["obs"]
        assert not any(k.startswith("telemetry_")
                       for k in off["obs"]["metrics"])


def test_engine_trace_and_metrics_export(reference, tmp_path):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core import Profile, ProfileRegion
    from repro_torch.models import PagedLayout
    from repro_torch.serving import Request, ServingEngine
    _, params = reference
    cfg = get_smoke_config("deepseek_7b")
    layout = PagedLayout(num_blocks=64, block_tokens=4, max_blocks=16)
    prof = Profile("chat", [ProfileRegion(0, 4, (0, 150_000, 600_000, 0))])
    eng = ServingEngine(cfg, params, layout, max_batch=2, policy="ebpf",
                        profile=prof, trace=True, device="cpu")
    rng = np.random.default_rng(1)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            1, cfg.vocab, 20).tolist(), max_new_tokens=6, app="chat"))
    n = 0
    while eng.step():
        n += 1
        if n == 3:
            live = eng.poll_events()            # destructive mid-run drain
            assert live and all(set(e) == {"ts", "tag", "name", "a0", "a1",
                                           "a2"} for e in live)
    out = eng.run()
    assert out["engine"]["completed"] == 3 and "telemetry" in out
    eng.write_trace(tmp_path / "t.json")
    doc = json.loads((tmp_path / "t.json").read_text())
    host = [e for e in doc["traceEvents"] if e["ph"] == "X" and
            e["pid"] == 1]
    assert {e["name"] for e in host} >= {"decode", "mm-tick", "req 2"}
    assert all(e["dur"] >= 0 for e in host)
    text = eng.metrics_text()
    assert text.endswith("\n") and "repro_engine_completed 3" in text
    with pytest.raises(ValueError, match="online profiler"):
        eng.write_wss_curve(tmp_path / "w.json")
    plain = ServingEngine(cfg, params, layout, max_batch=2, policy="thp",
                          device="cpu")
    assert plain.telemetry is None and plain.poll_events() == []
    with pytest.raises(ValueError, match="without telemetry"):
        plain.write_trace(tmp_path / "x.json")


# ------------------------------------------------- the port's own tracing
class _Device:
    """A fake device clock: ``now`` is the device time an event recorded
    now gets, ``done`` how far the device has run."""

    def __init__(self, now: int):
        self.now, self.done = now, now


class _Event:
    def __init__(self, dev: _Device):
        self.dev, self.t = dev, None

    def record(self):
        self.t = self.dev.now

    def query(self) -> bool:
        return self.t <= self.dev.done

    def elapsed_time(self, end) -> float:           # ms, as CUDA's
        return (end.t - self.t) / 1e6


def _fake_card(tel, host_ns: int, dev_ns: int):
    """Point ``tel``'s host clock and its CUDA events at fakes."""
    host, dev = [host_ns], _Device(dev_ns)
    tel.now = lambda: host[0]
    tel._event = lambda: (tel._spare.pop() if tel._spare else _Event(dev))
    return host, dev


def test_device_span_anchor_arithmetic():
    """A device timestamp is the anchor's host time plus the anchor's
    elapsed time to the event; the first span records the anchor, every
    resolve a new one; spent events are reused."""
    from repro_torch.obs import Telemetry
    tel = Telemetry(trace=True)
    host, dev = _fake_card(tel, 1_000, 7_000_000)
    with tel.device_span("dev decode", "cuda"):    # anchor (1_000, 7e6)
        dev.now += 900
    dev.done = dev.now
    host[0] = 5_000
    tel.resolve_device()                           # anchor (5_000, 7e6+900)
    assert tel.spans == [("dev decode", "device", "stream", 1_000, 900)]
    dev.now += 1_100
    with tel.device_span("dev policy", "cuda:0"):
        dev.now += 500
    dev.done = dev.now
    host[0] = 9_000
    tel.resolve_device()
    assert tel.spans[1] == ("dev policy", "device", "stream", 6_100, 500)
    assert len(tel._spare) == 3 and tel._anchor[0] == 9_000


def test_device_span_resolves_only_after_a_sync():
    """A span waits in the pending list until a resolve finds its end
    event done; a resolve before that keeps it.  On the CPU the marks are
    host-clock readings, and the span still waits for the resolve."""
    from repro_torch.obs import Telemetry
    tel = Telemetry(trace=True)
    host, dev = _fake_card(tel, 100, 0)
    with tel.device_span("dev prefill", "cuda"):
        dev.now = 2_000
    assert tel.spans == []
    tel.resolve_device()                       # the device is not done
    assert tel.spans == [] and len(tel._pending) == 1
    dev.done = 2_000
    tel.resolve_device()
    assert tel.spans == [("dev prefill", "device", "stream", 100, 2_000)]
    assert tel._pending == []
    cpu = Telemetry(trace=True)
    with cpu.device_span("dev copy", "cpu"):
        pass
    assert cpu.spans == [] and cpu._anchor is None
    cpu.resolve_device()
    (name, cat, tid, t0, dur), = cpu.spans
    assert (name, cat, tid) == ("dev copy", "device", "stream") and dur >= 0


@pytest.mark.parametrize("telemetry", [None, True])
def test_untraced_engine_records_no_span(monkeypatch, telemetry):
    """Without tracing (no telemetry, or telemetry without trace) no site
    enters a span or a device span, makes an event or resolves one."""
    from repro_torch.obs import Telemetry
    from repro_torch.serving import Request, ServingEngine

    def boom(*a, **kw):
        raise AssertionError("a span site ran without tracing")
    for name in ("span", "device_span", "resolve_device", "_event",
                 "_mark"):
        monkeypatch.setattr(Telemetry, name, boom)
    cfg, params, layout = _smoke_engine_args()
    from repro_torch.core import Profile, ProfileRegion
    prof = Profile("chat", [ProfileRegion(0, 4, (0, 150_000, 600_000, 0))])
    eng = ServingEngine(cfg, params, layout, max_batch=2, policy="ebpf",
                        profile=prof, prefix_cache=8, host_blocks=16,
                        telemetry=telemetry, device="cpu")
    rng = np.random.default_rng(2)
    shared = rng.integers(1, cfg.vocab, 12).tolist()
    for rid in range(5):
        eng.submit(Request(rid=rid, prompt=shared + rng.integers(
            1, cfg.vocab, 7).tolist(), max_new_tokens=9, app="chat"))
    out = eng.run()
    assert out["engine"]["completed"] == 5
    assert out["prefix_cache"]["hits"] > 0
    if telemetry:
        assert eng.telemetry.spans == [] and eng.telemetry._pending == []
        assert eng._queued == {}


def _inside(x, y, slack: int = 0) -> bool:
    return y[3] - slack <= x[3] and x[3] + x[4] <= y[3] + y[4] + slack


def _holder(x, spans, names) -> tuple | None:
    """The innermost span named in ``names`` (or by a prefix ending in a
    space or '=') that holds ``x``."""
    hold = [y for y in spans if y is not x and _inside(x, y) and (
        y[0] in names or any(y[0].startswith(n) for n in names
                             if n[-1] in " ="))]
    return min(hold, key=lambda y: y[4]) if hold else None


@pytest.mark.parametrize("case", ["W2/ebpf/batch/trace",
                                  "W1/ebpf/scalar/trace", "prefix/mixed"])
def test_engine_spans_nest(reference, monkeypatch, case):
    """Every host phase of a decode or a prefill lies inside its ``decode``
    or ``prefill rid=`` span; every device span inside the host span of
    its site (``dev decode`` / ``dev prefill`` in a ``graph`` span of a
    decode / a prefill, ``dev copy`` in ``moves``, ``dev policy`` in a
    phase that runs a policy program); each ``queue rid=N`` span ends
    before a ``prefill rid=N`` starts, one for each prefill; every span is
    of the reference's categories or the port's."""
    import repro_torch.serving as serving
    _, params = reference
    if case.startswith("prefix"):
        spec = dict(prefix_cases()[case])
        spec["engine"] = dict(spec["engine"], trace=True)
    else:
        spec = _spec_cases()[case]
    engines = []

    class Keep(serving.ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)
    monkeypatch.setattr(serving, "ServingEngine", Keep)
    drive("repro_torch", spec, params)
    spans = engines[0].telemetry.spans
    names = {s[0] for s in spans}
    assert {"admit", "faults", "tables", "graph", "sample", "access",
            "moves", "dev decode", "dev prefill"} <= names
    # the scalar route runs its programs one fault at a time, on no device
    assert ("dev policy" in names) == ("scalar" not in case)
    sites = {"dev decode": ("graph",), "dev prefill": ("graph",),
             "dev copy": ("moves",),
             "dev policy": ("faults", "fault-range", "mm-tick", "prefix")}
    for s in spans:
        assert s[1] in ("engine", "request", "phase", "wait", "device",
                        "setup") and s[4] >= 0
        if s[0] in ("faults", "tables", "graph", "sample", "access"):
            assert _holder(s, spans, ("decode", "prefill rid=")), s
        if s[1] == "device":
            g = _holder(s, spans, sites[s[0]])
            assert g is not None, s
            if s[0] == "dev decode":
                assert _holder(g, spans, ("decode",)), s
            elif s[0] == "dev prefill":
                assert _holder(g, spans, ("prefill rid=",)), s
    prefills = [s for s in spans if s[0].startswith("prefill rid=")]
    queues = [s for s in spans if s[0].startswith("queue rid=")]
    assert len(queues) == len(prefills) > 0
    for q in queues:
        rid = q[0].split("=")[1]
        assert q[1] == "wait" and any(
            p[0] == f"prefill rid={rid}" and q[3] + q[4] <= p[3]
            for p in prefills), q
    if case.startswith("W2"):
        assert "dev copy" in names


def test_idle_by_phase_on_synthetic_spans():
    """Idle instants go to the innermost host phase open there (engine,
    phase and setup spans; wait and request spans never), or to
    ``unattributed``; device spans that overlap count once; the window
    clips both."""
    from repro_torch.obs import idle_by_phase, idle_segments
    spans = [
        ("step 0", "engine", "engine", 0, 100),
        ("decode", "engine", "engine", 10, 80),
        ("sample", "phase", "engine", 20, 10),
        ("graph", "phase", "engine", 40, 30),
        ("queue rid=3", "wait", "queue", 0, 150),
        ("req 3", "request", "requests", 0, 150),
        ("dev decode", "device", "stream", 45, 20),
        ("dev copy", "device", "stream", 60, 8),       # overlaps
        ("prefill rid=3", "engine", "engine", 110, 30),
        ("dev prefill", "device", "stream", 115, 20),
    ]
    assert idle_segments(spans, 0, 150) == [
        (0, 10, "step"), (10, 20, "decode"), (20, 30, "sample"),
        (30, 40, "decode"), (40, 45, "graph"), (68, 70, "graph"),
        (70, 90, "decode"), (90, 100, "step"), (100, 110, "unattributed"),
        (110, 115, "prefill"), (135, 140, "prefill"),
        (140, 150, "unattributed")]
    assert idle_by_phase(spans, 0, 150) == {
        "step": 20, "decode": 40, "sample": 10, "graph": 7,
        "unattributed": 20, "prefill": 10}
    assert idle_by_phase(spans, 25, 50) == {"sample": 5, "decode": 10,
                                            "graph": 5}
    assert idle_by_phase([], 0, 7) == {"unattributed": 7}
    assert idle_by_phase(spans, 47, 60) == {}


def test_chrome_trace_device_track():
    """With device spans the trace gains a ``device`` process: the spans
    on its ``stream`` row and the idle time, by phase, on its ``idle``
    row; the host rows hold every other span."""
    from repro_torch.obs import Telemetry, chrome_trace, idle_by_phase
    tel = Telemetry(trace=True)
    tel.spans += [("step 0", "engine", "engine", 0, 2_000),
                  ("graph", "phase", "engine", 100, 1_500),
                  ("dev decode", "device", "stream", 300, 1_000),
                  ("dev copy", "device", "stream", 1_700, 100),
                  ("queue rid=0", "wait", "queue", 0, 50)]
    ev = chrome_trace(tel)["traceEvents"]
    procs = {e["pid"]: e["args"]["name"] for e in ev
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {1: "host", 2: "modeled", 3: "device"}
    host = [e for e in ev if e["ph"] == "X" and e["pid"] == 1]
    stream = [e for e in ev if e["ph"] == "X" and e["pid"] == 3
              and e["tid"] == 1]
    idle = [e for e in ev if e["ph"] == "X" and e["pid"] == 3
            and e["tid"] == 2]
    assert {e["name"] for e in host} == {"step 0", "graph", "queue rid=0"}
    assert [(e["name"], e["ts"], e["dur"]) for e in stream] == \
        [("dev decode", 0.3, 1.0), ("dev copy", 1.7, 0.1)]
    assert [(e["name"], e["ts"], e["dur"]) for e in idle] == \
        [("graph", 1.3, 0.3), ("step", 1.6, 0.1)]
    assert sum(e["dur"] for e in idle) * 1000 == pytest.approx(
        sum(idle_by_phase(tel.spans, 300, 1_800).values()))
