"""The port's serving engine against the reference engine, end to end.

Both engines run on both fault routes: the batched route (the default, one
policy invocation per decode step through the batch executor) and the
scalar route (``batch_faults=False``).  The port runs with
``device="cpu"``, so every kernel takes its plain PyTorch version and the
policy executor runs on the CPU.

Two workloads that drain block-copy moves (the ``test_system`` workload
drains none: its VMAs are smaller than one order-2 window):

  * W1: 4 requests, prompt 100, 28 new tokens, ``max_batch=2``, 256 blocks —
    khugepaged collapses hot prefixes (collapse moves);
  * W2: 3 requests, prompt 64, 64 new tokens, ``max_batch=3``, 64 blocks —
    pool pressure: compactions, collapses and preemptions.

Finished tokens, ``EngineStats`` (wall time aside), ``MMStats``, the
khugepaged counters, the hook counters and the sequence of drained moves
must be identical; ``heat_histograms`` agree to 2e-2.  A divergence is
reported with the first engine step at which the per-step record differs.
The same function (:func:`drive`) serves the tiering and prefix-cache engine
tests (``test_torch_tiering.py``, ``test_torch_prefix.py``).

The reference runs in a child process (:func:`run_reference`).  Its
batched route calls ``jax.experimental.enable_x64``, which jax 0.9.0
removed: the child installs ``jax.enable_x64`` under the old name before
it runs anything — a patch that dies with the child, so it can never leak
into the reference's own test files (``tests/test_torch_executor.py``
explains why that matters).  It sets ``REPRO_CACHE_DIR`` to a temporary
directory, so the reference's artifact cache writes nothing into the tree,
and runs with XLA's excess precision off
(``--xla_allow_excess_precision=false``).  With it on, XLA's CPU backend
keeps some bf16 intermediates in float32 across fused ops (a matmul's
output into the residual add), which its HLO does not ask for; the port
rounds every bf16 op, as the HLO states.  The two then differ in the last
bf16 bit often enough to flip a greedy token at a near-tie.  The child
keeps the flag away from every other test in this process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.obs.ringbuf import EV_CACHE, EV_COMPILE, EV_HOOK

WORKLOADS = {
    # name: (num_blocks, n_requests, prompt, new_tokens, max_batch)
    "W1": (256, 4, 100, 28, 2),
    "W2": (64, 3, 64, 64, 3),
}
POLICIES = ("ebpf", "thp", "never")
# the loaded baselines run only on the batched route's W2 (pool pressure)
PROG_POLICIES = ("thp-prog", "never-prog")
MAX_STEPS = 400


def _profile_regions(max_blocks: int):
    return [(0, max(4, max_blocks // 4), (0, 150_000, 600_000, 2_500_000)),
            (max(4, max_blocks // 4), max_blocks, (0, 0, 0, 0))]


def workload_spec(workload: str, policy: str, batch: bool) -> dict:
    nb, nreq, plen, new, mb = WORKLOADS[workload]
    return {"num_blocks": nb, "n_req": nreq, "prompt": plen, "new": new,
            "max_batch": mb, "policy": policy,
            "engine": {"batch_faults": batch}}


def _spec_cases() -> dict:
    """Every engine case of this file: name -> spec."""
    cases = {}
    for w in WORKLOADS:
        for p in POLICIES:
            for batch in (False, True):
                cases[f"{w}/{p}/{'batch' if batch else 'scalar'}"] = \
                    workload_spec(w, p, batch)
    for p in PROG_POLICIES:
        cases[f"W2/{p}/batch"] = workload_spec("W2", p, True)
    return cases


def _prompts(spec: dict, vocab: int) -> list:
    """The request stream of a spec: ``n_req`` seeded random prompts, or
    (``shared``) one shared system prompt plus a per-request tail."""
    if "shared" in spec and spec.get("mixed"):
        # test_prefix_cache's mixed traffic: shared-prefix requests
        # interleaved with random one-offs
        rng = np.random.default_rng(3)
        return [list(spec["shared"]) + [spec["tail_base"] + r] * spec["tail"]
                if r % 2 == 0 else rng.integers(1, vocab, 20).tolist()
                for r in range(spec["n_req"])]
    if "shared" in spec:
        return [list(spec["shared"]) + [spec["tail_base"] + r]
                * spec["tail"] for r in range(spec["n_req"])]
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, spec["prompt"]).tolist()
            for _ in range(spec["n_req"])]


TIE_MARGIN = 0.02     # top-2 logit gap below which greedy order is a tie


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors while a test
    runs, restored after it: the suite's six xdist workers share the
    machine's cores, and idle intra-op threads spin."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _top2_margin(logits, vocab: int) -> float:
    top = np.sort(np.asarray(logits, np.float64)[:vocab])[-2:]
    return float(top[1] - top[0])


def drive(pkg: str, spec: dict, params=None, replay=None,
          replay_heat=None) -> dict:
    """Run one engine spec through package ``pkg`` ("repro", or
    "repro_torch", which takes the converted ``params``) and return its
    per-step record and end state as plain JSON data.

    Every greedy sample is logged as ``[token, top-2 margin]`` in call
    order (``samples``).  ``replay`` (a reference run's ``samples``) makes
    the engine emit the reference's tokens instead of its own, so both
    engines see one token stream; the port's own choices are logged all
    the same, for :func:`assert_replay_agrees`.

    Every DAMON heat vector the engine records (``mm.record_access``) is
    logged as ``[pid, values, dtype]`` (``accesses``).  ``replay_heat`` (a
    reference run's ``accesses``) feeds the reference's heat to the memory
    manager instead of the port's own: the paged kernel's heat agrees with
    the reference's only to rounding, and where two pages' heat ties to
    within it, the promotion scan's order of candidates can follow the
    rounding.

    spec keys: ``num_blocks``, ``max_blocks`` (default 32), ``n_req``,
    ``prompt`` (or ``shared`` + ``tail`` + ``tail_base``), ``new``,
    ``max_batch``, ``policy``, ``engine`` (extra engine keywords),
    ``max_steps``, ``serial`` (submit one request, run to completion, then
    the next — the prefix-cache workload's order)."""
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    serving = importlib.import_module(f"{pkg}.serving")
    models = importlib.import_module(f"{pkg}.models")
    cfg = importlib.import_module(f"{pkg}.configs.base").get_smoke_config(
        "deepseek_7b")
    layout = models.PagedLayout(num_blocks=spec["num_blocks"],
                                block_tokens=4,
                                max_blocks=spec.get("max_blocks", 32))
    policy = spec["policy"]
    prof = spec.get("profile")          # "auto": the online profiler
    if policy == "ebpf" and prof is None:
        prof = core.Profile("chat", [core.ProfileRegion(*r) for r in
                                     _profile_regions(layout.max_blocks)])
    kw = dict(spec.get("engine", {}))
    if pkg == "repro":
        import jax
        params = models.materialize(jax.random.PRNGKey(0),
                                    models.model_spec(cfg))
    else:
        kw["device"] = "cpu"
    eng = serving.ServingEngine(cfg, params, layout,
                                max_batch=spec["max_batch"], policy=policy,
                                profile=prof, **kw)
    if "doorkeeper" in spec:
        eng.prefix_cache.doorkeeper = spec["doorkeeper"]
    samples: list = []
    own = eng.sampler.sample

    def logged_sample(logits, vocab, temperature):
        tok = int(own(logits, vocab, temperature))
        samples.append([tok, _top2_margin(logits, vocab)])
        if replay is not None:
            return replay[len(samples) - 1][0]
        return tok
    eng.sampler.sample = logged_sample
    moves: list = []
    drain = eng.mm.drain_moves

    def logged_drain():
        mv = drain()
        moves.extend([list(m) for m in mv])
        return mv
    eng.mm.drain_moves = logged_drain
    accesses: list = []
    record_access = eng.mm.record_access

    def logged_access(pid, heat):
        heat = np.asarray(heat)
        if replay_heat is not None:
            _, values, dtype = replay_heat[len(accesses)]
            heat = np.asarray(values, dtype)
        accesses.append([int(pid), heat.tolist(), str(heat.dtype)])
        return record_access(pid, heat)
    eng.mm.record_access = logged_access
    steps = []
    max_steps = spec.get("max_steps", MAX_STEPS)

    def run_steps():
        n = 0
        while eng.step():
            stats = eng.stats.snapshot()
            stats.pop("wall_host_s")
            steps.append({
                "engine": stats, "mm": eng.mm.stats.snapshot(),
                "moves": len(moves),
                "tokens": {str(s.req.rid): list(map(int, s.generated))
                           for s in eng.active.values()},
                "finished": {str(k): v for k, v in eng.finished.items()}})
            n += 1
            if n >= max_steps:
                break

    reqs = [serving.Request(rid=r, prompt=p, max_new_tokens=spec["new"],
                            app="chat")
            for r, p in enumerate(_prompts(spec, cfg.vocab))]
    for req in reqs:
        eng.submit(req)
        if spec.get("serial"):
            run_steps()
    if not spec.get("serial"):
        run_steps()
    khp = eng.khugepaged
    hooks = eng.mm.hooks
    final = eng.stats.snapshot()
    final.pop("wall_host_s")
    out = {
        "samples": samples,
        "accesses": accesses,
        "final": {"engine": final, "mm": eng.mm.stats.snapshot()},
        "steps": steps,
        "finished": {str(k): list(map(int, v))
                     for k, v in eng.finished.items()},
        "moves": moves,
        "khugepaged": None if khp is None else [khp.collapsed, khp.considered],
        "hooks": {"invocations": hooks.invocations, "calls": hooks.calls,
                  "batch_calls": hooks.batch_calls},
        "heat": {k: v.tolist() for k, v in eng.heat_histograms.items()},
    }
    if eng.prefix_cache is not None:
        out["prefix_cache"] = eng.prefix_cache.snapshot()
    if hasattr(eng.mm, "tier_snapshot"):
        out["tier"] = eng.mm.tier_snapshot()
    out["obs"] = observed(eng)
    return json.loads(json.dumps(out))


def observed(eng) -> dict:
    """An engine's observability, resilience and profiler state: its
    ``metrics()``, the supervisor's ledger, the injector's and the
    profiler's snapshots, and (with telemetry) every pending ring event
    and the names of its trace spans."""
    out = {"metrics": eng.metrics(),
           "supervisor": eng.mm.hooks.supervisor.snapshot()}
    if eng.injector is not None:
        out["injector"] = eng.injector.snapshot()
    if eng.profiler is not None:
        out["profiler"] = eng.profiler.snapshot()
        out["wss_curve"] = eng.profiler.wss_curve_doc()
        out["profiles"] = {app: [[r.start, r.end, list(r.benefit)]
                                 for r in p.regions]
                           for app, p in eng.profiler.profiles.items()}
    tel = eng.telemetry
    if tel is not None:
        out["ring"] = tel.ring.peek().tolist()
        out["spans"] = [[n, c, t] for n, c, t, _, _ in tel.spans]
    return out


# Ring tags whose events carry host wall time (ts and a2) or, for EV_CACHE,
# the process's own artifact-cache history: tag -> how many of [tag, a0, a1]
# are compared.  Every other tag runs on the modeled clock and must match
# bit for bit.
HOST_EVENT_FIELDS = {EV_HOOK: 3, EV_COMPILE: 3, EV_CACHE: 1}


def modeled_ring(ring) -> list:
    """Ring events with their wall-time fields dropped: modeled-clock
    events whole, host-side events as ``[tag, a0, a1]`` (EV_HOOK: hook,
    batch size; EV_COMPILE: hook, executor) or ``[tag]`` (EV_CACHE)."""
    out = []
    for ts, tag, a0, a1, a2 in ring:
        keep = HOST_EVENT_FIELDS.get(tag)
        out.append([ts, tag, a0, a1, a2] if keep is None
                   else [tag, a0, a1][:keep])
    return out


def _wall_metric(key: str) -> bool:
    """Metrics read off a wall clock, or off the process-wide artifact
    cache's history, rather than off the modeled run."""
    return key == "engine_wall_host_s" or key.startswith((
        "cache_", "telemetry_mgmt_step_ns", "telemetry_request_ttft_ns",
        "telemetry_decode_token_ns")) or (
        key.startswith("telemetry_hooks_") and "_invoke_ns_" in key)


def assert_same_observed(ref: dict, port: dict) -> None:
    """Two ``drive`` results' observability sections agree: the metric
    key sets (a wall histogram's sparse bucket keys aside) and every
    modeled metric value, the supervisor, injector and profiler state, the
    ring's modeled-clock events whole and its host-side events without
    their wall fields, and the span names."""
    a, b = ref["obs"], port["obs"]
    buckets = (lambda k: _wall_metric(k) and "_buckets_" in k)
    assert {k for k in a["metrics"] if not buckets(k)} == \
        {k for k in b["metrics"] if not buckets(k)}
    modeled = {k: v for k, v in a["metrics"].items() if not _wall_metric(k)}
    assert {k: b["metrics"][k] for k in modeled} == modeled
    for key in ("supervisor", "injector", "profiler", "wss_curve",
                "profiles", "spans"):
        assert b.get(key) == a.get(key), key
    assert ("ring" in a) == ("ring" in b)
    if "ring" in a:
        assert modeled_ring(b["ring"]) == modeled_ring(a["ring"])


def _converted_params(path):
    """The reference's materialized smoke params, converted — drawn by the
    child process that runs the reference and handed over as .npz."""
    from repro_torch.convert import params_from_jax
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return params_from_jax(tree, device="cpu")


def _reference_main(out_dir: str, cases_of: str) -> None:
    """Child-process entry: run every engine case of test file
    ``cases_of`` on the reference and save its smoke params for the port
    side."""
    import importlib
    import jax
    import jax.experimental
    # the reference's batch executors call the name jax 0.9 removed; this
    # process runs only the reference, and the alias dies with it
    jax.experimental.enable_x64 = jax.enable_x64
    from repro.configs.base import get_smoke_config
    from repro.models import materialize, model_spec
    params = materialize(jax.random.PRNGKey(0),
                         model_spec(get_smoke_config("deepseek_7b")))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
    walk(params, "")
    np.savez(Path(out_dir) / "params.npz", **flat)
    mod = importlib.import_module(cases_of)
    results = {name: drive("repro", spec)
               for name, spec in mod._spec_cases().items()}
    extra = getattr(mod, "_reference_extra", None)
    if extra is not None:
        results["extra"] = extra(params)
    (Path(out_dir) / "reference.json").write_text(json.dumps(results))


def run_reference(tmp_path_factory, cases_of: str):
    """Run module ``cases_of``'s engine cases on the reference, in a child
    process; returns ``(results, converted params)``."""
    out = tmp_path_factory.mktemp("reference")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false"
                        + " --xla_cpu_multi_thread_eigen=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["REPRO_CACHE_DIR"] = str(out / "artifact-cache")
    here = Path(__file__).resolve().parent
    src = str(here.parent / "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src, str(here), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, __file__, str(out), cases_of],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return (json.loads((out / "reference.json").read_text()),
            _converted_params(out / "params.npz"))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "test_torch_engine")


def first_divergence(ref_steps, port_steps) -> str:
    for i, (a, b) in enumerate(zip(ref_steps, port_steps)):
        if a != b:
            keys = [k for k in a if a[k] != b[k]]
            return (f"first divergence at engine step {i}: "
                    + "; ".join(f"{k}: ref={a[k]} port={b[k]}" for k in keys))
    if len(ref_steps) != len(port_steps):
        return (f"step counts differ: ref={len(ref_steps)} "
                f"port={len(port_steps)}")
    return "per-step records equal"


def assert_replay_agrees(ref: dict, port: dict) -> None:
    """For a port run that replayed ``ref``'s tokens: at every sample whose
    reference top-2 margin is at least ``TIE_MARGIN``, the port's own greedy
    choice is the reference's token.  Below that margin the order of the
    top two is a rounding tie: XLA's CPU backend evaluates exp and its
    float32 reductions in another order than PyTorch does, which moves a
    bf16 attention output by one unit in the last place now and then, and
    the logits by up to ~1e-2."""
    assert len(port["samples"]) == len(ref["samples"])
    off = [(i, r, p) for i, (r, p) in enumerate(zip(ref["samples"],
                                                    port["samples"]))
           if r[0] != p[0]]
    assert all(r[1] < TIE_MARGIN for _, r, _ in off), \
        f"greedy token differs outside a tie: {off[:5]}"
    assert len(off) <= max(1, len(ref["samples"]) // 50), \
        f"{len(off)} tie flips of {len(ref['samples'])} samples"


def assert_same_run(ref: dict, port: dict, *, replayed: bool = False
                    ) -> None:
    """Per-step records, tokens, moves, counters and end-state sections of
    two ``drive`` results are identical; heat agrees to 2e-2.  For a port
    run that replayed the reference's tokens (``replayed``), the port's own
    greedy choices are held by :func:`assert_replay_agrees` instead."""
    where = first_divergence(ref["steps"], port["steps"])
    assert port["steps"] == ref["steps"], where
    assert port["final"] == ref["final"], where
    assert port["finished"] == ref["finished"], where
    assert port["moves"] == ref["moves"], where
    assert port["khugepaged"] == ref["khugepaged"], where
    assert port["hooks"] == ref["hooks"], where
    for section in ("prefix_cache", "tier"):
        assert port.get(section) == ref.get(section), section
    if replayed:
        assert_replay_agrees(ref, port)
    else:
        assert [s[0] for s in port["samples"]] == \
            [s[0] for s in ref["samples"]], where
    assert sorted(port["heat"]) == sorted(ref["heat"])
    for app, h in ref["heat"].items():
        np.testing.assert_allclose(port["heat"][app], h, rtol=2e-2,
                                   atol=2e-2)


def _check_workload(reference, workload, policy, route):
    results, params = reference
    ref = results[f"{workload}/{policy}/{route}"]
    port = drive("repro_torch", workload_spec(workload, policy,
                                              route == "batch"), params)
    assert_same_run(ref, port)
    if workload == "W1" and policy == "ebpf":
        assert len(ref["moves"]) >= 1 and ref["khugepaged"][0] >= 1
    if workload == "W2" and policy == "ebpf":
        last = ref["steps"][-1]
        assert last["mm"]["compactions"] >= 1
        assert last["engine"]["preemptions"] >= 1
    if route == "batch" and policy == "ebpf":
        # one HOOK_FAULT invocation per faulting step, none per fault
        assert ref["hooks"]["batch_calls"]["mm_fault"] >= 1
        assert ref["hooks"]["calls"]["mm_fault"] == \
            ref["hooks"]["batch_calls"]["mm_fault"]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_engine_matches_reference(reference, workload, policy):
    """The scalar fault route (``batch_faults=False``) on both engines."""
    _check_workload(reference, workload, policy, "scalar")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_engine_batched_route_matches_reference(reference, workload,
                                                policy):
    """The batched fault route, both engines' default."""
    _check_workload(reference, workload, policy, "batch")


@pytest.mark.parametrize("policy", PROG_POLICIES)
def test_loaded_baselines_match_reference(reference, policy):
    """thp-prog / never-prog: the THP and never baselines as attached
    programs on the batched route, against the reference's."""
    results, params = reference
    ref = results[f"W2/{policy}/batch"]
    port = drive("repro_torch", workload_spec("W2", policy, True), params)
    assert_same_run(ref, port)
    assert ref["hooks"]["batch_calls"]["mm_fault"] >= 1


def _smoke_engine_args():
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import PagedLayout, materialize, model_spec
    cfg = get_smoke_config("deepseek_7b")
    params = materialize(torch.Generator().manual_seed(0), model_spec(cfg),
                         device="cpu")
    return cfg, params, PagedLayout(num_blocks=64, block_tokens=4,
                                    max_blocks=16)


def test_engine_signature_matches_reference():
    """The port's ``ServingEngine`` takes every keyword the reference's
    takes, with the same defaults, plus ``device``; it takes no catch-all
    ``**kwargs``."""
    import inspect
    from repro.serving import ServingEngine as Ref
    from repro_torch.serving import ServingEngine
    ref = inspect.signature(Ref.__init__).parameters
    port = inspect.signature(ServingEngine.__init__).parameters
    assert set(port) == set(ref) | {"device"}
    assert not any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in port.values())
    for name, p in ref.items():
        if name != "cache_dtype":       # a jnp dtype there, a torch one here
            assert port[name].default == p.default, name
            assert port[name].kind == p.kind, name


def test_default_route_is_batched():
    """``ServingEngine(...)`` takes the batched fault route by default, as
    the reference does, and builds the fault program's batch executor on
    the engine's device at construction."""
    import inspect
    from repro_torch.core.hooks import HOOK_FAULT
    from repro_torch.core import Profile, ProfileRegion
    from repro_torch.serving import ServingEngine
    assert inspect.signature(ServingEngine).parameters[
        "batch_faults"].default is True
    cfg, params, layout = _smoke_engine_args()
    prof = Profile("chat", [ProfileRegion(*r) for r in
                            _profile_regions(layout.max_blocks)])
    eng = ServingEngine(cfg, params, layout, policy="ebpf", profile=prof,
                        device="cpu")
    assert eng.batch_faults
    ap = eng.mm.hooks._hooks[HOOK_FAULT]
    assert ap.pred is not None and ap.pred.device.type == "cpu"


def test_default_device_is_cuda():
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import PagedLayout, materialize, model_spec
    from repro_torch.serving import ServingEngine
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    cfg = get_smoke_config("deepseek_7b")
    params = materialize(torch.Generator().manual_seed(0), model_spec(cfg),
                         device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params, PagedLayout(64, 4, 16), policy="thp")


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
