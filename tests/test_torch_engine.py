"""The port's serving engine against the reference engine, end to end.

The reference runs with ``batch_faults=False`` — its scalar fault route,
the one whose policy executor runs on this JAX version (ROADMAP, "Holding
the port against the reference") — and the port with ``device="cpu"``, so
every kernel takes its plain PyTorch version.

Two workloads that drain block-copy moves (the ``test_system`` workload
drains none: its VMAs are smaller than one order-2 window):

  * W1: 4 requests, prompt 100, 28 new tokens, ``max_batch=2``, 256 blocks —
    khugepaged collapses hot prefixes (collapse moves);
  * W2: 3 requests, prompt 64, 64 new tokens, ``max_batch=3``, 64 blocks —
    pool pressure: compactions, collapses and preemptions.

Finished tokens, ``EngineStats`` (wall time aside), ``MMStats``, the
khugepaged counters and the sequence of drained moves must be identical;
``heat_histograms`` agree to 2e-2.  A divergence is reported with the first
engine step at which the per-step record differs.

The reference runs in a child process with XLA's excess precision off
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

WORKLOADS = {
    # name: (num_blocks, n_requests, prompt, new_tokens, max_batch)
    "W1": (256, 4, 100, 28, 2),
    "W2": (64, 3, 64, 64, 3),
}
POLICIES = ("ebpf", "thp", "never")
MAX_STEPS = 400


def _profile_regions(max_blocks: int):
    return [(0, max(4, max_blocks // 4), (0, 150_000, 600_000, 2_500_000)),
            (max(4, max_blocks // 4), max_blocks, (0, 0, 0, 0))]


def drive(pkg: str, workload: str, policy: str, params=None) -> dict:
    """Run one workload through package ``pkg`` ("repro" or "repro_torch",
    which takes the converted ``params``) and return its per-step record and
    end state as plain JSON data."""
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    serving = importlib.import_module(f"{pkg}.serving")
    models = importlib.import_module(f"{pkg}.models")
    cfg = importlib.import_module(f"{pkg}.configs.base").get_smoke_config(
        "deepseek_7b")
    nb, nreq, plen, new, mb = WORKLOADS[workload]
    layout = models.PagedLayout(num_blocks=nb, block_tokens=4, max_blocks=32)
    prof = None
    if policy == "ebpf":
        prof = core.Profile("chat", [core.ProfileRegion(*r) for r in
                                     _profile_regions(layout.max_blocks)])
    if pkg == "repro":
        import jax
        params = models.materialize(jax.random.PRNGKey(0),
                                    models.model_spec(cfg))
        eng = serving.ServingEngine(cfg, params, layout, max_batch=mb,
                                    policy=policy, profile=prof,
                                    batch_faults=False)
    else:
        eng = serving.ServingEngine(cfg, params, layout, max_batch=mb,
                                    policy=policy, profile=prof,
                                    device="cpu")
    moves: list = []
    drain = eng.mm.drain_moves

    def logged_drain():
        mv = drain()
        moves.extend([list(m) for m in mv])
        return mv
    eng.mm.drain_moves = logged_drain
    rng = np.random.default_rng(0)
    for r in range(nreq):
        eng.submit(serving.Request(
            rid=r, prompt=rng.integers(1, cfg.vocab, plen).tolist(),
            max_new_tokens=new, app="chat"))
    steps = []
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
        if n >= MAX_STEPS:
            break
    khp = eng.khugepaged
    return {
        "steps": steps,
        "finished": {str(k): list(map(int, v))
                     for k, v in eng.finished.items()},
        "moves": moves,
        "khugepaged": None if khp is None else [khp.collapsed, khp.considered],
        "heat": {k: v.tolist() for k, v in eng.heat_histograms.items()},
    }


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


def _reference_main(out_dir: str) -> None:
    """Child-process entry: run every (workload, policy) on the reference
    and save its smoke params for the port side."""
    import jax
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
    results = {f"{w}/{p}": drive("repro", w, p)
               for w in WORKLOADS for p in POLICIES}
    (Path(out_dir) / "reference.json").write_text(json.dumps(results))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return (json.loads((out / "reference.json").read_text()),
            _converted_params(out / "params.npz"))


def _first_divergence(ref_steps, port_steps) -> str:
    for i, (a, b) in enumerate(zip(ref_steps, port_steps)):
        if a != b:
            keys = [k for k in a if a[k] != b[k]]
            return (f"first divergence at engine step {i}: "
                    + "; ".join(f"{k}: ref={a[k]} port={b[k]}" for k in keys))
    if len(ref_steps) != len(port_steps):
        return (f"step counts differ: ref={len(ref_steps)} "
                f"port={len(port_steps)}")
    return "per-step records equal"


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_engine_matches_reference(reference, workload, policy):
    results, params = reference
    ref = results[f"{workload}/{policy}"]
    port = drive("repro_torch", workload, policy, params)
    where = _first_divergence(ref["steps"], port["steps"])
    assert port["steps"] == ref["steps"], where
    assert port["finished"] == ref["finished"], where
    assert port["moves"] == ref["moves"], where
    assert port["khugepaged"] == ref["khugepaged"], where
    assert sorted(port["heat"]) == sorted(ref["heat"])
    for app, h in ref["heat"].items():
        np.testing.assert_allclose(port["heat"][app], h, rtol=2e-2,
                                   atol=2e-2)
    if workload == "W1" and policy == "ebpf":
        assert len(ref["moves"]) >= 1 and ref["khugepaged"][0] >= 1
    if workload == "W2" and policy == "ebpf":
        last = ref["steps"][-1]
        assert last["mm"]["compactions"] >= 1
        assert last["engine"]["preemptions"] >= 1


def test_unported_options_raise():
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import PagedLayout, materialize, model_spec
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config("deepseek_7b")
    params = materialize(torch.Generator().manual_seed(0), model_spec(cfg),
                         device="cpu")
    layout = PagedLayout(num_blocks=64, block_tokens=4, max_blocks=16)
    for kw in ({"batch_faults": True}, {"host_blocks": 8},
               {"tier_blocks": (8,)}, {"prefix_cache": True},
               {"telemetry": True}, {"trace": True}, {"chaos": 1}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(cfg, params, layout, policy="thp", device="cpu",
                          **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(cfg, params, layout, policy="ebpf", profile="auto",
                      device="cpu")
    for policy in ("thp-prog", "never-prog"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(cfg, params, layout, policy=policy, device="cpu")


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
    _reference_main(sys.argv[1])
