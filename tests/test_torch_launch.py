"""The port's serve and train launchers against the reference's.

The reference's ``repro.launch.serve`` and ``repro.launch.train`` run in one
child process (the engine tests' setting: XLA's excess precision off, the
``enable_x64`` alias that jax 0.9 removed, an artifact cache in a tmp dir),
each through its own ``main`` on deepseek-7b smoke; the child saves their
outputs, the serving engine's greedy samples and the params both launchers
drew (``materialize(PRNGKey(0), ...)``).  The port's ``run(args,
params=...)`` takes those params, converted, with ``--device cpu``.

Serving replays the reference's tokens (ROADMAP "Holding the port"): the
port's engine emits the reference's samples, and its own greedy choice must
agree wherever the reference's top-2 margin is at least 0.02; the engine
and MM stats must be equal.  Training: 3 steps, the logged losses within
the Trainer test's tolerances.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_engine import TIE_MARGIN, _converted_params, _top2_margin

HERE = Path(__file__).resolve().parent
SERVE = ["--arch", "deepseek_7b", "--smoke", "--requests", "4",
         "--max-new", "12", "--prompt-len", "40", "--batch", "2",
         "--blocks", "128"]
TRAIN = ["--arch", "deepseek_7b", "--smoke", "--steps", "3", "--batch", "2",
         "--seq", "32"]


def _reference_main(out: Path) -> None:
    import jax
    import jax.experimental
    # the reference's batch executors call the name jax 0.9 removed; this
    # process runs only the reference, and the alias dies with it
    jax.experimental.enable_x64 = jax.enable_x64
    from repro.configs.base import get_smoke_config
    from repro.launch import serve, train
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
    np.savez(out / "params.npz", **flat)

    samples = []

    class Logged(serve.ServingEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            own = self.sampler.sample

            def sample(logits, vocab, temperature):
                tok = int(own(logits, vocab, temperature))
                samples.append([tok, _top2_margin(logits, vocab)])
                return tok
            self.sampler.sample = sample
    serve.ServingEngine = Logged
    res = {}
    for name, mod, argv in (("serve", serve, SERVE),
                            ("train", train, TRAIN + ["--ckpt-dir",
                                                      str(out / "ckpt")])):
        sys.argv = [name] + argv
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        res[name] = buf.getvalue()
    res["samples"] = samples
    (out / "reference.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false"
                        + " --xla_cpu_multi_thread_eigen=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["REPRO_CACHE_DIR"] = str(out / "artifact-cache")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads((out / "reference.json").read_text())
    ref["params"] = out / "params.npz"
    return ref


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _without_walls(stats):
    if isinstance(stats, dict):
        return {k: _without_walls(v) for k, v in stats.items()
                if "wall" not in k}
    return stats


def test_serve_launcher_matches_reference(reference, monkeypatch):
    from repro_torch.launch import serve
    replay, own = list(reference["samples"]), []

    class Replayed(serve.ServingEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            sample = self.sampler.sample

            def replayed(logits, vocab, temperature):
                own.append([int(sample(logits, vocab, temperature)),
                            _top2_margin(logits, vocab)])
                return replay[len(own) - 1][0]
            self.sampler.sample = replayed
    monkeypatch.setattr(serve, "ServingEngine", Replayed)
    args = serve.parser().parse_args(SERVE + ["--device", "cpu"])
    eng, out = serve.run(args, params=_converted_params(reference["params"]))
    assert eng.device.type == "cpu"
    want = json.loads(reference["serve"])
    assert _without_walls(out) == _without_walls(want)
    assert out["engine"]["completed"] == 4
    assert len(own) == len(replay)
    off = [(r, p) for r, p in zip(replay, own) if r[0] != p[0]]
    assert all(r[1] < TIE_MARGIN for r, _ in off), off[:5]


def test_train_launcher_matches_reference(reference, tmp_path):
    from repro_torch.launch import train
    args = train.parser().parse_args(
        TRAIN + ["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = train.run(args, params=_converted_params(reference["params"]))
    text = reference["train"]
    want = json.loads(text[:text.rindex("\nloss ")])
    assert out["final_step"] == 3 and out["ckpt_dir"] == str(tmp_path)
    assert [m["step"] for m in out["metrics"]] == [m["step"] for m in want]
    for m, r in zip(out["metrics"], want):
        np.testing.assert_allclose(m["loss"], r["loss"], rtol=2e-2)
        np.testing.assert_allclose(m["lr"], r["lr"], rtol=1e-6)
        np.testing.assert_allclose(m["grad_norm"], r["grad_norm"], rtol=0.1)


def test_launchers_default_to_the_card(capsys):
    """Without ``--device`` both launchers draw their weights on CUDA,
    which a machine without a card refuses; ``main`` prints the reference's
    output form."""
    from repro_torch.launch import serve, train
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        serve.run(serve.parser().parse_args(SERVE))
    with pytest.raises((RuntimeError, AssertionError)):
        train.run(train.parser().parse_args(TRAIN))
    serve.main(SERVE[:3] + ["--requests", "1", "--max-new", "2",
                            "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["engine"]["completed"] == 1


if __name__ == "__main__":
    _reference_main(Path(sys.argv[1]))
