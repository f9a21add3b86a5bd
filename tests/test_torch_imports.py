"""``repro_torch`` stands alone: importing the whole port loads neither JAX
nor any module of the JAX package ``repro`` — the telemetry, trace, failure
injection, artifact cache and online-profiling modules included, the
training slice (optimizer, schedule, data, checkpoints, fault tolerance,
train step and trainer), the distributed slice (sharded decode,
sharding rules, gradient compression, meshes and the launchers), and the
multi-pod dry-run (its cells, the fake world, the DTensor bridges and the
dry-run itself)."""

import os
import subprocess
import sys
from pathlib import Path

CHECK = """
import importlib, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len([m for m in sys.modules if m.startswith("repro_torch")]))
assert not bad, bad
new = {"repro_torch.obs." + m for m in ("hist", "metrics", "telemetry",
                                        "trace")}
new |= {"repro_torch.resilience.faults", "repro_torch.core.cache",
        "repro_torch.core.wss"}
new |= {"repro_torch." + m for m in (
    "optim.adamw", "optim.schedule", "data.pipeline", "checkpoint.store",
    "distributed.fault", "training.train_step", "training.trainer")}
new |= {"repro_torch." + m for m in (
    "distributed.flashdecode", "distributed.sharding",
    "distributed.compression", "launch.mesh", "launch.serve",
    "launch.train")}
new |= {"repro_torch." + m for m in (
    "launch.specs", "launch.dryrun", "launch.fakeworld", "distributed.spmd")}
assert new <= set(sys.modules), sorted(new - set(sys.modules))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CHECK], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) > 20   # every port module imported
