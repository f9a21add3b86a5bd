"""``chip_smoke.py`` against the package it drives, on the CPU.

The script runs only on a card and no test or benchmark runs it, so a
rename in the port would break it unseen.  These tests import it (which
runs nothing) and hold every package name it still reaches: the modules it
imports under an alias and each attribute it reads or patches on them, and
the private attributes of the engine, its entries and the batch executors
it reads or patches; and that it no longer patches the internals of the
engine's fault path, of the batch executor's staging or of the compiled
entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import re
from pathlib import Path

import pytest

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

SCRIPT = Path(__file__).resolve().parents[1] / "chip_smoke.py"
SOURCE = SCRIPT.read_text()


def _chains(prefix: str) -> set[str]:
    """Every ``<prefix>.a.b...`` attribute chain the script names."""
    return set(re.findall(rf"(?<![\w.]){re.escape(prefix)}\.(\w+(?:\.\w+)*)",
                          SOURCE))


def _resolve(obj, chain: str) -> bool:
    """Whether ``obj`` has the chain; past a tensor (or a buffer the CPU
    leaves None) the names are torch's, not the package's."""
    import torch
    for name in chain.split("."):
        if obj is None or isinstance(obj, torch.Tensor):
            return True
        if not hasattr(obj, name):
            return False
        obj = getattr(obj, name)
    return True


def test_import_runs_nothing():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main)
    assert SOURCE.rstrip().endswith('if __name__ == "__main__":\n    main()')


def test_module_attributes_exist():
    """Each ``from repro_torch... import X as Y`` (and ``build``), and
    every attribute chain the script reads off ``Y``."""
    aliases = {alias: f"{pkg}.{name}" for pkg, name, alias in re.findall(
        r"from (repro_torch[\w.]*) import (\w+) as (\w+)", SOURCE)}
    aliases["build"] = "repro_torch.kernels.build"
    assert {"engine_mod", "pe", "fa", "pa", "bc", "build"} <= set(aliases)
    missing = []
    for alias, path in sorted(aliases.items()):
        mod = importlib.import_module(path)
        for chain in sorted(_chains(alias)):
            if not _resolve(mod, chain):
                missing.append(f"{alias}.{chain}")
    assert not missing


@pytest.fixture(scope="module")
def engine():
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core import Profile, ProfileRegion
    from repro_torch.models import PagedLayout, materialize, model_spec
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config("deepseek_7b")
    params = materialize(torch.Generator().manual_seed(0), model_spec(cfg),
                         device="cpu")
    return ServingEngine(cfg, params, PagedLayout(64, 4, 16), max_batch=2,
                         policy="ebpf", profile=Profile("chat", [
                             ProfileRegion(0, 8, (0, 1, 2, 3))]),
                         prefix_cache=True, chaos=1, device="cpu")


def test_engine_attributes_exist(engine):
    """The engine's attributes the script names off ``eng`` and its private
    ones off ``e``, its decode and prefill entries' (``._decode.``,
    ``._prefill.``, ``pg.``) and its memory manager's."""
    chains = _chains("eng") | {c for c in _chains("e") if c[0] == "_"}
    assert {"_decode", "_prefill", "_run_prefill", "_pool_leaves"} <= \
        {c.split(".")[0] for c in chains}
    missing = [c for c in sorted(chains) if not _resolve(engine, c)]
    for name in ("_decode", "_prefill"):
        found = set(re.findall(rf"\.{name}\.(\w+(?:\.\w+)*)", SOURCE))
        missing += [f"{name}.{c}" for c in sorted(found)
                    if not _resolve(getattr(engine, name), c)]
    missing += [f"pg.{c}" for c in sorted(_chains("pg"))
                if not _resolve(engine._prefill, c)]
    missing += [f"mm.{c}" for c in sorted(_chains("mm"))
                if c[0] == "_" and not _resolve(engine.mm, c)]
    assert not missing


def test_executor_attributes_exist(engine):
    """What the script reads off a batch executor (``ex.``), on both
    executors: the fault hook's predicated one and the pc walk."""
    from repro_torch.core import JitPolicy, ebpf_mm_program
    pred = engine.mm.hooks._hooks["mm_fault"].pred
    jit = JitPolicy(ebpf_mm_program(max_regions=8), engine.mm.maps,
                    device="cpu")
    chains = _chains("ex")
    assert {"_run_eager", "_launch", "_table", "_maps_dev"} <= \
        {c.split(".")[0] for c in chains}
    missing = [f"{type(ex).__name__}.{c}" for ex in (pred, jit)
               for c in sorted(chains) if not _resolve(ex, c)]
    assert not missing


@pytest.mark.parametrize("patch", [
    r"\.run_batch\s*=", r"_run_eager\s*=", r"\._capture\b",
    r"_fault_slots", r"_apply_pending_moves", r"_sync_tables",
    r"_decode\._\w+", r"_copy_out", r"_eager_entry", r"_eager_executors",
    r"--phase\W+3g"])
def test_settled_forks_are_not_patched(patch):
    """The script no longer swaps the executor's or the entries' methods
    for eager ones, nor labels the engine's fault path by its internal
    method names."""
    assert not re.search(patch, SOURCE)
