"""Finds what belongs to a cell by name: the cell in ``BENCHMARK.json``,
its configuration file (``configs``' ``file``), its traffic mix
(``traffic/<mix>.json``), its limits (``limits/<cell>.json``), the
reference and counts modules its configuration names
(``reference/<name>.py``, ``counts/<name>.py``) and a reader per
per-layer metric (``metrics/<metric>.py``, a ``read(rec)`` that returns a
number, or None when it finds nothing to read)."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        self.root = Path(path).parent
        self.bench = _json(path)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell])]


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return _json(HERE / "limits" / f"{cell}.json")


def module(kind: str, name: str):
    """``portbench.<kind>.<name>`` (kind: reference or counts)."""
    return importlib.import_module(f"portbench.{kind}.{name}")


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
