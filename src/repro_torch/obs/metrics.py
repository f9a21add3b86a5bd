"""Flat Prometheus-style metrics snapshot.

``flatten_metrics`` turns a tree of sections (nested dicts/lists of
numbers, e.g. ``{"mm": mm.stats.snapshot(), "telemetry": tel.snapshot()}``)
into one flat ``{"mm_faults": 42, ...}`` mapping; ``render_prometheus``
prints it in the exposition text format (one ``repro_<key> <value>`` line
per scalar).  Non-numeric leaves are skipped, so arbitrary snapshot dicts
can be fed in unfiltered.
"""

from __future__ import annotations

import re

_SAN = re.compile(r"[^a-zA-Z0-9_]")


def _clean(key: str) -> str:
    return _SAN.sub("_", str(key))


def flatten_metrics(sections: dict, prefix: str = "",
                    out: dict | None = None) -> dict:
    if out is None:
        out = {}
    for key, val in sections.items():
        name = f"{prefix}{_clean(key)}"
        if isinstance(val, bool):
            out[name] = int(val)
        elif isinstance(val, (int, float)):
            out[name] = val
        elif isinstance(val, dict):
            flatten_metrics(val, f"{name}_", out)
        elif isinstance(val, (list, tuple)):
            for i, item in enumerate(val):
                if isinstance(item, dict):
                    flatten_metrics(item, f"{name}_{i}_", out)
                elif isinstance(item, (int, float)) and not isinstance(item, bool):
                    out[f"{name}_{i}"] = item
        # strings / None / arrays: not a metric
    return out


def render_prometheus(flat: dict, namespace: str = "repro") -> str:
    lines = []
    for key in sorted(flat):
        val = flat[key]
        if isinstance(val, float):
            lines.append(f"{namespace}_{key} {val:.6g}")
        else:
            lines.append(f"{namespace}_{key} {val}")
    return "\n".join(lines) + "\n"
