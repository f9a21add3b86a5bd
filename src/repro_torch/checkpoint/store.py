"""Checkpointing (``repro.checkpoint.store``): sharded, manifest-driven,
async-capable.

Layout of one checkpoint, the reference's:
    <dir>/step_000123/
        manifest.json     {step, tree structure, leaf shapes/dtypes}
        shard_<i>.npz     flattened leaves (split round-robin into shards so
                          restore can be parallelized / partially read)
        _COMMITTED        written LAST — a checkpoint without it is garbage
                          (crash-consistent commit protocol)

Trees are the port's: dicts (walked in sorted-key order, as JAX flattens
them), lists, tuples and NamedTuples (``AdamWState``) over tensor leaves.
A bf16 tensor is stored as its int16 bit pattern, its manifest dtype
``bfloat16``.  Host RAM is the staging buffer: save() copies every leaf to
the host before it returns; save(..., blocking=False) then writes on a
worker thread, and wait() joins it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..data.pipeline import resolve_device

Pytree = Any


def flatten(tree: Pytree) -> tuple[list, Any]:
    """(leaves, structure) of a dict/list/tuple/NamedTuple tree."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return ("namedtuple", type(node), tuple(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, len(node),
                    tuple(walk(v) for v in node))
        leaves.append(node)
        return None
    return leaves, walk(tree)


def unflatten(structure, leaves: list) -> Pytree:
    it = iter(leaves)

    def build(node):
        if node is None:
            return next(it)
        kind, meta, kids = node
        vals = [build(k) for k in kids]
        if kind == "dict":
            return dict(zip(meta, vals))
        if kind == "namedtuple":
            return meta(*vals)
        return list(vals) if kind == "list" else tuple(vals)
    return build(structure)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


class CheckpointStore:
    def __init__(self, directory: str | os.PathLike, *, num_shards: int = 4):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.num_shards = num_shards
        self._pending: threading.Thread | None = None
        self._structure = None

    # ------------------------------------------------------------------ save
    def save(self, tree: Pytree, *, step: int, keep: int | None = None,
             blocking: bool = True) -> Path:
        self.wait()
        leaves, structure = flatten(tree)
        host = [_to_host(l) for l in leaves]            # host snapshot NOW
        path = self.dir / f"step_{step:09d}"

        def write():
            tmp = path.with_suffix(".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {
                "step": step,
                "treedef": str(structure),
                "num_leaves": len(host),
                "num_shards": self.num_shards,
                "leaves": [{"shape": list(a.shape), "dtype": dt}
                           for a, dt in host],
            }
            for s in range(self.num_shards):
                arrs = {f"leaf_{i}": host[i][0]
                        for i in range(s, len(host), self.num_shards)}
                np.savez(tmp / f"shard_{s}.npz", **arrs)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            (tmp / "_COMMITTED").touch()
            if path.exists():
                shutil.rmtree(path)
            tmp.rename(path)
            if keep is not None:
                self._gc(keep)

        if blocking:
            write()
        else:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        self._structure = structure
        return path

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self, keep: int) -> None:
        steps = self.all_steps()
        for s in steps[:-keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if (p / "_COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, *, like: Pytree | None = None,
                device=None) -> tuple[Pytree, dict]:
        """Restore ``step`` as tensors on ``device`` (default CUDA; pass
        ``device="cpu"`` on a machine without a card).  ``like`` provides
        the tree structure (required unless save() ran on this store)."""
        dev = resolve_device(device)
        path = self.dir / f"step_{step:09d}"
        if not (path / "_COMMITTED").exists():
            raise FileNotFoundError(f"no committed checkpoint at {path}")
        manifest = json.loads((path / "manifest.json").read_text())
        n = manifest["num_leaves"]
        leaves: list = [None] * n
        for s in range(manifest["num_shards"]):
            with np.load(path / f"shard_{s}.npz") as z:
                for key in z.files:
                    i = int(key.split("_")[1])
                    t = torch.from_numpy(z[key])
                    if manifest["leaves"][i]["dtype"] == "bfloat16":
                        t = t.view(torch.bfloat16)
                    leaves[i] = t.to(dev)
        structure = flatten(like)[1] if like is not None else self._structure
        if structure is None:
            raise ValueError("restore needs `like` unless save() ran on this "
                             "store")
        return unflatten(structure, leaves), {"step": manifest["step"]}
