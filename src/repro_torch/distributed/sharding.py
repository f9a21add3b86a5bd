"""Sharding rule engine: logical parameter/activation axes -> mesh axes.

The counterpart of ``repro.distributed.sharding``.  Megatron-style TP on the
"model" axis, DP over ("pod", "data"); every rule is divisibility-checked
against the actual dim size and falls back to replication when it does not
divide (e.g. qwen2-vl's 28 heads on TP=16).  ZeRO-1 additionally shards
optimizer state over the data axis on the largest still-replicated dim.

A spec is a tuple with one entry per dimension, trailing ``None``s
dropped: ``None`` (replicated), a mesh axis name, or a tuple of names (the
content of the reference's ``PartitionSpec``).  :func:`shardings_for_tree`
turns specs into DTensor placements on a ``DeviceMesh`` (``Shard(i)`` or
``Replicate()`` per mesh dimension), the counterpart of ``NamedSharding``.
The rules read only the mesh's axis names and sizes
(:func:`repro_torch.distributed.collectives.axis_sizes`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

from torch.distributed.tensor import Replicate, Shard

from .collectives import axis_sizes

Pytree = Any

# logical axis -> ordered mesh-axis candidates (first that divides wins)
DEFAULT_RULES: dict[str, tuple] = {
    "vocab": ("model",),
    "ff": ("model",),
    "expert": ("model",),
    "q_heads": ("model",),
    "kv_heads": ("model",),
    "kv_lora": (),
    "head_dim": (),
    "embed": (),
    "layers": (),
    "state": (),
    "conv": (),
    # activations
    "batch": (("pod", "data"), "data"),
    "seq": ("data",),
    "pool_blocks": (("data", "model"),),
}


def _flat(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def spec_for(shape: tuple[int, ...], axes: tuple, mesh,
             rules: dict | None = None) -> tuple:
    sizes = axis_sizes(mesh)
    rules = rules or DEFAULT_RULES
    used: set = set()
    parts = []
    for dim, name in zip(shape, axes):
        chosen = None
        for cand in rules.get(name, ()) if name else ():
            flat = _flat(cand)
            if not all(a in sizes for a in flat) or used.intersection(flat):
                continue
            if dim % math.prod(sizes[a] for a in flat) == 0:
                chosen = cand
                used.update(flat)
                break
        parts.append(chosen)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def zero1_spec(shape: tuple[int, ...], axes: tuple, mesh,
               rules: dict | None = None) -> tuple:
    """Optimizer-state sharding: param spec + shard the largest replicated
    dim over the data axis (ZeRO-1)."""
    base = spec_for(shape, axes, mesh, rules)
    sizes = axis_sizes(mesh)
    if "data" not in sizes:
        return base
    parts = list(base) + [None] * (len(shape) - len(base))
    best, best_dim = -1, None
    for i, (dim, cur) in enumerate(zip(shape, parts)):
        if cur is None and dim % sizes["data"] == 0 and dim > best:
            best, best_dim = dim, i
    if best_dim is not None:
        parts[best_dim] = "data"
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def batch_spec(mesh) -> tuple:
    """Batch-dim sharding: over pod+data when multi-pod."""
    if "pod" in axis_sizes(mesh):
        return (("pod", "data"),)
    return ("data",)


@dataclass(frozen=True)
class NamedSharding:
    """A tensor's spec on a ``DeviceMesh`` and the DTensor placements it
    gives, one per mesh dimension."""
    mesh: Any
    spec: tuple
    placements: tuple


def placements_for(spec: tuple, mesh) -> tuple:
    """``Shard(i)`` on each mesh dimension that a tensor dim ``i``'s spec
    entry names (several mesh dims on one tensor dim shard it in mesh
    order), ``Replicate()`` on the others."""
    out = []
    for name in axis_sizes(mesh):
        dim = next((i for i, e in enumerate(spec)
                    if e is not None and name in _flat(e)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _map_leaves(fn, shapes_tree, axes_tree):
    """``fn(shape, axes)`` over the leaves of ``axes_tree`` (tuples of axis
    names) and the matching leaves of ``shapes_tree`` (anything with a
    ``.shape``), through dicts and lists."""
    if _is_axes(axes_tree):
        return fn(tuple(shapes_tree.shape), axes_tree)
    if isinstance(axes_tree, dict):
        return {k: _map_leaves(fn, shapes_tree[k], v)
                for k, v in axes_tree.items()}
    return [_map_leaves(fn, s, a) for s, a in zip(shapes_tree, axes_tree)]


def specs_for_tree(shapes_tree: Pytree, axes_tree: Pytree, mesh,
                   rules: dict | None = None) -> Pytree:
    return _map_leaves(lambda s, a: spec_for(s, a, mesh, rules),
                       shapes_tree, axes_tree)


def shardings_for_tree(shapes_tree: Pytree, axes_tree: Pytree, mesh,
                       rules: dict | None = None) -> Pytree:
    """shapes_tree: tensors or param specs; axes_tree: logical axes."""
    def one(shape, axes):
        spec = spec_for(shape, axes, mesh, rules)
        return NamedSharding(mesh, spec, placements_for(spec, mesh))
    return _map_leaves(one, shapes_tree, axes_tree)


def zero1_shardings_for_tree(shapes_tree, axes_tree, mesh, rules=None):
    def one(shape, axes):
        spec = zero1_spec(shape, axes, mesh, rules)
        return NamedSharding(mesh, spec, placements_for(spec, mesh))
    return _map_leaves(one, shapes_tree, axes_tree)
