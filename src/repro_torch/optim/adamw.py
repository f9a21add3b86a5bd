"""AdamW with decoupled weight decay and global-norm clipping over float32
master weights (``repro.optim.adamw``).

Plain functions over the port's param tree (dicts and lists of tensors), no
``torch.optim``: the state is an :class:`AdamWState` of float32 moments
shaped like the params.  Unlike the reference, whose arrays are immutable,
:func:`adamw_update` writes the new params and moments into the given
tensors, one leaf at a time: at deepseek-7b's widths a second copy of the
float32 params and moments would not fit the card beside the first."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

Pytree = Any
F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    mu: Pytree               # f32, like params
    nu: Pytree               # f32, like params


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of a dict/list tree (and of trees of
    the same structure in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _shard_like(grads, moments) -> None:
    """Replace each DTensor leaf of ``grads`` by itself redistributed to
    its moment's placements, in place (dicts and lists)."""
    keys = grads.keys() if isinstance(grads, dict) else range(len(grads))
    for k in keys:
        g, m = grads[k], moments[k]
        if isinstance(g, (dict, list)):
            _shard_like(g, m)
        elif isinstance(g, DTensor):
            grads[k] = g.redistribute(m.device_mesh, m.placements)
            del g


def adamw_init(params: Pytree) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: Pytree) -> torch.Tensor:
    return torch.sqrt(sum(l.float().square().sum()
                          for l in tree_leaves(tree)))


def adamw_update(params: Pytree, grads: Pytree, state: AdamWState, *,
                 lr: torch.Tensor, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: float | None = 1.0):
    """Returns (params, new_state, metrics); ``params`` and the moments of
    ``state`` are updated in place (call it under ``torch.no_grad()`` when
    the params require grad).  Each expression keeps the reference's order
    of float32 operations.  DTensor grads (a sharded step) first take
    their moments' placements, once per leaf and in ``grads``' own
    containers (each whole gradient freed as its shard replaces it):
    ZeRO-1's reduce-scatter over the data axes, after which the norm, the
    moments and the update work on the shards."""
    _shard_like(grads, state.mu)
    gnorm = global_norm(grads)
    scale = None
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / gnorm.clamp_min(1e-9), max=1.0)

    step = state.step + 1
    t = step.to(F32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=t.device), t)

    def upd(p, g, m, v):
        g = g.float() if scale is None else g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
            + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    tree_map(upd, params, grads, state.mu, state.nu)
    metrics = {"grad_norm": gnorm,
               "update_norm": lr * torch.ones((), dtype=F32,
                                              device=gnorm.device)}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), metrics
