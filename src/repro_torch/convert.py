"""Convert the JAX package's materialized parameters to this package's layout.

The JAX package draws its weights with ``jax.random``; PyTorch's generators
give other numbers for the same seed, so a test that holds the two packages
to the same outputs hands the JAX arrays (as numpy) to :func:`params_from_jax`
instead of re-drawing.  Weight layouts are shared (``[d_in, d_out]``); the
one change is that a scan segment's ``[reps, ...]`` leaves (the decoder's
segments, and Whisper's encoder ``encoder/blocks``) become a list of one
subtree per repetition.  :func:`params_to_numpy` goes back (gradients are
compared leaf by leaf in the reference's layout), and
:func:`opt_state_from_jax` converts an ``AdamWState``.

For the distributed paths, one rank's part of the reference's arrays:
:func:`rank_params_from_jax` (the expert-parallel slice of every MoE layer),
:func:`cache_from_jax` (a pool shard's ``NB_loc`` rows) and
:func:`sharded_tables` (the reference's ``[B, NS, MBl]`` sharded table and
logical index of a block table).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .models.decode import POOL_KEYS
from .models.moe import moe_rank_params
from .optim.adamw import AdamWState

Pytree = Any


def _tensor(x, device, dtype) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":      # ml_dtypes bf16: go through f32
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))      # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: Pytree, *, device, dtype=None) -> Pytree:
    """``tree``: the JAX package's param pytree with array leaves (numpy or
    anything ``np.asarray`` accepts).  Returns the port's params on
    ``device`` (``"cuda"`` for the kernels, ``"cpu"`` for the plain
    versions), cast to ``dtype`` when given."""
    def unstack(seg):
        reps = np.asarray(next(iter(_leaves(seg)))).shape[0]
        return [_map(seg, lambda x, r=r: _tensor(np.asarray(x)[r], device,
                                                 dtype)) for r in range(reps)]

    out = {k: _map(v, lambda x: _tensor(x, device, dtype))
           for k, v in tree.items() if k not in ("blocks", "encoder")}
    out["blocks"] = {key: unstack(seg) if key.startswith("s")
                     else _map(seg, lambda x: _tensor(x, device, dtype))
                     for key, seg in tree["blocks"].items()}
    if "encoder" in tree:               # Whisper: a stacked encoder scan
        enc = tree["encoder"]
        out["encoder"] = {
            "blocks": unstack(enc["blocks"]),
            "final_norm": _map(enc["final_norm"],
                               lambda x: _tensor(x, device, dtype))}
    return out


def _to_numpy(x) -> np.ndarray:
    t = x.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_to_numpy(tree: Pytree) -> Pytree:
    """The inverse of :func:`params_from_jax`: the port's params (or
    gradients) as numpy arrays in the reference's layout, each scan
    segment's list restacked into ``[reps, ...]`` leaves (bf16 as
    float32)."""
    def stack(seg):
        return _stack([_map(r, _to_numpy) for r in seg])

    out = {k: _map(v, _to_numpy) for k, v in tree.items()
           if k not in ("blocks", "encoder")}
    out["blocks"] = {key: stack(seg) if isinstance(seg, list)
                     else _map(seg, _to_numpy)
                     for key, seg in tree["blocks"].items()}
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {"blocks": stack(enc["blocks"]),
                          "final_norm": _map(enc["final_norm"], _to_numpy)}
    return out


def _stack(reps: list) -> Pytree:
    if isinstance(reps[0], dict):
        return {k: _stack([r[k] for r in reps]) for k in reps[0]}
    return np.stack(reps)


def opt_state_from_jax(state, *, device):
    """The reference's ``AdamWState`` (step, mu, nu) as the port's
    :class:`repro_torch.optim.AdamWState` on ``device``."""
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        mu=params_from_jax(state.mu, device=device, dtype=torch.float32),
        nu=params_from_jax(state.nu, device=device, dtype=torch.float32))


def _ep_slice(tree, m: int, M: int):
    if isinstance(tree, list):
        return [_ep_slice(t, m, M) for t in tree]
    if not isinstance(tree, dict):
        return tree
    if "router" in tree and "w_in" in tree:
        return moe_rank_params(tree, m, M)
    return {k: _ep_slice(v, m, M) for k, v in tree.items()}


def rank_params_from_jax(tree: Pytree, *, model_index: int, model_size: int,
                         device, dtype=None) -> Pytree:
    """Model rank ``model_index``'s params on an ``model_size``-way
    "model" axis: :func:`params_from_jax` (a whole model's tree; a bare
    MoE layer's dict is converted leaf by leaf), then every MoE layer cut
    to the rank's experts and shared-expert columns / rows
    (:func:`repro_torch.models.moe.moe_rank_params`); the rest whole."""
    if "blocks" in tree:
        out = params_from_jax(tree, device=device, dtype=dtype)
    else:
        out = _map(tree, lambda x: _tensor(x, device, dtype))
    return _ep_slice(out, model_index, model_size)


def cache_from_jax(tree: Pytree, *, device, dtype=None, shard: int = 0,
                   num_shards: int = 1) -> Pytree:
    """The reference's serving cache (same structure: a scan segment's
    leaves stacked ``[reps, ...]``) on ``device``; every pool leaf cut to
    shard ``shard``'s rows ``[shard * NB_loc, (shard + 1) * NB_loc)`` of
    ``num_shards``, the per-slot leaves whole; cast to ``dtype`` when
    given."""
    def walk(node, stacked):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, stacked)
                continue
            t = _tensor(v, device, dtype)
            if k in POOL_KEYS:
                axis = 1 if stacked else 0
                n = t.shape[axis] // num_shards
                t = t.narrow(axis, shard * n, n).contiguous()
            out[k] = t
        return out
    return {k: walk(v, k.startswith("s")) for k, v in tree.items()}


def sharded_tables(block_table, *, nb_loc: int, num_slots: int):
    """The reference's sharded table and logical index of a ``[B, MB]``
    block table of GLOBAL block ids (-1 = unmapped) on a pool sharded
    ``nb_loc`` rows per shard: block ``phys`` sits in slot ``(phys //
    nb_loc) % num_slots`` (its model rank when the batch is sharded, its
    shard otherwise), each slot's blocks in logical order.  Returns
    (table, logical), int32 numpy ``[B, num_slots, MB // num_slots]``,
    -1 padded."""
    tbl = np.asarray(block_table)
    B, MB = tbl.shape
    mbl = MB // num_slots
    table = np.full((B, num_slots, mbl), -1, np.int32)
    logical = np.full((B, num_slots, mbl), -1, np.int32)
    for b in range(B):
        used = [0] * num_slots
        for lb in range(MB):
            phys = int(tbl[b, lb])
            if phys < 0:
                continue
            slot = (phys // nb_loc) % num_slots
            if used[slot] == mbl:
                raise ValueError(f"row {b}: more than {mbl} blocks on "
                                 f"slot {slot}")
            table[b, slot, used[slot]] = phys
            logical[b, slot, used[slot]] = lb
            used[slot] += 1
    return table, logical


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
