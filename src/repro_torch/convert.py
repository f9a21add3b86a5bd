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
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
