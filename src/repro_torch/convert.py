"""Convert the JAX package's materialized parameters to this package's layout.

The JAX package draws its weights with ``jax.random``; PyTorch's generators
give other numbers for the same seed, so a test that holds the two packages
to the same outputs hands the JAX arrays (as numpy) to :func:`params_from_jax`
instead of re-drawing.  Weight layouts are shared (``[d_in, d_out]``); the
one change is that a scan segment's ``[reps, ...]`` leaves become a list of
one subtree per repetition.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

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
    out = {k: _map(v, lambda x: _tensor(x, device, dtype))
           for k, v in tree.items() if k != "blocks"}
    blocks = {}
    for key, seg in tree["blocks"].items():
        if key.startswith("s"):
            reps = np.asarray(next(iter(_leaves(seg)))).shape[0]
            blocks[key] = [_map(seg, lambda x, r=r: _tensor(
                np.asarray(x)[r], device, dtype)) for r in range(reps)]
        else:
            blocks[key] = _map(seg, lambda x: _tensor(x, device, dtype))
    out["blocks"] = blocks
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
