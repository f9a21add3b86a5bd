"""The benchmark's weights, made from ``--seed`` on the device.

One ``normal_`` call with a seeded ``torch.Generator`` on the device fills
one flat buffer in the served dtype; each parameter is a contiguous view of
it (256-element aligned), scaled in place: products' weights N(0,
1/fan_in) (fan-in: the product's input width), the embedding N(0, 1),
norm scales 1, biases 0.  Names and shapes are the serving engine's
(``model_spec``); the same tensors go to the plain reference.
"""

from __future__ import annotations

import math

import torch

from .traffic import SEED_MASK

ALIGN = 256


def _walk(node, fn):
    """``node`` with ``fn`` applied to each leaf, dicts in sorted-key
    order, lists in order."""
    if isinstance(node, dict):
        return {k: _walk(node[k], fn) for k in sorted(node)}
    if isinstance(node, list):
        return [_walk(n, fn) for n in node]
    return fn(node)


def _padded(p) -> int:
    return -(-math.prod(p.shape) // ALIGN) * ALIGN


def make_params(spec: dict, seed: int, *, device, dtype) -> dict:
    """Tensors for every leaf of ``spec`` (the program's param spec:
    leaves with ``shape`` and ``init``) from ``seed``."""
    sizes: list = []
    _walk(spec, lambda p: sizes.append(_padded(p)))
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(int(seed) & SEED_MASK)
    flat = torch.empty(sum(sizes), dtype=dtype, device=dev)
    flat.normal_(generator=gen)
    off = [0]

    def leaf(p, embed: bool):
        t = flat[off[0]:off[0] + math.prod(p.shape)].view(p.shape)
        off[0] += _padded(p)
        if p.init == "ones":
            t.fill_(1)
        elif p.init == "zeros":
            t.zero_()
        elif not embed:
            fan_in = p.shape[-2] if len(p.shape) > 1 else p.shape[0]
            t.mul_(1.0 / math.sqrt(fan_in))
        return t
    return {k: _walk(spec[k], lambda p, e=(k == "embed"): leaf(p, e))
            for k in sorted(spec)}
