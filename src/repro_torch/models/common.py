"""Parameter-spec machinery and numeric helpers shared by the model code.

The PyTorch counterpart of ``repro.models.common``: a *spec* (nested dict of
:class:`ParamSpec`) describes every weight's shape, init and logical axes,
and :func:`materialize` draws real tensors for it from an explicit
``torch.Generator`` on an explicit device.  The draws differ from
``jax.random`` for the same seed, so tests that compare against the JAX
package convert its materialized arrays (:mod:`repro_torch.convert`)
instead of re-drawing.

Weights keep the JAX layout (``x @ w`` with ``w`` as ``[d_in, d_out]``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

Pytree = Any

F32 = torch.float32
BF16 = torch.bfloat16


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's dtype.  On the CPU a bf16 product runs as one
    float32 product rounded once to bf16 — how XLA's CPU backend computes
    the reference's bf16 dots; PyTorch's own CPU bf16 kernel rounds some
    elements differently at prefill sizes, enough to flip a greedy token at
    a near-tie.  On the GPU the product stays a bf16 GEMM with float32
    accumulation."""
    w = w.to(x.dtype)
    if x.dtype == BF16 and not x.is_cuda:
        return (x.float() @ w.float()).to(BF16)
    return x @ w


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"         # normal | zeros | ones | scaled
    scale: float | None = None   # stddev override for normal/scaled
    dtype: Any = F32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def _fan_in(shape: tuple[int, ...]) -> int:
    # last axis is the output axis by convention (x @ w)
    return math.prod(shape[:-1]) if len(shape) > 1 else shape[0]


def materialize(gen: torch.Generator, spec: Pytree, *,
                device: torch.device | str, dtype=None) -> Pytree:
    """Draw real parameters for ``spec`` (dicts walked in sorted-key order,
    lists in order).  ``dtype`` overrides every leaf's spec dtype — the
    full-width model is materialized straight into bf16."""
    def leaf(p: ParamSpec) -> torch.Tensor:
        dt = dtype or p.dtype
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt, device=device)
        std = p.scale if p.scale is not None \
            else 1.0 / math.sqrt(max(1, _fan_in(p.shape)))
        x = torch.randn(p.shape, generator=gen, dtype=F32, device=device)
        return x.mul_(std).to(dt)

    def walk(node):
        if isinstance(node, ParamSpec):
            return leaf(node)
        if isinstance(node, list):
            return [walk(n) for n in node]
        return {k: walk(node[k]) for k in sorted(node)}

    return walk(spec)


# ---------------------------------------------------------------------------
# Common numeric helpers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (offset + scale.float())
    return y.to(x.dtype)


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    """Pad embedding tables so the vocab axis shards evenly (MaxText-style)."""
    return ((vocab + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split layout, as the JAX package)
# ---------------------------------------------------------------------------

# The cos/sin of every rotary angle come from one host table per (head_dim,
# theta, device), computed once in float32 with the C library's sinf/cosf —
# the functions the reference's XLA CPU backend calls — from float32 angles
# pos * freq, with freq = theta^(-2i/hd) evaluated in float64 and rounded
# (what XLA's constant folding produces).  PyTorch's vectorized sin/cos
# differ in the last bit for a few percent of angles, and in bf16 that is
# enough to flip a greedy token at a near-tie.
_ROPE_TABLES: dict = {}


def _libm_sincos():
    """(sinf, cosf) of the C math library, loaded at first use."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for fn in (libm.sinf, libm.cosf):
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float]
    return libm.sinf, libm.cosf


def rope_freqs(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return (1.0 / (float(theta) ** (np.arange(0, head_dim, 2) / head_dim))
            ).astype(np.float32)


def rope_table(n: int, head_dim: int, theta: float, device):
    """(cos, sin), each [>= n, head_dim/2] float32 on ``device``."""
    key = (head_dim, float(theta), str(device))
    tab = _ROPE_TABLES.get(key)
    if tab is None or tab[0].shape[0] < n:
        rows = max(n, 1024, 2 * tab[0].shape[0] if tab is not None else 0)
        ang = (np.arange(rows, dtype=np.float32)[:, None]
               * rope_freqs(head_dim, theta)).ravel().tolist()
        sinf, cosf = _libm_sincos()
        cos = np.fromiter(map(cosf, ang), np.float32, len(ang))
        sin = np.fromiter(map(sinf, ang), np.float32, len(ang))
        shape = (rows, head_dim // 2)
        tab = (torch.from_numpy(cos.reshape(shape)).to(device),
               torch.from_numpy(sin.reshape(shape)).to(device))
        _ROPE_TABLES[key] = tab
    return tab


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, max_pos: int,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: integer, broadcastable to
    [..., seq], each below ``max_pos``.  The first and second halves of
    head_dim are the rotated pairs."""
    hd = x.shape[-1]
    cos_t, sin_t = rope_table(max_pos, hd, theta, x.device)
    pos = positions.long()
    cos = cos_t[pos][..., None, :]                      # [..., seq, 1, hd/2]
    sin = sin_t[pos][..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
