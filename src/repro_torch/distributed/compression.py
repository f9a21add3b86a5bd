"""Gradient compression for the data-parallel all-reduce, with error feedback.

The counterpart of ``repro.distributed.compression``.  Modes:
  none  — plain float32 all-reduce.
  bf16  — cast to bf16 and back before the all-reduce (the reference's
          ``psum(v.astype(bf16).astype(f32))``), float32 accumulate.
  int8  — per-row int8 quantization + float32 scale, exchanged with
          ``all_gather_into_tensor`` over the data axis and reduced locally
          in float32 (the 1-bit-Adam-style formulation that keeps the sum
          exact per shard).  ~4x fewer bytes on the wire: the int8 values
          and the scales cross it as they are, nothing is up-cast first.
          Error feedback carries the quantization residual into the next
          step, so compression error does not bias convergence.

Where the reference takes the gradients of every shard stacked on a
leading ``[n, ...]`` axis in one process, each rank here passes its OWN
gradient and gets the mean.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from .collectives import all_gather, all_reduce, axis_sizes

Pytree = Any
F32 = torch.float32


def quantize_int8(x: torch.Tensor):
    """Symmetric per-row int8 quantization. x: [*, d] -> (q int8, scale
    [*, 1] f32).  ``torch.round`` rounds half to even, as ``jnp.round``."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(F32)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_residual(x: torch.Tensor, err: torch.Tensor):
    """Apply error feedback: quantize (x + err) row by row; returns (q
    [rows, d], scale [rows, 1], new_err in x's shape)."""
    target = x.to(F32) + err
    q, scale = quantize_int8(target.reshape(-1, x.shape[-1]) if x.dim() > 1
                             else target[None, :])
    deq = dequantize_int8(q, scale).reshape(target.shape)
    return q, scale, target - deq


def compressed_psum_mean(x: torch.Tensor, mesh, axis: str = "data", *,
                         mode: str = "int8", err: torch.Tensor | None = None):
    """Mean of every rank's ``x`` (this rank's microbatch gradient of the
    full tensor) over the mesh ``axis``.  Returns (mean f32, new_err);
    ``err`` is the error-feedback state (int8 mode; zeros when None)."""
    n = axis_sizes(mesh)[axis]
    if mode == "none":
        return all_reduce(x.to(F32).clone(), dist.ReduceOp.SUM, mesh,
                          axis) / n, err
    if mode == "bf16":
        v = x.to(torch.bfloat16).to(F32)
        return all_reduce(v, dist.ReduceOp.SUM, mesh, axis) / n, err
    if mode != "int8":
        raise ValueError(f"unknown compression mode {mode!r}")
    if err is None:
        err = torch.zeros(x.shape, dtype=F32, device=x.device)
    q, scale, new_err = compress_residual(x, err)
    qg = all_gather(q, mesh, axis)                 # int8 on the wire
    sg = all_gather(scale, mesh, axis)
    total = dequantize_int8(qg, sg).reshape((n,) + tuple(x.shape)).sum(0)
    return total / n, new_err


def wire_bytes(x: torch.Tensor, mode: str = "int8") -> int:
    """Bytes one rank puts on the wire for ``x`` in ``mode``: int8 values
    plus one float32 scale per row, bf16, or float32."""
    if mode == "int8":
        rows = x.numel() // x.shape[-1] if x.dim() > 1 else 1
        return x.numel() + 4 * rows
    return x.numel() * (2 if mode == "bf16" else 4)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of dict / list trees of one structure."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, list):
        return [_tree_map(fn, *(t[i] for t in trees))
                for i in range(len(head))]
    return fn(*trees)


def compressed_grad_mean_tree(grads: Pytree, mesh, axis: str = "data", *,
                              mode: str = "int8",
                              err_tree: Pytree | None = None):
    """:func:`compressed_psum_mean` over every leaf of this rank's
    gradient tree (dicts and lists).  Returns (mean tree, error tree)."""
    if err_tree is None:
        err_tree = _tree_map(lambda g: None, grads)
    pairs = _tree_map(lambda g, e: compressed_psum_mean(
        g, mesh, axis, mode=mode, err=e), grads, err_tree)
    return (_tree_map(lambda g, p: p[0], grads, pairs),
            _tree_map(lambda g, p: p[1], grads, pairs))
