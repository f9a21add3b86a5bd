"""The collectives of the distributed paths, over the axes of a mesh.

The reference writes its collectives inside ``shard_map`` bodies
(``jax.lax.pmax`` / ``psum`` / ``pmean`` / ``all_gather`` / ``all_to_all``
over named mesh axes).  Here every function runs per rank, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` name
the axes ("data", "model", or "pod", "data", "model").  The groups come
from the mesh (one per axis, made when the mesh was built); nothing here
picks a backend.  A reduction over several axes is one all-reduce per axis
in turn, which is the same reduction as one over the axes' product group
and needs no group beyond the mesh's own.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` in mesh order, for a ``DeviceMesh`` or any
    mesh with a ``.shape`` mapping and ``.axis_names`` (what the sharding
    rules read)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def _names(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes``, row-major over the axes in the
    order given (``jax.lax.axis_index`` of one axis, the reference's
    ``_axis_index`` of several)."""
    idx = 0
    for name in _names(axes):
        idx = idx * axis_sizes(mesh)[name] + mesh.get_local_rank(name)
    return idx


def axes_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[n] for n in _names(axes))


def all_reduce(t: torch.Tensor, op, mesh, axes) -> torch.Tensor:
    """Reduce ``t`` in place with ``op`` over the mesh ``axes`` (one
    all-reduce per axis) and return it."""
    for name in _names(axes):
        dist.all_reduce(t, op=op, group=mesh.get_group(name))
    return t


def all_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``[n * t.shape[0], ...]``: every rank's ``t`` along ``axis``,
    stacked in axis order, in ``t``'s dtype (nothing is up-cast)."""
    n = axis_sizes(mesh)[axis]
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(),
                                group=mesh.get_group(axis))
    return out


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t``: ``[n, ...]``.  Chunk j goes to the rank of index j along
    ``axis``; the result stacks the chunks received by source
    (``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)``).
    Differentiable where ``t`` needs a gradient."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllToAll.apply(t, mesh, axis)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=mesh.get_group(axis))
    return out


# ---------------------------------------------------------------------------
# Differentiable forms (a training step runs the expert-parallel MoE)
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all`; its backward sends the gradients back the same
    way (the exchange is its own inverse)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(),
                               group=mesh.get_group(axis))
        return out

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.mesh, ctx.axis), None, None


class _ReduceSum(torch.autograd.Function):
    """Sum over the mesh ``axes`` with the identity as its backward: every
    rank holds the same sum and the same gradient of it (Megatron's reduce
    from the model-parallel region)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return all_reduce(t.clone(), dist.ReduceOp.SUM, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GradScale(torch.autograd.Function):
    """The identity, with its gradient scaled by ``s``."""

    @staticmethod
    def forward(ctx, t, s):
        ctx.s = s
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def reduce_sum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """A new tensor: ``t`` summed over the mesh ``axes``; differentiable
    (the identity backward of :class:`_ReduceSum`) where ``t`` needs a
    gradient."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _ReduceSum.apply(t, mesh, axes)
    return all_reduce(t.clone(), dist.ReduceOp.SUM, mesh, axes)


def grad_scale(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t`` itself, whose gradient is scaled by ``s`` where it has one."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _GradScale.apply(t, s)
    return t
