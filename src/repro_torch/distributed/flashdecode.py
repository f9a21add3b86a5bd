"""Distributed paged flash-decoding (the optimized serve path), per rank.

The counterpart of ``repro.distributed.flashdecode``.  The pool's block dim
shards over the whole mesh: rank ``shard`` (its row-major index over every
mesh axis) holds the global pool rows ``[shard * NB_loc, (shard + 1) *
NB_loc)``, and each sequence's blocks sit round-robin on the shards that
own them.  Every rank computes flash partials over its OWN blocks only and
the partials combine with one all-reduce MAX and one SUM (flash-decoding
algebra), so the only cross-rank payload is ``[B, H, hd]``-sized.

Two layouts, as in the reference:
  * ``batch_sharded=True``  — the batch splits over the data axes
    ("pod", "data"); blocks over "model"; the combine reduces over "model".
  * ``batch_sharded=False`` — every rank holds the whole batch; blocks over
    the whole mesh; the combine reduces over every axis.

Where the reference's ``shard_map`` takes global arrays and its specs cut
them, each function here takes what its rank holds:
  * q, lengths: the rank's data shard's rows (batch-sharded) or all rows;
  * pools: the rank's own ``[NB_loc, ...]`` rows;
  * sharded table / logical: the rank's ``[B_l, MBl]`` slice of the
    reference's global ``[B, NS, MBl]`` arrays (GLOBAL block ids, -1 pads).
and returns the rank's rows of the output and its ``[B_l, MBl]`` columns of
the reference's shard-major heat (``[B, NS * MBl]``; heat is never combined
across ranks).  The heat is the reference's: per shard, each head's mass
against its LOCAL max, unnormalised.

The GQA shard body is the paged kernel's computation
(:func:`repro_torch.kernels.paged_attention.ops.paged_decode_partials`:
one split and one local-combine launch on CUDA tensors).  MLA's latent
body is torch ops, as the reference computes it in jnp.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..kernels.paged_attention import ops as paged_ops
from . import spmd
from .collectives import all_reduce, axis_index, axis_sizes

NEG_INF = -1e30

_DECODE_MESH = None


def set_decode_mesh(mesh) -> None:
    """Install the mesh the sharded decode and the EP MoE run on (a
    ``DeviceMesh``; ``None`` turns them off)."""
    global _DECODE_MESH
    _DECODE_MESH = mesh


def get_decode_mesh():
    return _DECODE_MESH


def _mesh():
    if _DECODE_MESH is None:
        raise RuntimeError("set_decode_mesh(mesh) first: the sharded decode "
                           "runs under an installed mesh")
    return _DECODE_MESH


def shard_layout(mesh, batch_sharded: bool) -> tuple[int, int, tuple]:
    """(this rank's pool shard, its slot in the sharded table's NS axis,
    the axes the partials combine over).  The shard is the reference's
    ``_axis_index`` over the data axes times M plus the model index, or
    over every axis (:func:`repro_torch.distributed.collectives.
    axis_index`)."""
    names = tuple(axis_sizes(mesh))
    data_axes = tuple(n for n in names if n != "model")
    if batch_sharded:
        m = axis_index(mesh, "model")
        shard = axis_index(mesh, data_axes) * axis_sizes(mesh)["model"] + m
        return shard, m, ("model",)
    shard = axis_index(mesh, names)
    return shard, shard, names


def owned_blocks(table: torch.Tensor, shard: int, nb_loc: int):
    """``table``'s GLOBAL block ids as this shard's local rows, -1 where
    a block is unmapped or another shard's."""
    local = table - shard * nb_loc
    ok = (table >= 0) & (local >= 0) & (local < nb_loc)
    return torch.where(ok, local, torch.full_like(local, -1)).to(
        torch.int32).contiguous()


def _combine(m_loc, l_loc, acc, mesh, axes):
    """Merge the ranks' partials over ``axes``: acc_g / max(l_g, 1e-30).
    A rank with nothing valid (m_loc = NEG_INF) weighs 0, and a row masked
    on every rank comes out 0."""
    m_g = all_reduce(m_loc.clone(), dist.ReduceOp.MAX, mesh, axes)
    corr = torch.where(m_loc <= NEG_INF / 2, torch.zeros_like(m_loc),
                       torch.exp(m_loc - m_g))
    B, H = m_loc.shape
    packed = torch.cat([(acc * corr[..., None]).reshape(B, -1),
                        (l_loc * corr).reshape(B, -1)], dim=1)
    all_reduce(packed, dist.ReduceOp.SUM, mesh, axes)
    acc_g = packed[:, :-H].reshape(acc.shape)
    l_g = packed[:, -H:]
    return acc_g / l_g.clamp_min(1e-30)[..., None]


def paged_decode_attention_sharded(q, pool_k, pool_v, sharded_table,
                                   sharded_logical, lengths, *,
                                   block_tokens: int, window=None,
                                   soft_cap=None, batch_sharded: bool = True):
    """q: [B_l,H,hd]; pools: this rank's [NB_loc,bt,KVH,hd];
    sharded_table / logical: this rank's [B_l, MBl] int32 (global block
    ids, -1 pads); lengths: [B_l] int32 incl. the current token.  Returns
    (out [B_l,H,hd] in q's dtype, heat [B_l, MBl] f32).  DTensor inputs
    (the reference's global arrays: tables [B, NS, MBl]) run this per rank
    through :func:`repro_torch.distributed.spmd.flashdecode` and return the
    global (out, heat [B, NS * MBl])."""
    if spmd.is_dtensor(q, pool_k):
        return spmd.flashdecode(
            paged_decode_attention_sharded, (q,), (pool_k, pool_v),
            sharded_table, sharded_logical, lengths,
            kernel="paged_decode_partials", block_tokens=block_tokens,
            window=window, soft_cap=soft_cap, batch_sharded=batch_sharded)
    mesh = _mesh()
    shard, _, axes = shard_layout(mesh, batch_sharded)
    local = owned_blocks(sharded_table, shard, pool_k.shape[0])
    m_loc, l_loc, acc, heat = paged_ops.paged_decode_partials(
        q, pool_k, pool_v, local, lengths, block_tokens=block_tokens,
        logical=sharded_logical.to(torch.int32).contiguous(), window=window,
        soft_cap=soft_cap)
    out = _combine(m_loc, l_loc, acc, mesh, axes)
    return out.to(q.dtype), heat


def paged_mla_decode_sharded(q_eff, q_rope, pool_ckv, sharded_table,
                             sharded_logical, lengths, *, block_tokens: int,
                             kv_lora: int, qk_nope: int = 128,
                             batch_sharded: bool = True,
                             scale: float | None = None):
    """MLA absorbed decode over this rank's latent pool rows.
    q_eff: [B_l,H,L] (q_nope @ w_uk); q_rope: [B_l,H,Dr]; pool_ckv: this
    rank's [NB_loc, bt, L+Dr]; sharded_table / logical / lengths as in
    :func:`paged_decode_attention_sharded`; ``scale`` the softmax scale
    (None: ``(qk_nope + Dr) ** -0.5``).  Returns (o_lat [B_l,H,L] f32,
    heat [B_l, MBl]); DTensor inputs as in
    :func:`paged_decode_attention_sharded`."""
    if spmd.is_dtensor(q_eff, pool_ckv):
        return spmd.flashdecode(
            paged_mla_decode_sharded, (q_eff, q_rope), (pool_ckv,),
            sharded_table, sharded_logical, lengths,
            block_tokens=block_tokens, kv_lora=kv_lora, qk_nope=qk_nope,
            batch_sharded=batch_sharded, scale=scale)
    mesh = _mesh()
    shard, _, axes = shard_layout(mesh, batch_sharded)
    local = owned_blocks(sharded_table, shard, pool_ckv.shape[0])
    Bl, MBl = local.shape
    bt = block_tokens
    if scale is None:
        scale = 1.0 / math.sqrt(qk_nope + q_rope.shape[-1])
    lat = pool_ckv[local.clamp_min(0).long()].reshape(Bl, MBl * bt, -1)
    ckv, kr = lat[..., :kv_lora].float(), lat[..., kv_lora:].float()
    s = (torch.einsum("bhl,bsl->bhs", q_eff.float(), ckv)
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), kr)) * scale
    pos = (sharded_logical.clamp_min(0).long()[:, :, None] * bt
           + torch.arange(bt, device=local.device)).reshape(Bl, MBl * bt)
    valid = (local >= 0).repeat_interleave(bt, dim=1) & \
        (pos < lengths[:, None])
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    m_loc = s.amax(-1)                                        # [B_l, H]
    p = torch.where(valid[:, None], torch.exp(s - m_loc[..., None]),
                    torch.zeros_like(s))
    acc = torch.einsum("bhs,bsl->bhl", p, ckv)
    heat = p.sum(dim=1).reshape(Bl, MBl, bt).sum(-1)
    return _combine(m_loc, p.sum(-1), acc, mesh, axes), heat
