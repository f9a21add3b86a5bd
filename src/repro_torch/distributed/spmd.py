"""DTensor bridges: where a step function meets a DTensor, the op that
DTensor's sharding propagation does not cover runs on each rank's local
shards through ``torch.distributed.tensor.experimental.local_map``, with
the placements in and out stated.

The step functions (:func:`repro_torch.models.decode.prefill_step`,
:func:`~repro_torch.models.decode.decode_step` and
:func:`repro_torch.training.train_step.make_train_step`'s step) run
unchanged on plain tensors; given DTensors (the dry-run's sharded cells,
:mod:`repro_torch.launch.dryrun`) DTensor propagates their placements and
inserts the collectives, the counterpart of GSPMD, and these bridges take
over at the kernel wrappers and at the per-rank code of the distributed
slice.  Each bridge first redistributes its inputs to the placements it
states (the collectives this costs are DTensor's), then calls the plain
per-rank function on the local tensors.

:func:`flash_attention` and :func:`paged_decode_attention` are what the
model code calls: the kernel wrapper itself on plain tensors, its bridge
on DTensors.  The kernels are not ``aten`` ops, so a flop counter does not
see them: the bridges report each kernel's floating-point operations on
the rank's local shapes (:func:`note_flops`) to the active dry-run trace
(nothing listens otherwise; the plain-tensor path reports nothing).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels.flash_attention import ops as flash_ops
from ..kernels.paged_attention import ops as paged_ops
from .collectives import axis_index

_LISTENERS: list = []


def is_dtensor(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


def note_flops(kind: str, flops: float) -> None:
    for fn in _LISTENERS:
        fn(kind, flops)


def flash_flops(q, k, v, causal: bool) -> float:
    """A flash forward's flops on these shapes: 2 * (hd + hdv) per
    query-key pair, half of them under a causal mask of equal lengths (the
    backward does 2.5 times as many)."""
    B, Sq, H, hd = q.shape
    pairs = B * H * Sq * k.shape[1] * (0.5 if causal and Sq == k.shape[1]
                                       else 1.0)
    return 2.0 * pairs * (hd + v.shape[-1])


def paged_flops(q, table, page_tokens: int) -> float:
    """A paged decode's flops: 4 * hd per query head and key slot of the
    table ([B, pages])."""
    B, H, hd = q.shape
    return 4.0 * B * H * hd * table.shape[1] * page_tokens


def listen(fn) -> None:
    _LISTENERS.append(fn)


def unlisten(fn) -> None:
    _LISTENERS.remove(fn)


def mesh_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def placements(mesh, shards: dict) -> tuple:
    """Placements from ``{mesh axis name: tensor dim}``: ``Shard(dim)`` on
    the named axes, ``Replicate()`` on the others."""
    return tuple(Shard(shards[n]) if n in shards else Replicate()
                 for n in mesh_names(mesh))


def batch_axes(x: DTensor, dim: int = 0) -> dict:
    """``{axis: dim}`` for every mesh axis on which ``x`` is sharded along
    ``dim`` (the axes its batch rows split over)."""
    return {n: dim for n, p in zip(mesh_names(x.device_mesh), x.placements)
            if isinstance(p, Shard) and p.dim == dim}


def local_call(fn, mesh, in_placements, out_placements, *args,
               grad_placements=None):
    """``fn(*local args)`` under ``local_map``: each DTensor argument is
    redistributed to its entry of ``in_placements`` (``None`` for a
    non-tensor argument) and the outputs are wrapped with
    ``out_placements`` (a tuple of placements per output, or ``None`` for
    a non-tensor output).  ``grad_placements``: the placements of the
    inputs' local gradients where they differ from ``in_placements`` (a
    replicated input whose gradient each rank holds a part of)."""
    wrapped = local_map(fn, out_placements=out_placements,
                        in_placements=tuple(in_placements),
                        in_grad_placements=None if grad_placements is None
                        else tuple(grad_placements),
                        device_mesh=mesh, redistribute_inputs=True)
    return wrapped(*args)


def replicate(x, mesh):
    """``x`` as a DTensor replicated on every axis of ``mesh`` (a plain
    tensor is taken as already replicated)."""
    rep = tuple(Replicate() for _ in mesh_names(mesh))
    if isinstance(x, DTensor):
        return x.redistribute(mesh, rep)
    return DTensor.from_local(x, mesh, rep, run_check=False)


def axis_size(mesh, name: str) -> int:
    return dict(zip(mesh_names(mesh), mesh.shape))[name]


def partial_on(mesh, pl: tuple, axes) -> tuple:
    """``pl`` with ``Partial()`` on the named mesh axes where it
    replicates: the placements of a local gradient that each rank holds a
    part of (its rows' contribution to a replicated weight)."""
    return tuple(Partial() if n in axes and isinstance(p, Replicate) else p
                 for n, p in zip(mesh_names(mesh), pl))


def _kv_heads(mesh, heads: int, kv_heads: int):
    """How a rank's heads lie.  The query heads split over "model" when
    their count divides by it (Megatron's tensor parallelism); then the
    KV heads are ``"split"`` too when their count divides, else ``(first,
    count)``, the run of KV heads the rank's query heads read out of K/V
    replicated over "model" (under GQA query head h reads KV head h // G,
    G = heads // kv_heads).  ``None``: the query heads do not split, or a
    rank's straddle KV groups unevenly; both then replicate."""
    if "model" not in mesh_names(mesh):
        return None
    M = axis_size(mesh, "model")
    if heads % M:
        return None
    if kv_heads % M == 0:
        return "split"
    per, G = heads // M, heads // kv_heads
    if per % G and G % per:
        return None
    first = axis_index(mesh, "model") * per // G
    return first, max(1, per // G)


def _with(axes: dict, heads: bool, dim: int) -> dict:
    """``axes`` (the data axes' splits) plus "model" on ``dim`` when the
    heads split."""
    out = {n: d for n, d in axes.items() if n != "model"}
    if heads:
        out["model"] = dim
    return out


def _kv_run(kv, x):
    """The KV heads ``kv`` (:func:`_kv_heads`) of a local ``x`` replicated
    over "model" (K/V [B, S, KVH, hd], a pool [NB, bt, KVH, hd]); ``x``
    itself when they split or replicate."""
    if not isinstance(kv, tuple):
        return x
    return x.narrow(2, kv[0], kv[1]).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, **opts):
    """:func:`repro_torch.kernels.flash_attention.ops.flash_attention`; on
    DTensors the kernel runs on local shards: the batch stays split as
    q's is (over the data axes), the query heads split over "model" when
    their count divides by it (Megatron TP), else replicate; K/V split
    with them when their head count divides too, else each rank takes the
    KV heads its query heads read (:func:`_kv_heads`) out of K/V
    replicated over "model"."""
    if not isinstance(q, DTensor):
        return flash_ops.flash_attention(q, k, v, **opts)
    mesh = q.device_mesh
    kv = _kv_heads(mesh, q.shape[2], k.shape[2])
    axes = batch_axes(q)
    pq = placements(mesh, _with(axes, kv is not None, 2))
    pk = placements(mesh, _with(axes, kv == "split", 2))
    # a rank's K/V gradient covers its KV heads only: a part of a sum
    gk = partial_on(mesh, pk, ("model",) if isinstance(kv, tuple) else ())
    causal = opts.get("causal", True)

    def local(a, b, c):
        b, c = _kv_run(kv, b), _kv_run(kv, c)
        flops = flash_flops(a, b, c, causal)
        note_flops("flash_attention", flops)
        out = flash_ops.flash_attention(a, b, c, **opts)
        if out.requires_grad:
            # fires once per backward (a remat recompute is not
            # differentiated)
            out.register_hook(lambda g: note_flops("flash_attention_bwd",
                                                   2.5 * flops))
        return (out,)
    return local_call(local, mesh, (pq, pk, pk), (pq,), q, k, v,
                      grad_placements=(pq, gk, gk))[0]


def paged_decode_attention(q, pool_k, pool_v, table, lengths, **opts):
    """:func:`repro_torch.kernels.paged_attention.ops.
    paged_decode_attention`; on DTensors the kernel runs on local shards:
    q, the table and the lengths keep q's batch split, the query heads
    split over "model" when their count divides by it; the pools are
    gathered whole on the data axes (every rank reads any block of its
    rows' tables) and split by KV head like q, or, where the KV head count
    does not divide, gathered whole and cut to the KV heads the rank's
    query heads read.  The heat sums over the heads: partial over "model"
    when they split."""
    if not is_dtensor(q, pool_k, pool_v, table):
        return paged_ops.paged_decode_attention(q, pool_k, pool_v, table,
                                                lengths, **opts)
    page_tokens = opts.get("page_blocks", 1) * opts["block_tokens"]

    def kernel(a, pk, pv, t, n, **o):
        note_flops("paged_decode_attention", paged_flops(a, t, page_tokens))
        return paged_ops.paged_decode_attention(a, pk, pv, t, n, **o)
    return paged_gather(kernel, (q,), (pool_k, pool_v), table, lengths,
                        kv_heads=pool_k.shape[2], **opts)


def paged_gather(fn, qs, pools, table, lengths, *, kv_heads=None, **opts):
    """``fn(*qs, *pools, table, lengths, **opts)`` -> (out, heat [B, MB])
    on local shards, as :func:`paged_decode_attention` places them; pools
    without a KV-head dim (``kv_heads=None``: MLA's latents) are gathered
    whole, and the query heads split alone."""
    q = qs[0]
    mesh = next(x.device_mesh for x in (*qs, *pools, table)
                if isinstance(x, DTensor))
    kv = _kv_heads(mesh, q.shape[1], kv_heads or q.shape[1])
    heads = kv is not None
    axes = batch_axes(q) if isinstance(q, DTensor) else {}
    pq = placements(mesh, _with(axes, heads, 1))
    pp = placements(mesh, {"model": 2} if kv == "split" and kv_heads
                    else {})
    pb = placements(mesh, {n: 0 for n in axes if n != "model"})
    ph = tuple(Partial() if n == "model" and heads else p
               for n, p in zip(mesh_names(mesh), pb))
    nq, npool = len(qs), len(pools)

    def local(*a):
        ps = [_kv_run(kv, x) for x in a[nq:nq + npool]]
        return fn(*a[:nq], *ps, a[-2], a[-1], **opts)
    return local_call(local, mesh, (pq,) * nq + (pp,) * npool + (pb, pb),
                      (pq, ph), *qs, *pools, table, lengths)


# ---------------------------------------------------------------------------
# Paged pool writes
# ---------------------------------------------------------------------------

def pool_write(fn, pool, kv, table, *rest, **opts):
    """A pool scatter (``fn(pool, kv, table, *rest, **opts)``, in place) on
    a pool whose block dim splits over the whole mesh: the new rows, the
    table (GLOBAL block ids) and the rest are gathered whole on every rank,
    and each rank writes the rows of the blocks it owns."""
    from .flashdecode import owned_blocks
    mesh = pool.device_mesh
    rep = placements(mesh, {})
    names = mesh_names(mesh)

    def local(p, x, t, *r):
        own = owned_blocks(t, axis_index(mesh, names), p.shape[0])
        fn(p, x, own, *r, **opts)
        return (p,)
    ins = (pool.placements, rep, rep) + (rep,) * len(rest)
    local_call(local, mesh, ins, (pool.placements,), pool, kv, table, *rest)
    return pool


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

_EXPERT_SPLIT = {"w_in": 0, "w_gate": 0, "w_out": 0, "shared_in": 1,
                 "shared_gate": 1, "shared_out": 0}


def moe_apply(params: dict, x, cfg, mlp_kind: str, *, capacity=None):
    """A MoE layer on DTensor tokens ``x`` ([T, d]).  Where
    :func:`repro_torch.models.moe.ep_applies` (the reference's condition,
    on the global T) it runs :func:`~repro_torch.models.moe.moe_apply_ep`
    per rank: the tokens split over the data axes, the experts and the
    shared expert's ff over "model" (:func:`~repro_torch.models.moe.
    moe_rank_params`' slices), the router whole; the output keeps the
    tokens' split and the aux loss is replicated.  Otherwise the
    single-device dispatch runs on every rank over all tokens and whole
    params."""
    from ..models import moe
    mesh = x.device_mesh
    names = sorted(params)
    rep = placements(mesh, {})
    if moe.ep_applies(mesh, cfg.num_experts, x.shape[0]):
        data = {n: 0 for n in mesh_names(mesh) if n != "model"}
        px = placements(mesh, data)
        pp = [placements(mesh, {"model": _EXPERT_SPLIT[n]})
              if n in _EXPERT_SPLIT else rep for n in names]

        # the model ranks route the same tokens: their gradients for the
        # tokens and the router are parts of a sum over "model"; every
        # weight's gradient is a part of a sum over the data axes
        gx = partial_on(mesh, px, ("model",))
        gp = [partial_on(mesh, p, mesh_names(mesh)) for p in pp]

        def local(xl, *ps):
            return moe.moe_apply_ep(dict(zip(names, ps)), xl, cfg, mlp_kind,
                                    mesh, capacity=capacity)
        return local_call(local, mesh, [px] + pp, (px, rep), x,
                          *(params[n] for n in names),
                          grad_placements=[gx] + gp)

    def local(xl, *ps):
        return moe._moe_apply_local(dict(zip(names, ps)), xl, cfg, mlp_kind,
                                    capacity=capacity)
    return local_call(local, mesh, [rep] * (len(names) + 1), (rep, rep), x,
                      *(params[n] for n in names))


# ---------------------------------------------------------------------------
# The sharded flash-decoding (per-rank code of distributed/flashdecode.py)
# ---------------------------------------------------------------------------

def flashdecode(fn, qs, pools, table, logical, lengths, *, kernel=None,
                **opts):
    """``fn`` (:func:`~repro_torch.distributed.flashdecode.
    paged_decode_attention_sharded` or :func:`~repro_torch.distributed.
    flashdecode.paged_mla_decode_sharded`) on local shards: the sharded
    table and logical index ([B, NS, MBl]) keep their placements (each
    rank's [B_l, 1, MBl] slice), the queries and lengths split their batch
    as the table does and replicate over the rest, the pools keep their
    rows.  Returns (out with the queries' placements, heat [B, NS * MBl]
    with the table's).  ``kernel``: the name under which ``fn``'s paged
    kernel reports its flops (``None``: ``fn`` runs torch ops, which the
    trace counts itself)."""
    mesh = table.device_mesh
    pt = table.placements
    pq = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in pt)
    nq, npool = len(qs), len(pools)

    def local(*a):
        q_l = a[:nq]
        p_l = a[nq:nq + npool]
        t, lg, n = a[nq + npool:]
        if kernel is not None:
            note_flops(kernel, paged_flops(q_l[0], t[:, 0],
                                           opts["block_tokens"]))
        out, heat = fn(*q_l, *p_l, t[:, 0], lg[:, 0], n, **opts)
        return out, heat[:, None, :]
    ins = ((pq,) * nq + tuple(p.placements for p in pools)
           + (pt, pt, pq))
    out, heat = local_call(local, mesh, ins, (pq, pt), *qs, *pools, table,
                           logical, lengths)
    B, NS, MBl = table.shape
    return out, heat.reshape(B, NS * MBl)


# ---------------------------------------------------------------------------
# Activation layout and the vocab-parallel loss
# ---------------------------------------------------------------------------

class _Constrain(torch.autograd.Function):
    """The identity, held to ``want`` both ways (a sharding constraint, as
    GSPMD applies one to a value and to its gradient): the forward
    redistributes ``x`` to ``want``, and so does the backward with the
    gradient."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def constrain(x, want: tuple):
    """``x`` held to the placements ``want``, its gradient too (a value
    that carries no gradient takes the plain redistribution: a decode's
    host time is in its dispatch)."""
    want = tuple(want)
    if x.requires_grad:
        return _Constrain.apply(x, want)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def rows(x):
    """The residual stream's layout (Megatron's): ``x``'s rows (dim 0)
    split as they are over the data axes, everything else replicated —
    a sharding constraint at a layer boundary that holds for the gradient
    too.  That makes it Megatron's conjugate pair: the gradient comes back
    partial over "model" (the column-parallel products' input gradients)
    and is reduced there once, so the products before it run on the local
    weight shards.  A plain tensor passes."""
    if not isinstance(x, DTensor):
        return x
    return constrain(x, tuple(
        p if isinstance(p, Shard) and p.dim == 0 and n != "model"
        else Replicate()
        for n, p in zip(mesh_names(x.device_mesh), x.placements)))


class _VocabParallelCE(torch.autograd.Function):
    """Per rank, on its vocab slice: (log-sum-exp, the label's logit) of
    every row, each combined over the "model" group (MAX and SUM
    all-reduces); the backward is local (the softmax, and the one-hot of
    the label)."""

    @staticmethod
    def forward(ctx, logits, labels, group, offset: int):
        V = logits.shape[-1]
        m = logits.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        s = torch.exp(logits - m[..., None]).sum(-1)
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        logz = m + torch.log(s)
        loc = labels.long() - offset
        ok = (loc >= 0) & (loc < V)
        loc = loc.clamp(0, V - 1)
        ll = torch.where(ok, torch.gather(logits, -1, loc[..., None])[..., 0],
                         torch.zeros_like(logz))
        dist.all_reduce(ll, op=dist.ReduceOp.SUM, group=group)
        ctx.save_for_backward(logits, logz, loc, ok)
        return logz, ll

    @staticmethod
    def backward(ctx, g_logz, g_ll):
        logits, logz, loc, ok = ctx.saved_tensors
        grad = torch.exp(logits - logz[..., None]) * g_logz[..., None]
        grad.scatter_add_(-1, loc[..., None], torch.where(
            ok, g_ll, torch.zeros_like(g_ll))[..., None])
        return grad, None, None, None


def vocab_parallel_ce(logits, labels):
    """(log-sum-exp, the label's logit) of every row of ``logits``
    ([..., V], float32) with its vocab split over "model", without
    gathering the vocab (Megatron's vocab-parallel cross-entropy).  Both
    outputs keep the rows' split over the data axes."""
    mesh = logits.device_mesh
    rows_at = {n: 0 for n in batch_axes(logits) if n != "model"}
    pl = placements(mesh, dict(rows_at, model=logits.ndim - 1))
    pr = placements(mesh, rows_at)

    def local(lg, lab):
        off = axis_index(mesh, "model") * lg.shape[-1]
        return _VocabParallelCE.apply(lg, lab, mesh.get_group("model"), off)
    return local_call(local, mesh, (pl, pr), (pr, pr), logits, labels)


def embedding(table, tokens):
    """``table[tokens]`` on local shards (Megatron's vocab-parallel
    embedding): with the vocab split over "model" each rank looks up the
    ids in its slice and zeros the rest, and the rows come out partial
    (summed over "model" by the next redistribution); the lookup keeps the
    tokens' split over the data axes."""
    mesh = table.device_mesh
    split = any(isinstance(p, Shard) and p.dim == 0 and n == "model"
                for n, p in zip(mesh_names(mesh), table.placements))
    rows_at = ({n: 0 for n in batch_axes(tokens) if n != "model"}
               if isinstance(tokens, DTensor) else {})
    pt = placements(mesh, {"model": 0} if split else {})
    pr = placements(mesh, rows_at)
    po = tuple(Partial() if n == "model" and split else p
               for n, p in zip(mesh_names(mesh), pr))

    def local(t, ids):
        if not split:
            return (t[ids.long()],)
        V = t.shape[0]
        loc = ids.long() - axis_index(mesh, "model") * V
        ok = (loc >= 0) & (loc < V)
        out = t[loc.clamp(0, V - 1)]
        return (torch.where(ok[..., None], out, torch.zeros_like(out)),)
    # the table's gradient: each rank's rows' part of a sum over the axes
    # that split the tokens
    return local_call(local, mesh, (pt, pr), (po,), table, tokens,
                      grad_placements=(partial_on(mesh, pt, rows_at),
                                       pr))[0]


def dense_decode(fn, q, k_cache, v_cache, lengths, **opts):
    """A decode over a dense per-sequence cache (Whisper's cross-attention)
    on local shards: the rows keep q's split over the data axes, the query
    heads split over "model" when their count divides by it, and the
    caches' KV heads with them, or cut to the KV heads a rank's query
    heads read (:func:`_kv_heads`); the caches and the lengths follow the
    rows."""
    mesh = q.device_mesh
    if not isinstance(lengths, DTensor):        # a host-made constant
        lengths = replicate(lengths, mesh)
    kv = _kv_heads(mesh, q.shape[1], k_cache.shape[2])
    axes = {n: 0 for n in batch_axes(q) if n != "model"}
    pq = placements(mesh, _with(axes, kv is not None, 1))
    pc = placements(mesh, _with(axes, kv == "split", 2))
    pb = placements(mesh, axes)

    def local(a, k, v, n):
        return (fn(a, _kv_run(kv, k), _kv_run(kv, v), n, **opts),)
    return local_call(local, mesh, (pq, pc, pc, pb), (pq,), q, k_cache,
                      v_cache, lengths)[0]
