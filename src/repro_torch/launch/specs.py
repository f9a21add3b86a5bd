"""Shape-only inputs and their shardings for every (architecture x input
shape x mesh) dry-run cell: the counterpart of ``repro.launch.specs``.  No
device allocation: every argument is an empty ``meta`` tensor of its
GLOBAL shape (the reference's ``ShapeDtypeStruct``), beside a
:class:`~repro_torch.distributed.sharding.NamedSharding` (spec tuple and
DTensor placements) in the same tree position.

Cell kinds:
  train   -> train_step(params, opt_state, batch)
  prefill -> prefill_step(params, cache, tokens, block_table, ...)
  decode  -> decode_step(params, cache, tokens, lengths, block_table[,
             sharded tables when attn_impl=flashdecode*])

Spec tuples are the reference's ``tuple(PartitionSpec(...))``, entry for
entry: ``None``, an axis name, or a tuple of several names (a one-name
tuple is the name, as JAX normalises it).  The params are the port's tree
(a scan segment is a list with one subtree per repetition where the
reference stacks a ``[reps, ...]`` axis that no rule shards).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..data.pipeline import batch_specs_for
from ..distributed.collectives import axis_sizes
from ..distributed.sharding import (NamedSharding, placements_for,
                                    shardings_for_tree,
                                    zero1_shardings_for_tree)
from ..models.common import BF16, abstract, logical_axes
from ..models.decode import PagedLayout, cache_spec
from ..models.transformer import model_spec
from ..optim.adamw import AdamWState, tree_map

I32, F32 = torch.int32, torch.float32

BLOCK_TOKENS = 16


@dataclass
class Cell:
    """Everything the dry-run needs to run one (arch, shape, mesh) cell."""
    kind: str
    args: tuple                 # meta tensors (global shapes), positional
    in_shardings: tuple
    out_shardings: Any
    layout: PagedLayout | None = None
    meta: dict | None = None


def _entry(axes):
    """A spec entry as JAX normalises it: a one-name tuple is the name."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def named(mesh, *entries) -> NamedSharding:
    """``NamedSharding(mesh, P(*entries))``: the spec keeps every entry
    given (trailing ``None``s too), as a ``PartitionSpec`` does."""
    spec = tuple(_entry(e) for e in entries)
    return NamedSharding(mesh, spec, placements_for(spec, mesh))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _data_axes(mesh) -> tuple:
    return tuple(n for n in axis_sizes(mesh) if n not in ("model",))


def _batch_sharding(mesh, batch: int) -> tuple:
    """The batch dim's spec: over every data axis when they divide it,
    else over "data" alone, else replicated."""
    sizes = axis_sizes(mesh)
    axes = _data_axes(mesh)
    if batch % math.prod(sizes[a] for a in axes) == 0:
        return (_entry(axes),)
    if "data" in sizes and batch % sizes["data"] == 0:
        return ("data",)
    return ()


def param_shardings(cfg: ModelConfig, mesh):
    spec = model_spec(cfg)
    return abstract(spec), shardings_for_tree(abstract(spec),
                                              logical_axes(spec), mesh)


def batch_shardings(cfg: ModelConfig, mesh, specs: dict) -> dict:
    bspec = _batch_sharding(mesh, specs["tokens"].shape[0])
    return {k: named(mesh, None, *bspec) if k == "pos3d"
            else named(mesh, *bspec) for k in specs}


def make_layout(cfg: ModelConfig, shape: ShapeSpec, mesh) -> PagedLayout:
    chips = math.prod(axis_sizes(mesh).values())
    max_blocks = -(-shape.seq_len // BLOCK_TOKENS)
    num_blocks = shape.global_batch * max_blocks
    # round NB up to a multiple of the mesh size so the pool shards evenly
    num_blocks = -(-num_blocks // chips) * chips
    # keep per-sequence tables divisible by the model axis for flashdecode
    m = axis_sizes(mesh)["model"]
    max_blocks = -(-max_blocks // m) * m
    return PagedLayout(num_blocks=num_blocks, block_tokens=BLOCK_TOKENS,
                       max_blocks=max_blocks)


def cache_shardings(cfg: ModelConfig, layout: PagedLayout, mesh,
                    batch: int):
    """Sharding tree matching :func:`cache_spec`: the pool block dim over
    the whole mesh, per-sequence state over the batch sharding."""
    cspec = cache_spec(cfg, layout, batch, BF16)
    all_axes = tuple(axis_sizes(mesh))
    bspec = _batch_sharding(mesh, batch)

    def one(key, leaf):
        parts: list = [None] * leaf.ndim
        if key in ("pool_k", "pool_v", "pool_ckv"):
            parts[0 if leaf.shape[0] == layout.num_blocks else 1] = all_axes
        elif key in ("ssm", "conv", "xk", "xv"):
            b_dim = 0 if leaf.shape[0] == batch else 1
            if leaf.shape[b_dim] == batch and bspec:
                parts[b_dim] = bspec[0]
        else:
            parts = []
        return named(mesh, *parts)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else one(k, v)
                for k, v in node.items()}

    return cspec, walk(cspec)


def train_cell(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Cell:
    pspecs, pshard = param_shardings(cfg, mesh)
    mu_shard = zero1_shardings_for_tree(
        pspecs, logical_axes(model_spec(cfg)), mesh)
    opt_specs = AdamWState(
        step=_meta((), I32),
        mu=tree_map(lambda s: _meta(s.shape, F32), pspecs),
        nu=tree_map(lambda s: _meta(s.shape, F32), pspecs))
    opt_shard = AdamWState(step=named(mesh), mu=mu_shard,
                           nu=tree_map(lambda s: s, mu_shard))
    bspecs = batch_specs_for(cfg, shape.global_batch, shape.seq_len,
                             train=True)
    bshard = batch_shardings(cfg, mesh, bspecs)
    metrics_shard = named(mesh)
    out_shardings = (pshard, opt_shard,
                     {"loss": metrics_shard, "lr": metrics_shard,
                      "grad_norm": metrics_shard,
                      "update_norm": metrics_shard})
    return Cell(kind="train",
                args=(pspecs, opt_specs, bspecs),
                in_shardings=(pshard, opt_shard, bshard),
                out_shardings=out_shardings,
                meta={"tokens_per_step": shape.global_batch * shape.seq_len})


def prefill_cell(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Cell:
    layout = make_layout(cfg, shape, mesh)
    B, S = shape.global_batch, shape.seq_len
    pspecs, pshard = param_shardings(cfg, mesh)
    cspec, cshard = cache_shardings(cfg, layout, mesh, B)
    bspecs = batch_specs_for(cfg, B, S, train=False)
    bshard = batch_shardings(cfg, mesh, bspecs)
    tbl = _meta((B, layout.max_blocks), I32)
    tbl_shard = named(mesh, *_batch_sharding(mesh, B))
    args = [pspecs, cspec, bspecs["tokens"], tbl]
    in_sh = [pshard, cshard, bshard["tokens"], tbl_shard]
    meta_kw = {}
    for extra in ("frames", "patches", "pos3d"):
        if extra in bspecs:
            meta_kw[extra] = True
            args.append(bspecs[extra])
            in_sh.append(bshard[extra])
    out_shardings = (named(mesh), cshard)
    return Cell(kind="prefill", args=tuple(args), in_shardings=tuple(in_sh),
                out_shardings=out_shardings, layout=layout,
                meta={"extras": meta_kw, "tokens_per_step": B * S})


def decode_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
                attn_impl: str = "gather") -> Cell:
    layout = make_layout(cfg, shape, mesh)
    B = shape.global_batch
    pspecs, pshard = param_shardings(cfg, mesh)
    cspec, cshard = cache_shardings(cfg, layout, mesh, B)
    bsh = _batch_sharding(mesh, B)
    args = [pspecs, cspec, _meta((B,), I32), _meta((B,), I32),
            _meta((B, layout.max_blocks), I32)]
    in_sh = [pshard, cshard, named(mesh, *bsh), named(mesh, *bsh),
             named(mesh, *bsh)]
    meta: dict = {"attn_impl": attn_impl, "tokens_per_step": B,
                  "kv_tokens": B * shape.seq_len}
    if attn_impl.startswith("flashdecode"):
        sizes = axis_sizes(mesh)
        names = tuple(sizes)
        M = sizes["model"]
        if attn_impl.endswith("blocksharded"):
            NS = math.prod(sizes.values())
            st_spec = (None, names, None)
        else:
            NS = M
            st_spec = (_data_axes(mesh), "model", None)
        MBl = -(-layout.max_blocks // NS)
        args += [_meta((B, NS, MBl), I32), _meta((B, NS, MBl), I32)]
        in_sh += [named(mesh, *st_spec), named(mesh, *st_spec)]
        meta["sharded_tables"] = (NS, MBl)
    if cfg.vlm_patches:
        args.append(_meta((3, B, 1), F32))
        in_sh.append(named(mesh, None, *bsh))
        meta["pos3d"] = True
    # logits stay vocab-sharded over "model" (the lm_head layout) — gathering
    # the [B, V_pad] f32 logits was 75% of decode's collective bytes
    b_part = bsh[0] if bsh else None
    out_shardings = (named(mesh, b_part, "model"), cshard, named(mesh, *bsh))
    return Cell(kind="decode", args=tuple(args), in_shardings=tuple(in_sh),
                out_shardings=out_shardings, layout=layout, meta=meta)


def make_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
              attn_impl: str = "gather") -> Cell:
    if shape.kind == "train":
        return train_cell(cfg, shape, mesh)
    if shape.kind == "prefill":
        return prefill_cell(cfg, shape, mesh)
    return decode_cell(cfg, shape, mesh, attn_impl=attn_impl)
