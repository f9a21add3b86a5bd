"""Serving-side model execution: paged-KV prefill and single-token decode.

The PyTorch counterpart of ``repro.models.decode`` for every arch of the
repo: GQA/MHA and MLA attention, mamba-2 layers, dense, MoE, VLM (M-RoPE,
stub patch embeddings) and encoder-decoder (Whisper) models.  The KV cache
lives in a paged pool owned by
:class:`repro_torch.core.MemoryManager`; every attention layer reads KV
through the block table (the page-table analogue) and emits per-block
attention mass — the DAMON heat signal that drives promotion decisions.

Attention runs through the kernel wrappers: decode through
:func:`repro_torch.kernels.paged_attention.paged_decode_attention` (its plain
version is the reference's ``paged_decode_attention_gather``), prefill and
the prefix-cache suffix prefill through
:func:`repro_torch.kernels.flash_attention.flash_attention` (its plain
version is the reference's chunked ``flash_attention``).  MLA decodes
through :func:`repro_torch.kernels.mla_decode.paged_decode_mla` (its plain
version is the reference's paged latent gather,
:func:`paged_decode_attention_mla_gather`; DTensors run the kernel on
their local shards) and prefills through the flash kernel with value
heads narrower than its query/key heads.

Cache layout (mirrors the block segmentation of transformer.py; a scan
segment's leaves carry a leading ``[reps, ...]`` axis):
  attn (GQA) : {"pool_k", "pool_v"}: [NB, bt, KVH, hd]
  MLA        : {"pool_ckv"}: [NB, bt, kv_lora + qk_rope]
  mamba      : {"ssm": [B, H, N, P], "conv": [B, K-1, conv_ch]}
  whisper dec: adds {"xk", "xv"}: [B, F, KVH, hd], the static cross-attention
               cache, filled by each slot's prefill
The pools are global (block-indexed); the other leaves are per slot.

Sharded decode (``decode_step(..., attn_impl="flashdecode" |
"flashdecode_blocksharded")``, the reference's optimized serve path):
every rank runs the step on what it holds under the mesh installed by
:func:`repro_torch.distributed.set_decode_mesh` — its rows of the batch
(batch-sharded) or all rows, its own ``[NB_loc, ...]`` rows of every pool,
and its ``[B_l, MBl]`` slice of the sharded table and logical index — with
whole params.  Attention goes through
:mod:`repro_torch.distributed.flashdecode`; a token's K/V is written only
where the rank owns its block.  The engine decodes through ``"gather"``, as
the reference's does.

Departure from the JAX package: the pools are updated IN PLACE.  JAX
returns a new cache from every step (functional update, buffers donated
under jit); here a step writes the new K/V rows into the existing pool
tensors and returns the same cache object, so a 7B-width pool is never
copied.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..distributed import spmd
from ..distributed.collectives import axes_size
# the flash and paged decode kernels (their local_map bridges on DTensors)
from ..distributed.spmd import (flash_attention, is_dtensor,
                                paged_decode_attention, rows)
from ..distributed.flashdecode import (get_decode_mesh, owned_blocks,
                                       paged_decode_attention_sharded,
                                       paged_mla_decode_sharded, shard_layout)
from ..kernels.mla_decode.ops import paged_decode_mla, paged_decode_mla_plain
from .attention import decode_attention_dense, mla_expand_attention
from .common import (BF16, F32, apply_rope, embed_lookup, head_logits,
                     matmul, rms_norm, split_heads,
                     sinusoidal_position_at, sinusoidal_positions, yarn_of)
from .mamba2 import mamba_apply, mamba_decode_step, mamba_state_init
from .transformer import (_apply_norm, _mla_project, _project_qkv,
                          _rotate, _xattn_forward, _xattn_kv,
                          build_layer_plans, build_segments, encoder_forward,
                          ffn_forward, mla_scale)

Pytree = Any
NEG_INF = -1e30
POOL_KEYS = ("pool_k", "pool_v", "pool_ckv")
SLOT_KEYS = ("ssm", "conv", "xk", "xv")


@dataclass(frozen=True)
class PagedLayout:
    """Static paged-KV geometry for one served batch."""
    num_blocks: int          # NB: physical pool blocks (global)
    block_tokens: int        # bt
    max_blocks: int          # MB: per-sequence block-table length

    @property
    def max_seq(self) -> int:
        return self.max_blocks * self.block_tokens


def _attn_cache_shape(cfg: ModelConfig, layout: PagedLayout) -> dict:
    if cfg.mla is not None:
        m = cfg.mla
        return {"pool_ckv": (layout.num_blocks, layout.block_tokens,
                             m.kv_lora + m.qk_rope)}
    shape = (layout.num_blocks, layout.block_tokens, cfg.kv_heads,
             cfg.head_dim)
    return {"pool_k": shape, "pool_v": shape}


def cache_spec(cfg: ModelConfig, layout: PagedLayout, batch: int,
               dtype=BF16, *, device="meta") -> Pytree:
    """Shape-only stand-in of the serving cache (empty tensors on
    ``device``, by default ``meta``), segment-structured as
    :func:`cache_init` builds it: a scan segment's leaves carry a leading
    ``[reps, ...]`` axis."""
    def layer_cache(plan, lead=()) -> dict:
        def leaf(shape):
            return torch.empty(lead + shape, dtype=dtype, device=device)
        if plan.kind == "mamba":
            mc = cfg.mamba
            di = mc.expand * cfg.d_model
            c = {"ssm": leaf((batch, di // mc.head_dim, mc.d_state,
                              mc.head_dim)),
                 "conv": leaf((batch, mc.conv_dim - 1,
                               di + 2 * mc.d_state))}
        else:
            c = {k: leaf(s) for k, s in _attn_cache_shape(cfg, layout).items()}
        if plan.xattn:
            shape = (batch, cfg.enc_frames, cfg.kv_heads, cfg.head_dim)
            c["xk"], c["xv"] = leaf(shape), leaf(shape)
        return c

    out: dict = {}
    for si, seg in enumerate(build_segments(build_layer_plans(cfg))):
        if seg[0] == "plain":
            out[f"p{si}"] = layer_cache(seg[1])
        else:
            _, cycle, reps = seg
            out[f"s{si}"] = {f"m{j}": layer_cache(pl, (reps,))
                             for j, pl in enumerate(cycle)}
    return out


def cache_init(cfg: ModelConfig, layout: PagedLayout, batch: int,
               dtype=BF16, *, device) -> Pytree:
    """Zeroed serving cache: the paged pools, and ``batch`` slots of
    per-sequence state (mamba, Whisper's cross-attention cache)."""
    def layer_cache(plan, lead=()) -> dict:
        def zeros(shape):
            return torch.zeros(lead + shape, dtype=dtype, device=device)
        if plan.kind == "mamba":
            st = mamba_state_init(batch, cfg.d_model, cfg.mamba, dtype,
                                  device=device)
            c = {k: v.expand(lead + tuple(v.shape)).clone()
                 for k, v in st.items()}
        elif cfg.mla is not None:
            m = cfg.mla
            c = {"pool_ckv": zeros((layout.num_blocks, layout.block_tokens,
                                    m.kv_lora + m.qk_rope))}
        else:
            shape = (layout.num_blocks, layout.block_tokens, cfg.kv_heads,
                     cfg.head_dim)
            c = {"pool_k": zeros(shape), "pool_v": zeros(shape)}
        if plan.xattn:
            shape = (batch, cfg.enc_frames, cfg.kv_heads, cfg.head_dim)
            c["xk"], c["xv"] = zeros(shape), zeros(shape)
        return c

    out: dict = {}
    for si, seg in enumerate(build_segments(build_layer_plans(cfg))):
        if seg[0] == "plain":
            out[f"p{si}"] = layer_cache(seg[1])
        else:
            _, cycle, reps = seg
            out[f"s{si}"] = {f"m{j}": layer_cache(pl, (reps,))
                             for j, pl in enumerate(cycle)}
    return out


def pool_leaves(cache: Pytree) -> list[torch.Tensor]:
    """Every paged pool tensor of ``cache`` (K, V or MLA latents) as a
    ``[reps, NB, ...]`` view; empty for a model with no attention pool."""
    out = []
    for key, seg in cache.items():
        members = seg.values() if key.startswith("s") else [seg]
        for mem in members:
            for name in POOL_KEYS:
                if name in mem:
                    leaf = mem[name]
                    out.append(leaf if key.startswith("s") else leaf[None])
    return out


def slot_cache_view(cache: Pytree, slot: int) -> Pytree:
    """``cache`` with every per-slot leaf (mamba ``ssm``/``conv``,
    Whisper's ``xk``/``xv``) narrowed to slot ``slot`` (a batch of one) and
    the pools whole: a one-sequence prefill writes through the views into
    the cache in place.  A scan segment's slot axis is axis 1
    (``[reps, B, ...]``), a plain layer's axis 0."""
    def narrow(key, mem):
        axis = 1 if key.startswith("s") else 0
        return {name: leaf.narrow(axis, slot, 1) if name in SLOT_KEYS
                else leaf for name, leaf in mem.items()}
    return {key: ({j: narrow(key, mem) for j, mem in seg.items()}
                  if key.startswith("s") else narrow(key, seg))
            for key, seg in cache.items()}


# ---------------------------------------------------------------------------
# KV pool writes (in place)
# ---------------------------------------------------------------------------

def _drop_put(pool, index, ok, values) -> None:
    """``pool[index[i]] = values[i]`` for every row i with ``ok[i]``, the
    other rows dropped (the reference's ``mode="drop"``), in place and
    without a mask: a boolean index would sync with the host, which a
    captured step may not.  ``index`` is a tuple of [N] long tensors into
    ``pool``'s leading dims, ``ok`` [N] bool, ``values`` [N, ...].  Every
    row writes; a dropped row writes the destination and the value of the
    first live row, so the duplicate writes agree whichever lands last.
    With no live row every row writes the first row's clamped destination
    back to itself."""
    first = torch.argmax(ok.to(torch.uint8))          # first live row, else 0
    rep = torch.where(ok, torch.arange(ok.shape[0], device=ok.device), first)
    dst = tuple(i[rep].clamp_min(0) for i in index)
    val = torch.where(ok.any(), values[rep].to(pool.dtype), pool[dst])
    pool.index_put_(dst, val)


def write_token_kv(pool, new_kv, block_table, lengths, *, block_tokens: int):
    """Scatter one token's KV into the pool, in place.
    pool: [NB,bt,...]; new_kv: [B,...]; lengths: position of the new token.
    Rows whose target block is unmapped (table = -1: empty batch slots,
    sequences skipped this step) are dropped.  A DTensor pool writes
    through :func:`repro_torch.distributed.spmd.pool_write`; a ``meta``
    pool (the dry-run's shape-only trace) is left as it is.

    No mask selects the rows (a boolean index would sync with the host,
    which a captured decode step may not): :func:`_drop_put`."""
    if is_dtensor(pool):
        return spmd.pool_write(write_token_kv, pool, new_kv, block_table,
                               lengths, block_tokens=block_tokens)
    if pool.is_meta:
        return pool
    blk = (lengths // block_tokens).long()
    off = (lengths % block_tokens).long()
    raw = torch.gather(block_table, 1, blk[:, None])[:, 0].long()
    _drop_put(pool, (raw, off), raw >= 0, new_kv)
    return pool


def write_prefill_kv(pool, kv_seq, block_table, *, block_tokens: int):
    """Scatter a full prefill's KV, in place. kv_seq: [B,S,...]; S % bt == 0
    (the engine pads).  Blocks with table = -1 are dropped, with no mask
    (:func:`_drop_put`).  DTensor and ``meta`` pools as in
    :func:`write_token_kv`."""
    if is_dtensor(pool):
        return spmd.pool_write(write_prefill_kv, pool, kv_seq, block_table,
                               block_tokens=block_tokens)
    if pool.is_meta:
        return pool
    B, S = kv_seq.shape[:2]
    nb = S // block_tokens
    kvb = kv_seq.reshape((B * nb, block_tokens) + kv_seq.shape[2:])
    tbl = block_table[:, :nb].reshape(-1).long()
    _drop_put(pool, (tbl,), tbl >= 0, kvb)
    return pool


# ---------------------------------------------------------------------------
# Decode step (single token for the whole batch)
# ---------------------------------------------------------------------------

def _layers(params: Pytree, cache: Pytree, cfg: ModelConfig):
    """(plan, layer params, layer cache) in depth order; cache entries of a
    scan segment are views into the stacked pools."""
    for si, seg in enumerate(build_segments(build_layer_plans(cfg))):
        if seg[0] == "plain":
            yield seg[1], params["blocks"][f"p{si}"], cache[f"p{si}"]
            continue
        _, cycle, reps = seg
        key = f"s{si}"
        for r in range(reps):
            for j, plan in enumerate(cycle):
                c = cache[key][f"m{j}"]
                yield (plan, params["blocks"][key][r][f"m{j}"],
                       {name: leaf[r] for name, leaf in c.items()})


def paged_decode_attention_mla_gather(q_eff, q_rope, pool_ckv, block_table,
                                      lengths, *, block_tokens: int,
                                      kv_lora: int, qk_nope: int = 128,
                                      scale: float | None = None):
    """MLA absorbed decode over the paged latent cache, by a gather of
    every block of the table (the reference's jnp, in torch ops:
    :func:`~repro_torch.kernels.mla_decode.ops.paged_decode_mla_plain`).
    q_eff: [B,H,L] (q_nope @ w_uk); q_rope: [B,H,Dr]; pool_ckv:
    [NB,bt,L+Dr]; block_table: [B,MB] (-1 = unmapped); lengths: [B] tokens
    INCLUDING the current one; ``scale``: the softmax scale (None:
    ``(qk_nope + Dr) ** -0.5``).  Returns (o_lat [B,H,L] f32, heat [B,MB]:
    the exact softmax mass per block, summed over the heads).  DTensors run
    it on local shards (:func:`repro_torch.distributed.spmd.paged_gather`:
    the latent pool gathered whole)."""
    if scale is None:
        scale = 1.0 / math.sqrt(qk_nope + q_rope.shape[-1])
    if is_dtensor(q_eff, pool_ckv):
        return spmd.paged_gather(
            paged_decode_attention_mla_gather, (q_eff, q_rope), (pool_ckv,),
            block_table, lengths, block_tokens=block_tokens, kv_lora=kv_lora,
            qk_nope=qk_nope, scale=scale)
    return paged_decode_mla_plain(q_eff, q_rope, pool_ckv, block_table,
                                  lengths, block_tokens=block_tokens,
                                  kv_lora=kv_lora, scale=scale)


def _decode_attn_layer(cfg, plan, p, cache, x, lengths, block_table, layout,
                       pos3d=None, sharded=None):
    """x: [B,d] -> (out [B,d], heat [B,MB]); writes the token's KV (or MLA
    latent) into the pool.  ``sharded``: None (the gather path), or
    (batch_sharded, write table of rank-local rows, sharded table, logical)
    for the sharded decode, whose heat is [B, MBl]."""
    B, d = x.shape
    H, KVH, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    bt = layout.block_tokens
    window = cfg.attn.window if plan.local else None
    positions = lengths[:, None]                              # [B,1]
    write_table = block_table if sharded is None else sharded[1]
    if cfg.mla is not None:
        m = cfg.mla
        q_nope, q_rope, c_kv, k_rope = _mla_project(
            cfg, p, x[:, None], positions, layout.max_seq)
        write_token_kv(cache["pool_ckv"], torch.cat([c_kv, k_rope], -1)[:, 0],
                       write_table, lengths, block_tokens=bt)
        q_eff = torch.einsum("bhd,hld->bhl", q_nope[:, 0].float(),
                             p["w_uk"].float())
        if sharded is not None:
            o_lat, heat = paged_mla_decode_sharded(
                q_eff, q_rope[:, 0], cache["pool_ckv"], sharded[2],
                sharded[3], lengths + 1, block_tokens=bt, kv_lora=m.kv_lora,
                qk_nope=m.qk_nope, batch_sharded=sharded[0],
                scale=mla_scale(cfg))
        elif is_dtensor(q_eff, cache["pool_ckv"]):
            o_lat, heat = spmd.paged_gather(
                paged_decode_mla, (q_eff, q_rope[:, 0]),
                (cache["pool_ckv"],), block_table, lengths + 1,
                block_tokens=bt, kv_lora=m.kv_lora, scale=mla_scale(cfg))
        else:
            o_lat, heat = paged_decode_mla(
                q_eff, q_rope[:, 0], cache["pool_ckv"], block_table,
                lengths + 1, block_tokens=bt, kv_lora=m.kv_lora,
                scale=mla_scale(cfg))
        out = torch.einsum("bhl,hld->bhd", o_lat, p["w_uv"].float())
        return matmul(out.reshape(B, H * m.v_head).to(x.dtype), p["wo"]), heat
    q = split_heads(matmul(x, p["wq"]), H, hd)
    k_new = split_heads(matmul(x, p["wk"]), KVH, hd)
    v_new = split_heads(matmul(x, p["wv"]), KVH, hd)
    if cfg.attn.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k_new = rms_norm(k_new, p["k_norm"])
    q = _rotate(cfg, q[:, None], positions, pos3d, layout.max_seq)[:, 0]
    k_new = _rotate(cfg, k_new[:, None], positions, pos3d,
                    layout.max_seq)[:, 0]
    write_token_kv(cache["pool_k"], k_new, write_table, lengths,
                   block_tokens=bt)
    write_token_kv(cache["pool_v"], v_new, write_table, lengths,
                   block_tokens=bt)
    if sharded is not None:
        out, heat = paged_decode_attention_sharded(
            q.contiguous(), cache["pool_k"], cache["pool_v"], sharded[2],
            sharded[3], lengths + 1, block_tokens=bt, window=window,
            soft_cap=cfg.attn.logit_soft_cap, batch_sharded=sharded[0])
    else:
        out, heat = paged_decode_attention(
            q.contiguous(), cache["pool_k"], cache["pool_v"], block_table,
            lengths + 1, block_tokens=bt, window=window,
            soft_cap=cfg.attn.logit_soft_cap)
    return matmul(out.reshape(B, H * hd), p["wo"]), heat


def _decode_layer(cfg, plan, p, cache, x, lengths, block_table, layout,
                  pos3d, sharded=None):
    """One layer of a decode step: x [B,d] -> (x, heat [B,MB] or None for
    a mamba layer).  Writes the layer's cache in place."""
    h = _apply_norm(cfg, p["ln1"], x)
    heat = None
    if plan.kind == "mamba":
        y, st = mamba_decode_step(p["mamba"], h, cache, cfg.mamba)
        for name, val in st.items():
            cache[name].copy_(val)
    else:
        y, heat = _decode_attn_layer(cfg, plan, p["attn"], cache, h, lengths,
                                     block_table, layout, pos3d, sharded)
    x = rows(x + y)
    if plan.xattn:
        B = x.shape[0]
        hx = _apply_norm(cfg, p["lnx"], x)
        q = split_heads(matmul(hx, p["xattn"]["wq"]), cfg.n_heads,
                        cfg.head_dim)
        F = cache["xk"].shape[1]
        xo = decode_attention_dense(
            q, cache["xk"], cache["xv"],
            torch.full((B,), F, dtype=torch.int32, device=x.device))
        x = rows(x + matmul(xo.reshape(B, -1), p["xattn"]["wo"]))
    if plan.ffn:
        x = rows(x + ffn_forward(cfg, plan, p,
                                 _apply_norm(cfg, p["ln2"], x))[0])
    return x, heat


def decode_step(params: Pytree, cfg: ModelConfig, cache: Pytree,
                tokens: torch.Tensor, lengths: torch.Tensor,
                block_table: torch.Tensor, layout: PagedLayout, *,
                active: torch.Tensor | None = None,
                pos3d: torch.Tensor | None = None, compute_dtype=BF16,
                attn_impl: str = "gather", sharded_table=None,
                sharded_logical=None):
    """One decode step for the batch.

    tokens: [B] int (the tokens at position ``lengths``); lengths: [B] int32
    current context length EXCLUDING the new token; block_table: [B, MB]
    int32.  ``active`` ([B] bool, optional) marks the rows that are real
    sequences this step; inactive rows see an all ``-1`` table and length 0,
    so their KV scatter is dropped and their attention/heat is all-masked —
    a vacated slot's row of the persistent device table may still hold
    live-looking physical indices (a mamba layer's state advances for every
    row, as in the reference).  ``pos3d`` ([3, B, 1] integer): the M-RoPE
    position streams of M-RoPE configs.

    ``attn_impl``: ``"gather"`` (the default and the engine's), or the
    sharded decode on this rank under the installed decode mesh:
    ``"flashdecode"`` (tokens, lengths, block_table and active are this
    rank's data shard's rows) or ``"flashdecode_blocksharded"`` (all
    rows); the cache's pools are the rank's own rows, ``sharded_table`` /
    ``sharded_logical`` its ``[B, MBl]`` slices (global block ids), with
    ``NS * MBl == layout.max_blocks``.  The heat is then [B, MBl]: the
    rank's columns of the reference's shard-major heat.  Given DTensors
    (a sharded program, :mod:`repro_torch.launch.dryrun`) every argument
    is the reference's global array, ``sharded_table`` / ``sharded_logical``
    ``[B, NS, MBl]``, and the heat is ``[B, NS * MBl]``.
    Returns (logits [B, V_pad] f32, cache (updated in place), heat [B, MB]).
    """
    B = tokens.shape[0]
    if active is not None:
        block_table = torch.where(active[:, None], block_table,
                                  torch.full_like(block_table, -1))
        lengths = torch.where(active, lengths, torch.zeros_like(lengths))
    block_table = block_table.contiguous()
    heat_cols = layout.max_blocks
    sharded = None
    if attn_impl != "gather":
        if attn_impl not in ("flashdecode", "flashdecode_blocksharded"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        if is_dtensor(sharded_table):
            # a sharded program: the global tables, split by DTensor
            sharded = (attn_impl == "flashdecode", block_table,
                       sharded_table, sharded_logical)
            heat_cols = sharded_table.shape[1] * sharded_table.shape[2]
        else:
            sharded = _sharded_route(cache, block_table, layout,
                                     sharded_table, sharded_logical,
                                     attn_impl == "flashdecode")
            heat_cols = sharded_table.shape[1]
    x = rows(embed_lookup(params["embed"], tokens).to(compute_dtype))
    if cfg.enc_dec:
        x = x + sinusoidal_position_at(lengths, cfg.d_model,
                                       max_pos=layout.max_seq + 1
                                       ).to(compute_dtype)
    heat_total = torch.zeros((B, heat_cols), dtype=F32, device=x.device)
    for plan, p, c in _layers(params, cache, cfg):
        x, heat = _decode_layer(cfg, plan, p, c, x, lengths, block_table,
                                layout, pos3d, sharded)
        if heat is not None:
            heat_total = heat_total + heat
    x = _apply_norm(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = head_logits(x, head)
    return logits, cache, heat_total


def _sharded_route(cache, block_table, layout, sharded_table,
                   sharded_logical, batch_sharded: bool):
    """The sharded decode's per-step tuple: (batch_sharded, the block
    table as this rank's local pool rows for the K/V write — every block
    another rank owns is dropped — the sharded table, its logical index)."""
    mesh = get_decode_mesh()
    if mesh is None:
        raise RuntimeError("set_decode_mesh(mesh) first: the sharded decode "
                           "runs under an installed mesh")
    if sharded_table is None or sharded_logical is None:
        raise ValueError("the sharded decode needs sharded_table and "
                         "sharded_logical")
    shard, _, axes = shard_layout(mesh, batch_sharded)
    ns = axes_size(mesh, axes)
    if ns * sharded_table.shape[1] != layout.max_blocks:
        raise ValueError(f"{ns} shards x {sharded_table.shape[1]} slots != "
                         f"max_blocks {layout.max_blocks}")
    leaves = pool_leaves(cache)
    nb_loc = leaves[0].shape[1]
    return (batch_sharded, owned_blocks(block_table, shard, nb_loc),
            sharded_table.to(torch.int32).contiguous(),
            sharded_logical.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# Prefill (full sequence, populating the paged pools)
# ---------------------------------------------------------------------------

def prefill_step(params: Pytree, cfg: ModelConfig, cache: Pytree,
                 tokens: torch.Tensor, block_table: torch.Tensor,
                 layout: PagedLayout, *,
                 frames: torch.Tensor | None = None,
                 patches: torch.Tensor | None = None,
                 pos3d: torch.Tensor | None = None, compute_dtype=BF16,
                 chunk: int = 1024, last_index: torch.Tensor | None = None):
    """Forward the prompt and write its K/V (MLA latents, mamba state,
    Whisper's cross-attention K/V) into the cache, in place.  Returns
    (last-token logits [B, V_pad] f32, cache).  ``cache``'s per-slot leaves
    must hold B rows (the engine passes :func:`slot_cache_view` for its
    one-sequence prefills).  ``last_index``: [B] index of each sequence's
    final REAL token (prompts are right-padded to a block multiple);
    defaults to the last position.  ``chunk`` is the KV chunk of the plain
    attention version (CPU tensors).  Whisper: ``frames`` ([B, F, d]) feed
    the encoder.  VLM configs: ``patches`` ([B, P, d]) replace the first P
    token embeddings and ``pos3d`` ([3, B, S] integer) are the M-RoPE
    position streams."""
    B, S = tokens.shape
    bt = layout.block_tokens
    x = rows(embed_lookup(params["embed"], tokens).to(compute_dtype))
    if patches is not None:
        P = patches.shape[1]
        x = torch.cat([patches.to(compute_dtype), x[:, P:]], dim=1)
    positions = torch.arange(S, device=x.device)[None, :]
    enc_out = None
    if cfg.enc_dec:
        enc_out = encoder_forward(params["encoder"], cfg, frames,
                                  compute_dtype=compute_dtype, chunk=chunk,
                                  remat=False)
        x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(
            compute_dtype)[None]
    for plan, p, c in _layers(params, cache, cfg):
        h = _apply_norm(cfg, p["ln1"], x)
        if plan.kind == "mamba":
            y, st = mamba_apply(p["mamba"], h, cfg.mamba, return_state=True)
            x = rows(x + y)
            for name, val in st.items():
                c[name].copy_(val)
        elif cfg.mla is not None:
            ap = p["attn"]
            q_nope, q_rope, c_kv, k_rope = _mla_project(cfg, ap, h,
                                                        positions, S)
            o = mla_expand_attention(q_nope, q_rope, c_kv, k_rope,
                                     ap["w_uk"], ap["w_uv"], causal=True,
                                     chunk=chunk, scale=mla_scale(cfg))
            x = rows(x + matmul(o.reshape(B, S, -1), ap["wo"]))
            write_prefill_kv(c["pool_ckv"], torch.cat([c_kv, k_rope], -1),
                             block_table, block_tokens=bt)
        else:
            q, k, v = _project_qkv(cfg, p["attn"], h)
            q = _rotate(cfg, q, positions, pos3d, S)
            k = _rotate(cfg, k, positions, pos3d, S)
            window = cfg.attn.window if plan.local else None
            o = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=plan.causal,
                                window=window,
                                soft_cap=cfg.attn.logit_soft_cap, chunk=chunk)
            x = rows(x + matmul(o.reshape(B, S, -1), p["attn"]["wo"]))
            write_prefill_kv(c["pool_k"], k, block_table, block_tokens=bt)
            write_prefill_kv(c["pool_v"], v, block_table, block_tokens=bt)
        if plan.xattn:
            kx, vx = _xattn_kv(cfg, p["xattn"], enc_out)
            x = rows(x + _xattn_forward(cfg, p["xattn"],
                                        _apply_norm(cfg, p["lnx"], x), kx,
                                        vx, chunk))
            c["xk"].copy_(kx)
            c["xv"].copy_(vx)
        if plan.ffn:
            x = rows(x + ffn_forward(cfg, plan, p,
                                     _apply_norm(cfg, p["ln2"], x))[0])
    if last_index is None:
        x_last = x[:, -1]
    else:
        x_last = x[torch.arange(B, device=x.device), last_index.long()]
    x_last = _apply_norm(cfg, params["final_norm"], x_last)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = head_logits(x_last, head)
    return logits, cache


# ---------------------------------------------------------------------------
# Suffix prefill (prefix-cache hit: prefix KV comes from the pool)
# ---------------------------------------------------------------------------

def write_suffix_kv(pool, kv_seq, block_table, start, *,
                    block_tokens: int):
    """Scatter a suffix prefill's KV at token offset ``start`` (an int, or
    a one-element integer tensor on the pool's device), in place.

    kv_seq: [B, S, ...] — the KV of tokens [start, start+S); rows whose
    target position lands in an unmapped block (table -1) or past the
    table are dropped, like the other pool scatters, with no mask
    (:func:`_drop_put`)."""
    B, S = kv_seq.shape[:2]
    MB = block_table.shape[1]
    pos = start + torch.arange(S, device=kv_seq.device)
    blk = pos // block_tokens
    off = (pos % block_tokens).expand(B, S)
    raw = block_table[:, blk.clamp(max=MB - 1)].long()            # [B, S]
    ok = (blk < MB)[None, :] & (raw >= 0)
    _drop_put(pool, (raw.reshape(-1), off.reshape(-1)), ok.reshape(-1),
              kv_seq.reshape((B * S,) + kv_seq.shape[2:]))
    return pool


def _gather_full_kv(pool, suffix, block_table, start, key_blocks: int,
                    block_tokens: int):
    """Assemble the FULL-length KV stream of one sequence: positions
    [0, start) gathered from the paged pool (the cached prefix),
    [start, start+S) from the freshly computed ``suffix``, the rest zero.
    ``start`` is an int or a one-element integer tensor.

    ``key_blocks`` is the prompt's padded block count, so the result has
    the exact key length of the stream the ordinary full prefill builds;
    the zero tail past the valid tokens is causally masked for every valid
    query row, which keeps the suffix rows equal to the full path's.  A
    pure selection per position (no mask index, no host sync): the pool's
    row where the position lies before ``start`` in a mapped block, the
    suffix's row where it lies in [start, start+S), zero elsewhere."""
    B, S = suffix.shape[:2]
    KB = key_blocks * block_tokens
    tbl = block_table[:, :key_blocks].long()                      # [B, nb]
    full = pool[tbl.clamp_min(0)].reshape((B, KB) + pool.shape[2:])
    posk = torch.arange(KB, device=suffix.device)
    valid = (posk[None, :] < start) & \
        (tbl.repeat_interleave(block_tokens, dim=1) >= 0)
    lead = (1,) * (full.ndim - 2)
    full = torch.where(valid.reshape(valid.shape + lead), full,
                       torch.zeros((), dtype=full.dtype,
                                   device=full.device)).to(suffix.dtype)
    rel = posk - start                                            # [KB]
    own = suffix.index_select(1, rel.clamp(0, S - 1))
    mine = ((rel >= 0) & (rel < S)).reshape((1, KB) + lead)
    return torch.where(mine, own, full)


def prefill_suffix_step(params: Pytree, cfg: ModelConfig, cache: Pytree,
                        tokens: torch.Tensor, block_table: torch.Tensor,
                        layout: PagedLayout, *,
                        prefix_len: "int | torch.Tensor",
                        key_blocks: int, compute_dtype=BF16,
                        chunk: int = 1024,
                        last_index: torch.Tensor | None = None):
    """Prefill ONLY the uncached suffix of a prompt whose first
    ``prefix_len`` tokens' KV already sits in the paged pool (a prefix-cache
    hit: shared blocks mapped read-only, the partial tail already
    copy-on-write-broken).

    tokens: [B, S] the SUFFIX tokens (block-padded); prefix_len: absolute
    position of tokens[:, 0], an int or a one-element int32 tensor on the
    tokens' device (the compiled entry's, read by the kernel from device
    memory); key_blocks: padded block count of the whole prompt.  Each
    attention layer projects q/k/v (MLA: q and the latents) for the
    suffix rows only, attends against pool-gathered prefix +
    computed suffix keys through ``flash_attention(q_offset=prefix_len)``
    and scatters the suffix KV at its token offset (in place).  As in the
    reference, encoder-decoder, VLM and M-RoPE configs are rejected, and so
    is any layer with sequential state (a mamba-kind layer, cross-
    attention): they cannot skip the prefix's compute.  Returns (last-token
    logits [B, V_pad] f32, cache).
    """
    if cfg.enc_dec or cfg.vlm_patches or cfg.attn.mrope_sections is not None:
        raise ValueError("suffix prefill supports plain decoder LMs only")
    B, S = tokens.shape
    bt = layout.block_tokens
    x = rows(embed_lookup(params["embed"], tokens).to(compute_dtype))
    positions = prefix_len + torch.arange(S, device=x.device)[None, :]
    # a bound on the table the positions index, known on the host without
    # reading prefix_len: prefix_len <= max_seq
    max_pos = layout.max_seq + S
    for plan, p, c in _layers(params, cache, cfg):
        if plan.kind not in ("a", "attn") or plan.xattn:
            raise ValueError(
                f"suffix prefill cannot skip prefix compute for layer kind "
                f"{plan.kind!r} (sequential state)")
        h = _apply_norm(cfg, p["ln1"], x)
        ap = p["attn"]
        if cfg.mla is not None:
            L = cfg.mla.kv_lora
            q_nope, q_rope, c_kv, k_rope = _mla_project(cfg, ap, h,
                                                        positions, max_pos)
            lat = torch.cat([c_kv, k_rope], -1)
            lat_full = _gather_full_kv(c["pool_ckv"], lat, block_table,
                                       prefix_len, key_blocks, bt)
            o = mla_expand_attention(q_nope, q_rope, lat_full[..., :L],
                                     lat_full[..., L:], ap["w_uk"],
                                     ap["w_uv"], causal=True, chunk=chunk,
                                     q_offset=prefix_len,
                                     scale=mla_scale(cfg))
            x = x + matmul(o.reshape(B, S, -1), ap["wo"])
            write_suffix_kv(c["pool_ckv"], lat, block_table, prefix_len,
                            block_tokens=bt)
        else:
            q, k, v = _project_qkv(cfg, ap, h)
            if cfg.attn.use_rope:
                rope = dict(max_pos=max_pos, theta=cfg.attn.rope_theta,
                            yarn=yarn_of(cfg.attn))
                q = apply_rope(q, positions, **rope)
                k = apply_rope(k, positions, **rope)
            window = cfg.attn.window if plan.local else None
            k_full = _gather_full_kv(c["pool_k"], k, block_table, prefix_len,
                                     key_blocks, bt)
            v_full = _gather_full_kv(c["pool_v"], v, block_table, prefix_len,
                                     key_blocks, bt)
            o = flash_attention(q.contiguous(), k_full.contiguous(),
                                v_full.contiguous(), causal=plan.causal,
                                window=window,
                                soft_cap=cfg.attn.logit_soft_cap,
                                chunk=chunk, q_offset=prefix_len)
            x = x + matmul(o.reshape(B, S, -1), ap["wo"])
            write_suffix_kv(c["pool_k"], k, block_table, prefix_len,
                            block_tokens=bt)
            write_suffix_kv(c["pool_v"], v, block_table, prefix_len,
                            block_tokens=bt)
        if plan.ffn:
            x = x + ffn_forward(cfg, plan, p, _apply_norm(cfg, p["ln2"], x))[0]
    if last_index is None:
        x_last = x[:, -1]
    else:
        x_last = x[torch.arange(B, device=x.device), last_index.long()]
    x_last = _apply_norm(cfg, params["final_norm"], x_last)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = head_logits(x_last, head)
    return logits, cache
