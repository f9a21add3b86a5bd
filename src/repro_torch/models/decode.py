"""Serving-side model execution: paged-KV prefill and single-token decode.

The PyTorch counterpart of ``repro.models.decode`` for decoders whose
every layer is GQA/MHA attention: dense, MoE and VLM (M-RoPE, stub patch
embeddings) families.  The KV cache lives in a paged pool owned by
:class:`repro_torch.core.MemoryManager`; every attention layer reads KV
through the block table (the page-table analogue) and emits per-block
attention mass — the DAMON heat signal that drives promotion decisions.

Attention runs through the kernel wrappers: decode through
:func:`repro_torch.kernels.paged_attention.paged_decode_attention` (its plain
version is the reference's ``paged_decode_attention_gather``), prefill and
the prefix-cache suffix prefill through
:func:`repro_torch.kernels.flash_attention.flash_attention` (its plain
version is the reference's chunked ``flash_attention``).

Cache layout (mirrors the block segmentation of transformer.py):
  {"s<i>": {"m<j>": {"pool_k", "pool_v"}: [reps, NB, bt, KVH, hd]}} for a
  scan segment, {"p<i>": {"pool_k", "pool_v"}: [NB, bt, KVH, hd]} for a
  plain layer.

Departure from the JAX package: the pools are updated IN PLACE.  JAX
returns a new cache from every step (functional update, buffers donated
under jit); here a step writes the new K/V rows into the existing pool
tensors and returns the same cache object, so a 7B-width pool is never
copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.paged_attention.ops import paged_decode_attention
from .common import BF16, F32, apply_mrope, apply_rope, matmul, rms_norm
from .transformer import (_apply_norm, _project_qkv, build_layer_plans,
                          build_segments, check_supported, ffn_forward)

Pytree = Any


@dataclass(frozen=True)
class PagedLayout:
    """Static paged-KV geometry for one served batch."""
    num_blocks: int          # NB: physical pool blocks (global)
    block_tokens: int        # bt
    max_blocks: int          # MB: per-sequence block-table length

    @property
    def max_seq(self) -> int:
        return self.max_blocks * self.block_tokens


def cache_init(cfg: ModelConfig, layout: PagedLayout, batch: int,
               dtype=BF16, *, device) -> Pytree:
    """Zeroed serving cache (``batch`` is kept for the reference signature:
    dense attention layers hold no per-slot state)."""
    check_supported(cfg)
    shape = (layout.num_blocks, layout.block_tokens, cfg.kv_heads,
             cfg.head_dim)

    def pools(lead=()):
        return {k: torch.zeros(lead + shape, dtype=dtype, device=device)
                for k in ("pool_k", "pool_v")}

    out: dict = {}
    for si, seg in enumerate(build_segments(build_layer_plans(cfg))):
        if seg[0] == "plain":
            out[f"p{si}"] = pools()
        else:
            _, cycle, reps = seg
            out[f"s{si}"] = {f"m{j}": pools((reps,))
                             for j in range(len(cycle))}
    return out


def pool_leaves(cache: Pytree) -> list[torch.Tensor]:
    """Every pool tensor of ``cache`` as a ``[reps, NB, ...]`` view."""
    out = []
    for key, seg in cache.items():
        members = seg.values() if key.startswith("s") else [seg]
        for mem in members:
            for name in ("pool_k", "pool_v"):
                leaf = mem[name]
                out.append(leaf if key.startswith("s") else leaf[None])
    return out


# ---------------------------------------------------------------------------
# KV pool writes (in place)
# ---------------------------------------------------------------------------

def write_token_kv(pool, new_kv, block_table, lengths, *, block_tokens: int):
    """Scatter one token's KV into the pool, in place.
    pool: [NB,bt,...]; new_kv: [B,...]; lengths: position of the new token.
    Rows whose target block is unmapped (table = -1: empty batch slots,
    sequences skipped this step) are dropped."""
    blk = (lengths // block_tokens).long()
    off = (lengths % block_tokens).long()
    raw = torch.gather(block_table, 1, blk[:, None])[:, 0].long()
    ok = raw >= 0
    pool[raw[ok], off[ok]] = new_kv[ok].to(pool.dtype)
    return pool


def write_prefill_kv(pool, kv_seq, block_table, *, block_tokens: int):
    """Scatter a full prefill's KV, in place. kv_seq: [B,S,...]; S % bt == 0
    (the engine pads).  Blocks with table = -1 are dropped."""
    B, S = kv_seq.shape[:2]
    nb = S // block_tokens
    kvb = kv_seq.reshape((B * nb, block_tokens) + kv_seq.shape[2:])
    tbl = block_table[:, :nb].reshape(-1).long()
    ok = tbl >= 0
    pool[tbl[ok]] = kvb[ok].to(pool.dtype)
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
                       {"pool_k": c["pool_k"][r], "pool_v": c["pool_v"][r]})


def _rotate(cfg, x, positions, pos3d, max_pos: int):
    """RoPE by ``positions`` ([..., seq]) or, for M-RoPE configs, by the
    three position streams ``pos3d`` ([3, ..., seq]); x: [..., seq, heads,
    hd]."""
    if cfg.attn.mrope_sections is not None:
        return apply_mrope(x, pos3d, cfg.attn.mrope_sections,
                           max_pos=max_pos, theta=cfg.attn.rope_theta)
    if cfg.attn.use_rope:
        return apply_rope(x, positions, max_pos=max_pos,
                          theta=cfg.attn.rope_theta)
    return x


def _decode_attn_layer(cfg, plan, p, cache, x, lengths, block_table, layout,
                       pos3d=None):
    """x: [B,d] -> (out [B,d], heat [B,MB]); writes the token's KV."""
    B, d = x.shape
    H, KVH, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    bt = layout.block_tokens
    window = cfg.attn.window if plan.local else None
    positions = lengths[:, None]                              # [B,1]
    q = matmul(x, p["wq"]).reshape(B, H, hd)
    k_new = matmul(x, p["wk"]).reshape(B, KVH, hd)
    v_new = matmul(x, p["wv"]).reshape(B, KVH, hd)
    if cfg.attn.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k_new = rms_norm(k_new, p["k_norm"])
    q = _rotate(cfg, q[:, None], positions, pos3d, layout.max_seq)[:, 0]
    k_new = _rotate(cfg, k_new[:, None], positions, pos3d,
                    layout.max_seq)[:, 0]
    write_token_kv(cache["pool_k"], k_new, block_table, lengths,
                   block_tokens=bt)
    write_token_kv(cache["pool_v"], v_new, block_table, lengths,
                   block_tokens=bt)
    out, heat = paged_decode_attention(
        q.contiguous(), cache["pool_k"], cache["pool_v"], block_table,
        lengths + 1, block_tokens=bt, window=window,
        soft_cap=cfg.attn.logit_soft_cap)
    return matmul(out.reshape(B, H * hd), p["wo"]), heat


def decode_step(params: Pytree, cfg: ModelConfig, cache: Pytree,
                tokens: torch.Tensor, lengths: torch.Tensor,
                block_table: torch.Tensor, layout: PagedLayout, *,
                active: torch.Tensor | None = None,
                pos3d: torch.Tensor | None = None, compute_dtype=BF16):
    """One decode step for the batch.

    tokens: [B] int (the tokens at position ``lengths``); lengths: [B] int32
    current context length EXCLUDING the new token; block_table: [B, MB]
    int32.  ``active`` ([B] bool, optional) marks the rows that are real
    sequences this step; inactive rows see an all ``-1`` table and length 0,
    so their KV scatter is dropped and their attention/heat is all-masked —
    a vacated slot's row of the persistent device table may still hold
    live-looking physical indices.  ``pos3d`` ([3, B, 1] integer): the
    M-RoPE position streams of M-RoPE configs.
    Returns (logits [B, V_pad] f32, cache (updated in place), heat [B, MB]).
    """
    B = tokens.shape[0]
    if active is not None:
        block_table = torch.where(active[:, None], block_table,
                                  torch.full_like(block_table, -1))
        lengths = torch.where(active, lengths, torch.zeros_like(lengths))
    block_table = block_table.contiguous()
    x = params["embed"][tokens.long()].to(compute_dtype)
    heat_total = torch.zeros((B, layout.max_blocks), dtype=F32,
                             device=x.device)
    for plan, p, c in _layers(params, cache, cfg):
        h = _apply_norm(cfg, p["ln1"], x)
        y, heat = _decode_attn_layer(cfg, plan, p["attn"], c, h, lengths,
                                     block_table, layout, pos3d)
        x = x + y
        heat_total = heat_total + heat
        x = x + ffn_forward(cfg, plan, p, _apply_norm(cfg, p["ln2"], x))
    x = _apply_norm(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x.float() @ head.float()
    return logits, cache, heat_total


# ---------------------------------------------------------------------------
# Prefill (full sequence, populating the paged pools)
# ---------------------------------------------------------------------------

def prefill_step(params: Pytree, cfg: ModelConfig, cache: Pytree,
                 tokens: torch.Tensor, block_table: torch.Tensor,
                 layout: PagedLayout, *,
                 patches: torch.Tensor | None = None,
                 pos3d: torch.Tensor | None = None, compute_dtype=BF16,
                 chunk: int = 1024, last_index: torch.Tensor | None = None):
    """Forward the prompt and write its K/V into the paged pools (in place).
    Returns (last-token logits [B, V_pad] f32, cache).  ``last_index``: [B]
    index of each sequence's final REAL token (prompts are right-padded to
    a block multiple); defaults to the last position.  ``chunk`` is the KV
    chunk of the plain attention version (CPU tensors).  VLM configs:
    ``patches`` ([B, P, d]) replace the first P token embeddings and
    ``pos3d`` ([3, B, S] integer) are the M-RoPE position streams."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()].to(compute_dtype)
    if patches is not None:
        P = patches.shape[1]
        x = torch.cat([patches.to(compute_dtype), x[:, P:]], dim=1)
    positions = torch.arange(S, device=x.device)[None, :]
    for plan, p, c in _layers(params, cache, cfg):
        h = _apply_norm(cfg, p["ln1"], x)
        q, k, v = _project_qkv(cfg, p["attn"], h)
        q = _rotate(cfg, q, positions, pos3d, S)
        k = _rotate(cfg, k, positions, pos3d, S)
        window = cfg.attn.window if plan.local else None
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=plan.causal, window=window,
                            soft_cap=cfg.attn.logit_soft_cap, chunk=chunk)
        x = x + matmul(o.reshape(B, S, -1), p["attn"]["wo"])
        write_prefill_kv(c["pool_k"], k, block_table,
                         block_tokens=layout.block_tokens)
        write_prefill_kv(c["pool_v"], v, block_table,
                         block_tokens=layout.block_tokens)
        x = x + ffn_forward(cfg, plan, p, _apply_norm(cfg, p["ln2"], x))
    if last_index is None:
        x_last = x[:, -1]
    else:
        x_last = x[torch.arange(B, device=x.device), last_index.long()]
    x_last = _apply_norm(cfg, params["final_norm"], x_last)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x_last.float() @ head.float()
    return logits, cache


# ---------------------------------------------------------------------------
# Suffix prefill (prefix-cache hit: prefix KV comes from the pool)
# ---------------------------------------------------------------------------

def write_suffix_kv(pool, kv_seq, block_table, start: int, *,
                    block_tokens: int):
    """Scatter a suffix prefill's KV at token offset ``start``, in place.

    kv_seq: [B, S, ...] — the KV of tokens [start, start+S); rows whose
    target position lands in an unmapped block (table -1) or past the
    table are dropped, like the other pool scatters."""
    B, S = kv_seq.shape[:2]
    MB = block_table.shape[1]
    pos = start + torch.arange(S, device=kv_seq.device)
    blk = pos // block_tokens
    off = (pos % block_tokens).expand(B, S)
    raw = block_table[:, blk.clamp(max=MB - 1)].long()            # [B, S]
    ok = (blk < MB)[None, :] & (raw >= 0)
    pool[raw[ok], off[ok]] = kv_seq[ok].to(pool.dtype)
    return pool


def _gather_full_kv(pool, suffix, block_table, start: int, key_blocks: int,
                    block_tokens: int):
    """Assemble the FULL-length KV stream of one sequence: positions
    [0, start) gathered from the paged pool (the cached prefix),
    [start, start+S) from the freshly computed ``suffix``, the rest zero.

    ``key_blocks`` is the prompt's padded block count, so the result has
    the exact key length of the stream the ordinary full prefill builds;
    the zero tail past the valid tokens is causally masked for every valid
    query row, which keeps the suffix rows equal to the full path's."""
    B, S = suffix.shape[:2]
    KB = key_blocks * block_tokens
    tbl = block_table[:, :key_blocks].long()                      # [B, nb]
    full = pool[tbl.clamp_min(0)].reshape((B, KB) + pool.shape[2:])
    posk = torch.arange(KB, device=suffix.device)
    valid = (posk[None, :] < start) & \
        (tbl.repeat_interleave(block_tokens, dim=1) >= 0)
    full = torch.where(valid.reshape(valid.shape + (1,) * (full.ndim - 2)),
                       full, torch.zeros((), dtype=full.dtype,
                                         device=full.device))
    full = full.to(suffix.dtype)
    idx = start + torch.arange(S, device=suffix.device)
    keep = idx < KB
    full[:, idx[keep]] = suffix[:, keep].to(full.dtype)
    return full


def prefill_suffix_step(params: Pytree, cfg: ModelConfig, cache: Pytree,
                        tokens: torch.Tensor, block_table: torch.Tensor,
                        layout: PagedLayout, *, prefix_len: int,
                        key_blocks: int, compute_dtype=BF16,
                        chunk: int = 1024,
                        last_index: torch.Tensor | None = None):
    """Prefill ONLY the uncached suffix of a prompt whose first
    ``prefix_len`` tokens' KV already sits in the paged pool (a prefix-cache
    hit: shared blocks mapped read-only, the partial tail already
    copy-on-write-broken).

    tokens: [B, S] the SUFFIX tokens (block-padded); prefix_len: absolute
    position of tokens[:, 0]; key_blocks: padded block count of the whole
    prompt.  Each attention layer projects q/k/v for the suffix rows only,
    attends against pool-gathered prefix + computed suffix keys through
    ``flash_attention(q_offset=prefix_len)`` and scatters the suffix KV at
    its token offset (in place).  VLM / M-RoPE configs are rejected, as the
    reference rejects them (their patches replace the prompt's first
    embeddings).  Returns (last-token logits [B, V_pad] f32, cache).
    """
    if cfg.vlm_patches or cfg.attn.mrope_sections is not None:
        raise ValueError("suffix prefill supports plain decoder LMs only")
    B, S = tokens.shape
    bt = layout.block_tokens
    x = params["embed"][tokens.long()].to(compute_dtype)
    positions = prefix_len + torch.arange(S, device=x.device)[None, :]
    max_pos = max(prefix_len + S, key_blocks * bt)
    for plan, p, c in _layers(params, cache, cfg):
        h = _apply_norm(cfg, p["ln1"], x)
        q, k, v = _project_qkv(cfg, p["attn"], h)
        if cfg.attn.use_rope:
            rope = dict(max_pos=max_pos, theta=cfg.attn.rope_theta)
            q = apply_rope(q, positions, **rope)
            k = apply_rope(k, positions, **rope)
        window = cfg.attn.window if plan.local else None
        k_full = _gather_full_kv(c["pool_k"], k, block_table, prefix_len,
                                 key_blocks, bt)
        v_full = _gather_full_kv(c["pool_v"], v, block_table, prefix_len,
                                 key_blocks, bt)
        o = flash_attention(q.contiguous(), k_full.contiguous(),
                            v_full.contiguous(), causal=plan.causal,
                            window=window, soft_cap=cfg.attn.logit_soft_cap,
                            chunk=chunk, q_offset=prefix_len)
        x = x + matmul(o.reshape(B, S, -1), p["attn"]["wo"])
        write_suffix_kv(c["pool_k"], k, block_table, prefix_len,
                        block_tokens=bt)
        write_suffix_kv(c["pool_v"], v, block_table, prefix_len,
                        block_tokens=bt)
        x = x + ffn_forward(cfg, plan, p, _apply_norm(cfg, p["ln2"], x))
    if last_index is None:
        x_last = x[:, -1]
    else:
        x_last = x[torch.arange(B, device=x.device), last_index.long()]
    x_last = _apply_norm(cfg, params["final_norm"], x_last)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x_last.float() @ head.float()
    return logits, cache
