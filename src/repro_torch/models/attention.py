"""Attention primitives of the serving path beyond GQA: dense-cache decode
(Whisper's cross-attention) and MLA's latent expansion (DeepSeek-V2).

The PyTorch counterpart of the parts of ``repro.models.attention`` that the
paged serving path runs.  The chunked flash attention itself is
:func:`repro_torch.kernels.flash_attention.flash_attention` (the CUDA
kernel on the card, its plain version on the CPU); MLA's expanded prefill
goes through it with value heads narrower than its query/key heads.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from ..distributed import spmd
# the flash kernel (its local_map bridge on DTensors)
from ..distributed.spmd import flash_attention
from .common import einsum

NEG_INF = -1e30


def decode_attention_dense(q, k_cache, v_cache, lengths, *, soft_cap=None,
                           window=None):
    """Single-token decode against a dense KV cache.

    q: [B, H, D]; caches: [B, S, KVH, D]; lengths: [B] (valid prefix
    length, including the current token's slot).  Returns [B, H, D] in
    q.dtype.  Torch ops: the reference computes it in jnp (no TPU kernel).
    DTensors run it on local shards
    (:func:`repro_torch.distributed.spmd.dense_decode`).
    """
    if isinstance(q, DTensor):
        return spmd.dense_decode(decode_attention_dense, q, k_cache, v_cache,
                                 lengths, soft_cap=soft_cap, window=window)
    B, H, D = q.shape
    _, S, KVH, _ = k_cache.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KVH, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    pos = torch.arange(S, device=q.device)[None, :]
    valid = pos < lengths[:, None]
    if window is not None:
        valid &= pos > (lengths[:, None] - 1 - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


def mla_expand_attention(q_nope, q_rope, c_kv, k_rope, w_uk, w_uv, *,
                         causal: bool = True, chunk: int = 1024,
                         q_offset: "int | torch.Tensor" = 0,
                         scale: float | None = None):
    """MLA prefill: expand the latents to per-head K/V, then flash-attend.

    q_nope: [B,Sq,H,Dn]; q_rope: [B,Sq,H,Dr]; c_kv: [B,Sk,L]; k_rope:
    [B,Sk,Dr]; w_uk: [H,L,Dn]; w_uv: [H,L,Dv].  Returns [B,Sq,H,Dv].
    ``q_offset`` is the absolute position of q[0] (a suffix prefill attends
    the tail of a sequence whose earlier latents came from the paged pool):
    an int, or a one-element int32 tensor the flash kernel reads from
    device memory.
    The flash call has query/key heads of Dn + Dr and value heads of Dv;
    ``scale`` is its softmax scale (None: ``(Dn + Dr) ** -0.5``; YaRN's
    configs pass :func:`~repro_torch.models.transformer.mla_scale`).
    """
    B, Sk = c_kv.shape[:2]
    H = q_nope.shape[2]
    k_nope = einsum("bsl,hld->bshd", c_kv, w_uk)
    v = einsum("bsl,hld->bshd", c_kv, w_uv)
    k_rope_b = k_rope[:, :, None, :].expand(B, Sk, H, k_rope.shape[-1])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, chunk=chunk, q_offset=q_offset,
                           scale=scale)


def mla_absorbed_decode(q_nope, q_rope, ckv_cache, krope_cache, lengths,
                        w_uk, w_uv):
    """Decode-path MLA with weight absorption, over a dense per-sequence
    latent cache (the reference's ``mla_absorbed_decode``, in torch ops as
    the reference's is jnp; neither package's serving path calls it — they
    decode through the paged latent gather).  ``W_uk`` folds into the query
    and ``W_uv`` into the output, so each cached token costs kv_lora +
    rope_dim, not heads * head_dim * 2.

    q_nope: [B,H,Dn]; q_rope: [B,H,Dr]; ckv_cache: [B,S,L]; krope_cache:
    [B,S,Dr]; lengths: [B] valid tokens; w_uk: [H,L,Dn]; w_uv: [H,L,Dv].
    Returns [B,H,Dv] in q_nope's dtype; float32 inside."""
    Dn = q_nope.shape[-1]
    scale = 1.0 / math.sqrt(Dn + q_rope.shape[-1])
    q_eff = torch.einsum("bhd,hld->bhl", q_nope.float(), w_uk.float())
    s = (torch.einsum("bhl,bsl->bhs", q_eff, ckv_cache.float())
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), krope_cache.float()))
    s = s * scale
    valid = torch.arange(ckv_cache.shape[1], device=s.device)[None, :] \
        < lengths[:, None]
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", p, ckv_cache.float())
    out = torch.einsum("bhl,hld->bhd", o_lat, w_uv.float())
    return out.to(q_nope.dtype)
