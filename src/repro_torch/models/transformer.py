"""The port of ``repro.models.transformer``: layer plans, segments, the
param spec, the per-layer projections the paged serving path
(:mod:`repro_torch.models.decode`) runs, and the full-sequence training
forward (:func:`model_forward`, :func:`lm_loss`), for every arch of the
repo: GQA/MHA attention (RoPE or M-RoPE, sliding windows, QK-norm) or MLA
latent attention, mamba-2 layers, RMSNorm or LayerNorm, gated or plain
MLPs, fine-grained MoE layers, and Whisper's encoder and cross-attention.

Layer kinds follow the reference to the letter: a plan's ``kind`` is the
config's layer kind ("a" or "m"), and the layer code takes its mamba branch
for ``kind == "mamba"``, as the reference's does.  No config gives that
kind, so mamba2 and jamba serve in both packages with attention (and
mamba2 with no MLP) at every layer: the reference's result, which the port
holds to, not repairs.

The JAX package stacks each repeated segment's params along a leading
``[reps, ...]`` axis so ``lax.scan`` can walk them; PyTorch runs the layers
eagerly, so here a scan segment's params are a list with one subtree per
repetition (:func:`repro_torch.convert.params_from_jax` unstacks).  The
reference's ``jax.checkpoint`` remat of each plain layer and each scan
repetition is ``torch.utils.checkpoint`` (non-reentrant) here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..distributed import spmd
# the flash kernel (its local_map bridge on DTensors)
from ..distributed.spmd import flash_attention, rows

from ..configs.base import ModelConfig
from .attention import mla_expand_attention
from .common import (BF16, F32, ParamSpec, activate, apply_mrope, apply_rope,
                     embed_lookup, gelu_tanh, layer_norm, matmul, merge_heads,
                     pad_vocab, rms_norm, sinusoidal_positions, silu,
                     split_heads, yarn_mscale, yarn_of)
from .mamba2 import mamba_apply, mamba_spec
from .moe import moe_apply, moe_spec

Pytree = Any


@dataclass(frozen=True)
class LayerPlan:
    kind: str          # "attn" | "mamba"
    local: bool = False
    moe: bool = False
    xattn: bool = False   # adds cross-attention (whisper decoder)
    causal: bool = True
    ffn: bool = True      # False for pure-SSM blocks (mamba2): no separate MLP


# ---------------------------------------------------------------------------
# Segmenting: express the layer list as prefix + repeated cycle + suffix
# ---------------------------------------------------------------------------

def build_layer_plans(cfg: ModelConfig, *, decoder: bool = True) -> list[LayerPlan]:
    kinds = cfg.layer_kinds()
    attn_kinds = cfg.attn_kinds()
    moes = cfg.moe_layers()
    plans = []
    for i in range(cfg.n_layers):
        plans.append(LayerPlan(
            kind=kinds[i],
            local=(attn_kinds[i] == "l"),
            moe=moes[i],
            xattn=cfg.enc_dec and decoder,
            causal=decoder,
            ffn=(cfg.family != "ssm"),
        ))
    return plans


def build_segments(plans: list[LayerPlan]) -> list[tuple]:
    """Return segments: ("plain", plan) or ("scan", (plans...), reps)."""
    n = len(plans)
    best = None
    for pre in range(0, 3):
        for p in (1, 2, 3, 4, 6, 8):
            if n - pre < p:
                continue
            cycle = tuple(plans[pre:pre + p])
            reps = (n - pre) // p
            if all(plans[pre + i] == cycle[i % p] for i in range(reps * p)):
                suffix = n - pre - reps * p
                score = (pre + suffix) * 10 + p
                if best is None or score < best[0]:
                    best = (score, pre, p, reps, suffix)
    if best is None:   # fully irregular; all plain
        return [("plain", pl) for pl in plans]
    _, pre, p, reps, suffix = best
    segs: list[tuple] = [("plain", plans[i]) for i in range(pre)]
    segs.append(("scan", tuple(plans[pre:pre + p]), reps))
    segs.extend(("plain", plans[pre + reps * p + i]) for i in range(suffix))
    return segs


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _norm_spec(cfg: ModelConfig, d: int) -> Pytree:
    if cfg.norm == "rms":
        return {"scale": ParamSpec((d,), ("embed",), init="ones")}
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def _apply_norm(cfg: ModelConfig, p: Pytree, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def _attn_spec(cfg: ModelConfig) -> Pytree:
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "wq": ParamSpec((d, H * (m.qk_nope + m.qk_rope)),
                            ("embed", "q_heads")),
            "w_dkv": ParamSpec((d, m.kv_lora + m.qk_rope), ("embed", None)),
            "kv_norm": ParamSpec((m.kv_lora,), (None,), init="ones"),
            "w_uk": ParamSpec((H, m.kv_lora, m.qk_nope),
                              ("q_heads", "kv_lora", "head_dim")),
            "w_uv": ParamSpec((H, m.kv_lora, m.v_head),
                              ("q_heads", "kv_lora", "head_dim")),
            "wo": ParamSpec((H * m.v_head, d), ("q_heads", "embed")),
        }
    spec = {
        "wq": ParamSpec((d, H * hd), ("embed", "q_heads")),
        "wk": ParamSpec((d, KVH * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, KVH * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((H * hd, d), ("q_heads", "embed")),
    }
    if cfg.attn.qk_norm:
        spec["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        spec["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    return spec


def _xattn_spec(cfg: ModelConfig) -> Pytree:
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, H * hd), ("embed", "q_heads")),
        "wk": ParamSpec((d, KVH * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, KVH * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((H * hd, d), ("q_heads", "embed")),
    }


def _mlp_spec(cfg: ModelConfig) -> Pytree:
    d, f = cfg.d_model, cfg.d_ff
    spec = {
        "w_in": ParamSpec((d, f), ("embed", "ff")),
        "w_out": ParamSpec((f, d), ("ff", "embed")),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        spec["w_gate"] = ParamSpec((d, f), ("embed", "ff"))
    return spec


def layer_spec(cfg: ModelConfig, plan: LayerPlan) -> Pytree:
    d = cfg.d_model
    if plan.kind == "mamba":
        spec = {"ln1": _norm_spec(cfg, d), "mamba": mamba_spec(d, cfg.mamba)}
    else:
        spec = {"ln1": _norm_spec(cfg, d), "attn": _attn_spec(cfg)}
    if plan.xattn:
        spec["lnx"] = _norm_spec(cfg, d)
        spec["xattn"] = _xattn_spec(cfg)
    if plan.ffn:
        spec["ln2"] = _norm_spec(cfg, d)
        if plan.moe:
            spec["moe"] = moe_spec(d, cfg.moe, cfg.mlp)
        else:
            spec["mlp"] = _mlp_spec(cfg)
    return spec


def model_spec(cfg: ModelConfig) -> Pytree:
    V = pad_vocab(cfg.vocab)
    d = cfg.d_model
    spec: dict = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": _norm_spec(cfg, d),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamSpec((d, V), ("embed", "vocab"))
    segs = build_segments(build_layer_plans(cfg, decoder=True))
    blocks: dict = {}
    for si, seg in enumerate(segs):
        if seg[0] == "plain":
            blocks[f"p{si}"] = layer_spec(cfg, seg[1])
        else:
            _, cycle, reps = seg
            blocks[f"s{si}"] = [
                {f"m{j}": layer_spec(cfg, pl) for j, pl in enumerate(cycle)}
                for _ in range(reps)]
    spec["blocks"] = blocks
    if cfg.enc_dec:
        enc_plan = LayerPlan(kind="attn", causal=False)
        spec["encoder"] = {
            "blocks": [{"m0": layer_spec(cfg, enc_plan)}
                       for _ in range(cfg.enc_layers)],
            "final_norm": _norm_spec(cfg, d),
        }
    return spec


# ---------------------------------------------------------------------------
# Per-layer projections
# ---------------------------------------------------------------------------

def _project_qkv(cfg, p, h):
    B, S, d = h.shape
    H, KVH, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = split_heads(matmul(h, p["wq"]), H, hd)
    k = split_heads(matmul(h, p["wk"]), KVH, hd)
    v = split_heads(matmul(h, p["wv"]), KVH, hd)
    if cfg.attn.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _rotate(cfg, x, positions, pos3d, max_pos: int):
    """RoPE by ``positions`` ([..., seq]) or, for M-RoPE configs, by the
    three position streams ``pos3d`` ([3, ..., seq]); x: [..., seq, heads,
    hd]."""
    if cfg.attn.mrope_sections is not None:
        return apply_mrope(x, pos3d, cfg.attn.mrope_sections,
                           max_pos=max_pos, theta=cfg.attn.rope_theta)
    if cfg.attn.use_rope:
        return apply_rope(x, positions, max_pos=max_pos,
                          theta=cfg.attn.rope_theta, yarn=yarn_of(cfg.attn))
    return x


def mla_scale(cfg) -> float:
    """MLA's softmax scale: ``(qk_nope + qk_rope) ** -0.5``, times
    DeepSeek-V2's YaRN ``m ** 2`` (``m = yarn_mscale(factor,
    mscale_all_dim)``) when the config scales its rope with a nonzero
    ``mscale_all_dim``."""
    a = cfg.attn
    scale = 1.0 / math.sqrt(cfg.mla.qk_nope + cfg.mla.qk_rope)
    if a.yarn_factor != 1.0 and a.yarn_mscale_all_dim:
        m = yarn_mscale(a.yarn_factor, a.yarn_mscale_all_dim)
        scale *= m * m
    return scale


def _mla_project(cfg, p, h, positions, max_pos: int):
    """MLA's projections of ``h`` ([..., seq, d]): (q_nope, q_rope roped,
    c_kv normed, k_rope roped), as the reference's prefill and decode
    compute them; the rope channels at YaRN's frequencies when the config
    scales its rope."""
    m = cfg.mla
    rope = dict(max_pos=max_pos, theta=cfg.attn.rope_theta,
                yarn=yarn_of(cfg.attn))
    q = matmul(h, p["wq"])
    q = split_heads(q, cfg.n_heads, m.qk_nope + m.qk_rope)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    dkv = matmul(h, p["w_dkv"])
    c_kv = rms_norm(dkv[..., :m.kv_lora], p["kv_norm"])
    q_rope = apply_rope(q_rope, positions, **rope)
    k_rope = apply_rope(dkv[..., m.kv_lora:][..., None, :], positions,
                        **rope)[..., 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mlp_forward(cfg, p, h):
    x = matmul(h, p["w_in"])
    if cfg.mlp in ("swiglu", "geglu"):
        g = matmul(h, p["w_gate"])
        # the reference's activations op by op (common.silu/gelu_tanh):
        # every op rounds to the working dtype, so bf16 matches bit for bit
        x = (silu(g) if cfg.mlp == "swiglu" else gelu_tanh(g)) * x
    else:
        x = activate(x, cfg.mlp)
    return matmul(x, p["w_out"])


def ffn_forward(cfg, plan: LayerPlan, p, h):
    """The layer's feed-forward block on ``h`` ([..., d]) -> (y, aux): its
    MLP (aux None), or its MoE layer over all of h's rows at once (a
    prefill's padded rows count toward the experts' capacity, as in the
    reference) and that layer's load-balancing loss."""
    if not plan.moe:
        return _mlp_forward(cfg, p["mlp"], h), None
    y, aux = moe_apply(p["moe"], h.reshape(-1, h.shape[-1]), cfg.moe,
                       cfg.mlp)
    return y.reshape(h.shape), aux


# ---------------------------------------------------------------------------
# Whisper: the encoder and the decoder's cross-attention
# ---------------------------------------------------------------------------

def _attn_forward(cfg, plan: LayerPlan, p, h, positions, chunk: int,
                  pos3d=None):
    """Full-sequence self-attention of ``h`` ([B, S, d]) through the flash
    kernel: MLA's latent expansion, or GQA/MHA with RoPE or M-RoPE (by
    ``pos3d``, [3, B, S]) when the config has it.  ``positions``: [1, S]
    integer."""
    S = h.shape[1]
    if cfg.mla is not None:
        q_nope, q_rope, c_kv, k_rope = _mla_project(cfg, p, h, positions, S)
        out = mla_expand_attention(q_nope, q_rope, c_kv, k_rope, p["w_uk"],
                                   p["w_uv"], causal=plan.causal, chunk=chunk,
                                   scale=mla_scale(cfg))
        return matmul(merge_heads(out), p["wo"])
    q, k, v = _project_qkv(cfg, p, h)
    q = _rotate(cfg, q, positions, pos3d, S)
    k = _rotate(cfg, k, positions, pos3d, S)
    window = cfg.attn.window if plan.local else None
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=plan.causal, window=window, chunk=chunk,
                          soft_cap=cfg.attn.logit_soft_cap)
    return matmul(merge_heads(out), p["wo"])


def _xattn_kv(cfg, p, enc_out):
    """Cross-attention K and V ([B, F, KVH, hd]) of the encoder output
    ``enc_out`` ([B, F, d]): what a Whisper decoder layer caches per slot
    (``xk``/``xv``)."""
    B, F, _ = enc_out.shape
    KVH, hd = cfg.kv_heads, cfg.head_dim
    return (split_heads(matmul(enc_out, p["wk"]), KVH, hd),
            split_heads(matmul(enc_out, p["wv"]), KVH, hd))


def _xattn_forward(cfg, p, h, k, v, chunk: int):
    """Cross-attention of the decoder rows ``h`` ([B, S, d]) over the
    encoder's K/V (:func:`_xattn_kv`): non-causal flash with Sq != Sk."""
    H, hd = cfg.n_heads, cfg.head_dim
    q = split_heads(matmul(h, p["wq"]), H, hd)
    out = flash_attention(q, k.contiguous(), v.contiguous(), causal=False,
                          chunk=chunk)
    return matmul(merge_heads(out), p["wo"])


def encoder_forward(enc_params, cfg: ModelConfig, frames, *,
                    compute_dtype=BF16, chunk: int = 1024,
                    remat: bool = True):
    """Whisper-style encoder over precomputed (stub) frame embeddings
    ``frames`` ([B, F, d]): sinusoidal positions, then ``enc_layers``
    non-causal attention + MLP layers (each under remat when ``remat``),
    then the final norm."""
    B, Fr, d = frames.shape
    x = frames.to(compute_dtype)
    x = x + sinusoidal_positions(Fr, d, x.device).to(compute_dtype)[None]
    positions = torch.arange(Fr, device=x.device)[None, :]
    plan = LayerPlan(kind="attn", causal=False)
    aux = torch.zeros((), dtype=F32, device=x.device)
    for layer in enc_params["blocks"]:
        x, aux = _remat(layer_forward, remat, cfg, plan, layer["m0"], x, aux,
                        positions, chunk=chunk)
    return _apply_norm(cfg, enc_params["final_norm"], x)


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------

def _remat(fn, remat: bool, *args, **kw):
    """``fn(*args, **kw)``, under activation checkpointing when ``remat``
    (the reference's ``jax.checkpoint``): the backward recomputes it."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)


def layer_forward(cfg: ModelConfig, plan: LayerPlan, p, x, aux, positions,
                  pos3d=None, *, enc_out=None, chunk: int = 1024):
    """One layer on the full sequence ``x`` ([B, S, d]) -> (x, aux), the
    MoE layer's load-balancing loss added to ``aux``.  In a sharded program
    each residual sum is held to :func:`~repro_torch.distributed.spmd.rows`
    (rows over the data axes, the rest replicated).  Follows the
    reference: a plan of kind "mamba" (which no config gives) takes the
    mamba-2 layer, every other kind attention."""
    h = _apply_norm(cfg, p["ln1"], x)
    if plan.kind == "mamba":
        x = rows(x + mamba_apply(p["mamba"], h, cfg.mamba))
    else:
        x = rows(x + _attn_forward(cfg, plan, p["attn"], h, positions, chunk,
                                   pos3d))
    if plan.xattn:
        kx, vx = _xattn_kv(cfg, p["xattn"], enc_out)
        x = rows(x + _xattn_forward(cfg, p["xattn"],
                                    _apply_norm(cfg, p["lnx"], x), kx, vx,
                                    chunk))
    if plan.ffn:
        y, a = ffn_forward(cfg, plan, p, _apply_norm(cfg, p["ln2"], x))
        x = rows(x + y)
        if a is not None:
            aux = aux + a
    return x, aux


def _run_blocks(cfg: ModelConfig, blocks, segs: list, x, positions,
                pos3d=None, *, enc_out=None, chunk: int, remat: bool):
    """The decoder's segments over ``x`` -> (x, aux): each plain layer, and
    each repetition of a scan segment's cycle, under remat when ``remat``."""
    aux = torch.zeros((), dtype=F32, device=x.device)

    def cycle_fwd(members, reps_params, x, aux):
        for j, plan in enumerate(members):
            x, aux = layer_forward(cfg, plan, reps_params[f"m{j}"], x, aux,
                                   positions, pos3d, enc_out=enc_out,
                                   chunk=chunk)
        return x, aux

    for si, seg in enumerate(segs):
        if seg[0] == "plain":
            x, aux = _remat(cycle_fwd, remat, (seg[1],),
                            {"m0": blocks[f"p{si}"]}, x, aux)
        else:
            _, cycle, _ = seg
            for rep in blocks[f"s{si}"]:
                x, aux = _remat(cycle_fwd, remat, cycle, rep, x, aux)
    return x, aux


def model_forward(params, cfg: ModelConfig, tokens, *, frames=None,
                  patches=None, pos3d=None, compute_dtype=BF16,
                  chunk: int = 1024, remat: bool = True):
    """Full-sequence forward -> (logits [B, S, V_pad] float32, aux loss).

    tokens: [B, S] integer.  frames: Whisper's stub encoder input [B, F, d].
    patches: qwen2-VL's stub patch embeddings [B, P, d] replacing the first
    P positions.  pos3d: [3, B, S] M-RoPE positions.  The logits are
    ``x.float() @ head.float()`` over the padded vocab, as the reference
    computes them."""
    B, S = tokens.shape
    x = rows(embed_lookup(params["embed"].to(compute_dtype), tokens))
    if patches is not None:
        P = patches.shape[1]
        x = torch.cat([patches.to(compute_dtype), x[:, P:]], dim=1)
    positions = torch.arange(S, device=x.device)[None, :]
    enc_out = None
    if cfg.enc_dec:
        if frames is None:
            raise ValueError("enc-dec model needs `frames`")
        enc_out = encoder_forward(params["encoder"], cfg, frames,
                                  compute_dtype=compute_dtype, chunk=chunk,
                                  remat=remat)
        # whisper decoder uses learned positions; sinusoidal stand-in
        x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(
            compute_dtype)[None]
    segs = build_segments(build_layer_plans(cfg, decoder=True))
    x, aux = _run_blocks(cfg, params["blocks"], segs, x, positions, pos3d,
                         enc_out=enc_out, chunk=chunk, remat=remat)
    x = _apply_norm(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x.float() @ head.float(), aux


def lm_loss(params, cfg: ModelConfig, batch: dict, *, compute_dtype=BF16,
            chunk: int = 1024, remat: bool = True, z_loss: float = 1e-4):
    """Next-token cross-entropy of ``batch["tokens"]`` ([B, S + 1]) with the
    z-loss and the MoE aux loss -> (total, {"ce", "z_loss", "aux"}), as the
    reference's ``lm_loss``; ``batch["weights"]`` ([B, S + 1]) weighs the
    labels when given."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:].long()
    weights = batch.get("weights")
    if weights is None:
        weights = torch.ones(labels.shape, dtype=F32, device=labels.device)
    else:
        weights = weights[:, 1:].float()
    logits, aux = model_forward(
        params, cfg, inputs, frames=batch.get("frames"),
        patches=batch.get("patches"), pos3d=batch.get("pos3d"),
        compute_dtype=compute_dtype, chunk=chunk, remat=remat)
    if isinstance(logits, DTensor) and "model" in logits.device_mesh.\
            mesh_dim_names:
        logz, ll = spmd.vocab_parallel_ce(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - ll) * weights
    denom = weights.sum().clamp_min(1.0)
    loss = nll.sum() / denom
    zl = z_loss * (logz.square() * weights).sum() / denom
    total = loss + zl + aux
    return total, {"ce": loss, "z_loss": zl, "aux": aux}
