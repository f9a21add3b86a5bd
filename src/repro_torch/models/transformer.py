"""Inference subset of ``repro.models.transformer``: layer plans, segments,
the param spec and the per-layer projections the paged serving path
(:mod:`repro_torch.models.decode`) runs, for decoders with GQA/MHA
attention (RoPE or M-RoPE, sliding windows, QK-norm), RMSNorm or LayerNorm,
gated or plain MLPs and fine-grained MoE layers.

The JAX package stacks each repeated segment's params along a leading
``[reps, ...]`` axis so ``lax.scan`` can walk them; PyTorch runs the layers
eagerly, so here a scan segment's params are a list with one subtree per
repetition (:func:`repro_torch.convert.params_from_jax` unstacks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..configs.base import ModelConfig
from .common import (ParamSpec, activate, gelu_tanh, layer_norm, matmul,
                     pad_vocab, rms_norm, silu)
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


def check_supported(cfg: ModelConfig) -> None:
    """The port serves decoders whose every layer is GQA/MHA attention
    (dense, MoE and VLM families).  MLA latent attention, mamba and hybrid
    stacks and encoder-decoders are ROADMAP "Modules still to port" item
    11's next slice."""
    if (cfg.mla is not None or cfg.enc_dec
            or any(k != "a" for k in cfg.layer_kinds())):
        raise NotImplementedError(
            f"{cfg.name}: MLA, mamba/hybrid and encoder-decoder models are "
            f"not ported yet (ROADMAP item 11, next slice: MLA, mamba2/jamba, "
            f"Whisper)")


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
    spec = {"ln1": _norm_spec(cfg, d), "attn": _attn_spec(cfg),
            "ln2": _norm_spec(cfg, d)}
    if plan.moe:
        spec["moe"] = moe_spec(d, cfg.moe, cfg.mlp)
    else:
        spec["mlp"] = _mlp_spec(cfg)
    return spec


def model_spec(cfg: ModelConfig) -> Pytree:
    check_supported(cfg)
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
    return spec


# ---------------------------------------------------------------------------
# Per-layer projections
# ---------------------------------------------------------------------------

def _project_qkv(cfg, p, h):
    B, S, d = h.shape
    H, KVH, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = matmul(h, p["wq"]).reshape(B, S, H, hd)
    k = matmul(h, p["wk"]).reshape(B, S, KVH, hd)
    v = matmul(h, p["wv"]).reshape(B, S, KVH, hd)
    if cfg.attn.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


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
    """The layer's feed-forward block on ``h`` ([..., d]): its MLP, or its
    MoE layer over all of h's rows at once (a prefill's padded rows count
    toward the experts' capacity, as in the reference)."""
    if not plan.moe:
        return _mlp_forward(cfg, p["mlp"], h)
    y, _ = moe_apply(p["moe"], h.reshape(-1, h.shape[-1]), cfg.moe, cfg.mlp)
    return y.reshape(h.shape)
