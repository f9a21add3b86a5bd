"""Inference subset of ``repro.models.transformer``: layer plans, segments,
the dense param spec and the per-layer projections the paged serving path
(:mod:`repro_torch.models.decode`) runs.

The JAX package stacks each repeated segment's params along a leading
``[reps, ...]`` axis so ``lax.scan`` can walk them; PyTorch runs the layers
eagerly, so here a scan segment's params are a list with one subtree per
repetition (:func:`repro_torch.convert.params_from_jax` unstacks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import ParamSpec, matmul, pad_vocab, rms_norm

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
    """The port serves dense GQA/MHA decoders with RMSNorm and a gated MLP;
    the other families are ROADMAP "Modules still to port" item 11."""
    if (cfg.mla is not None or cfg.moe is not None or cfg.enc_dec
            or cfg.vlm_patches or cfg.attn.mrope_sections is not None
            or cfg.attn.qk_norm or cfg.norm != "rms"
            or cfg.mlp not in ("swiglu", "geglu")
            or any(k != "a" for k in cfg.layer_kinds())):
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA/MHA decoders with RMSNorm and a "
            f"gated MLP are ported (ROADMAP item 11: other model families)")


# ---------------------------------------------------------------------------
# Parameter specs (dense decoder)
# ---------------------------------------------------------------------------

def _norm_spec(cfg: ModelConfig, d: int) -> Pytree:
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def _apply_norm(cfg: ModelConfig, p: Pytree, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, p["scale"])


def _attn_spec(cfg: ModelConfig) -> Pytree:
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, H * hd), ("embed", "q_heads")),
        "wk": ParamSpec((d, KVH * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, KVH * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((H * hd, d), ("q_heads", "embed")),
    }


def _mlp_spec(cfg: ModelConfig) -> Pytree:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_in": ParamSpec((d, f), ("embed", "ff")),
        "w_out": ParamSpec((f, d), ("ff", "embed")),
        "w_gate": ParamSpec((d, f), ("embed", "ff")),
    }


def layer_spec(cfg: ModelConfig, plan: LayerPlan) -> Pytree:
    d = cfg.d_model
    return {"ln1": _norm_spec(cfg, d), "attn": _attn_spec(cfg),
            "ln2": _norm_spec(cfg, d), "mlp": _mlp_spec(cfg)}


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
    return q, k, v


def _mlp_forward(cfg, p, h):
    x = matmul(h, p["w_in"])
    g = matmul(h, p["w_gate"])
    if cfg.mlp == "swiglu":
        # jax.nn.silu's own expression, op by op: every op rounds to the
        # working dtype, so bf16 results match the reference bit for bit
        g = g * (1 / (1 + torch.exp(-g)))
    else:
        g = F.gelu(g, approximate="tanh")
    return matmul(g * x, p["w_out"])
