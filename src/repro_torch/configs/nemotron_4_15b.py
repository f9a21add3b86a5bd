"""Nemotron-4 15B [arXiv:2402.16819; unverified]: 32L, d_model 6144, 48 heads
(GQA kv=8), d_ff 24576, vocab 256000; squared-ReLU MLP (no GLU), RoPE."""

from .base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    kv_heads=8,
    d_ff=24576,
    vocab=256000,
    mlp="relu2",
    norm="ln",              # nemotron-4 uses LayerNorm
    attn=AttnCfg(rope_theta=10000.0),
    notes="GQA kv=8; squared-ReLU non-gated MLP",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-smoke", family="dense", n_layers=4, d_model=64,
        n_heads=8, kv_heads=2, d_ff=160, vocab=512, mlp="relu2", norm="ln",
        attn=AttnCfg(rope_theta=10000.0))
