"""Phi-3-mini 3.8B [arXiv:2404.14219; unverified]: 32L, d_model 3072,
32 heads (kv=32), d_ff 8192, vocab 32064, RoPE + SwiGLU."""

from .base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    kv_heads=32,
    d_ff=8192,
    vocab=32064,
    mlp="swiglu",
    norm="rms",
    attn=AttnCfg(rope_theta=10000.0),
)


def smoke_config():
    return ModelConfig(
        name="phi3-smoke", family="dense", n_layers=3, d_model=48,
        n_heads=4, kv_heads=4, d_ff=96, vocab=512, mlp="swiglu", norm="rms")
