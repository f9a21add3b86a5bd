"""Qwen2-VL 7B [arXiv:2409.12191; hf]: 28L, d_model 3584, 28 heads (GQA kv=4),
d_ff 18944, vocab 152064; M-RoPE (temporal/height/width sections 16/24/24 of
head_dim/2=64); dynamic-resolution vision frontend is a STUB — input_specs()
provides precomputed patch embeddings + 3D positions."""

from .base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    kv_heads=4,
    d_ff=18944,
    vocab=152064,
    mlp="swiglu",
    norm="rms",
    attn=AttnCfg(rope_theta=1_000_000.0, mrope_sections=(16, 24, 24)),
    vlm_patches=1024,
    notes="28 heads not divisible by TP=16: attention-weight sharding falls "
          "back per the rule engine (kv=4 likewise); MLP TP carries the layer",
)


def smoke_config():
    return ModelConfig(
        name="qwen2vl-smoke", family="vlm", n_layers=3, d_model=64,
        n_heads=4, kv_heads=2, d_ff=128, vocab=512, mlp="swiglu", norm="rms",
        attn=AttnCfg(mrope_sections=(4, 2, 2)), vlm_patches=4)
