"""Gemma-3 27B [hf:google/gemma-3-1b-pt; unverified]: 62L, d_model 5376,
32 heads (GQA kv=16), d_ff 21504, vocab 262144; 5 local (sliding-window 1024)
: 1 global layer pattern; GeGLU; QK-norm; 128k context."""

from .base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    kv_heads=16,
    d_ff=21504,
    vocab=262144,
    mlp="geglu",
    norm="rms",
    attn=AttnCfg(rope_theta=1_000_000.0, window=1024,
                 pattern=("l", "l", "l", "l", "l", "g"), qk_norm=True),
    notes="5:1 local:global; local layers use a 1024-token sliding window, "
          "which keeps long_500k decode reads bounded for 52/62 layers",
)


def smoke_config():
    return ModelConfig(
        name="gemma3-smoke", family="dense", n_layers=6, d_model=64,
        n_heads=4, kv_heads=2, d_ff=128, vocab=512, mlp="geglu", norm="rms",
        attn=AttnCfg(window=8, pattern=("l", "l", "g"), qk_norm=True))
