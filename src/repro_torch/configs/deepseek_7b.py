"""DeepSeek-LLM 7B [arXiv:2401.02954; hf]: llama-arch, 30L, d_model 4096,
32 heads (MHA: kv=32), d_ff 11008, vocab 102400, SwiGLU, RMSNorm, RoPE."""

from .base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    kv_heads=32,
    d_ff=11008,
    vocab=102400,
    mlp="swiglu",
    norm="rms",
    attn=AttnCfg(rope_theta=10000.0),
)


def smoke_config():
    return ModelConfig(
        name="deepseek-7b-smoke", family="dense", n_layers=3, d_model=64,
        n_heads=4, kv_heads=4, d_ff=128, vocab=512, mlp="swiglu", norm="rms")
