"""DeepSeekMoE 16B [arXiv:2401.06066; hf]: 28L, d_model 2048, 16 heads
(kv=16), vocab 102400; fine-grained MoE: 64 routed experts (d_ff 1408)
top-6 + 2 shared experts; first layer dense (d_ff 10944)."""

from .base import AttnCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    d_ff=10944,                 # the single dense (first) layer
    vocab=102400,
    mlp="swiglu",
    norm="rms",
    attn=AttnCfg(rope_theta=10000.0),
    moe=MoECfg(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2,
               every=1, first_dense=1),
)


def smoke_config():
    return ModelConfig(
        name="dsmoe-smoke", family="moe", n_layers=3, d_model=64,
        n_heads=4, kv_heads=4, d_ff=128, vocab=512, mlp="swiglu", norm="rms",
        moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=32, num_shared=1,
                   every=1, first_dense=1))
