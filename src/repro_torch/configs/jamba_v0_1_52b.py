"""Jamba-v0.1 52B [arXiv:2403.19887; hf]: 32L, d_model 4096, 32 heads
(GQA kv=8), d_ff 14336, vocab 65536; attention:mamba 1:7 interleave
(1 attention layer per 8, at position 4 of each block), MoE 16 experts top-2
every other layer.

Adaptation note (DESIGN.md): Jamba-v0.1 uses Mamba-1 layers; we implement the
SSM with our Mamba-2/SSD layer (d_state 16 as published) since SSD is the
TPU-friendly matmul formulation of the same selective-SSM family.
"""

from .base import AttnCfg, MambaCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=65536,
    mlp="swiglu",
    norm="rms",
    attn=AttnCfg(use_rope=False),    # jamba uses no positional encoding
    mamba=MambaCfg(d_state=16, head_dim=64, expand=2, chunk=256, conv_dim=4),
    moe=MoECfg(num_experts=16, top_k=2, d_ff_expert=14336, num_shared=0,
               every=2, first_dense=1),
    hybrid_pattern=("m", "m", "m", "m", "a", "m", "m", "m"),
)


def smoke_config():
    return ModelConfig(
        name="jamba-smoke", family="hybrid", n_layers=8, d_model=64,
        n_heads=4, kv_heads=2, d_ff=128, vocab=512, mlp="swiglu", norm="rms",
        attn=AttnCfg(use_rope=False),
        mamba=MambaCfg(d_state=16, head_dim=16, expand=2, chunk=8, conv_dim=4),
        moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=64, num_shared=0,
                   every=2, first_dense=1),
        hybrid_pattern=("m", "m", "m", "m", "a", "m", "m", "m"))
