"""Mamba2-1.3B [arXiv:2405.21060; unverified]: 48L, d_model 2048, attention-
free SSD (state-space duality), d_state 128, vocab 50280; no separate MLP
(the mamba mixer is the whole block); tied embeddings.

Arch-applicability (DESIGN.md): the paper's paged multi-size KV technique has
no translated, growing address space to manage here — decode state is a fixed
[H, P, N] tensor — so the serving path uses plain state caching and the
eBPF-mm hook only manages the (fixed) state-buffer allocation.
"""

from .base import AttnCfg, MambaCfg, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=32,              # unused (attention-free)
    kv_heads=32,
    d_ff=0,
    vocab=50280,
    mlp="swiglu",            # unused
    norm="rms",
    attn=AttnCfg(use_rope=False),
    mamba=MambaCfg(d_state=128, head_dim=64, expand=2, chunk=256, conv_dim=4),
    tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="mamba2-smoke", family="ssm", n_layers=4, d_model=64,
        n_heads=4, kv_heads=4, d_ff=0, vocab=512, mlp="swiglu", norm="rms",
        attn=AttnCfg(use_rope=False),
        mamba=MambaCfg(d_state=16, head_dim=16, expand=2, chunk=8, conv_dim=4),
        tie_embeddings=True)
