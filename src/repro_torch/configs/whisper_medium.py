"""Whisper-medium [arXiv:2212.04356; unverified]: enc-dec, 24+24 layers,
d_model 1024, 16 heads (MHA), d_ff 4096, vocab 51865; LayerNorm + GELU;
absolute (sinusoidal) positions, no RoPE.  The conv audio frontend is a STUB:
input_specs() provides precomputed frame embeddings [B, frames, d_model]."""

from .base import AttnCfg, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    kv_heads=16,
    d_ff=4096,
    vocab=51865,
    mlp="gelu",
    norm="ln",
    attn=AttnCfg(use_rope=False),
    enc_dec=True,
    enc_layers=24,
    enc_frames=1500,
    notes="decode_32k lowered with a 32k self-attn KV for cross-arch "
          "comparability; whisper's natural decoder ceiling is 448 tokens",
)


def smoke_config():
    return ModelConfig(
        name="whisper-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, kv_heads=4, d_ff=128, vocab=512, mlp="gelu", norm="ln",
        attn=AttnCfg(use_rope=False), enc_dec=True, enc_layers=2,
        enc_frames=16)
