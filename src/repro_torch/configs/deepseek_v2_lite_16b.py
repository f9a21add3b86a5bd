"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf
deepseek-ai/DeepSeek-V2-Lite config.json]: 27L, d_model 2048, 16 heads,
MLA (no q_lora, kv_lora 512, nope 128 + rope 64, v 128), vocab 102400; MoE
64 routed (d_ff 1408) top-6 of a softmax with the gates left unnormalised
(``norm_topk_prob: false``, ``routed_scaling_factor`` 1) + 2 shared, first
layer dense (d_ff 10944); YaRN rope scaling (factor 40 over 4,096
positions, beta_fast 32, beta_slow 1, mscale and mscale_all_dim 0.707).

Note: the assignment line says "2 shared+160 routed" in the comment but the
explicit config field is "MoE 64e top-6"; 64 routed matches the published
V2-Lite checkpoint (160 is full V2), so we use 64 — recorded in DESIGN.md.

``smoke_config()`` keeps the JAX package's semantics (plain rope,
normalised gates), so the smoke model is held to the reference.
"""

from .base import AttnCfg, MLACfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    kv_heads=16,            # unused: MLA replaces GQA KV
    d_ff=10944,
    vocab=102400,
    mlp="swiglu",
    norm="rms",
    attn=AttnCfg(rope_theta=10000.0, yarn_factor=40.0,
                 yarn_original_max_pos=4096, yarn_beta_fast=32.0,
                 yarn_beta_slow=1.0, yarn_mscale=0.707,
                 yarn_mscale_all_dim=0.707),
    mla=MLACfg(kv_lora=512, qk_nope=128, qk_rope=64, v_head=128),
    moe=MoECfg(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2,
               every=1, first_dense=1, norm_topk_prob=False),
    notes="MLA latent cache (512+64 per token) makes even 500k-token KV "
          "small, but attention itself is full — long_500k skipped per rule",
)


def smoke_config():
    return ModelConfig(
        name="dsv2lite-smoke", family="moe", n_layers=3, d_model=64,
        n_heads=4, kv_heads=4, d_ff=128, vocab=512, mlp="swiglu", norm="rms",
        mla=MLACfg(kv_lora=32, qk_nope=16, qk_rope=8, v_head=16),
        moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=32, num_shared=1,
                   every=1, first_dense=1))
