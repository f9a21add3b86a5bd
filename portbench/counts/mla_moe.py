"""Operations and bytes of a decoder of multi-head latent attention (MLA)
layers with dense or mixture-of-experts feed-forward blocks (DeepSeek-V2
and its kin), from the configuration's ``model`` block, with the
interface of ``counts/transformer.py``.

Model flops count useful work only: 2 x the matmul parameters a token
uses (MLA's projections: the query's, the latent's, the output's and the
per-head up-projections of the latent to keys and values — applied to the
keys in a prefill, absorbed into the query and the output in a decode,
the same count a token; its MLP, or its router, its top-k routed experts
and the shared experts); attention over the keys each query sees,
``2 x heads x (kv_lora + qk_rope + kv_lora)`` a key for a decode row
(absorbed: scores against the 576-wide latent, values its first 512
channels) and ``2 x heads x (qk_nope + qk_rope + v_head)`` for a prefill
row (expanded); and the output head for each row whose logits are made.
Padding rows and an expert's unused capacity are not work.

A kernel's bound counts each input byte read once and each output byte
written once, whatever the kernel reads again.
"""

from __future__ import annotations

BF16 = 2
F32 = 4
I32 = 4


def attn_layers(m: dict) -> int:
    return m["n_layers"]


def moe_layer(m: dict, i: int) -> bool:
    moe = m.get("moe")
    if not moe:
        return False
    return i >= moe["first_dense"] and \
        (i - moe["first_dense"]) % moe["every"] == 0


def latent(m: dict) -> int:
    """The width of a cached latent: kv_lora + qk_rope."""
    return m["mla"]["kv_lora"] + m["mla"]["qk_rope"]


def token_params(m: dict) -> int:
    """Matmul parameters one token uses, every layer, the head excluded."""
    d, H, a = m["d_model"], m["n_heads"], m["mla"]
    attn = (d * H * (a["qk_nope"] + a["qk_rope"]) + d * latent(m)
            + H * a["kv_lora"] * (a["qk_nope"] + a["v_head"])
            + H * a["v_head"] * d)
    total = 0
    for i in range(m["n_layers"]):
        if moe_layer(m, i):
            e = m["moe"]
            total += attn + d * e["num_experts"] \
                + 3 * d * e["d_ff_expert"] * (e["top_k"] + e["num_shared"])
        else:
            total += attn + 3 * d * m["d_ff"]
    return total


def head_flops(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab"]


def decode_attn_flops(m: dict, keys: int) -> int:
    """One decode row over ``keys`` latents, every layer (absorbed)."""
    return 2 * m["n_heads"] * (latent(m) + m["mla"]["kv_lora"]) * keys \
        * attn_layers(m)


def prefill_attn_flops(m: dict, keys: int) -> int:
    """``keys`` query-key pairs of a prefill, every layer (expanded)."""
    a = m["mla"]
    return 2 * m["n_heads"] * (a["qk_nope"] + a["qk_rope"] + a["v_head"]) \
        * keys * attn_layers(m)


def decode_flops(m: dict, contexts) -> int:
    """A decode step over rows whose new token sees ``contexts`` keys."""
    base = 2 * token_params(m) + head_flops(m)
    return sum(base + decode_attn_flops(m, int(c)) for c in contexts)


def prefill_flops(m: dict, tokens: int, prefix: int) -> int:
    """A prefill of ``tokens`` real tokens after ``prefix`` cached ones
    (causal: token i sees prefix + i + 1 keys); logits for the last."""
    keys = tokens * prefix + tokens * (tokens + 1) // 2
    return 2 * token_params(m) * tokens + prefill_attn_flops(m, keys) \
        + head_flops(m)


def mla_bytes(m: dict, kv_tokens: int, rows: int, max_blocks: int) -> int:
    """One MLA decode call (one layer): the latents of ``kv_tokens`` valid
    tokens of the distinct pool blocks the rows read (bf16; a block several
    rows share is one input, read once), and for all ``rows`` the query
    (q_eff and q_rope, float32), the output (o_lat, float32), the heat
    (float32), the block table and the length (int32)."""
    H, L = m["n_heads"], m["mla"]["kv_lora"]
    return int(kv_tokens) * latent(m) * BF16 + rows * (
        H * latent(m) * F32 + H * L * F32 + max_blocks * (F32 + I32) + I32)


def flash_cost(m: dict, q_rows: int, keys: int, offset: int) -> tuple:
    """(flops, bytes) of one expanded-MLA flash call (one layer):
    ``q_rows`` queries at positions offset.. over ``keys`` keys, causal;
    query/key heads of qk_nope + qk_rope, value heads of v_head."""
    H, a = m["n_heads"], m["mla"]
    qk, v = a["qk_nope"] + a["qk_rope"], a["v_head"]
    seen = sum(min(offset + i + 1, keys) for i in range(q_rows))
    flops = 2 * H * (qk + v) * seen
    byts = (q_rows * H * (qk + v) + keys * H * (qk + v)) * BF16
    return flops, byts
