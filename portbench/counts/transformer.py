"""Operations and bytes of a decoder of attention layers with dense or
mixture-of-experts feed-forward blocks (DeepSeek-LLM, DeepSeekMoE and
their kin), from the configuration's ``model`` block.

Model flops count useful work only: 2 x the matmul parameters a token
uses (its attention projections, its MLP, or its router, its top-k routed
experts and the shared experts), 4 x heads x head size x the keys each
query sees for attention, and the output head for each row whose logits
are made.  Padding rows and an expert's unused capacity are not work.

A kernel's bound counts each input byte read once and each output byte
written once, whatever the kernel reads again; attention's operations are
those of the queries and keys it is given, with causal masking and a
prefix offset counted as the inputs need.
"""

from __future__ import annotations

BF16 = 2
F32 = 4
I32 = 4


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def attn_layers(m: dict) -> int:
    return m["n_layers"]


def moe_layer(m: dict, i: int) -> bool:
    moe = m.get("moe")
    if not moe:
        return False
    return i >= moe["first_dense"] and (i - moe["first_dense"]) % moe["every"] == 0


def token_params(m: dict) -> int:
    """Matmul parameters one token uses, every layer, the head excluded."""
    d, H, KVH, hd = m["d_model"], m["n_heads"], m["kv_heads"], head_dim(m)
    attn = d * H * hd * 2 + d * KVH * hd * 2
    total = 0
    for i in range(m["n_layers"]):
        if moe_layer(m, i):
            e = m["moe"]
            f = e["d_ff_expert"]
            total += attn + d * e["num_experts"] \
                + 3 * d * f * (e["top_k"] + e["num_shared"])
        else:
            total += attn + 3 * d * m["d_ff"]
    return total


def head_flops(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab"]


def attn_flops(m: dict, keys: int) -> int:
    """One query row over ``keys`` keys, every layer (QK and PV)."""
    return 4 * m["n_heads"] * head_dim(m) * keys * attn_layers(m)


def decode_flops(m: dict, contexts) -> int:
    """A decode step over rows whose new token sees ``contexts`` keys."""
    base = 2 * token_params(m) + head_flops(m)
    return sum(base + attn_flops(m, int(c)) for c in contexts)


def prefill_flops(m: dict, tokens: int, prefix: int) -> int:
    """A prefill of ``tokens`` real tokens after ``prefix`` cached ones
    (causal: token i sees prefix + i + 1 keys); logits for the last."""
    keys = tokens * prefix + tokens * (tokens + 1) // 2
    return 2 * token_params(m) * tokens + attn_flops(m, 1) * keys \
        + head_flops(m)


def paged_bytes(m: dict, kv_tokens: int, rows: int, max_blocks: int) -> int:
    """One paged-decode call (one layer): K and V of ``kv_tokens`` valid
    tokens (of the distinct pool blocks the rows read: a block several rows
    share is one input, read once), and for all ``rows`` the query and
    output (bf16), the heat (float32) and the block table (int32)."""
    H, KVH, hd = m["n_heads"], m["kv_heads"], head_dim(m)
    kv = int(kv_tokens) * KVH * hd * 2 * BF16
    return kv + rows * (2 * H * hd * BF16 + max_blocks * (F32 + I32))


def flash_cost(m: dict, q_rows: int, keys: int, offset: int) -> tuple:
    """(flops, bytes) of one flash call (one layer): ``q_rows`` queries at
    positions offset.. over ``keys`` keys, causal."""
    H, KVH, hd = m["n_heads"], m["kv_heads"], head_dim(m)
    seen = sum(min(offset + i + 1, keys) for i in range(q_rows))
    flops = 4 * H * hd * seen
    byts = (2 * q_rows * H * hd + 2 * keys * KVH * hd) * BF16
    return flops, byts
