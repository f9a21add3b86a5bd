"""Plain float32 reference of DeepSeek-V2-Lite (arXiv:2405.04434): a
pre-norm decoder of RMSNorm (eps 1e-6), multi-head latent attention (MLA)
and, past the first (dense SwiGLU) layer, a mixture of experts; a final
RMSNorm and the output head.

MLA, expanded to per-head keys and values with a full causal softmax: q =
h Wq split into 128 "nope" and 64 rope channels per head (no query
low-rank); the latent [c | k_rope] = h W_dkv, c RMS-normed (512 wide);
keys are [c W_uk[h] | k_rope] (k_rope shared by the 16 heads), values c
W_uv[h]; the scores are scaled by 192^-1/2 times YaRN's m^2.  YaRN
(``rope_scaling``: factor 40 over 4,096 original positions, beta_fast 32,
beta_slow 1, mscale 0.707, mscale_all_dim 0.707) as the published
``DeepseekV2YarnRotaryEmbedding`` computes it, in float32: each inverse
frequency blends its original and its interpolated (divided by the
factor) value by the linear ramp between the correction dimensions of
beta_fast and beta_slow, the angles are the float32 positions times those
frequencies, cos and sin are multiplied by mscale(factor, mscale) /
mscale(factor, mscale_all_dim) (1 here), and m = 0.1 mscale_all_dim
ln(factor) + 1.  The expert layer: a softmax over the 64 routed experts,
the top 6 taken with their probabilities as they are (``norm_topk_prob``
false, ``routed_scaling_factor`` 1), plus the 2 shared experts (one
SwiGLU of twice the width).

One departure from the published model is kept, because the weights are
drawn from a seed and not read from its checkpoint: each head's rope
channels are rotated as two halves (x1, x2) -> (x1 cos - x2 sin, x1 sin +
x2 cos).  The checkpoint stores them interleaved and its code
de-interleaves them before rotating by halves, which with seeded weights
is a fixed permutation of the rope columns of Wq and W_dkv.

Everything is computed in float32 from the benchmark's bf16 weights, with
TF32 off, one layer at a time over all the sequences (each layer's weights
made float32 only while it runs), the queries in chunks, so the 16B model
and an 8,700-token sequence's scores fit beside what is left on the card.
``quant`` replaces each weight of a product (attention, MLP, router,
experts) by its value after a round trip through a lower precision: the
control (:func:`fp8_weights`, DeepSeek-LLM's reference's).

Weights come as the serving engine takes them: ``embed`` [V, d],
``lm_head`` [d, V], ``final_norm.scale``, and ``blocks`` (plain layers
``p<i>`` and repeated segments ``s<i>``); a layer has ``ln1``, ``attn``
(``wq`` [d, H * 192], ``w_dkv`` [d, 576], ``kv_norm`` [512], ``w_uk``
[H, 512, 128], ``w_uv`` [H, 512, 128], ``wo`` [H * 128, d]), ``ln2`` and
``mlp`` or ``moe`` (``router`` [d, E], ``w_in``, ``w_gate`` [E, d, f],
``w_out`` [E, f, d], ``shared_in``, ``shared_gate`` [d, S * f],
``shared_out``).  Products are ``x @ w``.
"""

from __future__ import annotations

import math

import torch

from .deepseek import F32, fp8_weights, layers, rms_norm, swiglu

QUERY_CHUNK = 2048

__all__ = ["fp8_weights", "layers", "logits_at", "moe", "softmax_scale",
           "yarn_inv_freq"]


def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, attn: dict, device=None) -> torch.Tensor:
    """The rope channels' inverse frequencies [dim / 2] float32, YaRN's
    when ``attn`` (the model block's ``attn``) scales the rope."""
    base = float(attn["rope_theta"])
    exps = torch.arange(0, dim, 2, dtype=F32, device=device) / dim
    extra = 1.0 / (base ** exps)
    factor = float(attn.get("yarn_factor", 1.0))
    if factor == 1.0:
        return extra
    orig = attn["yarn_original_max_pos"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) \
            / (2 * math.log(base))
    low = max(math.floor(corr(attn["yarn_beta_fast"])), 0)
    high = min(math.ceil(corr(attn["yarn_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=F32, device=device) - low)
            / (high - low)).clamp(0, 1)
    inter = 1.0 / (factor * base ** exps)
    return inter * ramp + extra * (1 - ramp)


def softmax_scale(m: dict) -> float:
    """(qk_nope + qk_rope)^-1/2, times YaRN's m^2."""
    mla, attn = m["mla"], m["attn"]
    scale = (mla["qk_nope"] + mla["qk_rope"]) ** -0.5
    factor = float(attn.get("yarn_factor", 1.0))
    if factor != 1.0 and attn.get("yarn_mscale_all_dim"):
        mm = _mscale(factor, attn["yarn_mscale_all_dim"])
        scale *= mm * mm
    return scale


def rope(x: torch.Tensor, inv_freq: torch.Tensor, ratio: float):
    """x [T, heads, dim] at positions 0..T-1, the two halves rotated."""
    T, dim = x.shape[0], x.shape[-1]
    ang = torch.outer(torch.arange(T, dtype=F32, device=x.device), inv_freq)
    cos = (ang.cos() * ratio)[:, None]
    sin = (ang.sin() * ratio)[:, None]
    x1, x2 = x[..., :dim // 2], x[..., dim // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h: torch.Tensor, p: dict, m: dict, w, inv_freq,
              ratio: float) -> torch.Tensor:
    """MLA's causal self-attention of one sequence h [T, d], expanded."""
    T = h.shape[0]
    H = m["n_heads"]
    mla = m["mla"]
    L, dn, dr, dv = mla["kv_lora"], mla["qk_nope"], mla["qk_rope"], \
        mla["v_head"]
    q = (h @ w(p["wq"])).view(T, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], inv_freq, ratio)], -1)
    dkv = h @ w(p["w_dkv"])
    c = rms_norm(dkv[:, :L], p["kv_norm"])
    k_rope = rope(dkv[:, None, L:], inv_freq, ratio)          # [T, 1, dr]
    k = torch.cat([torch.einsum("tl,hld->thd", c, w(p["w_uk"])),
                   k_rope.expand(T, H, dr)], -1)
    v = torch.einsum("tl,hld->thd", c, w(p["w_uv"]))
    scale = softmax_scale(m)
    out = torch.empty((T, H, dv), dtype=F32, device=h.device)
    keys = torch.arange(T, device=h.device)
    for q0 in range(0, T, QUERY_CHUNK):
        q1 = min(T, q0 + QUERY_CHUNK)
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) * scale
        s = s.masked_fill(keys[None, :q1] > keys[q0:q1, None],
                          float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                  v[:q1])
    return out.reshape(T, H * dv) @ w(p["wo"])


def moe(h: torch.Tensor, p: dict, m: dict, w) -> torch.Tensor:
    """Routed experts (a softmax over E, top-k, the gates divided by their
    sum only if the model says so) plus the shared experts, for h [N, d]."""
    e = m["moe"]
    probs = torch.softmax(h @ w(p["router"]), dim=-1)
    gate, idx = probs.topk(e["top_k"], dim=-1)
    if e.get("norm_topk_prob", True):
        gate = gate / gate.sum(-1, keepdim=True)
    out = swiglu(h, w(p["shared_in"]), w(p["shared_gate"]),
                 w(p["shared_out"]))
    for x in torch.unique(idx).tolist():
        rows, slot = (idx == x).nonzero(as_tuple=True)
        y = swiglu(h[rows], w(p["w_in"][x]), w(p["w_gate"][x]),
                   w(p["w_out"][x]))
        out.index_add_(0, rows, y * gate[rows, slot][:, None])
    return out


def logits_at(params: dict, cfg: dict, seqs: list, starts: list, *,
              quant=None) -> list[torch.Tensor]:
    """For each token list ``seqs[i]``, the float32 logits [n_i, vocab] at
    positions ``starts[i]`` .. end (the logits that predict the token after
    each).  ``cfg``: the configuration's ``model`` block."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(params, cfg, seqs, starts, quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _logits_at(params, m, seqs, starts, quant):
    dev = params["embed"].device
    attn = m["attn"]
    inv_freq = yarn_inv_freq(m["mla"]["qk_rope"], attn, dev)
    factor = float(attn.get("yarn_factor", 1.0))
    ratio = (_mscale(factor, attn.get("yarn_mscale", 1.0))
             / _mscale(factor, attn.get("yarn_mscale_all_dim", 0.0))
             if factor != 1.0 else 1.0)

    def w(t):
        return t if quant is None else quant(t)

    def wide(node):
        if isinstance(node, dict):
            return {k: wide(v) for k, v in node.items()}
        return node.to(F32)

    xs = [params["embed"][torch.as_tensor(s, device=dev)].to(F32)
          for s in seqs]
    for raw in layers(params):
        layer = wide(raw)
        for i, x in enumerate(xs):
            x = x + attention(rms_norm(x, layer["ln1"]["scale"]),
                              layer["attn"], m, w, inv_freq, ratio)
            h = rms_norm(x, layer["ln2"]["scale"])
            if "moe" in layer:
                x = x + moe(h, layer["moe"], m, w)
            else:
                p = layer["mlp"]
                x = x + swiglu(h, w(p["w_in"]), w(p["w_gate"]),
                               w(p["w_out"]))
            xs[i] = x
        del layer
    head = params["lm_head"].to(F32)
    V = m["vocab"]
    return [(rms_norm(x[s:], params["final_norm"]["scale"]) @ head)[:, :V]
            for x, s in zip(xs, starts)]
