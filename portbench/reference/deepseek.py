"""Plain float32 reference of DeepSeek-LLM 7B (arXiv:2401.02954) and
DeepSeekMoE 16B (arXiv:2401.06066): a pre-norm decoder of RMSNorm (eps
1e-6), multi-head attention with rotary embeddings (theta 10,000, the two
halves of each head rotated as pairs), a SwiGLU MLP, and in DeepSeekMoE's
layers past the first a router over the routed experts (softmax, top-k)
plus always-on shared experts; a final RMSNorm and the output head.

One departure from the published DeepSeekMoE is kept, because the program
serves it so: the top-k gate weights are divided by their sum (the
published config has ``norm_topk_prob: false``).  The configuration file
lists it.

Everything is computed in float32 from the benchmark's bf16 weights, with
TF32 off, one layer at a time over all the sequences (each layer's weights
are made float32 only while that layer runs), so a 16B model fits beside
what is left on the card.  ``quant`` replaces each weight of a product
(attention, MLP, router, experts) by its value after a round trip through
a lower precision: the control (:func:`fp8_weights`).

Weights come as the serving engine takes them: ``embed`` [V, d],
``lm_head`` [d, V], ``final_norm.scale``, and ``blocks``: plain layers
``p<i>`` and repeated segments ``s<i>`` (a list of repetitions, each
``{"m<j>": layer}``), in segment order; a layer has ``ln1``, ``attn``
(``wq``, ``wk``, ``wv`` [d, heads * hd], ``wo``), ``ln2`` and ``mlp``
(``w_in``, ``w_gate`` [d, f], ``w_out`` [f, d]) or ``moe`` (``router``
[d, E], ``w_in``, ``w_gate`` [E, d, f], ``w_out`` [E, f, d],
``shared_in``, ``shared_gate`` [d, S * f], ``shared_out``).  Products are
``x @ w``.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32
EPS = 1e-6


def layers(params: dict) -> list[dict]:
    """The layers of ``params["blocks"]`` in order."""
    out = []
    blocks = params["blocks"]
    for key in sorted(blocks, key=lambda k: int(k[1:])):
        seg = blocks[key]
        if key.startswith("p"):
            out.append(seg)
        else:
            for rep in seg:
                out.extend(rep[f"m{j}"] for j in range(len(rep)))
    return out


def fp8_weights(w: torch.Tensor) -> torch.Tensor:
    """``w`` (float32, ``x @ w`` layout) after float8 e4m3 with one scale
    per output column (per expert and column for stacked experts)."""
    amax = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (w / scale).to(torch.float8_e4m3fn).to(F32) * scale


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) \
        * scale.to(F32)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, hd] at positions 0..T-1."""
    T, hd = x.shape[0], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                        device=x.device) / hd))
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().to(F32)[:, None], ang.sin().to(F32)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h: torch.Tensor, p: dict, cfg: dict, w) -> torch.Tensor:
    """Causal self-attention of one sequence h [T, d]."""
    T = h.shape[0]
    H, KVH, hd = cfg["n_heads"], cfg["kv_heads"], cfg["head_dim"]
    q = rope((h @ w(p["wq"])).view(T, H, hd), cfg["rope_theta"])
    k = rope((h @ w(p["wk"])).view(T, KVH, hd), cfg["rope_theta"])
    v = (h @ w(p["wv"])).view(T, KVH, hd)
    if KVH != H:
        k = k.repeat_interleave(H // KVH, dim=1)
        v = v.repeat_interleave(H // KVH, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool, device=h.device)
                      .triu(1), float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
    return o.reshape(T, H * hd) @ w(p["wo"])


def swiglu(h, w_in, w_gate, w_out):
    g = h @ w_gate
    return (g * torch.sigmoid(g) * (h @ w_in)) @ w_out


def moe(h: torch.Tensor, p: dict, cfg: dict, w) -> torch.Tensor:
    """Routed experts (softmax over E, top-k, gates divided by their sum)
    plus the shared experts, for the rows of h [N, d]."""
    K = cfg["top_k"]
    probs = torch.softmax(h @ w(p["router"]), dim=-1)
    gate, idx = probs.topk(K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    out = swiglu(h, w(p["shared_in"]), w(p["shared_gate"]),
                 w(p["shared_out"]))
    for e in torch.unique(idx).tolist():
        rows, slot = (idx == e).nonzero(as_tuple=True)
        y = swiglu(h[rows], w(p["w_in"][e]), w(p["w_gate"][e]),
                   w(p["w_out"][e]))
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


def _logits_at(params, cfg, seqs, starts, quant):
    dev = params["embed"].device
    cfg = dict(cfg, head_dim=cfg.get("head_dim") or
               cfg["d_model"] // cfg["n_heads"],
               rope_theta=cfg["attn"]["rope_theta"],
               top_k=(cfg.get("moe") or {}).get("top_k"))

    def w(t):
        return t if quant is None else quant(t)

    def wide(node):
        """The layer's weights in float32 (norm scales included)."""
        if isinstance(node, dict):
            return {k: wide(v) for k, v in node.items()}
        return node.to(F32)

    xs = [params["embed"][torch.as_tensor(s, device=dev)].to(F32)
          for s in seqs]
    for raw in layers(params):
        layer = wide(raw)
        for i, x in enumerate(xs):
            x = x + attention(rms_norm(x, layer["ln1"]["scale"]),
                              layer["attn"], cfg, w)
            h = rms_norm(x, layer["ln2"]["scale"])
            if "moe" in layer:
                x = x + moe(h, layer["moe"], cfg, w)
            else:
                m = layer["mlp"]
                x = x + swiglu(h, w(m["w_in"]), w(m["w_gate"]),
                               w(m["w_out"]))
            xs[i] = x
        del layer
    head = params["lm_head"].to(F32)
    V = cfg["vocab"]
    return [(rms_norm(x[s:], params["final_norm"]["scale"]) @ head)[:, :V]
            for x, s in zip(xs, starts)]
