"""Mixture-of-Experts FFN: fine-grained routed experts + shared experts
(DeepSeekMoE-style), with sort-based capacity dispatch — the single-device
path of ``repro.models.moe`` (``_moe_apply_local``), forward only.

Tokens are sorted by assigned expert, each expert processes a
static-capacity slab, and overflow tokens are dropped (their gate mass is
lost, standard capacity-factor semantics).  The expert products are batched
matmuls over the stacked ``[E, ...]`` expert weights.

Two details carry the reference's results bit for bit:

  * top-k ties break on the lower expert index (``jax.lax.top_k``): a
    stable descending sort;
  * the combine adds each token's routed contributions in bf16, one rounding
    per add, in the order of the expert-sorted list (the reference's
    ``out.at[stok].add``, which XLA's CPU backend applies update by update).
    Each token's entries sit in that list in increasing expert order, so
    the port adds its K contributions in that order, as K ordered adds over
    all tokens at once: deterministic on every device, with no atomics.
"""

from __future__ import annotations

import torch

from ..configs.base import MoECfg
from .common import BF16, ParamSpec, activate, gelu_tanh, matmul, silu


def moe_spec(d_model: int, cfg: MoECfg, mlp_kind: str) -> dict:
    E, fe = cfg.num_experts, cfg.d_ff_expert
    spec = {
        "router": ParamSpec((d_model, E), ("embed", None), scale=0.02),
        "w_in": ParamSpec((E, d_model, fe), ("expert", "embed", "ff")),
        "w_out": ParamSpec((E, fe, d_model), ("expert", "ff", "embed")),
    }
    if mlp_kind in ("swiglu", "geglu"):
        spec["w_gate"] = ParamSpec((E, d_model, fe), ("expert", "embed", "ff"))
    if cfg.num_shared > 0:
        fs = cfg.num_shared * fe
        spec["shared_in"] = ParamSpec((d_model, fs), ("embed", "ff"))
        spec["shared_out"] = ParamSpec((fs, d_model), ("ff", "embed"))
        if mlp_kind in ("swiglu", "geglu"):
            spec["shared_gate"] = ParamSpec((d_model, fs), ("embed", "ff"))
    return spec


def _bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched ``x @ w`` in x's dtype; on the CPU a bf16 product runs in
    float32 and rounds once, as :func:`~.common.matmul` does."""
    w = w.to(x.dtype)
    if x.dtype == BF16 and not x.is_cuda:
        return torch.bmm(x.float(), w.float()).to(BF16)
    return torch.bmm(x, w)


def _glu(g: torch.Tensor, h: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    if mlp_kind == "swiglu":
        return silu(g) * h
    return gelu_tanh(g) * h


def _expert_ffn(params, x_ec: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    """x_ec: [E, C, d] -> [E, C, d] through per-expert FFNs."""
    h = _bmm(x_ec, params["w_in"])
    if mlp_kind in ("swiglu", "geglu"):
        h = _glu(_bmm(x_ec, params["w_gate"]), h, mlp_kind)
    else:
        h = activate(h, mlp_kind)
    return _bmm(h, params["w_out"])


def _shared_ffn(params, x: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    h = matmul(x, params["shared_in"])
    if mlp_kind in ("swiglu", "geglu"):
        h = _glu(matmul(x, params["shared_gate"]), h, mlp_kind)
    else:
        h = activate(h, mlp_kind)
    return matmul(h, params["shared_out"])


def moe_apply(params, x: torch.Tensor, cfg: MoECfg, mlp_kind: str, *,
              capacity: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [T, d] -> ([T, d] in x's dtype, aux_loss float32 scalar).

    ``capacity`` (slots per expert) defaults to the reference's
    ``max(8, int(T * K / E * capacity_factor) + 1)``: a prefill's padded
    rows count toward T."""
    T, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    dev = x.device

    logits = x.float() @ params["router"].float()                 # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :K], expert_idx[:, :K]    # [T, K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- load-balancing aux loss (GShard/DeepSeek form) ----
    # counts of whole numbers add exactly in any order (no host sync, as
    # torch.bincount would need for its output size)
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=probs.dtype, device=dev).index_add_(
        0, expert_idx.reshape(-1), torch.ones_like(expert_idx.reshape(-1),
                                                   dtype=probs.dtype)) / (T * K)
    aux = cfg.router_aux_weight * E * (me * ce).sum()

    # ---- sort-based dispatch ----
    if capacity is None:
        capacity = max(8, int(T * K / E * cfg.capacity_factor) + 1)
    C = capacity
    flat_expert = expert_idx.reshape(-1)                           # [T*K]
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    stok = torch.div(order, K, rounding_mode="floor")
    # position of each entry within its expert group
    first_of_group = torch.searchsorted(se, se, side="left")
    pos_in_group = torch.arange(T * K, device=dev) - first_of_group
    keep = pos_in_group < C
    dest = torch.where(keep, se * C + pos_in_group,
                       torch.full_like(se, E * C))

    # kept entries have distinct rows; every dropped one lands on the
    # scratch row E*C, which is never read
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    buf[dest] = x[stok]
    y_ec = _expert_ffn(params, buf[:-1].reshape(E, C, d), mlp_kind)

    # ---- combine: each token's K contributions, added in expert order ----
    # slot of entry (t, k) in the sorted list; the token's entries, taken
    # in increasing expert order, are its sorted-list entries in order
    y_flat = torch.cat([y_ec.reshape(E * C, d),
                        torch.zeros((1, d), dtype=x.dtype, device=dev)])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=dev)
    by_expert = torch.argsort(expert_idx, dim=-1, stable=True)    # [T, K]
    slot = torch.gather(inv.reshape(T, K), 1, by_expert)           # [T, K]
    rows = dest[slot]                                              # drop -> 0
    gates = torch.gather(gate_vals, 1, by_expert).to(x.dtype)      # [T, K]
    out = torch.zeros((T, d), dtype=x.dtype, device=dev)
    for k in range(K):
        out = out + y_flat[rows[:, k]] * gates[:, k:k + 1]

    if cfg.num_shared > 0:
        out = out + _shared_ffn(params, x, mlp_kind)
    return out, aux
