"""Mixture-of-Experts FFN: fine-grained routed experts + shared experts
(DeepSeekMoE-style), with sort-based capacity dispatch — ``repro.models.moe``
forward: the single-device path (``_moe_apply_local``) and the
expert-parallel one (:func:`moe_apply_ep`), which :func:`moe_apply` takes
under the reference's condition when a decode mesh is installed.

Tokens are sorted by assigned expert, each expert processes a
static-capacity slab, and overflow tokens are dropped (their gate mass is
lost, standard capacity-factor semantics).  The expert products are batched
matmuls over the stacked ``[E, ...]`` expert weights, in groups of experts
where one ``[E, C, d_ff]`` intermediate would pass ``FFN_GROUP_BYTES`` (a
long dropless prefill: C then is the prompt's length, and each group's
intermediates are freed before the next group's are made; every expert's
products are the same).  A group holds a power of two of experts, so that
prefills of similar lengths split alike and a shorter one's intermediates
fit the blocks a longer one freed in a shared graph pool.  The combine
reads the expert rows through the dispatch's destinations with a dropped
entry's gate zeroed, so it makes no padded copy of them.

Two details carry the reference's results bit for bit:

  * top-k ties break on the lower expert index (``jax.lax.top_k``): a
    stable descending sort;
  * the combine adds each token's routed contributions in bf16, one rounding
    per add, in the order of the expert-sorted list (the reference's
    ``out.at[stok].add``, which XLA's CPU backend applies update by update).
    Each token's entries sit in that list in increasing expert order, so
    the port adds its K contributions in that order, as K ordered adds over
    all tokens at once: deterministic on every device, with no atomics.

The router divides the top-k gates by their sum, as the reference's does,
unless the config says otherwise (``MoECfg.norm_topk_prob=False``:
DeepSeek-V2's published router, whose gates are the softmax's
probabilities as they are).

Counters, for the operator and the tests: ``moe_apply.routed_rows`` (the
(token, expert) pairs routed) and ``moe_apply.computed_rows`` (the expert
rows the capacity-padded products compute, padding included) grow by
each single-device call's static counts, so a captured entry adds them
at each replay; :func:`dropped_rows` is a device counter of the routed
rows that overflowed an expert's capacity, read only when asked.

The expert-parallel path shares the routing, the dispatch into a
``[E * C, d]`` buffer and that combine; between them the buffer crosses
the "model" axis twice (``all_to_all_single`` on its contiguous ``[M,
E_loc * C, d]`` view) and each rank runs its ``E_loc = E / M`` experts.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import MoECfg
from ..distributed import spmd
from ..distributed.collectives import (all_to_all, axis_index, axis_sizes,
                                       grad_scale, reduce_sum)
from ..distributed.flashdecode import get_decode_mesh
from ..distributed.spmd import is_dtensor
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
    if x.dtype == BF16 and x.is_cpu:
        return torch.bmm(x.float(), w.float()).to(BF16)
    return torch.bmm(x, w)


def _glu(g: torch.Tensor, h: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    if mlp_kind == "swiglu":
        return silu(g) * h
    return gelu_tanh(g) * h


# the most bytes one [experts, C, d_ff] intermediate of the expert
# products may take before they run in groups of experts
FFN_GROUP_BYTES = 1 << 29


def _expert_group(params, x_ec: torch.Tensor, mlp_kind: str,
                  e: slice) -> torch.Tensor:
    h = _bmm(x_ec, params["w_in"][e])
    if mlp_kind in ("swiglu", "geglu"):
        h = _glu(_bmm(x_ec, params["w_gate"][e]), h, mlp_kind)
    else:
        h = activate(h, mlp_kind)
    return _bmm(h, params["w_out"][e])


def _expert_ffn(params, x_ec: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    """x_ec: [E, C, d] -> [E, C, d] through per-expert FFNs, in groups of
    ``n`` experts (a power of two) whose ``[n, C, d_ff]`` intermediates
    stay within ``FFN_GROUP_BYTES`` (shapes only: no host sync)."""
    E, C, _ = x_ec.shape
    row = C * params["w_in"].shape[-1] * x_ec.element_size()
    n = 1 << max(0, (FFN_GROUP_BYTES // max(1, row)).bit_length() - 1)
    if n >= E:
        return _expert_group(params, x_ec, mlp_kind, slice(None))
    out = torch.empty_like(x_ec)
    for e0 in range(0, E, n):
        e = slice(e0, min(E, e0 + n))
        out[e] = _expert_group(params, x_ec[e], mlp_kind, e)
    return out


def _shared_ffn(params, x: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    h = matmul(x, params["shared_in"])
    if mlp_kind in ("swiglu", "geglu"):
        h = _glu(matmul(x, params["shared_gate"]), h, mlp_kind)
    else:
        h = activate(h, mlp_kind)
    return matmul(h, params["shared_out"])


def _data_size(mesh) -> int:
    """The product of the mesh's axes other than "model"."""
    return math.prod(v for n, v in axis_sizes(mesh).items() if n != "model")


def ep_applies(mesh, num_experts: int, tokens: int) -> bool:
    """The reference's choice of the expert-parallel path
    (``moe_apply``): a mesh with a "model" axis of size M > 1 dividing the
    experts, and the ``tokens`` (global) dividing over the data axes."""
    if mesh is None or "model" not in axis_sizes(mesh):
        return False
    M = axis_sizes(mesh)["model"]
    D = _data_size(mesh)
    return (num_experts % M == 0 and tokens % D == 0 and tokens // D >= 1
            and M > 1)


def moe_apply(params, x: torch.Tensor, cfg: MoECfg, mlp_kind: str, *,
              capacity: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [T, d] -> ([T, d] in x's dtype, aux_loss float32 scalar).

    With a decode mesh installed (:func:`repro_torch.distributed.
    set_decode_mesh`) and :func:`ep_applies`, ``x`` is this rank's data
    shard of the tokens and the dispatch goes through :func:`moe_apply_ep`;
    otherwise the single-device sort-based path runs.

    ``capacity`` (slots per expert) defaults to the reference's
    ``max(8, int(T * K / E * capacity_factor) + 1)``: a prefill's padded
    rows count toward T.  DTensor tokens (a sharded program) go through
    :func:`repro_torch.distributed.spmd.moe_apply`."""
    if is_dtensor(x):
        return spmd.moe_apply(params, x, cfg, mlp_kind, capacity=capacity)
    mesh = get_decode_mesh()
    if mesh is not None and ep_applies(mesh, cfg.num_experts,
                                       x.shape[0] * _data_size(mesh)):
        return moe_apply_ep(params, x, cfg, mlp_kind, mesh,
                            capacity=capacity)
    return _moe_apply_local(params, x, cfg, mlp_kind, capacity=capacity)


def _route(x, router, cfg: MoECfg):
    """(gate_vals [T, K], expert_idx [T, K], aux): top-k of the softmax by
    a stable descending sort (ties on the lower expert); the gates divided
    by their sum unless ``cfg.norm_topk_prob`` is off."""
    T = x.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    logits = x.float() @ router.float()                           # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :K], expert_idx[:, :K]    # [T, K]
    if cfg.norm_topk_prob:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(
            1e-9)
    # ---- load-balancing aux loss (GShard/DeepSeek form) ----
    # counts of whole numbers add exactly in any order (no host sync, as
    # torch.bincount would need for its output size)
    me = probs.mean(dim=0)
    flat = expert_idx.reshape(-1)
    ce = torch.zeros(E, dtype=probs.dtype, device=x.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=probs.dtype)) / (T * K)
    aux = cfg.router_aux_weight * E * (me * ce).sum()
    return gate_vals, expert_idx, aux


def _dispatch(x, expert_idx, E: int, C: int):
    """Sort-based dispatch: (buf [E * C, d] — expert e's kept tokens in
    rows [e * C, (e + 1) * C), zeros elsewhere — order, dest)."""
    T, d = x.shape
    K = expert_idx.shape[1]
    dev = x.device
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
    return buf[:-1], order, dest


def _combine(y_flat, order, dest, expert_idx, gate_vals, dtype):
    """Each token's K contributions from ``y_flat`` [E * C, d], added in
    increasing expert order (the reference's ordered scatter-add).  A
    dropped entry (destination ``E * C``) adds 0: its gate is zeroed and it
    reads a kept row, which is finite."""
    T, K = expert_idx.shape
    n, d = y_flat.shape
    dev = y_flat.device
    # slot of entry (t, k) in the sorted list; the token's entries, taken
    # in increasing expert order, are its sorted-list entries in order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=dev)
    by_expert = torch.argsort(expert_idx, dim=-1, stable=True)    # [T, K]
    slot = torch.gather(inv.reshape(T, K), 1, by_expert)           # [T, K]
    rows = dest[slot]
    gates = torch.gather(gate_vals, 1, by_expert).to(dtype)        # [T, K]
    gates = torch.where(rows < n, gates, torch.zeros_like(gates))
    rows = rows.clamp_max(n - 1)
    out = torch.zeros((T, d), dtype=dtype, device=dev)
    for k in range(K):
        out = out + y_flat[rows[:, k]] * gates[:, k:k + 1]
    return out


def _capacity(cfg: MoECfg, T: int) -> int:
    E, K = cfg.num_experts, cfg.top_k
    return max(8, int(T * K / E * cfg.capacity_factor) + 1)


_DROPPED: dict = {}


def dropped_rows(device) -> torch.Tensor:
    """The device's count (int64, on the device) of routed rows that found
    their expert full, over every single-device call since the process
    started: made once per device and kept, so a captured entry adds to
    it at each replay.  Reading it syncs."""
    key = str(device)
    c = _DROPPED.get(key)
    if c is None:
        c = _DROPPED[key] = torch.zeros((), dtype=torch.int64, device=device)
    return c


def _moe_apply_local(params, x, cfg: MoECfg, mlp_kind: str, *,
                     capacity: int | None = None):
    """Single-shard sort-based dispatch (the reference path)."""
    E, T = cfg.num_experts, x.shape[0]
    C = _capacity(cfg, T) if capacity is None else capacity
    gate_vals, expert_idx, aux = _route(x, params["router"], cfg)
    buf, order, dest = _dispatch(x, expert_idx, E, C)
    moe_apply.routed_rows += T * cfg.top_k
    moe_apply.computed_rows += E * C
    dropped_rows(x.device).add_((dest == E * C).sum())
    y_ec = _expert_ffn(params, buf.reshape(E, C, -1), mlp_kind)
    out = _combine(y_ec.reshape(E * C, -1), order, dest, expert_idx,
                   gate_vals, x.dtype)
    if cfg.num_shared > 0:
        out = out + _shared_ffn(params, x, mlp_kind)
    return out, aux


def moe_rank_params(params, m: int, M: int) -> dict:
    """Model rank ``m``'s part of a MoE layer's params on an M-way "model"
    axis: experts ``[m * E_loc, (m + 1) * E_loc)`` of ``w_in`` / ``w_gate``
    / ``w_out``, the matching column slice of ``shared_in`` /
    ``shared_gate`` and row slice of ``shared_out``; the router whole
    (the reference's in-specs of ``moe_apply_ep``)."""
    out = dict(params)
    E = params["w_in"].shape[0]
    for name in ("w_in", "w_gate", "w_out"):
        if name in params:
            out[name] = params[name][m * E // M:(m + 1) * E // M]
    for name, axis in (("shared_in", 1), ("shared_gate", 1),
                       ("shared_out", 0)):
        if name in params:
            n = params[name].shape[axis] // M
            out[name] = params[name].narrow(axis, m * n, n)
    return out


def moe_apply_ep(params, x: torch.Tensor, cfg: MoECfg, mlp_kind: str, mesh,
                 *, capacity: int | None = None):
    """Expert-parallel dispatch on this rank: tokens stay on their data
    shard; routed tokens cross the "model" axis with two all-to-alls (the
    Megatron/GShard EP pattern).

    x: this rank's data shard [T_loc, d] (the same on every rank of its
    "model" group); params: the layer's whole params or this rank's
    :func:`moe_rank_params`.  Returns (out [T_loc, d] in x's dtype, aux:
    the mean over the data axes of each shard's aux)."""
    E = cfg.num_experts
    M = axis_sizes(mesh)["model"]
    data_axes = tuple(n for n in axis_sizes(mesh) if n != "model")
    T_loc, d = x.shape
    E_loc = E // M
    if params["w_in"].shape[0] != E_loc:
        params = moe_rank_params(params, axis_index(mesh, "model"), M)
    C = _capacity(cfg, T_loc) if capacity is None else capacity

    gate_vals, expert_idx, aux = _route(x, params["router"], cfg)
    aux = reduce_sum(aux, mesh, data_axes) / _data_size(mesh)
    buf, order, dest = _dispatch(x, expert_idx, E, C)
    recv = all_to_all(buf.reshape(M, E_loc * C, d), mesh, "model")
    x_ec = recv.reshape(M, E_loc, C, d).transpose(0, 1).reshape(
        E_loc, M * C, d)
    y_ec = _expert_ffn(params, x_ec, mlp_kind)
    back = y_ec.reshape(E_loc, M, C, d).transpose(0, 1).reshape(
        M, E_loc * C, d)
    got = all_to_all(back, mesh, "model")
    out = _combine(got.reshape(E * C, d), order, dest, expert_idx, gate_vals,
                   x.dtype)
    # the M ranks of a "model" group route the same tokens: each copy's
    # gradient counts 1/M (what reaches a rank's x and router is its part
    # of a sum over "model")
    out, aux = grad_scale(out, 1.0 / M), grad_scale(aux, 1.0 / M)
    if cfg.num_shared > 0:
        part = _shared_ffn(params, x, mlp_kind).float()
        out = out + reduce_sum(part, mesh, "model").to(x.dtype)
    return out, aux


moe_apply.routed_rows = 0
moe_apply.computed_rows = 0
