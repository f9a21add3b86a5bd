"""Mamba-2 (SSD, state-space duality) layer: the chunked scan of a prefill
and the O(1)-state decode step.

The PyTorch counterpart of ``repro.models.mamba2``, in the reference's
arithmetic and with its quirks, which are part of the result:

  * :func:`ssd_chunked` needs the sequence length to divide by the chunk
    (``mamba_apply`` uses ``min(cfg.chunk, S)``: a prompt padded to a block
    multiple must pad to at most one chunk or to a multiple of it);
  * the state a prefill hands to decode has run over the prompt's pad
    tokens (the engine right-pads prompts to a block multiple);
  * the ``ssm`` state is stored in the cache's dtype (bf16 in the engine),
    rounded at every step;
  * a decode step advances the state of every slot, active or not (an
    admission overwrites its slot's state).

The reference computes all of it in jnp (no TPU kernel); torch ops are its
port.  Decode carries a [H, N, P] state per sequence, so the paged KV
cache has nothing to page for these layers.
"""

from __future__ import annotations

import torch

from ..configs.base import MambaCfg
from .common import F32, ParamSpec, einsum, matmul, rms_norm, silu


def mamba_spec(d_model: int, cfg: MambaCfg) -> dict:
    di = cfg.expand * d_model
    H = di // cfg.head_dim
    N = cfg.d_state
    conv_ch = di + 2 * N
    return {
        # in_proj emits [z (di), x (di), B (N), C (N), dt (H)]
        "in_proj": ParamSpec((d_model, 2 * di + 2 * N + H), ("embed", "ff")),
        "conv_w": ParamSpec((cfg.conv_dim, conv_ch), (None, "ff"),
                            init="normal", scale=0.5),
        "conv_b": ParamSpec((conv_ch,), ("ff",), init="zeros"),
        "A_log": ParamSpec((H,), ("q_heads",), init="zeros"),
        "D": ParamSpec((H,), ("q_heads",), init="ones"),
        "dt_bias": ParamSpec((H,), ("q_heads",), init="zeros"),
        "norm": ParamSpec((di,), ("ff",), init="ones"),
        "out_proj": ParamSpec((di, d_model), ("ff", "embed")),
    }


def _split_proj(z_x_b_c_dt: torch.Tensor, di: int, N: int, H: int):
    z = z_x_b_c_dt[..., :di]
    x = z_x_b_c_dt[..., di:2 * di]
    B = z_x_b_c_dt[..., 2 * di:2 * di + N]
    C = z_x_b_c_dt[..., 2 * di + N:2 * di + 2 * N]
    dt = z_x_b_c_dt[..., 2 * di + 2 * N:]
    return z, x, B, C, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: ``logaddexp(x, 0)`` (no linear threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. u: [B,S,C]; w: [K,C]."""
    K = w.shape[0]
    S = u.shape[1]
    pad = torch.nn.functional.pad(u, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return silu(out + b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """SSD scan. x: [B,S,H,P]; dt: [B,S,H] (post-softplus); A: [H]
    (negative); Bm, Cm: [B,S,N].  Returns (y [B,S,H,P], final state
    [B,H,N,P]): within a chunk the quadratic attention-like form, across
    chunks the linear state recurrence, one chunk at a time."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    assert nc * chunk == S, "seq len must be divisible by ssd chunk"
    dA = dt * A                                   # [B,S,H] negative decays
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    h = torch.zeros((Bsz, H, N, P), dtype=x.dtype, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xg, dtg, dAg, Bg, Cg = x[:, sl], dt[:, sl], dA[:, sl], Bm[:, sl], \
            Cm[:, sl]
        seg = torch.cumsum(dAg, dim=1)                          # [B,c,H]
        rel = seg[:, :, None, :] - seg[:, None, :, :]           # [B,c,c,H]
        L = torch.where(tri[None, :, :, None], torch.exp(rel),
                        torch.zeros((), dtype=rel.dtype, device=x.device))
        scores = torch.einsum("bin,bjn->bij", Cg, Bg)           # [B,c,c]
        M = scores[..., None] * L * dtg[:, None, :, :]          # [B,c,c,H]
        y_intra = torch.einsum("bijh,bjhp->bihp", M, xg)
        y_inter = torch.einsum("bin,bih,bhnp->bihp", Cg, torch.exp(seg), h)
        decay_to_end = torch.exp(seg[:, -1:, :] - seg)          # [B,c,H]
        S_chunk = torch.einsum("bjn,bjh,bjhp->bhnp", Bg, dtg * decay_to_end,
                               xg)
        h = h * torch.exp(seg[:, -1, :])[..., None, None] + S_chunk
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def mamba_apply(params, x: torch.Tensor, cfg: MambaCfg,
                return_state: bool = False):
    """Full-sequence (prefill) path. x: [B,S,d] -> [B,S,d] (and, with
    ``return_state``, the decode state ``{"ssm", "conv"}`` in x.dtype)."""
    Bsz, S, d = x.shape
    di = cfg.expand * d
    H = di // cfg.head_dim
    N = cfg.d_state
    proj = matmul(x, params["in_proj"])
    z, u, Bm, Cm, dt = _split_proj(proj, di, N, H)
    ubc_raw = torch.cat([u, Bm, Cm], dim=-1)
    ubc = _causal_conv(ubc_raw, params["conv_w"].to(x.dtype),
                       params["conv_b"].to(x.dtype))
    u, Bm, Cm = ubc[..., :di], ubc[..., di:di + N], ubc[..., di + N:]
    dt = _softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    uh = u.reshape(Bsz, S, H, cfg.head_dim)
    y, h_last = ssd_chunked(uh.float(), dt, A, Bm.float(), Cm.float(),
                            min(cfg.chunk, S))
    y = y + uh.float() * params["D"].float()[None, None, :, None]
    y = y.reshape(Bsz, S, di).to(x.dtype)
    y = y * silu(z)
    y = rms_norm(y, params["norm"])
    out = matmul(y, params["out_proj"])
    if not return_state:
        return out
    K = cfg.conv_dim
    conv_state = (ubc_raw[:, -(K - 1):, :] if S >= K - 1 else
                  torch.nn.functional.pad(ubc_raw, (0, 0, K - 1 - S, 0)))
    return out, {"ssm": h_last.to(x.dtype), "conv": conv_state}


def mamba_decode_step(params, x: torch.Tensor, state: dict, cfg: MambaCfg):
    """Single-token decode. x: [B,d]; state = {"ssm": [B,H,N,P], "conv":
    [B,K-1,conv_ch]}.  Returns ([B,d], new state in the state's dtype)."""
    Bsz, d = x.shape
    di = cfg.expand * d
    H = di // cfg.head_dim
    N = cfg.d_state
    proj = matmul(x, params["in_proj"])
    z, u, Bm, Cm, dt = _split_proj(proj, di, N, H)
    ubc = torch.cat([u, Bm, Cm], dim=-1)                       # [B, conv_ch]
    conv_hist = torch.cat([state["conv"].to(x.dtype), ubc[:, None, :]],
                          dim=1)                               # [B,K,ch]
    w = params["conv_w"].to(x.dtype)
    conv_out = silu(einsum("bkc,kc->bc", conv_hist, w)
                    + params["conv_b"].to(x.dtype))
    u, Bm, Cm = conv_out[..., :di], conv_out[..., di:di + N], \
        conv_out[..., di + N:]
    dt = _softplus(dt.float() + params["dt_bias"].float())     # [B,H]
    A = -torch.exp(params["A_log"].float())
    g = torch.exp(dt * A)                                      # [B,H]
    uh = u.reshape(Bsz, H, cfg.head_dim).float()
    dBx = torch.einsum("bh,bn,bhp->bhnp", dt, Bm.float(), uh)
    h = state["ssm"].float() * g[..., None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), h)
    y = y + uh * params["D"].float()[None, :, None]
    y = y.reshape(Bsz, di).to(x.dtype) * silu(z)
    y = rms_norm(y, params["norm"])
    out = matmul(y, params["out_proj"])
    return out, {"ssm": h.to(state["ssm"].dtype),
                 "conv": conv_hist[:, 1:, :].to(state["conv"].dtype)}


def mamba_state_init(batch: int, d_model: int, cfg: MambaCfg, dtype=F32, *,
                     device) -> dict:
    di = cfg.expand * d_model
    H = di // cfg.head_dim
    return {
        "ssm": torch.zeros((batch, H, cfg.d_state, cfg.head_dim),
                           dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_dim - 1, di + 2 * cfg.d_state),
                            dtype=dtype, device=device),
    }
