"""Causal / windowed GQA flash attention: the forward (prefill and
training) and, for training, its backward.

The forward replaces the Pallas TPU kernel ``flash_attention_fwd``
(``repro/kernels/flash_attention/kernel.py``).  The plain version,
:func:`flash_attention_plain`, is the port of the chunked running-softmax
attention the reference prefill actually runs
(``repro/models/attention.py::flash_attention``), with the same chunking
and the same arithmetic order.

On a CUDA tensor :func:`flash_attention` launches a kernel of
``csrc/flash_attention.cu`` (or raises): bf16 inputs the tensor-core kernel
(``wgmma``, 64 query rows per warpgroup, a two-stage ``cp.async`` K/V ring)
at any head dim up to 256 (gemma-3-27b's is 168; phi-3-smoke's 12 is
zero-padded to 16 in a copy), float32 inputs the CUDA-core kernel at the
smallest instantiated head dim that holds the real one; the value head may
be narrower than the query/key head (MLA: 192 and 128).  The launcher
chooses on dtype.  On a CPU tensor it runs the plain version.

Training: when grad is enabled and an input requires grad,
:func:`flash_attention` goes through :class:`FlashAttentionFn`, whose
forward also writes each row's log-sum-exp (LSE) and whose backward is
:func:`flash_attention_bwd`: on the card the three kernels of
``csrc/flash_attention_bwd.cu`` (the JAX package has no backward kernel; it
differentiates its jnp attention), on the CPU their plain version
:func:`flash_attention_bwd_plain`.  bf16 backward calls run the
tensor-core kernels (``wgmma``; head dims zero-padded to a multiple of 8
in a copy, with the real head dim's scale), float32 ones the CUDA-core
kernels; :func:`_bwd_plan` is the launcher's choice.  Otherwise (serving,
or no grad) the forward launches as it did before, with a null LSE
pointer.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import build

NEG_INF = -1e30
F32 = torch.float32


def _chunk_mask(q_pos, k_pos, *, causal: bool, window):
    """[q, k] boolean mask; True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          q_offset: "int | torch.Tensor" = 0,
                          chunk: int = 1024, soft_cap=None,
                          return_lse: bool = False, scale=None):
    """Memory-bounded attention with a running-softmax loop over KV chunks.

    q: [B, Sq, H, D]; k: [B, Sk, KVH, D]; v: [B, Sk, KVH, Dv] with
    H % KVH == 0.  q_offset: absolute position of q[0], an int or a
    one-element integer tensor on q's device.  Returns
    [B, Sq, H, Dv] in q.dtype and, with ``return_lse``, each row's
    log-sum-exp of its scaled scores, [B, H, Sq] float32.  ``scale``: the
    softmax scale (None: 1 / sqrt(D)).
    """
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    Dv = v.shape[-1]
    if H % KVH:
        raise ValueError(f"H={H} not divisible by KVH={KVH}")
    G = H // KVH
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    dev = q.device
    nchunks = -(-Sk // chunk)
    pad = nchunks * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, Sq, KVH, G, D).float()
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, KVH, G, Sq), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, KVH, G, Sq), dtype=F32, device=dev)
    acc = torch.zeros((B, KVH, G, Sq, Dv), dtype=F32, device=dev)
    for ci in range(nchunks):
        kci = k[:, ci * chunk:(ci + 1) * chunk].float()
        vci = v[:, ci * chunk:(ci + 1) * chunk].float()
        k_pos = ci * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, kci) * scale
        if soft_cap is not None:
            s = soft_cap * torch.tanh(s / soft_cap)
        mask = _chunk_mask(q_pos, k_pos, causal=causal, window=window)
        mask &= (k_pos < Sk)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        l_corr = torch.exp(m - m_new)
        l = l * l_corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckd->bkgqd", p, vci)
        acc = acc * l_corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]                # [B,KVH,G,Sq,Dv]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, H, Sq)
    return out


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *, causal: bool = True,
                              window=None, soft_cap=None, chunk: int = 1024,
                              scale=None):
    """The backward of the attention, as its explicit formula in torch ops,
    in float32, chunked over the keys like the forward: with P = exp(scale
    * Q.K^T - LSE) (0 where masked) and D = rowsum(dO * O), dV = P^T dO,
    dS = P * (dO V^T - D) (times 1 - tanh^2 with a soft cap), dQ = scale *
    dS K and dK = scale * dS^T Q, dK and dV summed over each kv head's G
    query heads.  Shapes as :func:`flash_attention_plain`'s; lse [B, H, Sq]
    float32; ``scale`` the forward's (None: 1 / sqrt(q's head dim)).
    Returns (dq, dk, dv) in the dtypes of q, k and v."""
    D = flash_bwd_preprocess_plain(out, dout)
    return _bwd_plain(q, k, v, dout, lse, D, causal=causal, window=window,
                      soft_cap=soft_cap, chunk=chunk, scale=scale)


def flash_bwd_preprocess_plain(out, dout):
    """D = rowsum(dout * out) in float32: [B, Sq, H, Dv] -> [B, H, Sq]."""
    return (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def _bwd_plain(q, k, v, dout, lse, D, *, causal, window, soft_cap,
               chunk: int = 1024, scale=None):
    """(dq, dk, dv) from D (:func:`flash_bwd_preprocess_plain`); ``scale``
    defaults to 1 / sqrt(q's head dim)."""
    B, Sq, H, Dq = q.shape
    _, Sk, KVH, _ = k.shape
    Dv = v.shape[-1]
    G = H // KVH
    scale = 1.0 / math.sqrt(Dq) if scale is None else scale
    dev = q.device
    qg = q.reshape(B, Sq, KVH, G, Dq).float()
    dog = dout.reshape(B, Sq, KVH, G, Dv).float()
    dsum = D.reshape(B, KVH, G, Sq, 1)
    lse = lse.reshape(B, KVH, G, Sq, 1)
    q_pos = torch.arange(Sq, device=dev)
    dq = torch.zeros((B, KVH, G, Sq, Dq), dtype=F32, device=dev)
    dk, dv = [], []
    for c0 in range(0, Sk, chunk):
        kci = k[:, c0:c0 + chunk].float()
        vci = v[:, c0:c0 + chunk].float()
        k_pos = c0 + torch.arange(kci.shape[1], device=dev)
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, kci) * scale
        if soft_cap is not None:
            t = torch.tanh(s / soft_cap)
            s = soft_cap * t
        mask = _chunk_mask(q_pos, k_pos, causal=causal, window=window)
        p = torch.where(mask, torch.exp(s - lse), torch.zeros_like(s))
        dv.append(torch.einsum("bkgqc,bqkgd->bckd", p, dog))
        dp = torch.einsum("bqkgd,bckd->bkgqc", dog, vci)
        ds = p * (dp - dsum)
        if soft_cap is not None:
            ds = ds * (1 - t * t)
        dq += torch.einsum("bkgqc,bckd->bkgqd", ds, kci) * scale
        dk.append(torch.einsum("bkgqc,bqkgd->bckd", ds, qg) * scale)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dq)
    return (dq.to(q.dtype), torch.cat(dk, dim=1).to(k.dtype),
            torch.cat(dv, dim=1).to(v.dtype))


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# float32 head dims instantiated in the .cu; bf16 takes any multiple of 8 up
# to 256 (zero-padded in the kernel's loads to 64, 128, 192 or 256)
_F32_HEAD_DIMS = (16, 32, 48, 64, 96, 128, 256)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
             + [ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def _kernel_widths(hd: int, hdv: int, dtype) -> tuple[int, int]:
    """The (q/k, v) head dims a kernel instance takes for real widths
    (hd, hdv): bf16 rounds each up to a multiple of 8, float32 takes the
    smallest instance that holds both for q/k and v as it is."""
    if dtype == torch.bfloat16:
        return -(-hd // 8) * 8, -(-hdv // 8) * 8
    inst = next((w for w in _F32_HEAD_DIMS if w >= max(hd, hdv)), 0)
    return inst, hdv


def _pad_last(x, width: int):
    if x.shape[-1] == width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1])).contiguous()


def _unpad(x, width: int):
    return x if x.shape[-1] == width else x[..., :width].contiguous()


def _check_inputs(q, k, v, what: str) -> None:
    B, Sq, H, hd = q.shape
    Bk, Sk, KVH, hdk = k.shape
    if (Bk != B or hdk != hd or v.shape[:3] != k.shape[:3] or H % KVH
            or q.dtype not in _DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError(
            f"{what}: unsupported q{tuple(q.shape)} {q.dtype} "
            f"k{tuple(k.shape)} {k.dtype} v{tuple(v.shape)} {v.dtype}")


def _contiguous_on(dev, tensors, what: str) -> None:
    if not all(t.is_cuda and t.device == dev and t.is_contiguous()
               for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous and on one "
                         f"CUDA device")


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    soft_cap=None, chunk: int = 1024,
                    q_offset: "int | torch.Tensor" = 0, scale=None):
    """q: [B,Sq,H,hd]; k: [B,Sk,KVH,hd]; v: [B,Sk,KVH,hdv] ->
    [B,Sq,H,hdv] in q.dtype (MLA's value heads are narrower than its
    query/key heads).

    ``q_offset`` is the absolute position of q[0] (a suffix prefill
    attends over the whole key stream from position 0); key tiles stay
    aligned to absolute position 0.  It is an int, or a one-element int32
    tensor on q's device that the kernel reads from device memory (a
    suffix prefill captured in a CUDA graph; the caller keeps it >= 0, as
    nothing on the host reads it).  CUDA tensors launch a kernel (counted
    in ``flash_attention.launches``, and those with ``q_offset > 0`` or a
    tensor offset also in ``flash_attention.offset_launches``); a head dim
    the kernels do not
    take (bf16: not a multiple of 8; float32: not an instantiated width) is
    zero-padded into a copy first, with the softmax scale of the real one.
    CPU tensors run :func:`flash_attention_plain` with ``chunk``.
    ``scale`` is the softmax scale (None: 1 / sqrt(hd) of the real head
    dim; DeepSeek-V2's YaRN multiplies it by ``m ** 2``).

    With grad enabled and an input that requires grad the call goes
    through :class:`FlashAttentionFn` (the forward with LSE, then
    :func:`flash_attention_bwd`); training never needs a query offset, and
    a nonzero one raises there."""
    if not isinstance(q_offset, torch.Tensor):
        q_offset = int(q_offset)
        if q_offset < 0:
            raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if isinstance(q_offset, torch.Tensor) or q_offset:
            raise ValueError("flash_attention: no backward with q_offset > "
                             "0 (training never needs it)")
        return FlashAttentionFn.apply(q, k, v, causal, window, soft_cap,
                                      chunk, scale)
    return _forward(q, k, v, causal=causal, window=window, soft_cap=soft_cap,
                    chunk=chunk, q_offset=q_offset, scale=scale)


def _forward(q, k, v, *, causal, window, soft_cap, chunk, q_offset=0,
             return_lse=False, scale=None):
    """The forward: the plain version on the CPU, a kernel on the card;
    with ``return_lse`` also each row's LSE ([B, H, Sq] float32).  A
    ``meta`` tensor (the dry-run's shape-only trace) gets empty outputs of
    the kernel's shapes."""
    if q.is_meta:
        B, Sq, H, _ = q.shape
        out = q.new_empty((B, Sq, H, v.shape[-1]))
        lse = q.new_empty((B, H, Sq), dtype=F32)
        return (out, lse) if return_lse else out
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, chunk=chunk,
                                     soft_cap=soft_cap, return_lse=return_lse,
                                     scale=scale)
    _check_inputs(q, k, v, "flash_attention")
    B, Sq, H, hd = q.shape
    _, Sk, KVH, _ = k.shape
    hdv = v.shape[-1]
    hdp, hdvp = _kernel_widths(hd, hdv, q.dtype)
    if not (0 < hdv and 0 < hdp <= 256 and hdvp <= 256):
        raise ValueError(
            f"flash_attention: head dims ({hd}, {hdv}) have no {q.dtype} "
            f"kernel (bf16: up to 256; float32: up to {_F32_HEAD_DIMS[-1]})")
    _contiguous_on(q.device, (q, k, v), "flash_attention")
    q, k, v = _pad_last(q, hdp), _pad_last(k, hdp), _pad_last(v, hdvp)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    offset_dev = None
    if isinstance(q_offset, torch.Tensor):
        if (q_offset.numel() != 1 or q_offset.dtype != torch.int32
                or q_offset.device != q.device):
            raise ValueError(f"flash_attention: a tensor q_offset must be "
                             f"one int32 on {q.device}, not "
                             f"{tuple(q_offset.shape)} {q_offset.dtype} on "
                             f"{q_offset.device}")
        offset_dev, q_offset = q_offset.data_ptr(), 0
    out = torch.empty((B, Sq, H, hdvp), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=F32, device=q.device)
           if return_lse else None)
    fn = build.function("flash_attention", "flash_attention_launch",
                        _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(),
             B, Sq, Sk, H, KVH, hdp, hdvp, int(causal),
             -1 if window is None else int(window), q_offset, offset_dev,
             _DTYPES[q.dtype],
             0.0 if soft_cap is None else float(soft_cap),
             1.0 / math.sqrt(hd) if scale is None else float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.offset_launches += (offset_dev is not None
                                        or q_offset > 0)
    out = _unpad(out, hdv)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.offset_launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its backward: the forward saves q, k, v, the
    output and its LSE; the backward is :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, soft_cap, chunk, scale=None):
        out, lse = _forward(q, k, v, causal=causal, window=window,
                            soft_cap=soft_cap, chunk=chunk, return_lse=True,
                            scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, soft_cap=soft_cap,
                        chunk=chunk, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


# ---------------------------------------------------------------------------
# The backward kernels (csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------

_BWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                 + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window=None, soft_cap=None, chunk: int = 1024,
                        scale=None):
    """(dq, dk, dv) of the attention at (q, k, v) with output ``out``, its
    gradient ``dout`` and its rows' LSE ([B, H, Sq] float32).  CPU tensors
    run :func:`flash_attention_bwd_plain`; CUDA tensors launch the three
    kernels :func:`flash_bwd_preprocess`, :func:`flash_bwd_dkdv` and
    :func:`flash_bwd_dq` (or raise); ``meta`` tensors get empty
    gradients."""
    if q.is_meta:
        return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                         causal=causal, window=window,
                                         soft_cap=soft_cap, chunk=chunk,
                                         scale=scale)
    D = flash_bwd_preprocess(out, dout)
    opts = dict(causal=causal, window=window, soft_cap=soft_cap, scale=scale)
    dk, dv = flash_bwd_dkdv(q, k, v, dout, lse, D, **opts)
    dq = flash_bwd_dq(q, k, v, dout, lse, D, **opts)
    return dq, dk, dv


def _check_bwd(q, k, v, dout, lse, D, what: str) -> None:
    """Raise on inputs the backward kernels do not take (head dims past
    256: :func:`_bwd_plan`)."""
    _check_inputs(q, k, v, what)
    B, Sq, H, _ = q.shape
    hdv = v.shape[-1]
    if (dout.shape != (B, Sq, H, hdv) or dout.dtype != q.dtype
            or lse.shape != (B, H, Sq) or lse.dtype != F32
            or D.shape != lse.shape or D.dtype != F32):
        raise ValueError(
            f"{what}: unsupported dout{tuple(dout.shape)} {dout.dtype} "
            f"lse{tuple(lse.shape)} {lse.dtype} D{tuple(D.shape)} {D.dtype}")
    _contiguous_on(q.device, (q, k, v, dout, lse, D), what)


def flash_bwd_preprocess(out, dout):
    """D = rowsum(dout * out): [B, H, Sq] float32 (one kernel; CPU tensors
    run :func:`flash_bwd_preprocess_plain`)."""
    if not out.is_cuda:
        return flash_bwd_preprocess_plain(out, dout)
    if (out.dim() != 4 or dout.shape != out.shape
            or out.dtype not in _DTYPES or dout.dtype != out.dtype):
        raise ValueError(f"flash_bwd_preprocess: unsupported "
                         f"out{tuple(out.shape)} {out.dtype} "
                         f"dout{tuple(dout.shape)} {dout.dtype}")
    _contiguous_on(out.device, (out, dout), "flash_bwd_preprocess")
    B, Sq, H, hdv = out.shape
    D = torch.empty((B, H, Sq), dtype=F32, device=out.device)
    fn = build.function("flash_attention_bwd", "flash_bwd_preprocess_launch",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])
    err = fn(out.data_ptr(), dout.data_ptr(), D.data_ptr(), B, Sq, H, hdv,
             _DTYPES[out.dtype],
             torch.cuda.current_stream(out.device).cuda_stream)
    build.check(err, "flash_bwd_preprocess")
    flash_bwd_preprocess.launches += 1
    return D


class BwdPlan(NamedTuple):
    """How the backward kernels take a call: ``route`` "wgmma" (bf16, the
    tensor-core kernels) or "fma" (float32, the CUDA-core kernels); ``hd``
    and ``hdv`` the widths the kernels get (bf16 pads each to a multiple of
    8 in a zero-filled copy); ``scale`` the softmax scale of the real head
    dim, which padding must not change.  The kernel instance for the widths
    is the library's choice (``instance_width`` in
    ``csrc/flash_attention_bwd.cu``)."""
    route: str
    hd: int
    hdv: int
    scale: float


def _bwd_plan(hd: int, hdv: int, dtype) -> BwdPlan:
    """The backward launch plan for real head dims (hd, hdv) in ``dtype``."""
    if not 0 < hd <= 256 or not 0 < hdv <= 256:
        raise ValueError(f"flash backward: head dims ({hd}, {hdv}) outside "
                         f"1..256")
    scale = 1.0 / math.sqrt(hd)
    if dtype == torch.bfloat16:
        return BwdPlan("wgmma", -(-hd // 8) * 8, -(-hdv // 8) * 8, scale)
    return BwdPlan("fma", hd, hdv, scale)


def _bwd_padded(q, k, v, dout, what: str, scale=None):
    """The plan for (q, k, v) (its softmax scale ``scale`` when given) and
    the four inputs at its widths (a zero-padded copy only where a width
    grows)."""
    plan = _bwd_plan(q.shape[-1], v.shape[-1], q.dtype)
    if scale is not None:
        plan = plan._replace(scale=float(scale))
    padded = (_pad_last(q, plan.hd), _pad_last(k, plan.hd),
              _pad_last(v, plan.hdv), _pad_last(dout, plan.hdv))
    if plan.route == "wgmma" and any(t.data_ptr() % 16 for t in padded):
        raise ValueError(f"{what}: bf16 q, k, v, dout must be 16-byte "
                         f"aligned")
    return plan, padded


def _bwd_args(q, k, plan: BwdPlan, causal, window, soft_cap):
    B, Sq, H, _ = q.shape
    _, Sk, KVH, _ = k.shape
    return (B, Sq, Sk, H, KVH, plan.hd, plan.hdv, int(causal),
            -1 if window is None else int(window), _DTYPES[q.dtype],
            0.0 if soft_cap is None else float(soft_cap), plan.scale,
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_bwd_dkdv(q, k, v, dout, lse, D, *, causal, window, soft_cap,
                 scale=None):
    """(dk, dv) in the dtypes of k and v (one kernel; CPU tensors run the
    plain backward).  Counts its launches, and by route in ``routes``."""
    if not q.is_cuda:
        return _bwd_plain(q, k, v, dout, lse, D, causal=causal, window=window,
                          soft_cap=soft_cap, scale=scale)[1:]
    _check_bwd(q, k, v, dout, lse, D, "flash_bwd_dkdv")
    plan, (qp, kp, vp, dop) = _bwd_padded(q, k, v, dout, "flash_bwd_dkdv",
                                          scale)
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    fn = build.function("flash_attention_bwd", "flash_bwd_dkdv_launch",
                        _BWD_ARGTYPES)
    err = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
             lse.data_ptr(), D.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_bwd_args(q, k, plan, causal, window, soft_cap))
    build.check(err, "flash_bwd_dkdv")
    flash_bwd_dkdv.launches += 1
    flash_bwd_dkdv.routes[plan.route] += 1
    return _unpad(dk, k.shape[-1]), _unpad(dv, v.shape[-1])


def flash_bwd_dq(q, k, v, dout, lse, D, *, causal, window, soft_cap,
                 scale=None):
    """dq in q's dtype (one kernel; CPU tensors run the plain backward).
    Counts its launches, and by route in ``routes``."""
    if not q.is_cuda:
        return _bwd_plain(q, k, v, dout, lse, D, causal=causal, window=window,
                          soft_cap=soft_cap, scale=scale)[0]
    _check_bwd(q, k, v, dout, lse, D, "flash_bwd_dq")
    plan, (qp, kp, vp, dop) = _bwd_padded(q, k, v, dout, "flash_bwd_dq",
                                          scale)
    dq = torch.empty_like(qp)
    fn = build.function("flash_attention_bwd", "flash_bwd_dq_launch",
                        _BWD_ARGTYPES[:6] + _BWD_ARGTYPES[7:])
    err = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
             lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
             *_bwd_args(q, k, plan, causal, window, soft_cap))
    build.check(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    flash_bwd_dq.routes[plan.route] += 1
    return _unpad(dq, q.shape[-1])


flash_bwd_preprocess.launches = 0
flash_bwd_dkdv.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkdv.routes = {"wgmma": 0, "fma": 0}
flash_bwd_dq.routes = {"wgmma": 0, "fma": 0}
