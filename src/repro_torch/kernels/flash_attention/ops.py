"""Causal / windowed GQA flash attention, forward only (prefill).

Replaces the Pallas TPU kernel ``flash_attention_fwd``
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
"""

from __future__ import annotations

import ctypes
import math

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
                          q_offset: int = 0, chunk: int = 1024,
                          soft_cap=None):
    """Memory-bounded attention with a running-softmax loop over KV chunks.

    q: [B, Sq, H, D]; k: [B, Sk, KVH, D]; v: [B, Sk, KVH, Dv] with
    H % KVH == 0.  q_offset: absolute position of q[0].  Returns
    [B, Sq, H, Dv] in q.dtype.
    """
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    Dv = v.shape[-1]
    if H % KVH:
        raise ValueError(f"H={H} not divisible by KVH={KVH}")
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
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
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)
    return out.to(q.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# float32 head dims instantiated in the .cu; bf16 takes any multiple of 8 up
# to 256 (zero-padded in the kernel's loads to 64, 128, 192 or 256)
_F32_HEAD_DIMS = (16, 32, 48, 64, 96, 128, 256)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
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


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    soft_cap=None, chunk: int = 1024, q_offset: int = 0):
    """q: [B,Sq,H,hd]; k: [B,Sk,KVH,hd]; v: [B,Sk,KVH,hdv] ->
    [B,Sq,H,hdv] in q.dtype (MLA's value heads are narrower than its
    query/key heads).

    ``q_offset`` is the absolute position of q[0] (a suffix prefill
    attends over the whole key stream from position 0); key tiles stay
    aligned to absolute position 0.  CUDA tensors launch a kernel (counted
    in ``flash_attention.launches``, and those with ``q_offset > 0`` also
    in ``flash_attention.offset_launches``); a head dim the kernels do not
    take (bf16: not a multiple of 8; float32: not an instantiated width) is
    zero-padded into a copy first, with the softmax scale of the real one.
    CPU tensors run :func:`flash_attention_plain` with ``chunk``."""
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, chunk=chunk,
                                     soft_cap=soft_cap)
    B, Sq, H, hd = q.shape
    Bk, Sk, KVH, hdk = k.shape
    hdv = v.shape[-1]
    if (Bk != B or hdk != hd or v.shape[:3] != k.shape[:3] or H % KVH
            or q.dtype not in _DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError(
            f"flash_attention: unsupported q{tuple(q.shape)} {q.dtype} "
            f"k{tuple(k.shape)} {k.dtype} v{tuple(v.shape)} {v.dtype}")
    hdp, hdvp = _kernel_widths(hd, hdv, q.dtype)
    if not (0 < hdv and 0 < hdp <= 256 and hdvp <= 256):
        raise ValueError(
            f"flash_attention: head dims ({hd}, {hdv}) have no {q.dtype} "
            f"kernel (bf16: up to 256; float32: up to {_F32_HEAD_DIMS[-1]})")
    if not all(t.is_cuda and t.device == q.device and t.is_contiguous()
               for t in (q, k, v)):
        raise ValueError("flash_attention: tensors must be contiguous and on "
                         "one CUDA device")
    q, k, v = _pad_last(q, hdp), _pad_last(k, hdp), _pad_last(v, hdvp)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    out = torch.empty((B, Sq, H, hdvp), dtype=q.dtype, device=q.device)
    fn = build.function("flash_attention", "flash_attention_launch",
                        _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, Sq, Sk, H, KVH, hdp, hdvp, int(causal),
             -1 if window is None else int(window), q_offset,
             _DTYPES[q.dtype],
             0.0 if soft_cap is None else float(soft_cap),
             1.0 / math.sqrt(hd),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.offset_launches += q_offset > 0
    return out if hdvp == hdv else out[..., :hdv].contiguous()


flash_attention.launches = 0
flash_attention.offset_launches = 0
