"""Paged decode attention with exact per-page attention mass (heat).

Replaces the Pallas TPU kernel ``paged_class_partials``
(``repro/kernels/paged_attention/kernel.py``) and the jnp gather path the
reference engine actually runs (``repro/models/decode.py::
paged_decode_attention_gather``).  One call handles one page-size class of
``page_blocks`` = 4^c buddy-aligned pool blocks per page; the serving engine
uses class 0, a per-block ``[B, MB]`` table with logical index = column.

Heat is the EXACT softmax mass per page, summed over all query heads — what
the gather path emits and what DAMON consumes — not the Pallas kernel's
running-max heat, which depends on the order pages are visited and so is
undefined on a GPU where pages are not visited in one order.

On a CUDA tensor :func:`paged_decode_attention` launches the kernel in
``csrc/paged_attention.cu`` (or raises); on a CPU tensor it runs
:func:`paged_decode_plain`, the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import build

NEG_INF = -1e30
F32 = torch.float32


def _page_positions(page_table, logical, page_blocks: int, block_tokens: int):
    """[B, MP*pt] token positions of every page slot (logical index = column
    when ``logical`` is None)."""
    B, MP = page_table.shape
    pt = page_blocks * block_tokens
    if logical is None:
        logical = torch.arange(MP, device=page_table.device).expand(B, MP)
    pos = (logical.clamp_min(0)[:, :, None] * pt
           + torch.arange(pt, device=page_table.device))
    return pos.reshape(B, MP * pt)


def paged_decode_plain(q, pool_k, pool_v, page_table, lengths, *,
                       block_tokens: int, page_blocks: int = 1, logical=None,
                       window=None, soft_cap=None):
    """q: [B,H,hd]; pools: [NB,bt,KVH,hd]; page_table: [B,MP] int32 START
    block of each page (-1 = none); logical: optional [B,MP] logical page
    index (default: the column); lengths: [B] tokens valid INCLUDING the
    current one.  Returns (out [B,H,hd] in q.dtype, heat [B,MP] f32).

    The gather path of the reference, generalized to 4^c-block pages: with
    ``page_blocks=1`` and no ``logical`` it is the same arithmetic in the
    same order as ``paged_decode_attention_gather``."""
    B, H, hd = q.shape
    MP = page_table.shape[1]
    KVH = pool_k.shape[2]
    G = H // KVH
    pt = page_blocks * block_tokens
    scale = 1.0 / math.sqrt(hd)
    rows = (page_table.clamp_min(0)[:, :, None]
            + torch.arange(page_blocks, device=q.device)).reshape(B, -1)
    k = pool_k[rows].reshape(B, MP * pt, KVH, hd)
    v = pool_v[rows].reshape(B, MP * pt, KVH, hd)
    qg = q.reshape(B, KVH, G, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    pos = _page_positions(page_table, logical, page_blocks, block_tokens)
    valid = (pos < lengths[:, None]) & \
        (page_table >= 0).repeat_interleave(pt, dim=1)
    if window is not None:
        valid &= pos > (lengths[:, None] - 1 - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid[:, None, None], p, torch.zeros_like(p))
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    heat = p.sum(dim=(1, 2)).reshape(B, MP, pt).sum(-1)
    return out.reshape(B, H, hd).to(q.dtype), heat


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


def paged_decode_attention(q, pool_k, pool_v, page_table, lengths, *,
                           block_tokens: int, page_blocks: int = 1,
                           logical=None, window=None, soft_cap=None):
    """:func:`paged_decode_plain`'s contract; launches the CUDA kernel for
    CUDA tensors (counted in ``paged_decode_attention.launches``)."""
    if not q.is_cuda:
        return paged_decode_plain(
            q, pool_k, pool_v, page_table, lengths, block_tokens=block_tokens,
            page_blocks=page_blocks, logical=logical, window=window,
            soft_cap=soft_cap)
    B, H, hd = q.shape
    NB, bt, KVH, hd_k = pool_k.shape
    MP = page_table.shape[1]
    if (bt != block_tokens or hd_k != hd or H % KVH or pool_v.shape != pool_k.shape
            or q.dtype not in _DTYPES or pool_k.dtype != q.dtype
            or pool_v.dtype != q.dtype or H // KVH > 8 or hd > 256
            or page_table.dtype != torch.int32 or lengths.dtype != torch.int32
            or page_table.shape[0] != B or lengths.shape != (B,)):
        raise ValueError(
            f"paged_decode_attention: unsupported shapes/dtypes q{tuple(q.shape)} "
            f"{q.dtype} pool{tuple(pool_k.shape)} {pool_k.dtype} "
            f"table{tuple(page_table.shape)} {page_table.dtype}")
    tensors = [q, pool_k, pool_v, page_table, lengths]
    if logical is not None:
        if logical.shape != page_table.shape or logical.dtype != torch.int32:
            raise ValueError("logical must match page_table (int32)")
        tensors.append(logical)
    if not all(t.is_cuda and t.device == q.device and t.is_contiguous()
               for t in tensors):
        raise ValueError("paged_decode_attention: tensors must be contiguous "
                         "and on one CUDA device")
    out = torch.empty((B, H, hd), dtype=F32, device=q.device)
    heat_part = torch.empty((B, KVH, MP), dtype=F32, device=q.device)
    scratch = torch.empty((2, B, KVH, MP, H // KVH), dtype=F32,
                          device=q.device)
    fn = build.function("paged_attention", "paged_decode_launch", _ARGTYPES)
    err = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
             page_table.data_ptr(),
             logical.data_ptr() if logical is not None else None,
             lengths.data_ptr(), out.data_ptr(), heat_part.data_ptr(),
             scratch.data_ptr(),
             B, H, KVH, hd, MP, page_blocks, block_tokens,
             -1 if window is None else int(window), _DTYPES[q.dtype],
             0.0 if soft_cap is None else float(soft_cap),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out.to(q.dtype), heat_part.sum(dim=1)


paged_decode_attention.launches = 0
