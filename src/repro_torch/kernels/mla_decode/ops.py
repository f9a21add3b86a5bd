"""MLA's absorbed decode over the paged latent pool, with the exact
softmax mass per block (heat).

No TPU kernel computes it: the JAX package's engine gathers every block of
the table and computes the attention in jnp
(``repro/models/decode.py::paged_decode_attention_mla_gather``).
:func:`paged_decode_mla_plain` is that gather's arithmetic in torch ops;
:func:`paged_decode_mla` launches ``csrc/mla_decode.cu`` (a split pass over
the rows' valid latents on the tensor cores, then a combine that writes
``o_lat`` and the heat) for plain CUDA tensors, a bf16 pool on the tensor
cores and a float32 pool (a float32 model on the card) in scalar float32
products, and runs the plain version for CPU and ``meta`` tensors.
DTensors reach it on their local shards (``models/decode.py`` hands it to
``spmd.paged_gather``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

NEG_INF = -1e30
F32 = torch.float32
TILE = 64           # tokens per shared-memory tile of the split kernel


def paged_decode_mla_plain(q_eff, q_rope, pool_ckv, block_table, lengths, *,
                           block_tokens: int, kv_lora: int, scale: float):
    """q_eff: [B,H,L] (q_nope @ w_uk); q_rope: [B,H,Dr]; pool_ckv:
    [NB,bt,L+Dr]; block_table: [B,MB] (-1 = unmapped); lengths: [B] tokens
    INCLUDING the current one; ``scale``: the softmax scale.  Returns
    (o_lat [B,H,L] f32, heat [B,MB]: the exact softmax mass per block,
    summed over the heads).  Every block of the table is gathered, in
    float32."""
    B, H, L = q_eff.shape
    MB = block_table.shape[1]
    bt = block_tokens
    safe = block_table.clamp_min(0).long()
    lat = pool_ckv[safe].reshape(B, MB * bt, -1)
    ckv, kr = lat[..., :kv_lora].float(), lat[..., kv_lora:].float()
    s = (torch.einsum("bhl,bsl->bhs", q_eff.float(), ckv)
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), kr)) * scale
    pos = torch.arange(MB * bt, device=q_eff.device)[None, :]
    valid = (pos < lengths[:, None]) & \
        (block_table >= 0).repeat_interleave(bt, dim=1)
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid[:, None], p, torch.zeros_like(p))
    o_lat = torch.einsum("bhs,bsl->bhl", p, ckv)
    heat = p.sum(dim=1).reshape(B, MB, bt).sum(-1)
    return o_lat, heat


def split_slots(MB: int, B: int, block_tokens: int, sms: int) -> int:
    """Table slots per split of the kernel's grid (splits, B): a whole
    number of 64-token tiles, at least two (a block's fixed cost, q's copy
    and the first tile's wait, is a few tiles' worth), and about four
    blocks per SM over the grid (one block fits an SM: its two tiles take
    ~150 KB of shared memory at 576-wide latents).  Shapes only: no host
    sync."""
    ppt = TILE // block_tokens
    splits = max(1, -(-4 * sms // B))
    return ppt * max(2, -(-MB // (ppt * splits)))


@functools.lru_cache(maxsize=None)
def _plan(B: int, MB: int, bt: int, device_index: int) -> tuple[int, int]:
    """(slots per split, splits) for the call's shapes."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    pps = split_slots(MB, B, bt, sms)
    return pps, -(-MB // pps)


_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float]
             + [ctypes.c_int, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_mla(q_eff, q_rope, pool_ckv, block_table, lengths, *,
                     block_tokens: int, kv_lora: int, scale: float):
    """:func:`paged_decode_mla_plain`'s contract.  A plain CUDA call
    launches the split and the combine kernel (one call counted in
    ``paged_decode_mla.launches``) and reads each row's valid latents once;
    the table and lengths are read from device memory (capturable in a CUDA
    graph).  CPU and ``meta`` inputs run the plain version."""
    if not q_eff.is_cuda:
        return paged_decode_mla_plain(
            q_eff, q_rope, pool_ckv, block_table, lengths,
            block_tokens=block_tokens, kv_lora=kv_lora, scale=scale)
    B, H, L = q_eff.shape
    NB, bt, D = pool_ckv.shape
    MB = block_table.shape[1]
    R = D - kv_lora
    ok = (bt == block_tokens and L == kv_lora and q_rope.shape == (B, H, R)
          and 1 <= H <= 16 and L in (32, 64, 128, 256, 512) and D % 8 == 0
          and bt in (1, 2, 4, 8, 16) and pool_ckv.dtype in _DTYPES
          and block_table.dtype == torch.int32
          and block_table.shape == (B, MB) and lengths.dtype == torch.int32
          and lengths.shape == (B,))
    if not ok:
        raise ValueError(
            f"paged_decode_mla: unsupported q_eff{tuple(q_eff.shape)} "
            f"q_rope{tuple(q_rope.shape)} pool{tuple(pool_ckv.shape)} "
            f"{pool_ckv.dtype} table{tuple(block_table.shape)} "
            f"{block_table.dtype} lengths {lengths.dtype} (needs H <= 16, "
            "kv_lora 32..512 a power of 2, latent width % 8 == 0, "
            "block_tokens dividing 16, a bf16 or float32 pool)")
    table = block_table.contiguous()
    tensors = (pool_ckv, table, lengths)
    index = q_eff.get_device()
    if not all(t.get_device() == index and t.is_contiguous()
               for t in tensors) or pool_ckv.data_ptr() % 16:
        raise ValueError("paged_decode_mla: tensors must be contiguous, on "
                         "one CUDA device, the pool 16-byte aligned")
    q = torch.cat([q_eff.float(), q_rope.float()], dim=-1).contiguous()
    pps, NS = _plan(B, MB, bt, index)
    # one float32 workspace: acc [B,H,NS,L], (m, l) [2,B,H,NS] per split,
    # (m, l) [2,B,H,MB] per slot
    n_acc, n_ml, n_pml = B * H * NS * L, 2 * B * H * NS, 2 * B * H * MB
    ws = torch.empty(n_acc + n_ml + n_pml, dtype=F32, device=q.device)
    out = torch.empty((B, H, L), dtype=F32, device=q.device)
    heat = torch.empty((B, MB), dtype=F32, device=q.device)
    fn = build.function("mla_decode", "mla_decode_launch", _ARGTYPES)
    base = ws.data_ptr()
    build.check(fn(q.data_ptr(), pool_ckv.data_ptr(), table.data_ptr(),
                   lengths.data_ptr(), base, base + 4 * n_acc,
                   base + 4 * (n_acc + n_ml), out.data_ptr(),
                   heat.data_ptr(), B, H, L, R, MB, bt, pps, NS,
                   float(scale), _DTYPES[pool_ckv.dtype],
                   torch.cuda.current_stream(q.device).cuda_stream),
                "paged_decode_mla")
    paged_decode_mla.launches += 1
    return out, heat


paged_decode_mla.launches = 0
