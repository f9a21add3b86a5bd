"""Paged decode attention with exact per-page attention mass (heat).

Replaces the Pallas TPU kernel ``paged_class_partials``
(``repro/kernels/paged_attention/kernel.py``), its multi-class wrapper
(``repro/kernels/paged_attention/ops.py::paged_decode_attention``) and the
jnp gather path the reference engine actually runs
(``repro/models/decode.py::paged_decode_attention_gather``).
:func:`paged_decode_attention` handles one page-size class of
``page_blocks`` = 4^c buddy-aligned pool blocks per page; the serving engine
uses class 0, a per-block ``[B, MB]`` table with logical index = column.
:func:`paged_decode_multi` takes one table per class, as the JAX wrapper
does.

Heat is the EXACT softmax mass per page, summed over all query heads — what
the gather path emits and what DAMON consumes — not the Pallas kernel's
running-max heat, which depends on the order pages are visited and so is
undefined on a GPU where pages are not visited in one order.

On CUDA tensors both wrappers launch ``csrc/paged_attention.cu`` (or raise):
one split pass per class, grid (splits, KVH, B), sized by
:func:`split_pages`, then one combine pass that writes ``out`` in q's dtype
and the heat — two device kernels per single-class call.  On CPU tensors
they run the plain versions: :func:`paged_decode_plain` (the gather path's
arithmetic) and :func:`paged_decode_multi_plain`.  The split-and-combine
arithmetic itself is written out in :func:`split_partials_plain` and
:func:`combine_plain`, so the CPU tests reach the kernels' plan.

:func:`paged_decode_partials` is the per-shard body of the sharded
flash-decoding (``repro/distributed/flashdecode.py::_partials``, "exactly
the computation of the Pallas paged-attention kernel"): the same split pass,
then the combine in its local mode, which normalises nothing and returns
the shard's (m, l, acc) and its heat against each head's local max.  Its
plain version is :func:`paged_decode_partials_plain`.
"""

from __future__ import annotations

import ctypes
import functools
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


def _empty_heat(q, table):
    return q.new_empty(tuple(table.shape), dtype=torch.float32)


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


# ------------------------------------------------- the kernels' plan, plain

def split_pages(MP: int, rows: int, sms: int) -> int:
    """Page slots per split for a ``[rows = B*KVH, MP]`` class on a card of
    ``sms`` SMs, for blocks of up to 4 warps (a warp per page): fewer pages
    where blocks would number under 2 per SM, more where they would exceed
    4 per SM, so the grid runs in about one wave (8 pages per split at the
    serving shape, measured faster there than 4 or 16; PERF.md).  Shapes
    only: no host sync."""
    if MP <= 0:
        return 1
    blocks = lambda pps: rows * -(-MP // pps)
    pps = 4
    while pps > 1 and blocks(pps) < 2 * sms:
        pps //= 2
    while pps < MP and blocks(pps) > 4 * sms:
        pps *= 2
    return min(pps, MP)


def split_partials_plain(q, pool_k, pool_v, page_table, lengths, *,
                         block_tokens: int, pages_per_split: int,
                         page_blocks: int = 1, logical=None, window=None,
                         soft_cap=None):
    """What the split kernel writes for one class, in PyTorch.

    Splits own ``pages_per_split`` consecutive page slots.  Returns, with
    -inf marking "nothing valid":
    acc [B,H,NS,hd] (unnormalized, against the split max), m, l [B,H,NS]
    per split, and m_page, l_page [B,H,MP] per page slot (each page's mass
    against its own max)."""
    B, H, hd = q.shape
    MP = page_table.shape[1]
    KVH = pool_k.shape[2]
    G = H // KVH
    pt = page_blocks * block_tokens
    pps = pages_per_split
    NS = -(-MP // pps)
    rows = (page_table.clamp_min(0)[:, :, None]
            + torch.arange(page_blocks, device=q.device)).reshape(B, -1)
    k = pool_k[rows].reshape(B, MP, pt, KVH, hd).float()
    v = pool_v[rows].reshape(B, MP, pt, KVH, hd).float()
    s = torch.einsum("bkgd,bptkd->bkgpt", q.reshape(B, KVH, G, hd).float(),
                     k) / math.sqrt(hd)
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    pos = _page_positions(page_table, logical, page_blocks,
                          block_tokens).reshape(B, MP, pt)
    valid = (pos < lengths[:, None, None]) & (page_table >= 0)[:, :, None]
    if window is not None:
        valid &= pos > (lengths[:, None, None] - 1 - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, -math.inf))

    def mass(x, m):              # exp(x - m), 0 where x is -inf
        return torch.where(x == -math.inf, torch.zeros_like(x),
                           torch.exp(x - m.nan_to_num(neginf=0.0)))
    m_page = s.amax(-1)                                       # [B,KVH,G,MP]
    l_page = mass(s, m_page[..., None]).sum(-1)
    pad = NS * pps - MP
    s = torch.nn.functional.pad(s, (0, 0, 0, pad), value=-math.inf)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 0, 0, pad))
    s = s.reshape(B, KVH, G, NS, pps * pt)
    m = s.amax(-1)                                            # [B,KVH,G,NS]
    p = mass(s, m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgnt,bntkd->bkgnd", p,
                       v.reshape(B, NS, pps * pt, KVH, hd))
    return (acc.reshape(B, H, NS, hd), m.reshape(B, H, NS),
            l.reshape(B, H, NS), m_page.reshape(B, H, MP),
            l_page.reshape(B, H, MP))


def combine_plain(acc, m, l, m_page, l_page):
    """What the combine kernel computes: merge the splits of every (b, h)
    as ``combine_partials_ref`` does and weigh each page's own mass by the
    row's max and sum.  Returns (out [B,H,hd] f32, heat [B,NP])."""
    M = m.amax(-1, keepdim=True)                              # [B,H,1]
    Ms = M.nan_to_num(neginf=0.0)
    w = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp(m - Ms))
    L = (l * w).sum(-1, keepdim=True)
    out = (acc * w[..., None]).sum(2) / L.clamp_min(1e-30)
    hw = torch.where((m_page == -math.inf) | (L <= 0),
                     torch.zeros_like(m_page),
                     l_page * torch.exp(m_page - Ms) / L.clamp_min(1e-30))
    return out, hw.sum(1)


def paged_decode_multi_plain(q, pool_k, pool_v, page_tables, logical_idxs,
                             lengths, *, block_tokens: int, orders,
                             window=None, soft_cap=None, active=None):
    """Multi-class plain version: each class's partials (one split per
    class, :func:`split_partials_plain`) merged by :func:`combine_plain`.
    Returns (out [B,H,hd] in q.dtype, heats tuple of [B,MP_i] f32)."""
    parts = []
    for o, tbl, lg in zip(orders, page_tables, logical_idxs):
        if active is not None:
            tbl = torch.where(active[:, None], tbl, torch.full_like(tbl, -1))
        parts.append(split_partials_plain(
            q, pool_k, pool_v, tbl, lengths, block_tokens=block_tokens,
            pages_per_split=max(tbl.shape[1], 1), page_blocks=4 ** o,
            logical=lg, window=window, soft_cap=soft_cap))
    out, heat = combine_plain(*(torch.cat(x, dim=2) for x in zip(*parts)))
    sizes = [t.shape[1] for t in page_tables]
    return out.to(q.dtype), tuple(heat.split(sizes, dim=1))


def paged_decode_partials_plain(q, pool_k, pool_v, table, lengths, *,
                                block_tokens: int, logical, window=None,
                                soft_cap=None):
    """One shard's flash-decoding partials, the reference's ``_partials``
    in PyTorch.  q: [B,H,hd]; pools: the shard's own [NB_loc,bt,KVH,hd];
    table: [B,MP] int32 shard-LOCAL block ids (-1 = not on this shard);
    logical: [B,MP] int32 logical block index of each slot; lengths: [B]
    tokens valid INCLUDING the current one.  Returns, in float32, m [B,H]
    (the shard's max, -1e30 where nothing is valid), l [B,H] (the sum
    against it), acc [B,H,hd] (unnormalised) and heat [B,MP] (each slot's
    mass against each head's local max, summed over the heads)."""
    B, H, hd = q.shape
    MP = table.shape[1]
    KVH = pool_k.shape[2]
    G = H // KVH
    bt = block_tokens
    safe = table.clamp_min(0).long()
    k = pool_k[safe].reshape(B, MP * bt, KVH, hd).float()
    v = pool_v[safe].reshape(B, MP * bt, KVH, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, KVH, G, hd).float(),
                     k) * (1.0 / math.sqrt(hd))
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    pos = _page_positions(table, logical, 1, bt)
    valid = (table >= 0).repeat_interleave(bt, dim=1) & \
        (pos < lengths[:, None])
    if window is not None:
        valid &= pos > (lengths[:, None] - 1 - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.where(valid[:, None, None], torch.exp(s - m[..., None]),
                    torch.zeros_like(s))
    acc = torch.einsum("bkgs,bskd->bkgd", p, v)
    heat = p.sum(dim=(1, 2)).reshape(B, MP, bt).sum(-1)
    return (m.reshape(B, H), p.sum(-1).reshape(B, H), acc.reshape(B, H, hd),
            heat)


# ------------------------------------------------------------ the kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                   + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_COMBINE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
_LOCAL_COMBINE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _plan(B: int, KVH: int, MPs: tuple, device_index: int):
    """Per class (pages per split, splits), and the call's splits NS and
    page slots NP: shapes and the SM count only."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    splits = []
    for MP in MPs:
        pps = split_pages(MP, B * KVH, sms)
        splits.append((pps, -(-MP // pps) if MP else 0))
    return tuple(splits), sum(n for _, n in splits), sum(MPs)


def _launch(q, pool_k, pool_v, classes, lengths, *, block_tokens: int,
            window, soft_cap, what: str, local: bool = False):
    """classes: [(table [B,MP] int32, logical or None, page_blocks)].  One
    split launch per class, one combine.  Returns (out in q.dtype,
    heat [B, sum MP]); ``local``: one local combine instead, returning
    (m, l, acc, heat), all float32 (:func:`paged_decode_partials`)."""
    B, H, hd = q.shape
    NB, bt, KVH, hd_k = pool_k.shape
    ok = (bt == block_tokens and hd_k == hd and H % KVH == 0
          and pool_v.shape == pool_k.shape and q.dtype in _DTYPES
          and pool_k.dtype == q.dtype and pool_v.dtype == q.dtype
          and H // KVH <= 8 and 0 < hd <= 256
          and (hd <= 128 or hd % 4 == 0 or q.dtype == torch.bfloat16)
          and lengths.dtype == torch.int32 and lengths.shape == (B,))
    tensors = [q, pool_k, pool_v, lengths]
    for tbl, lg, _ in classes:
        ok = ok and tbl.dtype == torch.int32 and tbl.dim() == 2 \
            and tbl.shape[0] == B
        tensors.append(tbl)
        if lg is not None:
            ok = ok and lg.shape == tbl.shape and lg.dtype == torch.int32
            tensors.append(lg)
    if not ok:
        raise ValueError(
            f"{what}: unsupported shapes/dtypes q{tuple(q.shape)} {q.dtype} "
            f"pool{tuple(pool_k.shape)} {pool_k.dtype} tables "
            f"{[(tuple(t.shape), t.dtype) for t, _, _ in classes]} (needs "
            "G <= 8, hd <= 256, and hd % 4 == 0 for float32 above 128)")
    index = q.get_device()
    if not all(t.get_device() == index and t.is_contiguous()
               for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous and on one "
                         "CUDA device")
    # rows of whole 16-byte chunks are read by vector loads; other head
    # dims (bf16 hd 12) element by element, zero-filled past hd in the
    # kernel's loads (the pools are never copied)
    if (q.data_ptr() | pool_k.data_ptr() | pool_v.data_ptr()) % 16 and \
            hd * q.element_size() % 16 == 0:
        raise ValueError(f"{what}: q and the pools must be 16-byte aligned")
    splits, NS, NP = _plan(B, KVH, tuple(t.shape[1] for t, _, _ in classes),
                           index)
    # one float32 workspace: acc [B,H,NS,hd], (m, l) [2,B,H,NS] per split,
    # (m, l) [2,B,H,NP] per page slot, then the heat [B,NP] returned
    n_acc, n_ml, n_pml = B * H * NS * hd, 2 * B * H * NS, 2 * B * H * NP
    ws = torch.empty(n_acc + n_ml + n_pml + B * NP, dtype=F32,
                     device=q.device)
    acc_part = ws.data_ptr()
    ml_part = acc_part + 4 * n_acc
    page_ml = ml_part + 4 * n_ml
    heat = ws[n_acc + n_ml + n_pml:].view(B, NP)
    out = None if local else torch.empty((B, H, hd), dtype=q.dtype,
                                         device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dtype = _DTYPES[q.dtype]
    win = -1 if window is None else int(window)
    cap = 0.0 if soft_cap is None else float(soft_cap)
    split = build.function("paged_attention", "paged_split_launch",
                           _SPLIT_ARGTYPES)
    s0 = p0 = 0
    for (tbl, lg, pb), (pps, ns) in zip(classes, splits):
        MP = tbl.shape[1]
        if ns:
            build.check(split(
                q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                tbl.data_ptr(), lg.data_ptr() if lg is not None else None,
                lengths.data_ptr(), acc_part, ml_part, page_ml, B, H, KVH, hd,
                MP, pps, pb, bt, win, dtype, cap, NS, s0, NP, p0, stream),
                what)
        s0 += ns
        p0 += MP
    if local:
        acc = torch.empty((B, H, hd), dtype=F32, device=q.device)
        ml = torch.empty((2, B, H), dtype=F32, device=q.device)
        combine = build.function("paged_attention",
                                 "paged_local_combine_launch",
                                 _LOCAL_COMBINE_ARGTYPES)
        build.check(combine(acc_part, ml_part, page_ml, acc.data_ptr(),
                            ml.data_ptr(), heat.data_ptr(), B, H, hd, NS, NP,
                            stream), what)
        return ml[0], ml[1], acc, heat
    combine = build.function("paged_attention", "paged_combine_launch",
                             _COMBINE_ARGTYPES)
    build.check(combine(acc_part, ml_part, page_ml, out.data_ptr(),
                        heat.data_ptr(), B, H, hd, NS, NP, dtype, stream),
                what)
    return out, heat


def paged_decode_attention(q, pool_k, pool_v, page_table, lengths, *,
                           block_tokens: int, page_blocks: int = 1,
                           logical=None, window=None, soft_cap=None):
    """:func:`paged_decode_plain`'s contract; on CUDA tensors one split and
    one combine launch (counted once per call in
    ``paged_decode_attention.launches``); ``meta`` tensors get empty
    outputs of the kernel's shapes."""
    if q.is_meta:
        return q.new_empty(q.shape), _empty_heat(q, page_table)
    if not q.is_cuda:
        return paged_decode_plain(
            q, pool_k, pool_v, page_table, lengths, block_tokens=block_tokens,
            page_blocks=page_blocks, logical=logical, window=window,
            soft_cap=soft_cap)
    out, heat = _launch(
        q, pool_k, pool_v, [(page_table, logical, page_blocks)], lengths,
        block_tokens=block_tokens, window=window, soft_cap=soft_cap,
        what="paged_decode_attention")
    paged_decode_attention.launches += 1
    return out, heat


paged_decode_attention.launches = 0


def paged_decode_multi(q, pool_k, pool_v, page_tables, logical_idxs,
                       lengths, *, block_tokens: int, orders,
                       window=None, soft_cap=None, active=None):
    """Multi-size paged decode (the JAX wrapper's signature): entry i of
    ``page_tables`` / ``logical_idxs`` is the [B, MP_i] table of size class
    ``orders[i]`` (pages of 4^order blocks); ``active`` ([B] bool) masks
    whole rows out of every class.  Returns (out [B,H,hd] in q.dtype, heats
    tuple of [B,MP_i] f32, exact mass).  CUDA tensors: one split launch per
    class and one combine (``paged_decode_multi.launches`` counts calls);
    CPU tensors: :func:`paged_decode_multi_plain`."""
    if not q.is_cuda:
        return paged_decode_multi_plain(
            q, pool_k, pool_v, page_tables, logical_idxs, lengths,
            block_tokens=block_tokens, orders=orders, window=window,
            soft_cap=soft_cap, active=active)
    if not len(orders) == len(page_tables) == len(logical_idxs):
        raise ValueError("paged_decode_multi: one table and one logical "
                         "index per order")
    if active is not None:
        page_tables = [torch.where(active[:, None], t, torch.full_like(t, -1))
                       for t in page_tables]
    classes = [(t, lg, 4 ** o)
               for o, t, lg in zip(orders, page_tables, logical_idxs)]
    out, heat = _launch(
        q, pool_k, pool_v, classes, lengths, block_tokens=block_tokens,
        window=window, soft_cap=soft_cap, what="paged_decode_multi")
    paged_decode_multi.launches += 1
    return out, tuple(heat.split([t.shape[1] for t in page_tables], dim=1))


paged_decode_multi.launches = 0


def paged_decode_partials(q, pool_k, pool_v, table, lengths, *,
                          block_tokens: int, logical, window=None,
                          soft_cap=None):
    """:func:`paged_decode_partials_plain`'s contract: one shard's (m, l,
    acc, heat).  On CUDA tensors one split launch and one local-combine
    launch of ``csrc/paged_attention.cu`` (counted once per call in
    ``paged_decode_partials.launches``), or an error; CPU tensors take the
    plain version; ``meta`` tensors get empty outputs of its shapes."""
    if q.is_meta:
        B, H, hd = q.shape
        f32 = dict(dtype=torch.float32)
        return (q.new_empty((B, H), **f32), q.new_empty((B, H), **f32),
                q.new_empty((B, H, hd), **f32), _empty_heat(q, table))
    if not q.is_cuda:
        return paged_decode_partials_plain(
            q, pool_k, pool_v, table, lengths, block_tokens=block_tokens,
            logical=logical, window=window, soft_cap=soft_cap)
    m, l, acc, heat = _launch(
        q, pool_k, pool_v, [(table, logical, 1)], lengths,
        block_tokens=block_tokens, window=window, soft_cap=soft_cap,
        what="paged_decode_partials", local=True)
    paged_decode_partials.launches += 1
    return m, l, acc, heat


paged_decode_partials.launches = 0
