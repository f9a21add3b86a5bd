"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips on a machine without a CUDA
device: a CUDA kernel has no CPU mode.  The file imports neither JAX nor
the JAX package, so it runs on a GPU machine without JAX (``--noconftest``
skips ``tests/conftest.py``, which imports JAX):

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

Tolerances: 2e-2 for bf16 outputs (the repo's bf16 tolerance; the flash
kernel also rounds P to bf16 before P.V), 1e-4 for float32 outputs and
the float32 heat (the kernels take exp through the card's fast
approximation and sum in other orders than the plain versions), exact
equality for block copies.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.block_copy.ops import (block_copy, block_copy_plain,
                                                pool_pointers)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.paged_attention.ops import (paged_decode_attention,
                                                     paged_decode_multi,
                                                     paged_decode_multi_plain,
                                                     paged_decode_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tols(dtype):
    return (2e-2, 2e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)


def _check_paged(q, pk, pv, tbl, lengths, **kw):
    n = paged_decode_attention.launches
    out, heat = paged_decode_attention(q, pk, pv, tbl, lengths, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n + 1
    assert out.dtype == q.dtype and heat.shape == tbl.shape
    ref_out, ref_heat = paged_decode_plain(q, pk, pv, tbl, lengths, **kw)
    rtol, atol = _tols(q.dtype)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(heat, ref_heat, rtol=1e-4, atol=1e-4)
    return out, heat


@pytest.mark.gpu
@pytest.mark.parametrize("page_blocks", [1, 4])
def test_paged_kernel_matches_plain(cuda, page_blocks):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, H, KVH, hd, bt, NB, MP = 3, 8, 2, 128, 16, 128, 6
    q = torch.randn(B, H, hd, generator=g, device=cuda).bfloat16()
    pk = torch.randn(NB, bt, KVH, hd, generator=g, device=cuda).bfloat16()
    pv = torch.randn(NB, bt, KVH, hd, generator=g, device=cuda).bfloat16()
    tbl = torch.stack([torch.randperm(NB // page_blocks, generator=g,
                                      device=cuda)[:MP] * page_blocks
                       for _ in range(B)]).int()
    tbl[2, 3:] = -1
    lengths = torch.tensor([MP * page_blocks * bt, 37, 3 * page_blocks * bt],
                           dtype=torch.int32, device=cuda)
    _check_paged(q, pk, pv, tbl, lengths, block_tokens=bt,
                 page_blocks=page_blocks)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("window,soft_cap", [(None, None), (100, 30.0)])
def test_paged_kernel_main_path_shape(cuda, G, window, soft_cap):
    """The serving path's decode shape (B=4, 32 query heads x 128, 16-token
    blocks, 32 per row, lengths 320-512) with G query heads per kv head;
    row 1 ends inside a split, row 3 has an unmapped tail, and a window of
    100 crosses split boundaries."""
    g = torch.Generator(device=cuda).manual_seed(G)
    B, H, hd, bt, NB, MB = 4, 32, 128, 16, 512, 32
    KVH = H // G
    q = torch.randn(B, H, hd, generator=g, device=cuda).bfloat16()
    pk = torch.randn(NB, bt, KVH, hd, generator=g, device=cuda).bfloat16()
    pv = torch.randn(NB, bt, KVH, hd, generator=g, device=cuda).bfloat16()
    tbl = torch.stack([torch.randperm(NB, generator=g, device=cuda)[:MB]
                       for _ in range(B)]).int()
    tbl[3, 20:] = -1
    lengths = torch.tensor([512, 16 * 9 + 5, 449, 320], dtype=torch.int32,
                           device=cuda)
    _check_paged(q, pk, pv, tbl, lengths, block_tokens=bt, window=window,
                 soft_cap=soft_cap)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_paged_kernel_float32_and_inactive_rows(cuda, hd):
    """float32 pools, head dims up to 256 (two 16-byte chunks per lane),
    4-block pages with logical indices, and an inactive row (table all -1,
    length 0) that must give zero output and zero heat."""
    g = torch.Generator(device=cuda).manual_seed(hd)
    B, H, KVH, bt, NB, MP, pb = 3, 8, 4, 8, 256, 5, 4
    q = torch.randn(B, H, hd, generator=g, device=cuda)
    pk = torch.randn(NB, bt, KVH, hd, generator=g, device=cuda)
    pv = torch.randn(NB, bt, KVH, hd, generator=g, device=cuda)
    tbl = torch.stack([torch.randperm(NB // pb, generator=g,
                                      device=cuda)[:MP] * pb
                       for _ in range(B)]).int()
    logical = torch.stack([torch.randperm(MP, generator=g, device=cuda)
                           for _ in range(B)]).int()
    tbl[1] = -1
    lengths = torch.tensor([MP * pb * bt - 3, 0, 70], dtype=torch.int32,
                           device=cuda)
    out, heat = _check_paged(q, pk, pv, tbl, lengths, block_tokens=bt,
                             page_blocks=pb, logical=logical)
    assert torch.all(out[1] == 0) and torch.all(heat[1] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_multi_class_matches_plain(cuda, dtype):
    """Two size classes (1-block and 4-block pages) on disjoint pool halves
    and disjoint positions: one split launch per class, one combine."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, H, KVH, hd, bt, NB = 3, 16, 4, 128, 16, 256
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(dtype)
    pk = torch.randn(NB, bt, KVH, hd, generator=g, device=cuda).to(dtype)
    pv = torch.randn(NB, bt, KVH, hd, generator=g, device=cuda).to(dtype)
    t0 = torch.stack([torch.randperm(NB // 2, generator=g, device=cuda)[:8]
                      for _ in range(B)]).int()
    t1 = torch.stack([NB // 2 + 4 * torch.randperm(NB // 8, generator=g,
                                                   device=cuda)[:6]
                      for _ in range(B)]).int()
    l0 = torch.arange(8, device=cuda).int().expand(B, 8).contiguous()
    l1 = (2 + torch.arange(6, device=cuda)).int().expand(B, 6).contiguous()
    t1[2, 3:] = -1
    lengths = torch.tensor([8 * bt + 24 * bt, 8 * bt + 20, 300],
                           dtype=torch.int32, device=cuda)
    active = torch.tensor([True, True, True], device=cuda)
    n = paged_decode_multi.launches
    out, heats = paged_decode_multi(q, pk, pv, (t0, t1), (l0, l1), lengths,
                                    block_tokens=bt, orders=(0, 1),
                                    active=active)
    torch.cuda.synchronize()
    assert paged_decode_multi.launches == n + 1
    ref_out, ref_heats = paged_decode_multi_plain(
        q, pk, pv, (t0, t1), (l0, l1), lengths, block_tokens=bt,
        orders=(0, 1), active=active)
    rtol, atol = _tols(dtype)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=rtol,
                               atol=atol)
    for h, rh in zip(heats, ref_heats):
        torch.testing.assert_close(h, rh, rtol=1e-4, atol=1e-4)


def _check_flash(cuda, seed, B, S, H, KVH, hd, dtype=torch.bfloat16, Sk=None,
                 **kw):
    g = torch.Generator(device=cuda).manual_seed(seed)
    Sk = S if Sk is None else Sk
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Sk, KVH, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Sk, KVH, hd, generator=g, device=cuda).to(dtype)
    n = flash_attention.launches
    o = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    r = flash_attention_plain(q, k, v, chunk=256, **kw)
    rtol, atol = _tols(dtype)
    torch.testing.assert_close(o.float(), r.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_flash_kernel_matches_plain(cuda):
    _check_flash(cuda, 1, 1, 200, 8, 4, 128, causal=True, window=64)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 63, 64, 200, 448, 1000])
def test_flash_kernel_sequence_lengths(cuda, S):
    _check_flash(cuda, S, 1, S, 8, 8, 128, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 48, 64, 96, 128, 256])
def test_flash_kernel_head_dims_gqa(cuda, hd):
    """Every head dim the wrapper takes (16..96 ride the padded widths 64
    and 128), with two sequences and 4 query heads per kv head."""
    _check_flash(cuda, hd, 2, 200, 8, 2, hd, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(causal=False),
                                dict(causal=True, window=100),
                                dict(causal=True, soft_cap=20.0),
                                dict(causal=False, window=50, soft_cap=30.0)],
                         ids=["noncausal", "window", "softcap", "all"])
def test_flash_kernel_masks_and_soft_cap(cuda, kw):
    _check_flash(cuda, 3, 2, 333, 4, 2, 64, **kw)


@pytest.mark.gpu
def test_flash_kernel_ragged_keys(cuda):
    _check_flash(cuda, 4, 2, 65, 4, 1, 128, Sk=130, causal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 128])
def test_flash_kernel_float32(cuda, hd):
    _check_flash(cuda, 5, 1, 200, 4, 2, hd, dtype=torch.float32, causal=True,
                 window=64)


@pytest.mark.gpu
@pytest.mark.parametrize("prebuilt", [False, True])
def test_block_copy_kernel_matches_plain(cuda, prebuilt):
    g = torch.Generator(device=cuda).manual_seed(2)
    leaves = [torch.randn(4, 64, 16, 2, 32, generator=g,
                          device=cuda).bfloat16() for _ in range(2)]
    want = [leaf.clone() for leaf in leaves]
    src = np.asarray([0, 1, 2, 3, 10, 0], np.int32)
    dst = np.asarray([32, 33, 34, 35, 50, -1], np.int32)
    n = block_copy.launches
    block_copy(leaves, src, dst,
               ptrs=pool_pointers(leaves) if prebuilt else None)
    torch.cuda.synchronize()
    assert block_copy.launches == n + 1
    block_copy_plain(want, src, dst)
    for a, b in zip(leaves, want):
        assert torch.equal(a, b)
