"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips on a machine without a CUDA
device: a CUDA kernel has no CPU mode.  The file imports neither JAX nor
the JAX package, so it runs on a GPU machine without JAX (``--noconftest``
skips ``tests/conftest.py``, which imports JAX):

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

Tolerances: 2e-2 for bf16 outputs (the repo's bf16 tolerance), 1e-4 for
the float32 heat (both sides sum the same float32 products in other
orders), exact equality for block copies.
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
                                                     paged_decode_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


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
    n = paged_decode_attention.launches
    out, heat = paged_decode_attention(q, pk, pv, tbl, lengths,
                                       block_tokens=bt, page_blocks=page_blocks)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n + 1
    ref_out, ref_heat = paged_decode_plain(q, pk, pv, tbl, lengths,
                                           block_tokens=bt,
                                           page_blocks=page_blocks)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(heat, ref_heat, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_flash_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(1, 200, 8, 128, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, 200, 4, 128, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, 200, 4, 128, generator=g, device=cuda).bfloat16()
    n = flash_attention.launches
    o = flash_attention(q, k, v, causal=True, window=64)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    r = flash_attention_plain(q, k, v, causal=True, window=64, chunk=64)
    torch.testing.assert_close(o.float(), r.float(), rtol=2e-2, atol=2e-2)


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
