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
equality for block copies and for the policy-program kernel (int64
arithmetic: every output word of ``policy_exec`` equals its plain
version's, and its decisions, ring events and drops ``PolicyVM``'s).
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_copy.ops import (block_copy, block_copy_plain,
                                                pool_pointers)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_decode_multi, paged_decode_multi_plain,
    paged_decode_partials, paged_decode_partials_plain, paged_decode_plain)


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


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _shard_case(cuda, *, B, H, KVH, hd, MP, dtype, empty_rows=()):
    """One rank's shard: a pool of 4 * MP blocks of 16 tokens, each row's
    MP slots round-robin logical blocks of a 4-shard placement (logical 4j
    + 1 at slot j), some slots not on this shard (-1); lengths 449..512."""
    g = torch.Generator(device=cuda).manual_seed(1)
    bt, NB = 16, 4 * MP

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)
    q, pk, pv = rn(B, H, hd), rn(NB, bt, KVH, hd), rn(NB, bt, KVH, hd)
    tbl = torch.stack([torch.randperm(NB, generator=g, device=cuda)[:MP]
                       for _ in range(B)]).int()
    logical = (4 * torch.arange(MP, device=cuda) + 1).int().expand(
        B, MP).contiguous()
    lengths = torch.randint(449, 513, (B,), generator=g,
                            device=cuda).int()
    tbl[0, -2:] = -1                      # this row's tail is elsewhere
    for b in empty_rows:
        tbl[b] = -1
    return q, pk, pv, tbl, logical, lengths


def _check_partials(q, pk, pv, tbl, lengths, **kw):
    n = paged_decode_partials.launches
    got = paged_decode_partials(q, pk, pv, tbl, lengths, **kw)
    torch.cuda.synchronize()
    assert paged_decode_partials.launches == n + 1
    want = paged_decode_partials_plain(q, pk, pv, tbl, lengths, **kw)
    for name, a, b in zip(("m", "l", "acc", "heat"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _rel(a, b) < (1e-4 if name == "acc" else 1e-5), name
    return got


# ---------------------------------------------------------------------------
# MLA's paged latent decode (csrc/mla_decode.cu)
# ---------------------------------------------------------------------------

def _mla_case(dev, B, lens, mode, *, MB=640, bt=16, H=16, L=512, R=64,
              seed=0):
    """q_eff, q_rope (bf16), a bf16 latent pool, table and lengths: each
    row's blocks private, or the first 512 blocks (an 8,192-token document)
    shared by every row, or private with one unmapped slot ("holes"); a
    table's tail past a row's length unmapped."""
    g = torch.Generator().manual_seed(seed)
    used = [-(-n // bt) for n in lens]
    doc = min(min(used), 512) if mode == "shared" else 0
    NB = doc + B * MB + 1
    pool = torch.randn(NB, bt, L + R, generator=g).to(torch.bfloat16)
    perm = torch.randperm(NB - 1 - doc, generator=g) + doc
    table = torch.full((B, MB), -1, dtype=torch.int32)
    k = 0
    for b in range(B):
        for j in range(used[b]):
            if j < doc:
                table[b, j] = j
            else:
                table[b, j] = perm[k]
                k += 1
        if mode == "holes" and used[b] > 2:
            table[b, 1] = -1
    q_eff = torch.randn(B, H, L, generator=g) * 0.5
    q_rope = (torch.randn(B, H, R, generator=g) * 0.5).to(torch.bfloat16)
    return [t.to(dev) for t in (q_eff, q_rope, pool, table,
                                torch.tensor(lens, dtype=torch.int32))]


def _check_mla(q_eff, q_rope, pool, table, lengths, *, bt=16, scale=0.11472):
    """The kernel against the torch gather.  o_lat within 4e-3 of the
    largest |o_lat|: P enters the value product in bf16 (2^-9 relative a
    weight), q's scores in two bf16 parts (~2^-17); heat within 1e-4
    absolute of a row total of H (float32 sums, the same scores)."""
    from repro_torch.kernels.mla_decode import ops as ma
    n = ma.paged_decode_mla.launches
    kw = dict(block_tokens=bt, kv_lora=q_eff.shape[-1], scale=scale)
    o, heat = ma.paged_decode_mla(q_eff, q_rope, pool, table, lengths, **kw)
    torch.cuda.synchronize()
    assert ma.paged_decode_mla.launches == n + 1
    ref_o, ref_heat = ma.paged_decode_mla_plain(q_eff, q_rope, pool, table,
                                                lengths, **kw)
    assert o.dtype == heat.dtype == torch.float32
    assert heat.shape == table.shape and o.shape == ref_o.shape
    assert torch.isfinite(o).all() and torch.isfinite(heat).all()
    err = float((o - ref_o).abs().max())
    assert err <= 4e-3 * max(float(ref_o.abs().max()), 1e-6), err
    torch.testing.assert_close(heat, ref_heat, rtol=0, atol=1e-4)
    return o, heat


@pytest.mark.gpu
@pytest.mark.parametrize("B,mode", [(1, "private"), (4, "private"),
                                    (4, "holes"), (64, "private"),
                                    (64, "shared"), (64, "holes")])
def test_mla_decode_kernel_matches_gather(cuda, B, mode):
    """Contexts 1 to 10,240 tokens (the cell's 640 blocks of 16), shared
    and private blocks, unmapped slots and tails, inactive rows."""
    g = torch.Generator().manual_seed(B)
    lens = torch.randint(1, 10241, (B,), generator=g).tolist()
    if mode == "shared":
        lens = [8192 + int(x) for x in torch.randint(1, 2048, (B,),
                                                     generator=g)]
    if B > 1:
        lens[0], lens[-1] = 1, 10240
    if B == 64:
        lens[5] = 0                                  # an inactive row
    _check_mla(*_mla_case(cuda, B, lens, mode))


@pytest.mark.gpu
@pytest.mark.parametrize("bt,L,R,H", [(4, 32, 8, 4), (8, 128, 64, 16),
                                      (1, 64, 64, 8)])
def test_mla_decode_kernel_other_shapes(cuda, bt, L, R, H):
    """The smoke model's latents (L 32, R 8, 4 heads, 4-token blocks) and
    other widths and block sizes."""
    _check_mla(*_mla_case(cuda, 3, [5, 61, 30], "holes", MB=64 // bt,
                          bt=bt, H=H, L=L, R=R), bt=bt)


@pytest.mark.gpu
def test_mla_decode_kernel_in_a_captured_graph(cuda):
    """Captured once, replayed with new lengths and table rows written
    into the same device buffers: every replay equals the gather on that
    replay's inputs (the kernel reads both from device memory)."""
    from repro_torch.kernels.mla_decode import ops as ma
    q_eff, q_rope, pool, table, lengths = _mla_case(
        cuda, 8, [100, 2000, 8192, 16, 1, 5000, 10240, 333], "private")
    kw = dict(block_tokens=16, kv_lora=512, scale=0.11472)
    out = {}

    def run():
        out["o"], out["heat"] = ma.paged_decode_mla(q_eff, q_rope, pool,
                                                    table, lengths, **kw)
    run()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    g = torch.Generator().manual_seed(9)
    for step in range(3):
        lengths.copy_(torch.randint(0, 10241, (8,), generator=g,
                                    dtype=torch.int32))
        table.copy_(table[torch.randperm(8, generator=g)])
        graph.replay()
        torch.cuda.synchronize()
        ref_o, ref_heat = ma.paged_decode_mla_plain(q_eff, q_rope, pool,
                                                    table, lengths, **kw)
        err = float((out["o"] - ref_o).abs().max())
        assert err <= 4e-3 * max(float(ref_o.abs().max()), 1e-6), (step,
                                                                  err)
        torch.testing.assert_close(out["heat"], ref_heat, rtol=0,
                                   atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,lens,MB,bt,L,R,H", [
    (4, [40, 7, 0, 10240], 640, 16, 512, 64, 16),
    (3, [5, 61, 30], 16, 4, 32, 8, 4)])
def test_mla_decode_kernel_float32_pool(cuda, B, lens, MB, bt, L, R, H):
    """A float32 latent pool (a float32 model on the card, as the precision
    checks run it) launches the kernel's float32 pass: o_lat within 1e-4 of
    the largest |o_lat| and heat within 1e-4 absolute of the float32
    gather (both in float32 products; the combine's fast exp is good to a
    few ulp of its argument)."""
    from repro_torch.kernels.mla_decode import ops as ma
    q_eff, q_rope, pool, table, lengths = _mla_case(
        cuda, B, lens, "holes", MB=MB, bt=bt, H=H, L=L, R=R)
    q_rope, pool = q_rope.float(), pool.float()
    kw = dict(block_tokens=bt, kv_lora=L, scale=0.11472)
    n = ma.paged_decode_mla.launches
    o, heat = ma.paged_decode_mla(q_eff, q_rope, pool, table, lengths, **kw)
    torch.cuda.synchronize()
    assert ma.paged_decode_mla.launches == n + 1
    ref_o, ref_heat = ma.paged_decode_mla_plain(q_eff, q_rope, pool, table,
                                                lengths, **kw)
    assert torch.isfinite(o).all() and torch.isfinite(heat).all()
    err = float((o - ref_o).abs().max())
    assert err <= 1e-4 * max(float(ref_o.abs().max()), 1e-6), err
    torch.testing.assert_close(heat, ref_heat, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_mla_decode_kernel_refuses_other_pool_dtypes(cuda):
    """A latent pool of neither bf16 nor float32 is refused on the card,
    as an unsupported shape is: nothing falls back to the gather."""
    from repro_torch.kernels.mla_decode import ops as ma
    q_eff, q_rope, pool, table, lengths = _mla_case(
        cuda, 2, [40, 7], "private", MB=8)
    with pytest.raises(ValueError, match="bf16 or float32 pool"):
        ma.paged_decode_mla(q_eff, q_rope, pool.half(), table, lengths,
                            block_tokens=16, kv_lora=512, scale=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    dict(H=32, KVH=32, hd=128, window=None, soft_cap=None),  # deepseek-7b
    dict(H=48, KVH=8, hd=128, window=None, soft_cap=None),   # G 6
    dict(H=16, KVH=8, hd=168, window=100, soft_cap=30.0)])   # gemma-3-like
def test_paged_partials_kernel_matches_plain(cuda, dtype, shape):
    """The shard partials mode at one rank's decode shape: B 4, 16 slots
    of 16 tokens."""
    shape = dict(shape)
    window, cap = shape.pop("window"), shape.pop("soft_cap")
    q, pk, pv, tbl, logical, lengths = _shard_case(
        cuda, B=4, MP=16, dtype=dtype, **shape)
    _check_partials(q, pk, pv, tbl, lengths, block_tokens=16,
                    logical=logical, window=window, soft_cap=cap)


@pytest.mark.gpu
def test_paged_partials_kernel_empty_shard(cuda):
    """A shard holding no block of a row (or of every row): m = -1e30
    and l = acc = heat = 0 there, as the reference's masked partials."""
    for rows in ((1, 3), (0, 1, 2, 3)):
        q, pk, pv, tbl, logical, lengths = _shard_case(
            cuda, B=4, H=32, KVH=32, hd=128, MP=16, dtype=torch.bfloat16,
            empty_rows=rows)
        m, l, acc, heat = _check_partials(q, pk, pv, tbl, lengths,
                                          block_tokens=16, logical=logical)
        for b in rows:
            assert (m[b] == -1e30).all()
            assert not l[b].any() and not acc[b].any() and not heat[b].any()


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
                 hdv=None, **kw):
    g = torch.Generator(device=cuda).manual_seed(seed)
    Sk = S if Sk is None else Sk
    hdv = hd if hdv is None else hdv
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Sk, KVH, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Sk, KVH, hdv, generator=g, device=cuda).to(dtype)
    n = flash_attention.launches
    o = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    assert o.shape == (B, S, H, hdv) and o.is_contiguous()
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


@pytest.mark.gpu
def test_block_copy_kernel_leaves_of_several_depths(cuda):
    """A plain first layer beside a stacked segment (deepseek-MoE's dense
    first layer): leaves [1, NB, ...] and [27, NB, ...] in one launch."""
    g = torch.Generator(device=cuda).manual_seed(3)
    leaves = [torch.randn(r, 64, 16, 2, 32, generator=g,
                          device=cuda).bfloat16() for r in (1, 1, 27, 27)]
    want = [leaf.clone() for leaf in leaves]
    src = np.asarray([0, 1, 2, 3, 9], np.int32)
    dst = np.asarray([40, 41, 42, 43, 60], np.int32)
    ptrs = pool_pointers(leaves)
    assert ptrs.shape == (56,)
    n = block_copy.launches
    block_copy(leaves, src, dst, ptrs=ptrs)
    torch.cuda.synchronize()
    assert block_copy.launches == n + 1
    block_copy_plain(want, src, dst)
    for a, b in zip(leaves, want):
        assert torch.equal(a, b)


# ------------------------------------------------ flash with a query offset
@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("offset", [1, 64, 208, 256])
def test_flash_kernel_query_offset(cuda, hd, window, offset):
    """A suffix prefill's shape: Sq = Sk - offset query rows at absolute
    positions offset.., GQA (4 query heads per kv head), with and without a
    window; the offsets cover a tile boundary and off-tile starts."""
    Sk = 448
    _check_flash(cuda, offset + hd, 2, Sk - offset, 8, 2, hd, Sk=Sk,
                 causal=True, window=window, q_offset=offset)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,offset", [(8, 24, 15), (4, 16, 13),
                                          (192, 448, 256), (70, 130, 61)])
def test_flash_kernel_query_offset_ragged(cuda, dtype, Sq, Sk, offset):
    """Offsets whose last query rows reach past the key stream (a padded
    suffix: offset + Sq > Sk), in both dtypes."""
    _check_flash(cuda, Sq + offset, 1, Sq, 4, 4, 64, dtype=dtype, Sk=Sk,
                 causal=True, q_offset=offset)


@pytest.mark.gpu
def test_flash_kernel_counts_offset_launches(cuda):
    n = flash_attention.offset_launches
    _check_flash(cuda, 7, 1, 64, 4, 4, 64, Sk=128, causal=True, q_offset=64)
    _check_flash(cuda, 8, 1, 64, 4, 4, 64, causal=True)
    assert flash_attention.offset_launches == n + 1


# ------------------------- head dims by padding, and narrower value heads
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [8, 12, 24])
@pytest.mark.parametrize("window", [None, 50])
def test_flash_kernel_padded_head_dims(cuda, dtype, hd, window):
    """The smoke configs' head dims (nemotron-4 8, phi-3 12, MLA's
    query/key 24): float32 has no instance at any of them and bf16 none at
    12, so the launcher zero-pads a copy to the next width and scales by
    the real head dim."""
    _check_flash(cuda, hd, 2, 130, 4, 2, hd, dtype=dtype, causal=True,
                 window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,hdv", [(24, 16), (192, 128)])
@pytest.mark.parametrize("offset", [0, 256])
def test_flash_kernel_narrower_value_heads(cuda, dtype, hd, hdv, offset):
    """MLA's prefill: query/key heads of qk_nope + qk_rope (smoke 16 + 8,
    full width 128 + 64) against value heads of v_head (16, 128), causal,
    and the suffix prefill's query offset."""
    Sk = 448
    _check_flash(cuda, hd + offset, 1, Sk - offset, 16, 16, hd, dtype=dtype,
                 Sk=Sk, hdv=hdv, causal=True, q_offset=offset)


@pytest.mark.gpu
@pytest.mark.parametrize("Sq", [256, 1500])
def test_flash_kernel_whisper_shapes(cuda, Sq):
    """Whisper-medium's non-causal attention over the encoder's 1500
    frames: the cross-attention (Sq = 256 prompt rows) and the encoder's
    own self-attention (1500 x 1500), 16 heads of 64."""
    _check_flash(cuda, Sq, 1, Sq, 16, 16, 64, Sk=1500, causal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 12),
                                      (torch.bfloat16, 20),
                                      (torch.float32, 8),
                                      (torch.float32, 6)])
@pytest.mark.parametrize("window", [None, 100])
def test_paged_kernel_padded_head_dims(cuda, dtype, hd, window):
    """Head dims whose rows are not whole 16-byte chunks (bf16 12 and 20,
    float32 6) read element by element, zero-filled past hd in the
    kernel's loads; float32 8 reads whole chunks.  The pools are read in
    place."""
    g = torch.Generator(device=cuda).manual_seed(hd)
    B, H, KVH, bt, NB, MB = 4, 8, 2, 16, 256, 32
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(dtype)
    pk = torch.randn(NB, bt, KVH, hd, generator=g, device=cuda).to(dtype)
    pv = torch.randn(NB, bt, KVH, hd, generator=g, device=cuda).to(dtype)
    tbl = torch.stack([torch.randperm(NB, generator=g, device=cuda)[:MB]
                       for _ in range(B)]).int()
    tbl[3, 20:] = -1
    lengths = torch.tensor([512, 16 * 9 + 5, 449, 320], dtype=torch.int32,
                           device=cuda)
    _check_paged(q, pk, pv, tbl, lengths, block_tokens=bt, window=window)


@pytest.mark.gpu
def test_block_copy_empty_leaf_list(cuda):
    """A model with no paged pool: block copy moves nothing and launches
    nothing."""
    n = block_copy.launches
    block_copy([], np.asarray([0, 1], np.int32), np.asarray([2, 3], np.int32))
    torch.cuda.synchronize()
    assert block_copy.launches == n


# -------------------------------------------- the policy executor on CUDA
@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ebpf_mm_r8", "ebpf_mm_r64",
                                  "ebpf_mm_r8_traced", "tier_damon",
                                  "tier_edge_admission", "evict_lru",
                                  "profile_wss", "profile_benefit",
                                  "boundary_514"])
def test_cuda_executor_matches_interpreter(cuda, name):
    """The predicated executor on CUDA tensors gives the interpreter's
    decisions, ring events and drops, bit for bit, through the hook
    registry's buckets; both executors default to CUDA."""
    import test_torch_executor as tx
    c = tx.core("repro_torch")
    from repro_torch.core.hooks import HOOK_FAULT, HookRegistry
    maps = tx._maps(c)
    prog = tx._programs(c)[name]
    mat = np.concatenate([tx.ctx_rows(64, 21), tx.edge_rows(22)])
    want = tx._vm_results(c, prog, maps, mat)
    pol = c.PredicatedPolicy(prog, maps, device=cuda)
    tx._check(tx._batch_results(pol, mat), want, f"{name} on CUDA")
    reg = HookRegistry()                      # device None: CUDA
    reg.attach(HOOK_FAULT, prog, maps)
    for n in (1, 4, 5, 16, 33, 64):
        out = reg.run_batch(HOOK_FAULT, mat[:n], discipline=False)
        np.testing.assert_array_equal(out, want[0][:n])
    assert reg._hooks[HOOK_FAULT].pred.device.type == "cuda"
    for executor in (c.PredicatedPolicy, c.JitPolicy):   # device None: CUDA
        assert executor(prog, maps).device.type == "cuda"


@pytest.mark.gpu
def test_cuda_executor_follows_map_reload(cuda):
    """A profile hot-reloaded mid-run (a map write) reaches the CUDA
    executors' device copies of the maps: their fault decisions after each
    reload equal the interpreter's."""
    from test_torch_profiler import check_reload_follows
    check_reload_follows("cuda")


# ------------------------------- the policy-program kernel (policy_exec)
def _exec_case(name, route, cuda):
    """(executor on the card, program, maps) of one program and route."""
    import test_torch_policy_exec as tp
    c = tp.tx.core("repro_torch")
    maps = (c.MapRegistry()
            if name in (tp.OVER_MAX, "ring_overflow", *tp.LONG)
            else tp.tx._maps(c))
    prog = (tp._overflow_program(c) if name == "ring_overflow"
            else tp._long_program(c, *tp.LONG[name]) if name in tp.LONG
            else tp.program(c, name))
    ex = (c.PredicatedPolicy(prog, maps, device=cuda) if route == "pred"
          else c.JitPolicy(prog, maps, device=cuda))
    return ex, prog, maps


def _kernel_vs_plain(ex, ctx):
    """The kernel's output rows and the plain version's on the same CUDA
    inputs, bit for bit, in one launch counted on its route; returns the
    kernel's."""
    from repro_torch.kernels.policy_exec import ops as pe
    n, walk = pe.policy_exec.launches, pe.policy_exec.pc_walk_launches
    out = ex._launch(ctx)
    torch.cuda.synchronize()
    assert pe.policy_exec.launches == n + 1
    # the JIT route's launches are also counted apart
    assert pe.policy_exec.pc_walk_launches == walk + ex._halt_returns_r0
    flat, meta = ex._maps_dev.flat()
    want = pe.policy_exec_plain(ex._table, ctx, flat, meta, rb_cap=ex.rb_cap,
                                fuel=ex._fuel,
                                halt_returns_r0=ex._halt_returns_r0)
    assert torch.equal(out, want)
    return out


def _no_eager(monkeypatch):
    """A CUDA batch must never run an executor's eager body."""
    from repro_torch.core import predicate

    def refuse(self, ctx):
        raise AssertionError("the eager body ran on a CUDA batch")
    import repro_torch.core.jit as jit_mod
    monkeypatch.setattr(jit_mod.JitPolicy, "_run_eager", refuse)
    monkeypatch.setattr(predicate.PredicatedPolicy, "_run_eager", refuse)


_EXEC_PROGRAMS = ("ebpf_mm_r8", "ebpf_mm_r64", "ebpf_mm_r8_traced",
                  "thp_always", "never", "tier_damon", "tier_lru",
                  "tier_never", "tier_heat_band", "tier_edge_admission",
                  "evict_lru", "evict_lfu", "evict_ghost", "profile_wss",
                  "profile_heat_histogram", "profile_benefit", "reclaim_lru",
                  "boundary_512", "boundary_514", "alu_edges",
                  "ring_overflow", "long_3k", "long_7k")


@pytest.mark.gpu
@pytest.mark.parametrize("name,route", [(n, r) for n in _EXEC_PROGRAMS
                                        for r in ("pred", "jit")]
                         + [("over_max_unrolled", "jit")])
def test_policy_exec_kernel_matches_plain(cuda, name, route, monkeypatch):
    """The kernel == its plain version on the card (every output word) ==
    PolicyVM (decisions, ring events, drops), 64 seeded rows plus the
    int64 edge rows, on both routes (the over-long program on the JIT
    route only: its unroll is over MAX_UNROLLED); one launch per
    run_batch and no eager body."""
    import test_torch_executor as tx
    from repro_torch.kernels.policy_exec import ops as pe
    ex, prog, maps = _exec_case(name, route, cuda)
    mat = np.concatenate([tx.ctx_rows(64, 21), tx.edge_rows(22)])
    _kernel_vs_plain(ex, torch.from_numpy(mat).to(cuda))
    _no_eager(monkeypatch)
    n = pe.policy_exec.launches
    tx._check(tx._batch_results(ex, mat),
              tx._vm_results(tx.core("repro_torch"), prog, maps, mat),
              f"{name} {route} on the card")
    assert pe.policy_exec.launches == n + 1


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["pred", "jit"])
def test_policy_exec_kernel_every_batch_size(cuda, route):
    """Every batch size 1..64 (a block of 32 or 64 threads, lanes past B
    idle) and 4,096 lanes (32 blocks), with ring events: kernel == plain
    on the card."""
    import test_torch_executor as tx
    ex, _, _ = _exec_case("ebpf_mm_r8_traced", route, cuda)
    mat = np.concatenate([tx.ctx_rows(4096 - 16, 23), tx.edge_rows(24)])
    ctx = torch.from_numpy(mat).to(cuda)
    for B in list(range(1, 65)) + [4096]:
        _kernel_vs_plain(ex, ctx[:B].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["pred", "jit"])
def test_policy_exec_kernel_follows_map_reload(cuda, route):
    """A map write between two batches reaches the kernel's flat map
    buffer: after each reload, kernel == plain == PolicyVM."""
    import test_torch_executor as tx
    c = tx.core("repro_torch")
    ex, prog, maps = _exec_case("ebpf_mm_r8", route, cuda)
    mat = tx.ctx_rows(64, 25)
    ctx = torch.from_numpy(mat).to(cuda)
    seen = []
    for hot in (None, (0, 64), (128, 256)):
        if hot is not None:
            c.Profile("app", [c.ProfileRegion(*hot, (0, 150_000, 600_000,
                                                     2_500_000))]
                      ).load_into(maps[0])
        _kernel_vs_plain(ex, ctx)
        got = ex.run_batch(mat)
        np.testing.assert_array_equal(got, tx._vm_results(c, prog, maps,
                                                           mat)[0])
        seen.append(got.tolist())
    assert seen[0] != seen[1] != seen[2]




def _with_big_map(c, maps, words: int):
    """``maps`` with a second map of ``words`` int64 registered (seeded
    values): larger flat buffers for the staging paths."""
    big = c.ArrayMap(words, "big")
    big.load(np.random.default_rng(words).integers(-9, 9, words))
    maps.register(big)
    return maps


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["pred", "jit"])
@pytest.mark.parametrize("table_staged,maps_staged",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
def test_policy_exec_kernel_every_staging_path(cuda, route, table_staged,
                                               maps_staged, monkeypatch):
    """Each shared-memory layout `stage_plan` can give (table staged or
    read in place x maps staged or read in place), forced by the budget
    the plan is given, on both routes: kernel == plain, every word, on 129
    rows (two blocks) and on a view 8 bytes off a 16-byte boundary; and ==
    PolicyVM through run_batch."""
    import test_torch_executor as tx
    from repro_torch.kernels.policy_exec import ops as pe
    c = tx.core("repro_torch")
    ex, prog, maps = _exec_case("ebpf_mm_r8_traced", route, cuda)
    _with_big_map(c, maps, 2000)            # maps (19 KB) over the table
    flat, meta = ex._maps_dev.flat()
    mat = np.concatenate([tx.ctx_rows(130 - 16, 41), tx.edge_rows(42)])
    ctx = torch.from_numpy(mat).to(cuda)
    shape = (ex._table.shape[0], 129, flat.numel(), meta.shape[1])
    pe.stage_plan.cache_clear()
    p = pe.stage_plan(*shape)
    try:
        monkeypatch.setattr(pe, "SMEM_BUDGET", (
            p.maps + (p.table - p.maps) * maps_staged
            + (p.smem_bytes - p.table) * table_staged))
        pe.stage_plan.cache_clear()
        plan = pe.stage_plan(*shape)
        assert (plan.table >= 0, plan.maps >= 0) == (table_staged,
                                                     maps_staged)
        _kernel_vs_plain(ex, ctx[:129])
        _kernel_vs_plain(ex, ctx[1:])       # 552 B in: unaligned
        tx._check(tx._batch_results(ex, mat[:129]),
                  tx._vm_results(c, prog, maps, mat[:129]),
                  f"{route}, table staged {table_staged}, maps "
                  f"staged {maps_staged}")
    finally:
        pe.stage_plan.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["pred", "jit"])
@pytest.mark.parametrize("name", ["ebpf_mm_r8", "ring_overflow"])
def test_policy_exec_kernel_block_edges(cuda, name, route):
    """Batches at the warp and block edges (1, 31, 32, 33, 127, 128, 129,
    257 lanes), with no ring (``rb_cap`` 0) and with a ring that
    overflows: kernel == plain, every word."""
    import test_torch_executor as tx
    ex, _, _ = _exec_case(name, route, cuda)
    assert (ex.rb_cap == 0) == (name == "ebpf_mm_r8")
    mat = np.concatenate([tx.ctx_rows(257 - 16, 43), tx.edge_rows(44)])
    ctx = torch.from_numpy(mat).to(cuda)
    for B in (1, 31, 32, 33, 127, 128, 129, 257):
        out = _kernel_vs_plain(ex, ctx[:B])
        if name == "ring_overflow":
            assert (out[:, 2] == 64).all()       # every lane dropped 64


@pytest.mark.gpu
def test_policy_exec_kernel_runs_out_of_fuel(cuda):
    """Lanes the fuel stops: on the JIT route each returns its r0 register
    (fuel 3, 9, 40), on the predicated route 0 (code with no EXIT):
    kernel == plain == the CPU executors."""
    import test_torch_executor as tx
    from repro_torch.core.lower import LIns
    c = tx.core("repro_torch")
    maps = tx._maps(c)
    prog = tx._programs(c)["ebpf_mm_r8"]
    mat = tx.ctx_rows(40, 45)
    ctx = torch.from_numpy(mat).to(cuda)
    jit, jit_cpu = (c.JitPolicy(prog, maps, device=d) for d in (cuda, "cpu"))
    for fuel in (3, 9, 40):
        jit._fuel = jit_cpu._fuel = fuel
        out = _kernel_vs_plain(jit, ctx)
        np.testing.assert_array_equal(out[:, 0].cpu().numpy(),
                                      jit_cpu.run_batch(mat))
        np.testing.assert_array_equal(jit.run_batch(mat),
                                      jit_cpu.run_batch(mat))
    no_exit = (LIns(c.Op.LDCTX, 0, imm=c.CTX.ADDR), LIns(c.Op.ADDI, 0, imm=5))
    pred = c.PredicatedPolicy(prog, maps, code=no_exit, device=cuda)
    assert not _kernel_vs_plain(pred, ctx)[:, 0].any()
    assert not pred.run_batch(mat).any()


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["pred", "jit"])
def test_run_batch_copies_out_of_its_pinned_buffers(cuda, route):
    """Two back-to-back run_batch calls at one bucket with different ctx:
    the first call's decisions and ring rows are its own after the second
    has reused the bucket's pinned buffers; each equals PolicyVM's.  An
    empty batch launches nothing."""
    import test_torch_executor as tx
    from repro_torch.core.lower import collect_rb_events
    from repro_torch.kernels.policy_exec import ops as pe
    c = tx.core("repro_torch")
    ex, prog, maps = _exec_case("ebpf_mm_r8_traced", route, cuda)
    assert ex.rb_cap
    first, second = tx.ctx_rows(16, 47), tx.ctx_rows(16, 48)
    got1 = ex.run_batch(first)
    rb1 = ex._last_rb
    got2 = ex.run_batch(second)
    assert len(ex._staging) == 1                 # one bucket, reused
    want1, want2 = (tx._vm_results(c, prog, maps, m)
                    for m in (first, second))
    assert (want1[0] != want2[0]).any()
    np.testing.assert_array_equal(got1, want1[0])
    np.testing.assert_array_equal(got2, want2[0])
    assert collect_rb_events(*rb1, 16) == (want1[1], want1[2])
    assert ex.take_events(16) == (want2[1], want2[2])
    # an empty batch launches nothing and drops the last batch's events
    ex.run_batch(first)
    n = pe.policy_exec.launches
    assert ex.run_batch(first[:0]).shape == (0,)
    assert pe.policy_exec.launches == n and ex.take_events(16) == ([], 0)


# ------------------------------------ a tiered decode step (combined pool)
@pytest.mark.gpu
def test_tiered_decode_step_tables_past_hbm(cuda):
    """The engine's combined pool: block tables point past num_blocks (into
    the spill tiers' span); the decode step through the kernels matches the
    same step on the plain versions (float32), KV pool included."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import (PagedLayout, cache_init, decode_step,
                                    materialize, model_spec)
    from repro_torch.models.common import F32
    cfg = get_smoke_config("deepseek_7b")
    hbm, spill = 16, 48
    lay = PagedLayout(num_blocks=hbm + spill, block_tokens=4, max_blocks=12)
    params = materialize(torch.Generator(device=cuda).manual_seed(0),
                         model_spec(cfg), device=cuda)
    rng = np.random.default_rng(3)
    tbl = np.full((3, 12), -1, np.int32)
    tbl[0, :10] = rng.choice(np.arange(hbm, hbm + spill), 10, replace=False)
    tbl[1, :6] = rng.choice(hbm, 6, replace=False)
    tbl[2, :9] = np.concatenate([rng.choice(hbm, 3, replace=False),
                                 hbm + 40 + np.arange(6)])
    outs = {}
    for where in ("cuda", "cpu"):
        p = _tree_to(params, where)
        cache = cache_init(cfg, lay, 3, F32, device=where)
        g = torch.Generator().manual_seed(5)
        for leaf in (cache["s0"]["m0"]["pool_k"], cache["s0"]["m0"]["pool_v"]):
            leaf.copy_(torch.randn(leaf.shape, generator=g).to(where))
        lens = torch.tensor([37, 21, 33], dtype=torch.int32, device=where)
        logits, _, heat = decode_step(
            p, cfg, cache, torch.tensor([5, 9, 11], device=where), lens,
            torch.from_numpy(tbl).to(where), lay, compute_dtype=F32)
        outs[where] = (logits.cpu(), heat.cpu(),
                       cache["s0"]["m0"]["pool_k"].cpu())
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


# ------------------------------------- the model families' new kernel shapes
@pytest.mark.gpu
@pytest.mark.parametrize("hd", [40, 72, 168, 200])
@pytest.mark.parametrize("window", [None, 100])
def test_flash_kernel_head_dims_multiple_of_8(cuda, hd, window):
    """bf16 head dims that are multiples of 8 but not of 16 (gemma-3-27b's
    168 among them), zero-padded to the kernel's widths 64, 128, 192 and
    256, with GQA (2 and 7 query heads per kv head) and a window."""
    _check_flash(cuda, hd, 2, 200, 4, 2, hd, causal=True, window=window)
    _check_flash(cuda, hd + 1, 1, 130, 7, 1, hd, causal=True, window=window)


@pytest.mark.gpu
def test_flash_kernel_rejects_other_head_dims(cuda):
    """Every head dim up to 256 runs (zero-padded where no instance has
    it); wider ones raise in both dtypes."""
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(1, 8, 2, 264, device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match=r"head dims \(264, 264\)"):
            flash_attention(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hd", [(6, 128), (7, 128), (2, 168), (6, 96)])
@pytest.mark.parametrize("window", [None, 100])
def test_paged_kernel_idle_head_slots(cuda, G, hd, window):
    """G = 6 and 7 query heads per kv head run the 8-head instance with
    idle slots, which must write no output and add no heat: every output
    row and the heat equal the plain version's (an idle slot's write would
    land on the next group's heads), each row's heat sums to its H heads'
    softmax mass, and a second run gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(G * hd)
    B, KVH, bt, NB, MB = 4, 2, 16, 256, 32
    H = G * KVH
    q = torch.randn(B, H, hd, generator=g, device=cuda).bfloat16()
    pk = torch.randn(NB, bt, KVH, hd, generator=g, device=cuda).bfloat16()
    pv = torch.randn(NB, bt, KVH, hd, generator=g, device=cuda).bfloat16()
    tbl = torch.stack([torch.randperm(NB, generator=g, device=cuda)[:MB]
                       for _ in range(B)]).int()
    tbl[3, 20:] = -1
    lengths = torch.tensor([512, 16 * 9 + 5, 449, 320], dtype=torch.int32,
                           device=cuda)
    out, heat = _check_paged(q, pk, pv, tbl, lengths, block_tokens=bt,
                             window=window)
    # heat sums every real head's softmax mass: H per row
    torch.testing.assert_close(heat.sum(-1), torch.full(
        (B,), float(H), device=cuda), rtol=1e-4, atol=1e-3)
    # an idle slot writing would race a neighbour group's heads: a second
    # run must give the same bits
    out2, heat2 = paged_decode_attention(q.clone(), pk, pv, tbl, lengths,
                                         block_tokens=bt, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out2, out) and torch.equal(heat2, heat)


@pytest.mark.gpu
@pytest.mark.parametrize("mlp", ["swiglu", "relu2"])
def test_moe_on_cuda_is_deterministic(cuda, mlp):
    """``moe_apply`` on CUDA tensors gives bit-identical outputs across runs
    (the ordered combine: no atomics), with routes dropped at a forced
    capacity, and agrees with the same call on the CPU within bf16's
    tolerance."""
    from repro_torch.configs.base import MoECfg
    from repro_torch.models.common import materialize
    from repro_torch.models.moe import moe_apply, moe_spec
    cfg = MoECfg(num_experts=64, top_k=6, d_ff_expert=96, num_shared=2)
    params = materialize(torch.Generator(device=cuda).manual_seed(0),
                         moe_spec(256, cfg, mlp), device=cuda,
                         dtype=torch.bfloat16)
    x = torch.randn(448, 256, generator=torch.Generator(device=cuda)
                    .manual_seed(1), device=cuda).bfloat16()
    for cap in (None, 16):
        runs = [moe_apply(params, x, cfg, mlp, capacity=cap)[0]
                for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(runs[0], r) for r in runs[1:]), cap
        cpu, _ = moe_apply(_tree_to(params, "cpu"), x.cpu(), cfg, mlp,
                           capacity=cap)
        torch.testing.assert_close(runs[0].cpu().float(), cpu.float(),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["nemotron_4_15b", "phi3_mini_3p8b",
                                  "gemma3_27b", "deepseek_moe_16b",
                                  "qwen2_vl_7b", "deepseek_v2_lite_16b",
                                  "mamba2_1p3b", "jamba_v0_1_52b",
                                  "whisper_medium"])
def test_family_prefill_decode_kernels_match_plain(cuda, arch):
    """Each family's smoke model, at its own head dims (nemotron-4's 8,
    phi-3's 12, MLA's 24 / 16 run zero-padded), through the kernels against
    the same run on the plain versions (float32): prefill logits, decode
    logits and heat over a few steps, and every cache leaf (pools, MLA
    latents, Whisper's cross-attention K/V)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import (PagedLayout, cache_init, decode_step,
                                    materialize, model_spec, prefill_step)
    from repro_torch.models.common import F32
    from repro_torch.models.decode import slot_cache_view
    cfg = get_smoke_config(arch)
    lay = PagedLayout(num_blocks=64, block_tokens=4, max_blocks=16)
    params = materialize(torch.Generator(device=cuda).manual_seed(0),
                         model_spec(cfg), device=cuda)
    outs = {}
    for where in ("cuda", "cpu"):
        p = _tree_to(params, where)
        cache = cache_init(cfg, lay, 2, F32, device=where)
        tbl = torch.full((2, 16), -1, dtype=torch.int32, device=where)
        tbl[0, :10] = torch.arange(10)
        tbl[1, :10] = torch.arange(20, 30)
        toks = torch.arange(1, 33, device=where).reshape(2, 16) * 7
        kw = {}
        if cfg.vlm_patches:
            kw = dict(patches=torch.ones(1, cfg.vlm_patches, cfg.d_model,
                                         device=where) * 0.1,
                      pos3d=torch.arange(16, device=where).expand(3, 1, 16))
        if cfg.enc_dec:
            kw = dict(frames=torch.randn(
                1, cfg.enc_frames, cfg.d_model,
                generator=torch.Generator().manual_seed(1)).to(where))
        logits = [prefill_step(p, cfg, slot_cache_view(cache, i),
                               toks[i:i + 1], tbl[i:i + 1], lay,
                               compute_dtype=F32, **kw)[0]
                  for i in range(2)]
        lens = torch.tensor([16, 16], dtype=torch.int32, device=where)
        heats = []
        for step in range(6):
            dkw = {}
            if cfg.vlm_patches:
                dkw = dict(pos3d=lens[None, :, None].expand(3, 2, 1))
            lg, _, h = decode_step(p, cfg, cache, toks[:, step] + 1, lens,
                                   tbl, lay, compute_dtype=F32, **dkw)
            logits.append(lg)
            heats.append(h)
            lens = lens + 1
        outs[where] = (torch.cat(logits).cpu(), torch.stack(heats).cpu(),
                       torch.cat([x.reshape(-1) for x in
                                  _cache_leaves(cache)]).cpu())
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


def _cache_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _cache_leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# Training: the forward's LSE and the backward kernels
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KVH, hd, hdv, causal, window, soft cap)
BWD_CASES = {
    "main_causal": (2, 200, 200, 4, 4, 128, 128, True, None, None),
    "gqa6": (1, 150, 150, 12, 2, 128, 128, True, None, None),
    "window_hd168": (1, 260, 260, 4, 2, 168, 168, True, 100, None),
    "mla_192_128": (1, 130, 130, 4, 4, 192, 128, True, None, None),
    "whisper_noncausal": (2, 150, 150, 4, 4, 64, 64, False, None, None),
    "cross_sq_ne_sk": (1, 70, 150, 4, 4, 64, 64, False, None, None),
    "hd256": (1, 100, 100, 2, 1, 256, 256, True, None, None),
    "smoke_hd12": (2, 33, 33, 4, 2, 12, 12, True, None, None),
    "soft_cap": (1, 90, 90, 4, 2, 64, 64, True, None, 20.0),
    # many query and key tiles: the dkdv ring over (head, query tile)
    # steps and the heaviest-first order; S 1000 ends in a ragged tile
    "mha128_s1024": (1, 1024, 1024, 8, 8, 128, 128, True, None, None),
    "gqa4_hd64_s1024": (1, 1024, 1024, 8, 2, 64, 64, True, None, None),
    "s1000": (1, 1000, 1000, 4, 4, 128, 128, True, None, None),
}
BWD_DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                     ids=["f32", "bf16"])


def _bwd_inputs(cuda, case, dtype, seed=0):
    B, Sq, Sk, H, KVH, hd, hdv, causal, window, cap = BWD_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, soft_cap=cap)
    return (rn(B, Sq, H, hd), rn(B, Sk, KVH, hd), rn(B, Sk, KVH, hdv),
            rn(B, Sq, H, hdv), kw)


def _close_to_max(got, want, tol):
    """max |got - want| <= tol * max |want| (each tensor's own scale)."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), (err, tol)


@pytest.mark.gpu
@BWD_DTYPES
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_lse_matches_plain(cuda, dtype, case):
    q, k, v, _, kw = _bwd_inputs(cuda, case, dtype)
    out, lse = fa_ops._forward(q, k, v, chunk=64, return_lse=True, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_plain(q, k, v, chunk=64,
                                             return_lse=True, **kw)
    assert lse.shape == ref_lse.shape and lse.dtype == torch.float32
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out.float(), ref_out.float(),
                               rtol=_tols(dtype)[0], atol=_tols(dtype)[1])


@pytest.mark.gpu
@BWD_DTYPES
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_kernels_match_plain(cuda, dtype, case):
    q, k, v, dout, kw = _bwd_inputs(cuda, case, dtype)
    out, lse = flash_attention_plain(q, k, v, chunk=64, return_lse=True,
                                     **kw)
    out = out.contiguous()           # the plain version may return a view
    n = [f.launches for f in (fa_ops.flash_bwd_preprocess,
                              fa_ops.flash_bwd_dkdv, fa_ops.flash_bwd_dq)]
    got = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    assert [f.launches for f in (fa_ops.flash_bwd_preprocess,
                                 fa_ops.flash_bwd_dkdv,
                                 fa_ops.flash_bwd_dq)] == [x + 1 for x in n]
    want = fa_ops.flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                            chunk=64, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        _close_to_max(g, w, tol)


@pytest.mark.gpu
@BWD_DTYPES
@pytest.mark.parametrize("case", ["main_causal", "gqa6", "mla_192_128",
                                  "cross_sq_ne_sk"])
def test_flash_on_cuda_has_a_backward(cuda, dtype, case):
    """The repaired fault: a CUDA flash call on inputs that require grad
    returns a tensor with a grad_fn, and its q/k/v gradients are those of
    the plain path's autograd on the same inputs."""
    q, k, v, dout, kw = _bwd_inputs(cuda, case, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n_fwd = flash_attention.launches
    out = flash_attention(*leaves, **kw)
    assert out.grad_fn is not None and flash_attention.launches == n_fwd + 1
    got = torch.autograd.grad(out, leaves, dout)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        flash_attention_plain(*plain, chunk=64, **kw), plain, dout)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for g, w in zip(got, want):
        _close_to_max(g, w, tol)


@pytest.mark.gpu
@BWD_DTYPES
def test_flash_bwd_is_deterministic(cuda, dtype):
    q, k, v, dout, kw = _bwd_inputs(cuda, "gqa6", dtype)
    out, lse = fa_ops._forward(q, k, v, chunk=64, return_lse=True, **kw)
    a = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    b = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mha128_s1024", "gqa4_hd64_s1024"])
def test_flash_bwd_bf16_is_deterministic_at_s1024(cuda, case):
    q, k, v, dout, kw = _bwd_inputs(cuda, case, torch.bfloat16)
    out, lse = fa_ops._forward(q, k, v, chunk=64, return_lse=True, **kw)
    a = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    b = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["main_causal", "gqa6", "whisper_noncausal",
                                  "cross_sq_ne_sk", "smoke_hd12", "soft_cap",
                                  "mha128_s1024", "gqa4_hd64_s1024", "s1000"])
def test_flash_bwd_bf16_takes_the_tensor_core_route(cuda, case):
    """bf16 calls at head dims up to 128 run the wgmma kernels: the route
    counters of both wrappers move."""
    q, k, v, dout, kw = _bwd_inputs(cuda, case, torch.bfloat16)
    out, lse = fa_ops._forward(q, k, v, chunk=64, return_lse=True, **kw)
    assert fa_ops._bwd_plan(q.shape[-1], v.shape[-1], q.dtype).route == \
        "wgmma"
    wrappers = (fa_ops.flash_bwd_dkdv, fa_ops.flash_bwd_dq)
    before = [dict(f.routes) for f in wrappers]
    fa_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    for f, n in zip(wrappers, before):
        assert f.routes == {"wgmma": n["wgmma"] + 1, "fma": n["fma"]}


@pytest.mark.gpu
def test_flash_bwd_library_runs_on_tensor_cores(cuda):
    """libflash_attention_bwd.so holds HGMMA (wgmma) instructions."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    if not tool.exists():
        pytest.skip("no cuobjdump in the CUDA toolkit")
    build.build_all(["flash_attention_bwd"])
    sass = subprocess.run(
        [str(tool), "-sass", str(build._build_dir()
                                 / "libflash_attention_bwd.so")],
        capture_output=True, text=True, check=True).stdout
    assert sum(tok.split(".")[0] == "HGMMA" for line in sass.splitlines()
               for tok in line.split()) > 0


@pytest.mark.gpu
def test_flash_bwd_rejects_what_it_cannot_take(cuda):
    q, k, v, dout, kw = _bwd_inputs(cuda, "smoke_hd12", torch.float32)
    out, lse = fa_ops._forward(q, k, v, chunk=64, return_lse=True, **kw)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q.clone().requires_grad_(), k, v, q_offset=4)
    with pytest.raises(ValueError):            # lse of the wrong shape
        fa_ops.flash_attention_bwd(q, k, v, out, dout, lse[:, :1], **kw)
    with pytest.raises(ValueError):            # mixed dtypes
        fa_ops.flash_attention_bwd(q, k, v, out, dout.bfloat16(), lse, **kw)
    wide = torch.zeros(1, 8, 1, 264, device=cuda)
    with pytest.raises(ValueError, match="256"):
        fa_ops.flash_attention_bwd(wide, wide, wide, wide, wide,
                                   torch.zeros(1, 1, 8, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek_7b", "deepseek_v2_lite_16b",
                                  "gemma3_27b", "whisper_medium"])
def test_smoke_model_grads_on_cuda_match_cpu(cuda, arch):
    """A smoke model's float32 loss and gradients through the kernels
    (forward and backward) against the same on the CPU's plain versions."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import lm_loss, materialize, model_spec
    from repro_torch.optim.adamw import tree_leaves, tree_map
    cfg = get_smoke_config(arch)
    params = materialize(torch.Generator().manual_seed(0), model_spec(cfg),
                         device="cpu")
    res = {}
    for where in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(where).requires_grad_(), params)
        batch = synthetic_batch(cfg, 2, 32, 0, device=where)
        n = fa_ops.flash_bwd_dq.launches
        loss, _ = lm_loss(p, cfg, batch, compute_dtype=torch.float32,
                          chunk=16)
        grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                    materialize_grads=True)
        if where == "cuda":
            assert fa_ops.flash_bwd_dq.launches > n
        res[where] = (loss.item(), [g.cpu() for g in grads])
    np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-4)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        _close_to_max(a, b, 1e-3)


# ---------------------------------------------------------------------------
# The engine's compiled decode entry: one CUDA graph per engine
# ---------------------------------------------------------------------------

SERVED_ARCHS = ["deepseek_7b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
                "gemma3_27b", "qwen2_vl_7b", "nemotron_4_15b",
                "phi3_mini_3p8b", "mamba2_1p3b", "jamba_v0_1_52b",
                "whisper_medium"]


def _graph_case(cuda, arch, seed=0, dtype=None):
    """A smoke model on the card (its params in ``dtype``, by default the
    spec's float32), a bf16 cache with every leaf drawn from a seed (pools,
    MLA latents, mamba state, Whisper's cross K/V), a table of distinct
    blocks per row and ``steps`` of inputs with one inactive row."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import (PagedLayout, cache_init, materialize,
                                    model_spec)
    cfg = get_smoke_config(arch)
    lay = PagedLayout(num_blocks=64, block_tokens=4, max_blocks=16)
    g = torch.Generator(device=cuda).manual_seed(seed)
    params = materialize(g, model_spec(cfg), device=cuda, dtype=dtype)
    cache = cache_init(cfg, lay, 3, device=cuda)
    for key, seg in cache.items():
        for mem in (seg.values() if key.startswith("s") else [seg]):
            for leaf in mem.values():
                leaf.copy_(torch.randn(leaf.shape, generator=g, device=cuda))
    rng = np.random.default_rng(seed)
    table = np.full((3, 16), -1, np.int32)
    table[:, :8] = rng.permutation(64)[:24].reshape(3, 8)
    lengths = rng.integers(5, 31, 3).astype(np.int32)
    tokens = rng.integers(1, cfg.vocab, 3).astype(np.int32)
    return cfg, params, cache, lay, table, lengths, tokens


def _clone_cache(cache):
    return {k: ({j: {n: t.clone() for n, t in m.items()}
                 for j, m in seg.items()} if k.startswith("s")
                else {n: t.clone() for n, t in seg.items()})
            for k, seg in cache.items()}


def _named_leaves(cache):
    return [(k, n, t) for k, seg in sorted(cache.items())
            for m in (seg.values() if k.startswith("s") else [seg])
            for n, t in sorted(m.items())]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_decode_graph_replay_matches_eager_decode(cuda, arch):
    """Three replays of the captured step against three eager calls of
    the same entry on a copy of the cache: logits, heat and every cache
    leaf bit for bit, hence the same greedy tokens."""
    from repro_torch.serving.compiled import DecodeGraph, decode_entry
    cfg, params, cache, lay, table, lengths, tokens = _graph_case(cuda, arch)
    ref = _clone_cache(cache)
    tb = torch.from_numpy(table).to(cuda)
    graph = DecodeGraph(cfg, params, cache, tb.clone(), lay)
    assert graph.graph is not None and graph.pool_bytes >= 0
    # the capture's warm-up wrote no KV and put the per-slot state back
    for (k, n, a), (_, _, b) in zip(_named_leaves(cache), _named_leaves(ref)):
        assert torch.equal(a, b), (k, n)
    active = np.array([True, False, True])
    for step in range(3):
        lg, heat = graph(tokens, lengths, active)
        want, want_heat = decode_entry(
            params, cfg, ref, tb, lay, torch.from_numpy(tokens).to(cuda),
            torch.from_numpy(lengths).to(cuda),
            torch.from_numpy(active).to(cuda))
        want, want_heat = want.cpu().numpy(), want_heat.cpu().numpy()
        diff = np.abs(lg - want).max()
        assert np.array_equal(lg, want), f"step {step}: logits differ by " \
            f"up to {diff}"
        assert np.array_equal(heat, want_heat), step
        assert np.array_equal(lg.argmax(-1), want.argmax(-1))
        tokens = want.argmax(-1).astype(np.int32)
        lengths = lengths + 1
    torch.cuda.synchronize()
    for (k, n, a), (_, _, b) in zip(_named_leaves(cache), _named_leaves(ref)):
        assert torch.equal(a, b), (k, n)


@pytest.mark.gpu
def test_decode_graph_counts_launches_on_replay(cuda):
    """A replay calls no wrapper: the capture's launches per step are
    added to the counts on every replay, and the capture adds none."""
    from repro_torch.models import build_layer_plans
    from repro_torch.serving.compiled import DecodeGraph
    cfg, params, cache, lay, table, lengths, tokens = _graph_case(
        cuda, "deepseek_7b")
    n_attn = sum(1 for p in build_layer_plans(cfg) if p.kind != "mamba")
    graph = DecodeGraph(cfg, params, cache, torch.from_numpy(table).to(cuda),
                        lay)
    assert graph.per_replay == {(paged_decode_attention, "launches"): n_attn}
    n = paged_decode_attention.launches
    for _ in range(3):
        graph(tokens, lengths, np.ones(3, bool))
    assert paged_decode_attention.launches == n + 3 * n_attn


@pytest.mark.gpu
def test_decode_graph_warms_up_under_sync_debug_error(cuda, monkeypatch):
    """The warm-up calls after the first run with the sync debug mode at
    "error"; the mode is put back after the capture."""
    from repro_torch.serving.compiled import DecodeGraph
    cfg, params, cache, lay, table, *_ = _graph_case(cuda, "gemma3_27b")
    modes = []
    real = DecodeGraph._write_out

    def write_out(self):
        modes.append(torch.cuda.get_sync_debug_mode())
        real(self)
    monkeypatch.setattr(DecodeGraph, "_write_out", write_out)
    before = torch.cuda.get_sync_debug_mode()
    DecodeGraph(cfg, params, cache, torch.from_numpy(table).to(cuda), lay)
    assert modes[1:3] == [2, 2] and len(modes) == 4
    assert torch.cuda.get_sync_debug_mode() == before


@pytest.mark.gpu
def test_decode_graph_capture_fails_on_a_host_sync(cuda, monkeypatch):
    """A step that syncs with the host (the masked KV append it replaced)
    fails the capture, naming the op; nothing falls back."""
    from repro_torch.models import decode as port_decode
    from repro_torch.serving.compiled import DecodeGraph
    cfg, params, cache, lay, table, *_ = _graph_case(cuda, "deepseek_7b")

    def masked(pool, new_kv, block_table, lengths, *, block_tokens):
        blk = (lengths // block_tokens).long()
        raw = torch.gather(block_table, 1, blk[:, None])[:, 0].long()
        ok = raw >= 0
        pool[raw[ok], (lengths % block_tokens).long()[ok]] = \
            new_kv[ok].to(pool.dtype)
        return pool
    monkeypatch.setattr(port_decode, "write_token_kv", masked)
    with pytest.raises(RuntimeError, match="syncs with the host at aten"):
        DecodeGraph(cfg, params, cache, torch.from_numpy(table).to(cuda),
                    lay)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_engine_replays_the_graph_and_matches_eager(cuda, arch,
                                                    monkeypatch):
    """A smoke engine on the card decodes through its captured graph; the
    same requests through an eager entry (the graph's class without its
    capture) give the same tokens and MMStats."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import PagedLayout, materialize, model_spec
    from repro_torch.serving import Request, ServingEngine, compiled
    from repro_torch.serving import engine as engine_mod
    cfg = get_smoke_config(arch)
    params = materialize(torch.Generator(device=cuda).manual_seed(0),
                         model_spec(cfg), device=cuda)
    lay = PagedLayout(num_blocks=64, block_tokens=4, max_blocks=16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, 9 + r).tolist() for r in range(4)]

    class Eager(compiled.DecodeGraph):
        def _capture(self):
            pass

    runs = {}
    for route in ("graph", "eager"):
        if route == "eager":
            monkeypatch.setattr(engine_mod, "DecodeGraph", Eager)
        eng = ServingEngine(cfg, params, lay, max_batch=3, policy="thp")
        assert (eng._decode.graph is not None) == (route == "graph")
        for r, p in enumerate(prompts):
            eng.submit(Request(rid=r, prompt=p, max_new_tokens=6))
        out = eng.run(max_steps=100)
        runs[route] = (eng.finished, out["mm"])
    assert runs["graph"] == runs["eager"]


# ---------------------------------------------------------------------------
# The engine's compiled prefill entries: one CUDA graph per padded shape
# ---------------------------------------------------------------------------

def _modal(cfg, cuda):
    """The engine's modality inputs (``ServingEngine._modality_kwargs``)
    without an engine."""
    import functools
    import types
    from repro_torch.serving import ServingEngine
    owner = types.SimpleNamespace(cfg=cfg, device=cuda, _modal={})
    return functools.partial(ServingEngine._modality_kwargs, owner)


def _prefill_case(cuda, arch, seed=0, dtype=None):
    """``_graph_case``'s model, cache and table, an entry over them and a
    copy of the cache for the eager calls."""
    from repro_torch.serving.compiled import PrefillGraphs
    cfg, params, cache, lay, table, *_ = _graph_case(cuda, arch, seed, dtype)
    tb = torch.from_numpy(table).to(cuda)
    ref = _clone_cache(cache)
    modal = _modal(cfg, cuda)
    return cfg, params, cache, ref, lay, tb, modal, PrefillGraphs(
        cfg, params, cache, tb, lay, modal)


def _i32(values, cuda):
    return torch.tensor(values, dtype=torch.int32, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_prefill_graph_replay_matches_eager_entry(cuda, arch):
    """A full prefill through the captured graph of its padded length, at
    two lengths (4 and 8 blocks), against the eager entry on a copy of the
    cache: logits and every cache leaf (pools, per-slot state) bit for
    bit; the capture's warm-up wrote nothing."""
    from repro_torch.serving.compiled import prefill_entry, stage_cache
    cfg, params, cache, ref, lay, tb, modal, pg = _prefill_case(cuda, arch)
    rng = np.random.default_rng(1)
    for n in (13, 29):
        prompt = rng.integers(1, cfg.vocab, n).astype(np.int32)
        lg = pg.full(prompt, 1).copy()
        S = -(-n // 4) * 4
        toks = np.zeros((1, S), np.int32)
        toks[0, :n] = prompt
        want = prefill_entry(params, cfg, ref, stage_cache(ref), tb[1:2],
                             lay, torch.from_numpy(toks).to(cuda),
                             _i32([n - 1], cuda), _i32([1], cuda).long(),
                             **modal(S)).cpu().numpy()[0]
        assert np.array_equal(lg, want), \
            f"{n} tokens: logits differ by up to {np.abs(lg - want).max()}"
        torch.cuda.synchronize()
        for (k, nm, a), (_, _, b) in zip(_named_leaves(cache),
                                         _named_leaves(ref)):
            assert torch.equal(a, b), (n, k, nm)
    assert sorted(pg.graphs) == [("full", 4), ("full", 8)]
    assert all(g is not None and g.calls == 1 for g in pg.graphs.values())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek_7b", "deepseek_v2_lite_16b",
                                  "gemma3_27b"])
def test_prefill_graph_suffix_at_two_offsets_matches_eager(cuda, arch):
    """Two prefix-cache hits of one (suffix blocks, key blocks) shape at
    prefix lengths 13 and 15 replay one graph, whose flash launches read
    the offset from device memory, against the eager suffix entry with the
    host int offset: logits and every pool cell bit for bit; each replay
    adds one offset launch per layer."""
    from repro_torch.models import build_layer_plans
    from repro_torch.models.decode import prefill_suffix_step
    cfg, params, cache, ref, lay, tb, _, pg = _prefill_case(cuda, arch, 2)
    n_attn = len(build_layer_plans(cfg))
    prompt = np.random.default_rng(3).integers(1, cfg.vocab, 29).astype(
        np.int32)
    for plen in (13, 15):
        n0 = fa_ops.flash_attention.offset_launches
        lg = pg.suffix(prompt, 0, plen).copy()
        assert fa_ops.flash_attention.offset_launches == n0 + n_attn
        toks = np.zeros((1, 16), np.int32)
        toks[0, :29 - plen] = prompt[plen:]
        want, _ = prefill_suffix_step(
            params, cfg, ref, torch.from_numpy(toks).to(cuda), tb[0:1], lay,
            prefix_len=plen, key_blocks=8, chunk=256,
            last_index=torch.tensor([28 - plen], device=cuda))
        want = want.cpu().numpy()[0]
        assert np.array_equal(lg, want), \
            f"prefix {plen}: logits differ by up to {np.abs(lg - want).max()}"
        torch.cuda.synchronize()
        for (k, nm, a), (_, _, b) in zip(_named_leaves(cache),
                                         _named_leaves(ref)):
            assert torch.equal(a, b), (plen, k, nm)
    assert list(pg.graphs) == [("suffix", 4, 8)]
    assert pg.graphs[("suffix", 4, 8)].calls == 2


@pytest.mark.gpu
def test_prefill_graph_capture_fails_on_a_host_sync(cuda, monkeypatch):
    """A prefill that syncs with the host (the masked KV scatter it
    replaced) fails the capture, naming the entry and the op; nothing
    falls back."""
    from repro_torch.models import decode as port_decode

    def masked(pool, kv_seq, block_table, *, block_tokens):
        B, S = kv_seq.shape[:2]
        nb = S // block_tokens
        kvb = kv_seq.reshape((B * nb, block_tokens) + kv_seq.shape[2:])
        tbl = block_table[:, :nb].reshape(-1).long()
        ok = tbl >= 0
        pool[tbl[ok]] = kvb[ok].to(pool.dtype)
        return pool
    monkeypatch.setattr(port_decode, "write_prefill_kv", masked)
    cfg, *_, pg = _prefill_case(cuda, "deepseek_7b")
    with pytest.raises(RuntimeError, match="the prefill entry at 4 blocks "
                                           "syncs with the host at aten"):
        pg.full(np.arange(1, 14, dtype=np.int32), 1)


@pytest.mark.gpu
def test_prefill_graph_second_length_shares_the_pool(cuda):
    """All of an entry's graphs share one memory pool: a second, shorter
    length captured after the first reserves less than the same length
    captured alone in a pool of its own."""
    from repro_torch.serving.compiled import PrefillGraphs
    cfg, params, cache, _, lay, tb, modal, pg = _prefill_case(cuda,
                                                              "deepseek_7b")
    prompt = np.arange(1, 30, dtype=np.int32)
    pg.full(prompt, 1)
    pg.full(prompt[:13], 1)
    alone = PrefillGraphs(cfg, params, cache, tb, lay, modal)
    alone.full(prompt[:13], 1)
    first, shared = pg.graphs[("full", 8)], pg.graphs[("full", 4)]
    own = alone.graphs[("full", 4)]
    assert first.pool_bytes > 0 and own.pool_bytes > 0
    assert shared.pool_bytes < own.pool_bytes


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "deepseek_v2_lite_16b"])
def test_prefill_graph_primer_reserves_an_expert_models_pool(cuda, arch):
    """An entry of a model with an expert layer captures the longest full
    prefill (the layout's 16 blocks) first, into the shared pool, and
    never replays it; two shorter lengths captured after it, the shorter
    last, reserve less than it did together (their replays against the
    eager entry: ``test_prefill_graph_replay_matches_eager_entry``).  A
    dense model's entry has no primer."""
    cfg, params, cache, ref, lay, tb, modal, pg = _prefill_case(cuda, arch)
    rng = np.random.default_rng(2)
    for n in (29, 13):
        pg.full(rng.integers(1, cfg.vocab, n).astype(np.int32), 1)
    assert pg.primer is not None and pg.primer.calls == 0
    assert pg.primer.pool_bytes > 0
    assert sorted(pg.graphs) == [("full", 4), ("full", 8)]
    assert sum(g.pool_bytes for g in pg.graphs.values()) < \
        pg.primer.pool_bytes
    *_, dense = _prefill_case(cuda, "deepseek_7b")
    dense.full(np.arange(1, 14, dtype=np.int32), 1)
    assert dense.primer is None


@pytest.mark.gpu
@pytest.mark.parametrize("arch,prefix", [(a, False) for a in SERVED_ARCHS]
                         + [("deepseek_7b", True),
                            ("deepseek_v2_lite_16b", True)])
def test_engine_prefill_graphs_match_eager(cuda, arch, prefix, monkeypatch):
    """A smoke engine on the card prefills through its graphs (and decodes
    through its own); the same requests with both entries eager give the
    same tokens and MMStats.  With the prefix cache
    on, shared prompts hit and prefill their suffixes through the suffix
    graphs."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import PagedLayout, materialize, model_spec
    from repro_torch.serving import Request, ServingEngine, compiled
    from repro_torch.serving import engine as engine_mod
    cfg = get_smoke_config(arch)
    params = materialize(torch.Generator(device=cuda).manual_seed(0),
                         model_spec(cfg), device=cuda)
    lay = PagedLayout(num_blocks=64, block_tokens=4, max_blocks=16)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab, 9).tolist()
    prompts = [(shared if prefix else []) + rng.integers(
        1, cfg.vocab, 9 + r).tolist() for r in range(4)]

    class EagerDecode(compiled.DecodeGraph):
        def _capture(self):
            pass

    class EagerPrefill(compiled.PrefillGraphs):
        def _capture(self, key, run):
            return None

    runs = {}
    for route in ("graph", "eager"):
        if route == "eager":
            monkeypatch.setattr(engine_mod, "DecodeGraph", EagerDecode)
            monkeypatch.setattr(engine_mod, "PrefillGraphs", EagerPrefill)
        eng = ServingEngine(cfg, params, lay, max_batch=3, policy="thp",
                            prefix_cache=prefix)
        for r, p in enumerate(prompts):
            eng.submit(Request(rid=r, prompt=p, max_new_tokens=6))
            if prefix:
                eng.run(max_steps=100)
        out = eng.run(max_steps=100)
        graphs = eng._prefill.graphs
        assert graphs and all((g is not None) == (route == "graph")
                              for g in graphs.values())
        if prefix:
            assert out["prefix_cache"]["hits"] >= 2
            assert any(k[0] == "suffix" for k in graphs)
        runs[route] = (eng.finished, out["mm"])
    assert runs["graph"] == runs["eager"]


# ---------------------------------------------------------------------------
# The engine's own tracing on the card: device spans on the telemetry clock
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_engine_traces_device_spans_on_the_card(cuda):
    """A traced smoke engine on the card (batched faults, the prefix cache,
    a tiered pool): the same tokens and MMStats as an untraced one; every
    graph capture a ``capture`` span holding ``capture-warm`` and
    ``capture-graph``; every ``dev decode`` / ``dev prefill`` span inside
    its host ``graph`` span to within 50 us at each end; ``dev policy``
    spans for the fault batches; nothing left pending after the run's
    last synchronisation but the copies launched after it."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core import Profile, ProfileRegion
    from repro_torch.models import PagedLayout, materialize, model_spec
    from repro_torch.obs import idle_by_phase
    from repro_torch.serving import Request, ServingEngine
    cfg = get_smoke_config("deepseek_7b")
    params = materialize(torch.Generator(device=cuda).manual_seed(0),
                         model_spec(cfg), device=cuda)
    lay = PagedLayout(num_blocks=64, block_tokens=4, max_blocks=16)
    prof = Profile("chat", [ProfileRegion(0, 4, (0, 150_000, 600_000, 0))])
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab, 12).tolist()
    prompts = [shared + rng.integers(1, cfg.vocab, 5 + r).tolist()
               for r in range(5)]
    runs = {}
    for trace in (False, True):
        eng = ServingEngine(cfg, params, lay, max_batch=3, policy="ebpf",
                            profile=prof, prefix_cache=16, host_blocks=32,
                            trace=trace, device=cuda)
        for r, p in enumerate(prompts):
            eng.submit(Request(rid=r, prompt=p, max_new_tokens=7,
                               app="chat"))
        out = eng.run(max_steps=200)
        runs[trace] = (eng.finished, out["mm"], out["engine"]["steps"])
    assert runs[True] == runs[False]
    spans = eng.telemetry.spans
    caps = [s for s in spans if s[0] == "capture"]
    assert len(caps) == 1 + len(eng._prefill.graphs)
    for c in caps:
        kids = [s for s in spans if s[1] == "setup" and s[0] != "capture"
                and c[3] <= s[3] and s[3] + s[4] <= c[3] + c[4]]
        assert sorted(k[0] for k in kids) == ["capture-graph",
                                              "capture-warm"]
    graphs = [s for s in spans if s[0] == "graph"]
    dev = [s for s in spans if s[0] in ("dev decode", "dev prefill")]
    assert len(dev) == len(graphs) > 0
    slack = 50_000
    for d in dev:
        # the last graph span to start before it (a first admission's
        # graph span holds its capture, then the dev span)
        g = max((g for g in graphs if g[3] <= d[3] + slack),
                key=lambda g: g[3])
        assert d[3] + d[4] <= g[3] + g[4] + slack, (d, g)
    assert sum(s[0] == "dev policy" for s in spans) >= \
        eng.mm.hooks.batch_calls["mm_fault"] > 0
    assert all(p[0] == "dev copy" for p in eng.telemetry._pending)
    steps = [s for s in spans if s[0].startswith("step ")]
    idle = idle_by_phase(spans, steps[0][3], steps[-1][3] + steps[-1][4])
    assert sum(idle.values()) > 0 and "graph" in idle


# ---------------------------------------------------------------------------
# The LM head: float32 logits from one bf16 product, no float32 head copy
# ---------------------------------------------------------------------------

HEAD_V, HEAD_D = 102400, 4096          # deepseek-7b's vocab and width


def _head_operands(cuda, M: int, tied: bool):
    """bf16 ``x`` [M, d] and a bf16 head [d, V] (tied: ``embed.T`` of an
    [V, d] table) from a fixed numpy seed, at deepseek-7b's head shape."""
    rng = np.random.default_rng(29)
    x = torch.from_numpy(rng.standard_normal((M, HEAD_D), dtype=np.float32))
    shape = (HEAD_V, HEAD_D) if tied else (HEAD_D, HEAD_V)
    w = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    x, w = x.to(cuda, torch.bfloat16), (w * 0.02).to(cuda, torch.bfloat16)
    return x, (w.T if tied else w)


@pytest.mark.gpu
@pytest.mark.parametrize("M,tied", [(1, False), (32, False), (32, True)])
def test_head_logits_within_the_float32_sum_bound(cuda, M, tied):
    """The card's route against a float64 product of the same bf16
    operands, element by element, within 4 K 2^-24 sum_k |x_k w_k|: each
    product of two bf16 numbers is exact in float32, so the only error is
    the float32 sum's, and any order of summing K terms (split-K partials
    included) errs by at most (K - 1) 2^-24 sum_k |x_k w_k|; the 4 is room.
    On every row whose top two logits lie more than twice the row's bound
    apart, the argmax is the float32 route's (``x.float() @
    head.float()``).  One launch, float32 out."""
    from repro_torch.models.common import head_logits
    x, head = _head_operands(cuda, M, tied)
    n = head_logits.launches
    got = head_logits(x, head)
    torch.cuda.synchronize()
    assert head_logits.launches == n + 1
    assert got.dtype == torch.float32 and got.shape == (M, HEAD_V)
    ref = x.double() @ head.double()
    bound = 4 * HEAD_D * 2.0 ** -24 * (x.double().abs() @ head.double().abs())
    excess = ((got.double() - ref).abs() - bound).max().item()
    assert excess <= 0, f"{excess} over the float32 sum bound"
    top2 = ref.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * bound.max(dim=1).values
    f32 = x.float() @ head.float()
    assert torch.equal(got.argmax(1)[clear], f32.argmax(1)[clear])
    if M > 1:
        assert clear.any()


@pytest.mark.gpu
def test_decode_graph_pool_holds_no_float32_head(cuda, monkeypatch):
    """deepseek-7b's head shape (one layer of its widths, bf16 params, 32
    rows): the decode graph's pool is smaller than on the float32 route
    (the product ``x.float() @ head.float()`` patched in) by at least 0.95
    x the V x d float32 copy of the head that route makes."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import (PagedLayout, cache_init, materialize,
                                    model_spec)
    from repro_torch.models import decode as port_decode
    from repro_torch.serving.compiled import DecodeGraph
    cfg = dataclasses.replace(get_config("deepseek_7b"), n_layers=1)
    params = materialize(torch.Generator(device=cuda).manual_seed(0),
                         model_spec(cfg), device=cuda, dtype=torch.bfloat16)
    assert tuple(params["lm_head"].shape) == (HEAD_D, HEAD_V)
    lay = PagedLayout(num_blocks=64, block_tokens=16, max_blocks=16)
    table = torch.full((32, 16), -1, dtype=torch.int32, device=cuda)
    pools = {}
    for route in ("float32", "bf16"):
        with monkeypatch.context() as m:
            if route == "float32":
                m.setattr(port_decode, "head_logits",
                          lambda x, head: x.float() @ head.float())
            g = DecodeGraph(cfg, params, cache_init(cfg, lay, 32,
                                                    device=cuda),
                            table.clone(), lay)
        pools[route] = g.pool_bytes
        del g
    assert pools["float32"] - pools["bf16"] >= 0.95 * HEAD_V * HEAD_D * 4, \
        pools


@pytest.mark.gpu
def test_entries_replay_one_head_launch_with_a_bf16_head(cuda):
    """With bf16 params the LM head takes the card's route in every
    captured entry: the decode graph and each prefill graph (full and
    suffix) add one head launch a replay (launches = per replay x calls),
    and the decode replay's logits equal the eager entry's bit for bit."""
    from repro_torch.models.common import head_logits
    from repro_torch.serving.compiled import DecodeGraph, decode_entry
    cfg, params, cache, lay, table, lengths, tokens = _graph_case(
        cuda, "deepseek_7b", dtype=torch.bfloat16)
    ref = _clone_cache(cache)
    tb = torch.from_numpy(table).to(cuda)
    graph = DecodeGraph(cfg, params, cache, tb.clone(), lay)
    assert graph.per_replay[(head_logits, "launches")] == 1
    n = head_logits.launches
    active = np.array([True, False, True])
    lg, _ = graph(tokens, lengths, active)
    assert graph.calls == 1 and head_logits.launches == n + 1
    want, _ = decode_entry(params, cfg, ref, tb, lay,
                           torch.from_numpy(tokens).to(cuda),
                           torch.from_numpy(lengths).to(cuda),
                           torch.from_numpy(active).to(cuda))
    assert head_logits.launches == n + 2
    assert np.array_equal(lg, want.cpu().numpy())
    *_, pg = _prefill_case(cuda, "deepseek_7b", dtype=torch.bfloat16)
    prompt = np.arange(1, 30, dtype=np.int32)
    n = head_logits.launches
    pg.full(prompt, 1)
    pg.suffix(prompt, 0, 13)
    pg.suffix(prompt, 2, 15)
    assert sorted(pg.graphs) == [("full", 8), ("suffix", 4, 8)]
    for g in pg.graphs.values():
        assert g.per_replay[(head_logits, "launches")] == 1
    assert head_logits.launches == n + sum(
        g.per_replay[(head_logits, "launches")] * g.calls
        for g in pg.graphs.values()) == n + 3
