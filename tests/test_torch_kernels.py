"""The port's kernels against the JAX package, on the CPU.

Each kernel's plain PyTorch version — what its wrapper runs for CPU
tensors — is held against two references: the ``ref.py`` oracle of the
Pallas kernel it replaces, and the jnp function the reference engine
actually runs (decode: ``paged_decode_attention_gather``; prefill: the
chunked ``models.attention.flash_attention``; moves: the engine's
``.at[:, dst].set(leaf[:, src], mode="drop")`` scatter).  Shape grids are
those of ``tests/test_kernels.py``; tolerances are its own: 2e-5 for
float32, 2e-2 for bf16 (2.5e-2 for bf16 flash, as there).

The paged kernel's plan (split the page slots, then combine) is written
out in PyTorch (``split_partials_plain`` / ``combine_plain``) and held here
to ``paged_decode_plain`` and to ``combine_partials_ref``; the multi-class
wrapper is held to the JAX multi-class ``paged_decode_attention``.

``tests/test_torch_gpu.py`` launches the CUDA kernels themselves.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.block_copy.ops import expand_moves
from repro.kernels.block_copy.ref import block_copy_ref
from repro.kernels.flash_attention.ref import mha_ref
from repro.kernels.paged_attention import ref as pa_ref
from repro.kernels.paged_attention.ops import \
    paged_decode_attention as jax_paged_decode_multi
from repro.models.attention import flash_attention as jnp_flash_attention
from repro.models.decode import paged_decode_attention_gather

from repro_torch.kernels.block_copy.ops import block_copy, block_copy_plain
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.paged_attention.ops import (
    combine_plain, paged_decode_attention, paged_decode_multi,
    paged_decode_plain, split_pages, split_partials_plain)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def both(x: np.ndarray, dt: str):
    """The same numpy values as a JAX array and a torch tensor of dtype dt
    (both round float32 -> bf16 to nearest even)."""
    jdt, tdt, _ = DTYPES[dt]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def make_pages(B, NB, MP, pb, seed=0):
    rng = np.random.default_rng(seed)
    tbl = np.full((B, MP), -1, np.int32)
    logical = np.full((B, MP), -1, np.int32)
    for b in range(B):
        n = rng.integers(1, MP + 1)
        tbl[b, :n] = rng.choice(NB // pb, size=n, replace=False) * pb
        logical[b, :n] = np.arange(n)
    return tbl, logical


def expand_to_blocks(tbl: np.ndarray, pb: int) -> np.ndarray:
    """Per-page table -> the equivalent per-block table (logical = column)."""
    B, MP = tbl.shape
    blocks = tbl[:, :, None] + np.arange(pb)[None, None, :]
    blocks = np.where(tbl[:, :, None] >= 0, blocks, -1)
    return blocks.reshape(B, MP * pb).astype(np.int32)


PAGED_SHAPES = [(2, 8, 4, 32, 8, 128, 5), (1, 4, 1, 64, 16, 256, 3),
                (3, 4, 4, 16, 4, 192, 7)]
PAGED_CASES = [(o, dt, s) for o in (0, 1, 2) for dt in DTYPES
               for s in PAGED_SHAPES if s[5] // 4 ** o >= s[6]]


class TestPagedDecodePlain:
    @pytest.mark.parametrize("order,dt,shape", PAGED_CASES)
    def test_matches_oracle_and_gather_path(self, order, dt, shape):
        B, H, KVH, hd, bt, NB, MP = shape
        pb = 4 ** order
        rng = np.random.default_rng(order * 7 + len(dt))
        q = rng.normal(size=(B, H, hd)).astype(np.float32)
        pk = rng.normal(size=(NB, bt, KVH, hd)).astype(np.float32)
        pv = rng.normal(size=(NB, bt, KVH, hd)).astype(np.float32)
        tbl, logical = make_pages(B, NB, MP, pb, seed=order)
        lengths = rng.integers(1, MP * pb * bt, size=(B,)).astype(np.int32)
        (jq, tq), (jk, tk), (jv, tv) = both(q, dt), both(pk, dt), both(pv, dt)
        tol = DTYPES[dt][2]
        out, heat = paged_decode_attention(
            tq, tk, tv, torch.from_numpy(tbl), torch.from_numpy(lengths),
            block_tokens=bt, page_blocks=pb, logical=torch.from_numpy(logical))
        ref_out, _ = pa_ref.paged_decode_ref(
            jq, jk, jv, {order: jnp.asarray(tbl)},
            {order: jnp.asarray(logical)}, jnp.asarray(lengths),
            block_tokens=bt)
        np.testing.assert_allclose(f32(out), f32(ref_out), rtol=tol, atol=tol)
        # exact per-page mass == the gather path's per-block mass, summed
        g_out, g_heat = paged_decode_attention_gather(
            jq, jk, jv, jnp.asarray(expand_to_blocks(tbl, pb)),
            jnp.asarray(lengths), block_tokens=bt)
        np.testing.assert_allclose(f32(out), f32(g_out), rtol=tol, atol=tol)
        np.testing.assert_allclose(
            f32(heat), np.asarray(g_heat).reshape(B, MP, pb).sum(-1),
            rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("window,soft_cap", [(8, None), (None, 20.0),
                                                 (12, 30.0)])
    def test_window_and_soft_cap_match_gather_path(self, window, soft_cap):
        B, H, KVH, hd, bt, NB, MB = 2, 4, 2, 32, 8, 128, 6
        rng = np.random.default_rng(3)
        q = rng.normal(size=(B, H, hd)).astype(np.float32)
        pk = rng.normal(size=(NB, bt, KVH, hd)).astype(np.float32)
        pv = rng.normal(size=(NB, bt, KVH, hd)).astype(np.float32)
        tbl = rng.choice(NB, size=(B, MB), replace=False).astype(np.int32)
        tbl[1, 4:] = -1
        lengths = np.asarray([44, 30], np.int32)
        out, heat = paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
            torch.from_numpy(tbl), torch.from_numpy(lengths), block_tokens=bt,
            window=window, soft_cap=soft_cap)
        g_out, g_heat = paged_decode_attention_gather(
            jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(tbl), jnp.asarray(lengths), block_tokens=bt,
            window=window, soft_cap=soft_cap)
        np.testing.assert_allclose(f32(out), f32(g_out), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(f32(heat), np.asarray(g_heat), rtol=2e-5,
                                   atol=2e-5)

    def test_inactive_rows_are_all_masked(self):
        """A row with an all -1 table and length 0 (the engine's inactive
        slot) attends to nothing: zero output, zero heat."""
        B, H, KVH, hd, bt, NB, MB = 2, 4, 4, 16, 4, 32, 8
        rng = np.random.default_rng(5)
        q = torch.from_numpy(rng.normal(size=(B, H, hd)).astype(np.float32))
        pk = torch.from_numpy(rng.normal(size=(NB, bt, KVH, hd)).astype(np.float32))
        tbl = torch.from_numpy(rng.choice(NB, (B, MB), replace=False).astype(np.int32))
        tbl[1] = -1
        out, heat = paged_decode_attention(
            q, pk, pk, tbl, torch.tensor([17, 0], dtype=torch.int32),
            block_tokens=bt)
        assert torch.all(out[1] == 0) and torch.all(heat[1] == 0)
        assert heat[0].sum().item() == pytest.approx(H, rel=1e-5)


# split plan cases: (name, window); each runs with 1, 3 and MP page slots
# per split
SPLIT_SCENARIOS = ["ragged", "empty_split", "window_crosses_split",
                   "masked_rows"]


def _split_case(name, seed=0):
    """[B=4] rows over MP=7 slots of 4-token blocks: ``empty_split`` leaves
    slots 3.. of row 0 past its length and slots 2.. of row 1 unmapped (so
    splits of 1 and 3 slots hold no valid token); ``window_crosses_split``
    attends to the last 10 tokens, across slot and split boundaries;
    ``masked_rows`` has an all -1 row with a length and an inactive row
    (all -1, length 0)."""
    B, H, KVH, hd, bt, NB, MP = 4, 8, 2, 32, 4, 64, 7
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    pk = rng.normal(size=(NB, bt, KVH, hd)).astype(np.float32)
    pv = rng.normal(size=(NB, bt, KVH, hd)).astype(np.float32)
    tbl = np.stack([rng.choice(NB, MP, replace=False)
                    for _ in range(B)]).astype(np.int32)
    lengths = rng.integers(1, MP * bt + 1, size=B).astype(np.int32)
    window = None
    if name == "empty_split":
        lengths[0] = 2 * bt + 3
        tbl[1, 2:] = -1
        lengths[1] = MP * bt
    elif name == "window_crosses_split":
        window = 10
        lengths[:] = [MP * bt, 5 * bt + 1, 3 * bt - 1, 9]
    elif name == "masked_rows":
        tbl[2] = -1
        lengths[2] = 3 * bt
        tbl[3] = -1
        lengths[3] = 0
    return (torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
            torch.from_numpy(tbl), torch.from_numpy(lengths), bt, window)


class TestPagedSplitPlan:
    @pytest.mark.parametrize("pps", [1, 3, 7], ids=["pps1", "pps3", "ppsMP"])
    @pytest.mark.parametrize("name", SPLIT_SCENARIOS)
    def test_split_and_combine_match_plain(self, name, pps):
        q, pk, pv, tbl, lengths, bt, window = _split_case(name)
        parts = split_partials_plain(q, pk, pv, tbl, lengths, block_tokens=bt,
                                     pages_per_split=pps, window=window,
                                     soft_cap=20.0)
        out, heat = combine_plain(*parts)
        ref_out, ref_heat = paged_decode_plain(
            q, pk, pv, tbl, lengths, block_tokens=bt, window=window,
            soft_cap=20.0)
        assert torch.isfinite(out).all() and torch.isfinite(heat).all()
        np.testing.assert_allclose(f32(out), f32(ref_out), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(f32(heat), f32(ref_heat), rtol=2e-5,
                                   atol=2e-5)
        if name == "masked_rows":
            assert torch.all(out[2:] == 0) and torch.all(heat[2:] == 0)
        if name == "empty_split" and pps < 7:   # a split really held nothing
            assert bool((parts[1] == -np.inf).any())

    @pytest.mark.parametrize("name", SPLIT_SCENARIOS)
    def test_combine_matches_combine_partials_ref(self, name):
        q, pk, pv, tbl, lengths, bt, window = _split_case(name, seed=1)
        acc, m, l, m_page, l_page = split_partials_plain(
            q, pk, pv, tbl, lengths, block_tokens=bt, pages_per_split=3,
            window=window)
        out, _ = combine_plain(acc, m, l, m_page, l_page)
        m_ref = np.where(np.isneginf(f32(m)), pa_ref.NEG_INF, f32(m))
        ref = pa_ref.combine_partials_ref(
            [(jnp.asarray(f32(acc)[:, :, s]), jnp.asarray(m_ref[:, :, s]),
              jnp.asarray(f32(l)[:, :, s])) for s in range(m.shape[2])])
        np.testing.assert_allclose(f32(out), f32(ref), rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("MP,rows,sms,want", [
        (32, 128, 132, 8),      # the serving path: 512 blocks of 4 warps
        (6, 6, 132, 1),         # few rows: one slot per block
        (512, 256, 132, 256),   # many slots: at most 4 blocks per SM
        (2, 2000, 132, 2)])     # never more slots than the row has
    def test_split_pages(self, MP, rows, sms, want):
        pps = split_pages(MP, rows, sms)
        assert pps == want
        assert rows * -(-MP // pps) <= 4 * sms or pps == MP


def _two_class_case(dt, seed=0):
    """Class 0 (1-block pages, logical 0..3) in the low half of the pool and
    class 1 (4-block pages, logical 1..3 = blocks 4..15) in the high half:
    disjoint positions, so the per-block table that concatenates them is the
    gather path's view of the same sequence."""
    B, H, KVH, hd, bt, NB = 3, 8, 2, 32, 4, 128
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    pk = rng.normal(size=(NB, bt, KVH, hd)).astype(np.float32)
    pv = rng.normal(size=(NB, bt, KVH, hd)).astype(np.float32)
    t0 = np.stack([rng.choice(NB // 2, 4, replace=False)
                   for _ in range(B)]).astype(np.int32)
    t1 = np.stack([NB // 2 + 4 * rng.choice(NB // 8, 3, replace=False)
                   for _ in range(B)]).astype(np.int32)
    l0 = np.tile(np.arange(4, dtype=np.int32), (B, 1))
    l1 = np.tile(np.arange(1, 4, dtype=np.int32), (B, 1))
    t0[1, 2] = -1                   # a hole in class 0
    t1[2, 1:] = -1                  # row 2 ends in class 1's first page
    lengths = np.asarray([16 * bt, 11 * bt + 2, 6 * bt + 1], np.int32)
    blocks = np.full((B, 16), -1, np.int32)
    blocks[:, :4] = t0
    for j in range(3):
        for i in range(4):
            blocks[:, 4 * (j + 1) + i] = np.where(t1[:, j] >= 0,
                                                  t1[:, j] + i, -1)
    return q, pk, pv, (t0, t1), (l0, l1), lengths, bt, blocks


class TestPagedMultiClass:
    @pytest.mark.parametrize("dt", list(DTYPES))
    def test_matches_jax_multi_class(self, dt):
        q, pk, pv, tbls, lgs, lengths, bt, blocks = _two_class_case(dt)
        (jq, tq), (jk, tk), (jv, tv) = both(q, dt), both(pk, dt), both(pv, dt)
        tol = DTYPES[dt][2]
        out, heats = paged_decode_multi(
            tq, tk, tv, [torch.from_numpy(t) for t in tbls],
            [torch.from_numpy(lg) for lg in lgs], torch.from_numpy(lengths),
            block_tokens=bt, orders=(0, 1))
        assert out.dtype == tq.dtype
        ref_out, _ = pa_ref.paged_decode_ref(
            jq, jk, jv, {0: jnp.asarray(tbls[0]), 1: jnp.asarray(tbls[1])},
            {0: jnp.asarray(lgs[0]), 1: jnp.asarray(lgs[1])},
            jnp.asarray(lengths), block_tokens=bt)
        np.testing.assert_allclose(f32(out), f32(ref_out), rtol=tol, atol=tol)
        k_out, _ = jax_paged_decode_multi(
            jq, jk, jv, tuple(jnp.asarray(t) for t in tbls),
            tuple(jnp.asarray(lg) for lg in lgs), jnp.asarray(lengths),
            block_tokens=bt, orders=(0, 1), interpret=True)
        np.testing.assert_allclose(f32(out), f32(k_out), rtol=tol, atol=tol)
        # exact mass per page == the gather path's per-block mass, summed
        _, g_heat = paged_decode_attention_gather(
            jq, jk, jv, jnp.asarray(blocks), jnp.asarray(lengths),
            block_tokens=bt)
        g_heat = np.asarray(g_heat)
        np.testing.assert_allclose(f32(heats[0]), g_heat[:, :4], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(
            f32(heats[1]), g_heat[:, 4:].reshape(-1, 3, 4).sum(-1),
            rtol=2e-5, atol=2e-5)

    def test_active_masks_whole_rows(self):
        q, pk, pv, tbls, lgs, lengths, bt, _ = _two_class_case("f32", seed=1)
        args = (torch.from_numpy(q), torch.from_numpy(pk),
                torch.from_numpy(pv), [torch.from_numpy(t) for t in tbls],
                [torch.from_numpy(lg) for lg in lgs],
                torch.from_numpy(lengths))
        active = torch.tensor([True, False, True])
        out, heats = paged_decode_multi(*args, block_tokens=bt, orders=(0, 1),
                                        active=active)
        k_out, _ = jax_paged_decode_multi(
            jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
            tuple(jnp.asarray(t) for t in tbls),
            tuple(jnp.asarray(lg) for lg in lgs), jnp.asarray(lengths),
            block_tokens=bt, orders=(0, 1), interpret=True,
            active=jnp.asarray(active.numpy()))
        np.testing.assert_allclose(f32(out), f32(k_out), rtol=2e-5, atol=2e-5)
        assert torch.all(out[1] == 0)
        assert all(torch.all(h[1] == 0) for h in heats)
        assert sum(h[0].sum() for h in heats).item() == pytest.approx(
            q.shape[1], rel=1e-5)


FLASH_SHAPES = [(2, 64, 64, 4, 2, 32, True, None),
                (1, 96, 96, 4, 4, 16, True, 8),
                (2, 33, 65, 8, 2, 64, True, None),
                (1, 64, 64, 2, 1, 32, False, None),
                (1, 128, 128, 4, 1, 48, True, 32)]


class TestFlashAttentionPlain:
    @pytest.mark.parametrize("dt", list(DTYPES))
    @pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd,causal,window", FLASH_SHAPES)
    def test_matches_oracle_and_chunked_path(self, dt, B, Sq, Sk, H, KVH, hd,
                                             causal, window):
        rng = np.random.default_rng(Sq + hd)
        q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
        k = rng.normal(size=(B, Sk, KVH, hd)).astype(np.float32)
        v = rng.normal(size=(B, Sk, KVH, hd)).astype(np.float32)
        (jq, tq), (jk, tk), (jv, tv) = both(q, dt), both(k, dt), both(v, dt)
        tol = 2e-5 if dt == "f32" else 2.5e-2
        o = flash_attention(tq, tk, tv, causal=causal, window=window,
                            chunk=32)
        r = mha_ref(jq, jk, jv, causal=causal, window=window)
        np.testing.assert_allclose(f32(o), f32(r), rtol=tol, atol=tol)
        c = jnp_flash_attention(jq, jk, jv, causal=causal, window=window,
                                chunk=32)
        np.testing.assert_allclose(f32(o), f32(c), rtol=tol, atol=tol)

    def test_soft_cap(self):
        rng = np.random.default_rng(11)
        q, k, v = (rng.normal(size=(1, 64, 2, 32)).astype(np.float32)
                   for _ in range(3))
        o = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            soft_cap=20.0, chunk=32)
        r = mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    soft_cap=20.0)
        np.testing.assert_allclose(f32(o), f32(r), rtol=2e-5, atol=2e-5)

    def test_q_offset_matches_chunked_path(self):
        rng = np.random.default_rng(12)
        q = rng.normal(size=(1, 16, 4, 32)).astype(np.float32)
        k, v = (rng.normal(size=(1, 48, 2, 32)).astype(np.float32)
                for _ in range(2))
        o = flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                  q_offset=32, chunk=16)
        c = jnp_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_offset=32, chunk=16)
        np.testing.assert_allclose(f32(o), f32(c), rtol=2e-5, atol=2e-5)


class TestBlockCopyPlain:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
    def test_moves_match_oracle(self, dtype):
        base = (np.arange(32 * 64).reshape(32, 4, 16) % 97).astype(np.float32)
        plan = [(0, 16, 1), (8, 24, 0), (9, 25, 0)]
        src, dst = expand_moves(plan, pad_to=8)
        jpool = jnp.asarray(base, dtype)
        ref = block_copy_ref(jpool.reshape(32, -1), jnp.asarray(src),
                             jnp.asarray(dst)).reshape(jpool.shape)
        leaf = torch.from_numpy(base).to(getattr(torch, dtype))[None]
        block_copy([leaf], src, dst)
        np.testing.assert_array_equal(f32(leaf[0]), f32(ref))

    def test_stacked_leaves_match_engine_scatter(self):
        """[reps, NB, ...] K and V leaves in one call, dst = -1 pads dropped:
        the reference engine's ``_moves_entry`` on stacked pools."""
        rng = np.random.default_rng(2)
        k = rng.normal(size=(3, 40, 4, 2, 8)).astype(np.float32)
        v = rng.normal(size=(3, 40, 4, 2, 8)).astype(np.float32)
        src = np.asarray([0, 1, 2, 3, 7, 0, 0], np.int32)
        dst = np.asarray([20, 21, 22, 23, 30, -1, -1], np.int32)

        def scatter(leaf):
            d = jnp.where(dst >= 0, dst, leaf.shape[1])
            return leaf.at[:, d].set(leaf[:, src], mode="drop")
        leaves = [torch.from_numpy(k.copy()), torch.from_numpy(v.copy())]
        block_copy(leaves, src, dst)
        for got, want in zip(leaves, (k, v)):
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(scatter(jnp.asarray(want))))


def _hazard_free(batch) -> bool:
    """No move of the batch reads or writes a block an earlier move wrote,
    and none writes a block an earlier move reads."""
    written, read = set(), set()
    for s, d, n in batch:
        if written & set(range(s, s + n)) or \
                (written | read) & set(range(d, d + n)):
            return False
        written |= set(range(d, d + n))
        read |= set(range(s, s + n))
    return True


def test_engine_move_batches_are_safe_for_concurrent_copies():
    """The engine splits a drained move list so every launch can copy its
    rows concurrently in place, and the batches in order equal the moves
    applied one by one."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.buddy import order_blocks
    from repro_torch.models import PagedLayout, materialize, model_spec
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config("deepseek_7b")
    params = materialize(torch.Generator().manual_seed(0), model_spec(cfg),
                         device="cpu")
    eng = ServingEngine(cfg, params, PagedLayout(64, 4, 16), policy="thp",
                        device="cpu")
    for leaf in eng._pool_leaves:
        leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator()
                               .manual_seed(3)))
    # collapse-like drain: the second move set writes blocks the first one
    # reads (freed and re-allocated), then a chain A->B->C and a repeated dst
    moves = [(0, 16, 1), (4, 20, 0), (20, 40, 0), (40, 48, 0), (8, 0, 1),
             (33, 49, 0), (34, 49, 0)]
    seq = [leaf.clone() for leaf in eng._pool_leaves]
    for s, d, o in moves:
        n = order_blocks(o)
        for leaf in seq:
            leaf[:, d:d + n] = leaf[:, s:s + n].clone()
    batches = []
    apply_batch = eng._apply_move_batch

    def record(batch):
        batches.append([(s, d, order_blocks(o)) for s, d, o in batch])
        apply_batch(batch)
    eng._apply_move_batch = record
    eng.mm._move_log.extend(moves)
    eng._apply_pending_moves()
    assert len(batches) > 1 and all(_hazard_free(b) for b in batches)
    for got, want in zip(eng._pool_leaves, seq):
        assert torch.equal(got, want)
