"""The port's kernels against the JAX package, on the CPU.

Each kernel's plain PyTorch version — what its wrapper runs for CPU
tensors — is held against two references: the ``ref.py`` oracle of the
Pallas kernel it replaces, and the jnp function the reference engine
actually runs (decode: ``paged_decode_attention_gather``; prefill: the
chunked ``models.attention.flash_attention``; moves: the engine's
``.at[:, dst].set(leaf[:, src], mode="drop")`` scatter).  Shape grids are
those of ``tests/test_kernels.py``; tolerances are its own: 2e-5 for
float32, 2e-2 for bf16 (2.5e-2 for bf16 flash, as there).

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
from repro.models.attention import flash_attention as jnp_flash_attention
from repro.models.decode import paged_decode_attention_gather

from repro_torch.kernels.block_copy.ops import block_copy, block_copy_plain
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.paged_attention.ops import (paged_decode_attention,
                                                     paged_decode_plain)

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
