"""The engine's compiled prefill entries (``repro_torch.serving.compiled``)
on the CPU: the prefills a CUDA graph captures must not sync with the
host, and their capturable pieces must give the bits the masked, per-call
forms gave.

* The full prefill entry of each of the ten smoke archs (and mamba2 /
  jamba with their mamba layers live), and the suffix entry of the plain
  decoders (MLA included), run under :class:`HostSyncGuard` after one
  warm-up call, as the capture does.
* The mask-free ``write_prefill_kv``, ``write_suffix_kv`` and
  ``_gather_full_kv`` against the masked forms they replaced, bit for bit,
  where a naive clamp of a dropped block would race a live one.
* The suffix prefill with a tensor ``prefix_len`` against the int one, bit
  for bit; the entries against ``prefill_step`` / ``prefill_suffix_step``
  on a slot view, bit for bit; and against the reference's (bf16 compute on
  both sides: 2e-2 of the largest logit, the repo's bf16 tolerance).
* A warm-up with the table row all ``-1`` writes no pool cell, and the
  state the capture puts back is every per-slot leaf.

The engine tests (``test_torch_engine.py`` and the family, zoo, tiering,
prefix and resilience files) hold the whole engine, now prefilling through
these entries, to the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.models import (PagedLayout, cache_init, materialize,
                                model_spec, prefill_step, transformer)
from repro_torch.models import decode as port_decode
from repro_torch.models.common import BF16
from repro_torch.models.decode import (SLOT_KEYS, _gather_full_kv,
                                       prefill_suffix_step, slot_cache_view,
                                       write_prefill_kv, write_suffix_kv)
from repro_torch.serving import Request, ServingEngine, compiled
from repro_torch.serving.compiled import (HostSyncGuard, PrefillGraphs,
                                          prefill_entry,
                                          prefill_suffix_entry, stage_cache)

ARCHS = ("deepseek_7b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
         "gemma3_27b", "qwen2_vl_7b", "nemotron_4_15b", "phi3_mini_3p8b",
         "mamba2_1p3b", "jamba_v0_1_52b", "whisper_medium")
# the archs whose layers are all attention: the prefix cache's and the
# suffix prefill's
PLAIN = ("deepseek_7b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
         "gemma3_27b", "nemotron_4_15b", "phi3_mini_3p8b")
LAYOUT = PagedLayout(num_blocks=64, block_tokens=4, max_blocks=16)
B = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch: str):
    cfg = get_smoke_config(arch)
    params = materialize(torch.Generator().manual_seed(0), model_spec(cfg),
                         device="cpu")
    return cfg, params


def _live_mamba(monkeypatch):
    """Plans of kind "mamba" for the "m" layers, so the prefill takes its
    mamba branch (the served plans carry "m", as the reference's)."""
    orig = transformer.build_layer_plans

    def plans(cfg, *, decoder=True):
        return [dataclasses.replace(p, kind="mamba") if p.kind == "m"
                else p for p in orig(cfg, decoder=decoder)]
    monkeypatch.setattr(transformer, "build_layer_plans", plans)
    monkeypatch.setattr(port_decode, "build_layer_plans", plans)


def _random_cache(cfg, seed: int):
    """A bf16 cache with every leaf drawn from a seed: pools, MLA latents,
    mamba state, Whisper's cross K/V."""
    g = torch.Generator().manual_seed(seed)
    cache = cache_init(cfg, LAYOUT, B, device="cpu")
    for leaf in _leaves(cache):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    return cache


def _leaves(cache) -> list:
    return [t for k, seg in sorted(cache.items())
            for m in (seg.values() if k.startswith("s") else [seg])
            for _, t in sorted(m.items())]


def _clone(cache):
    return {k: ({j: {n: t.clone() for n, t in m.items()}
                 for j, m in seg.items()} if k.startswith("s")
                else {n: t.clone() for n, t in seg.items()})
            for k, seg in cache.items()}


def _equal_caches(a, b) -> bool:
    return all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               for x, y in zip(_leaves(a), _leaves(b)))


def _engine(arch: str):
    cfg, params = _model(arch)
    eng = ServingEngine(cfg, params, LAYOUT, max_batch=B, policy="thp",
                        device="cpu")
    return cfg, params, eng


def _prompt(cfg, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, cfg.vocab, n).astype(
        np.int32)


def _table_row(eng, slot: int, blocks) -> None:
    eng._table_buf[slot] = -1
    eng._table_buf[slot, :len(blocks)] = torch.as_tensor(blocks)


# ----------------------------------------------------------- no host sync

@pytest.mark.parametrize("arch,live", [(a, False) for a in ARCHS]
                         + [("mamba2_1p3b", True), ("jamba_v0_1_52b", True)],
                         ids=list(ARCHS) + ["mamba2_1p3b-live-mamba",
                                            "jamba_v0_1_52b-live-mamba"])
def test_prefill_entry_does_not_sync_with_the_host(monkeypatch, arch, live):
    """The capture's procedure on the CPU: one warm-up call, then the full
    prefill entry (as the engine builds it: its modality inputs, its
    table row and per-slot buffers) under the guard must dispatch no
    syncing op."""
    if live:
        _live_mamba(monkeypatch)
    cfg, _, eng = _engine(arch)
    _table_row(eng, 1, range(8, 16))
    prompt = _prompt(cfg, 29)
    want = eng._prefill.full(prompt, 1).copy()
    with HostSyncGuard("the prefill entry") as g:
        got = eng._prefill.full(prompt, 1)
    assert g.last is not None
    assert np.isfinite(got).all() and np.array_equal(got, want)


@pytest.mark.parametrize("arch", PLAIN)
def test_suffix_entry_does_not_sync_with_the_host(arch):
    cfg, _, eng = _engine(arch)
    _table_row(eng, 2, range(20, 28))
    prompt = _prompt(cfg, 29)
    eng._prefill.suffix(prompt, 2, 10)
    with HostSyncGuard("the suffix prefill entry") as g:
        got = eng._prefill.suffix(prompt, 2, 10)
    assert g.last is not None and np.isfinite(got).all()


def test_guard_names_the_entry():
    with pytest.raises(RuntimeError, match="the prefill entry at 3 blocks "
                                           "must not sync with the host"):
        with HostSyncGuard("the prefill entry at 3 blocks"):
            torch.arange(4).nonzero()


# ------------------------------------------------- the mask-free writers

def _masked_prefill_write(pool, kv_seq, block_table, *, block_tokens):
    """The boolean-mask scatter the mask-free form replaced."""
    B_, S = kv_seq.shape[:2]
    nb = S // block_tokens
    kvb = kv_seq.reshape((B_ * nb, block_tokens) + kv_seq.shape[2:])
    tbl = block_table[:, :nb].reshape(-1).long()
    ok = tbl >= 0
    pool[tbl[ok]] = kvb[ok].to(pool.dtype)
    return pool


def _masked_suffix_write(pool, kv_seq, block_table, start, *, block_tokens):
    B_, S = kv_seq.shape[:2]
    MB = block_table.shape[1]
    pos = start + torch.arange(S)
    blk = pos // block_tokens
    off = (pos % block_tokens).expand(B_, S)
    raw = block_table[:, blk.clamp(max=MB - 1)].long()
    ok = (blk < MB)[None, :] & (raw >= 0)
    pool[raw[ok], off[ok]] = kv_seq[ok].to(pool.dtype)
    return pool


def _masked_gather(pool, suffix, block_table, start, key_blocks,
                   block_tokens):
    B_, S = suffix.shape[:2]
    KB = key_blocks * block_tokens
    tbl = block_table[:, :key_blocks].long()
    full = pool[tbl.clamp_min(0)].reshape((B_, KB) + pool.shape[2:])
    posk = torch.arange(KB)
    valid = (posk[None, :] < start) & \
        (tbl.repeat_interleave(block_tokens, dim=1) >= 0)
    full = torch.where(valid.reshape(valid.shape + (1,) * (full.ndim - 2)),
                       full, torch.zeros((), dtype=full.dtype))
    full = full.to(suffix.dtype)
    idx = start + torch.arange(S)
    keep = idx < KB
    full[:, idx[keep]] = suffix[:, keep].to(full.dtype)
    return full


# (row [1, 6] of a 4-token block layout) per case
PREFILL_ROWS = {
    "mixed": [5, 6, -1, 9, 2, -1],
    "a -1 block mid-row": [5, 6, -1, 9, 2, 3],
    "every block -1": [-1] * 6,
    # block 1 is dropped and would clamp to block 0, which block 3 writes
    "dropped block clamps onto a live block": [5, -1, 7, 0, 2, 3],
}


def _bits(t):
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("case", sorted(PREFILL_ROWS))
def test_mask_free_prefill_write_matches_masked_scatter(case, dtype):
    g = torch.Generator().manual_seed(1)
    row = torch.tensor([PREFILL_ROWS[case]], dtype=torch.int32)
    pool = torch.randn(12, 4, 2, 3, generator=g).to(dtype)
    kv = torch.randn(1, 24, 2, 3, generator=g)
    want = _masked_prefill_write(pool.clone(), kv, row, block_tokens=4)
    got = write_prefill_kv(pool.clone(), kv, row, block_tokens=4)
    assert torch.equal(_bits(got), _bits(want))
    if case == "every block -1":
        assert torch.equal(_bits(got), _bits(pool))


# (row [1, 6], start, suffix length) per case; block size 4
SUFFIX_CASES = {
    "mixed": ([5, 6, 7, -1, 2, 3], 6, 12),
    "a -1 block mid-row": ([5, 6, -1, 9, 2, 3], 5, 12),
    "every block -1": ([-1] * 6, 6, 8),
    "past the table": ([5, 6, 7, 8, 2, 3], 18, 12),
    # position 6 (block 1, -1) is dropped and would clamp to block 0 at
    # offset 2, which position 14 (block 3 = 0) writes
    "dropped block clamps onto a live block": ([5, -1, 7, 0, 2, 3], 6, 12),
}


@pytest.mark.parametrize("start_as", ["int", "tensor"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("case", sorted(SUFFIX_CASES))
def test_mask_free_suffix_write_matches_masked_scatter(case, dtype,
                                                       start_as):
    row, start, S = SUFFIX_CASES[case]
    g = torch.Generator().manual_seed(2)
    table = torch.tensor([row], dtype=torch.int32)
    pool = torch.randn(12, 4, 2, 3, generator=g).to(dtype)
    kv = torch.randn(1, S, 2, 3, generator=g)
    want = _masked_suffix_write(pool.clone(), kv, table, start,
                                block_tokens=4)
    s = start if start_as == "int" else torch.tensor([start],
                                                     dtype=torch.int32)
    got = write_suffix_kv(pool.clone(), kv, table, s, block_tokens=4)
    assert torch.equal(_bits(got), _bits(want))
    if case == "every block -1":
        assert torch.equal(_bits(got), _bits(pool))


def test_suffix_collision_case_is_one():
    """The collision case really collides: a dropped position clamped to
    block 0 would write the cell a live position writes."""
    row, start, S = SUFFIX_CASES["dropped block clamps onto a live block"]
    pos = np.arange(start, start + S)
    blk, off = pos // 4, pos % 4
    raw = np.asarray(row)[blk]
    live = {(int(b), int(o)) for b, o in zip(raw, off) if b >= 0}
    assert any((0, int(o)) in live for b, o in zip(raw, off) if b < 0)


# (row, start, suffix length, key blocks) per case; block size 4
GATHER_CASES = {
    "aligned": ([5, 6, 7, 8, 2, -1], 8, 12, 5),
    "mid-block start": ([5, 6, 7, 8, 2, -1], 6, 12, 5),
    "a -1 prefix block": ([5, -1, 7, 8, 2, 3], 10, 8, 5),
    "suffix past the keys": ([5, 6, 7, 8, 2, 3], 13, 12, 6),
}


@pytest.mark.parametrize("start_as", ["int", "tensor"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_full_kv_matches_masked_form(case, dtype, start_as):
    row, start, S, kb = GATHER_CASES[case]
    g = torch.Generator().manual_seed(3)
    table = torch.tensor([row], dtype=torch.int32)
    pool = torch.randn(12, 4, 2, 3, generator=g).to(dtype)
    suffix = torch.randn(1, S, 2, 3, generator=g).to(dtype)
    want = _masked_gather(pool, suffix, table, start, kb, 4)
    s = start if start_as == "int" else torch.tensor([start],
                                                     dtype=torch.int32)
    with HostSyncGuard():
        got = _gather_full_kv(pool, suffix, table, s, kb, 4)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


# ------------------------------------------------------------ the entries

@pytest.mark.parametrize("arch", ["deepseek_7b", "deepseek_v2_lite_16b",
                                  "gemma3_27b"])
def test_tensor_prefix_len_equals_the_int(arch):
    """prefill_suffix_step with ``prefix_len`` an int32 tensor (what the
    flash kernel reads from device memory) against the int: logits and
    every pool cell bit for bit."""
    cfg, params = _model(arch)
    cache = _random_cache(cfg, 4)
    ref = _clone(cache)
    table = torch.full((1, LAYOUT.max_blocks), -1, dtype=torch.int32)
    table[0, :7] = torch.tensor([3, 9, 11, 20, 31, 40, 2])
    toks = torch.from_numpy(_prompt(cfg, 16, 1))[None]
    kw = dict(key_blocks=7, last_index=torch.tensor([13]))
    a, _ = prefill_suffix_step(params, cfg, cache, toks, table, LAYOUT,
                               prefix_len=torch.tensor([11],
                                                       dtype=torch.int32),
                               **kw)
    b, _ = prefill_suffix_step(params, cfg, ref, toks, table, LAYOUT,
                               prefix_len=11, **kw)
    assert torch.equal(a, b)
    assert _equal_caches(cache, ref)


@pytest.mark.parametrize("arch,live", [("deepseek_7b", False),
                                       ("qwen2_vl_7b", False),
                                       ("whisper_medium", False),
                                       ("jamba_v0_1_52b", True)])
def test_entry_equals_prefill_step_on_a_slot_view(monkeypatch, arch, live):
    """The engine's full prefill through its entry (static buffers, the
    staged per-slot state written with ``index_copy_``) against the eager
    route it replaced, ``prefill_step`` on ``slot_cache_view``: logits and
    every cache leaf bit for bit."""
    if live:
        _live_mamba(monkeypatch)
    cfg, params, eng = _engine(arch)
    cache = eng.cache
    for leaf, new in zip(_leaves(cache), _leaves(_random_cache(cfg, 5))):
        leaf.copy_(new)
    ref = _clone(cache)
    _table_row(eng, 1, [40, 7, 33, 12, 50, 1, 8, 19])
    prompt = _prompt(cfg, 29, 2)
    got = eng._prefill.full(prompt, 1).copy()
    S = 32
    toks = np.zeros((1, S), np.int32)
    toks[0, :29] = prompt
    want, _ = prefill_step(params, cfg, slot_cache_view(ref, 1),
                           torch.from_numpy(toks), eng._table_buf[1:2],
                           LAYOUT, chunk=256, last_index=torch.tensor([28]),
                           **eng._modality_kwargs(S))
    assert np.array_equal(got, want[0].numpy())
    assert _equal_caches(cache, ref)
    assert list(eng._prefill.graphs) == [("full", 8)]
    assert eng._prefill.graphs[("full", 8)] is None     # no graph on the CPU


def test_suffix_entry_equals_prefill_suffix_step():
    cfg, params, eng = _engine("deepseek_v2_lite_16b")
    cache = eng.cache
    for leaf, new in zip(_leaves(cache), _leaves(_random_cache(cfg, 6))):
        leaf.copy_(new)
    ref = _clone(cache)
    _table_row(eng, 0, [40, 7, 33, 12, 50, 1, 8])
    prompt = _prompt(cfg, 27, 3)
    got = eng._prefill.suffix(prompt, 0, 13).copy()
    toks = np.zeros((1, 16), np.int32)
    toks[0, :14] = prompt[13:]
    want, _ = prefill_suffix_step(params, cfg, ref, torch.from_numpy(toks),
                                  eng._table_buf[0:1], LAYOUT, prefix_len=13,
                                  key_blocks=7, chunk=256,
                                  last_index=torch.tensor([13]))
    assert np.array_equal(got, want[0].numpy())
    assert _equal_caches(cache, ref)
    assert list(eng._prefill.graphs) == [("suffix", 4, 7)]


def test_suffix_rejects_a_prefix_outside_the_prompt():
    cfg, _, eng = _engine("deepseek_7b")
    for plen in (0, 29):
        with pytest.raises(ValueError, match="prefix"):
            eng._prefill.suffix(_prompt(cfg, 29), 0, plen)


def _reference(arch: str):
    import jax
    from repro.configs.base import get_smoke_config as jax_smoke
    from repro.models import materialize as jax_materialize
    from repro.models import model_spec as jax_spec
    from repro_torch.convert import params_from_jax
    jcfg = jax_smoke(arch)
    jparams = jax_materialize(jax.random.PRNGKey(0), jax_spec(jcfg))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_smoke_config(arch), params


def _bf16_close(got, want):
    tol = 2e-2 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("arch", ["deepseek_7b", "deepseek_v2_lite_16b"])
def test_entries_match_the_reference(arch):
    """A full prefill through :func:`prefill_entry`, then a suffix prefill
    through :func:`prefill_suffix_entry` with a tensor prefix length,
    against the reference's ``prefill_step`` and ``prefill_suffix_step``
    (a traced ``prefix_len``, as its ``_prefill_sfx_entry`` has) on the
    same converted params and inputs: logits and the pools the suffix
    wrote."""
    import jax
    import jax.numpy as jnp
    from repro.models.decode import PagedLayout as JaxLayout
    from repro.models.decode import cache_init as jax_cache_init
    from repro.models.decode import prefill_step as jax_prefill
    from repro.models.decode import prefill_suffix_step as jax_suffix
    jcfg, jparams, cfg, params = _reference(arch)
    jl = JaxLayout(LAYOUT.num_blocks, LAYOUT.block_tokens, LAYOUT.max_blocks)
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, cfg.vocab, 27).astype(np.int32)
    table = np.full((1, LAYOUT.max_blocks), -1, np.int32)
    table[0, :7] = rng.choice(LAYOUT.num_blocks, 7, replace=False)
    S0 = 13
    pre = np.zeros((1, 16), np.int32)
    pre[0, :S0] = prompt[:S0]
    sfx = np.zeros((1, 16), np.int32)
    sfx[0, :27 - S0] = prompt[S0:]

    jc = jax_cache_init(jcfg, jl, 1, jnp.bfloat16)
    jlog, jc = jax.jit(lambda p, c, t, tb, li: jax_prefill(
        p, jcfg, c, t, tb, jl, chunk=256, last_index=li))(
        jparams, jc, jnp.asarray(pre), jnp.asarray(table),
        jnp.asarray([S0 - 1], jnp.int32))
    jslog, jc = jax.jit(lambda p, c, t, tb, plen, li: jax_suffix(
        p, jcfg, c, t, tb, jl, prefix_len=plen, key_blocks=7, chunk=256,
        last_index=li))(
        jparams, jc, jnp.asarray(sfx), jnp.asarray(table),
        jnp.asarray(S0, jnp.int32), jnp.asarray([27 - S0 - 1], jnp.int32))

    cache = cache_init(cfg, LAYOUT, 1, device="cpu")
    row = torch.from_numpy(table)
    i32 = dict(dtype=torch.int32)
    log = prefill_entry(params, cfg, cache, stage_cache(cache), row, LAYOUT,
                        torch.from_numpy(pre), torch.tensor([S0 - 1], **i32),
                        torch.tensor([0]))
    slog = prefill_suffix_entry(params, cfg, cache, row, LAYOUT,
                                torch.from_numpy(sfx),
                                torch.tensor([27 - S0 - 1], **i32),
                                torch.tensor([S0], **i32), key_blocks=7)
    _bf16_close(log.numpy(), np.asarray(jlog))
    _bf16_close(slog.numpy(), np.asarray(jslog))
    pools = ("pool_ckv",) if cfg.mla is not None else ("pool_k", "pool_v")
    for seg in cache:
        for j in cache[seg]:
            for k in pools:
                got = cache[seg][j][k].float().numpy()
                want = np.asarray(jc[seg][j][k], np.float32)
                assert np.array_equal(got != 0, want != 0), (seg, j, k)
                _bf16_close(got, want)


# ------------------------------------------------------------ the warm-up

@pytest.mark.parametrize("arch,live", [("deepseek_7b", False),
                                       ("deepseek_v2_lite_16b", False),
                                       ("whisper_medium", False),
                                       ("jamba_v0_1_52b", True)])
def test_warm_up_with_a_minus_one_row_changes_nothing(monkeypatch, arch,
                                                      live):
    """What the capture does before it captures, on the CPU: the entry
    run with the table row all -1 (every pool write drops) writes no pool
    cell, and once the per-slot state the capture saves is put back, the
    cache is bit-identical; the saved state is every per-slot leaf."""
    if live:
        _live_mamba(monkeypatch)
    cfg, params, eng = _engine(arch)
    cache = eng.cache
    for leaf, new in zip(_leaves(cache), _leaves(_random_cache(cfg, 8))):
        leaf.copy_(new)
    ref = _clone(cache)
    pg = eng._prefill
    state = compiled._slot_state(cache, SLOT_KEYS)
    saved = [t.clone() for t in state]
    pg.row.fill_(-1)
    prompt = _prompt(cfg, 29, 4)
    h = pg.trip.host_in
    h[:3] = 28, 2, 0
    h[3:32] = prompt
    pg._full_out(32)
    for t, s in zip(state, saved):
        t.copy_(s)
    assert _equal_caches(cache, ref)
    if arch == "deepseek_v2_lite_16b":
        h[:3] = 15, 2, 13
        h[3:19] = prompt[13:29]
        pg._suffix_out(16, 8)
        assert _equal_caches(cache, ref)


def _named(cache, names) -> list:
    return [t for k, seg in cache.items()
            for m in (seg.values() if k.startswith("s") else [seg])
            for n, t in m.items() if n in names]


@pytest.mark.parametrize("arch,live", [("whisper_medium", False),
                                       ("jamba_v0_1_52b", True),
                                       ("deepseek_7b", False)])
def test_capture_saves_every_per_slot_leaf(monkeypatch, arch, live):
    if live:
        _live_mamba(monkeypatch)
    cache = cache_init(get_smoke_config(arch), LAYOUT, B, device="cpu")
    got = {id(t) for t in compiled._slot_state(cache, SLOT_KEYS)}
    want = {id(t) for t in _named(cache, SLOT_KEYS)}
    assert got == want
    assert bool(want) == (arch != "deepseek_7b")
    # the staged buffers: one slot of each per-slot leaf, the pools shared
    staged = stage_cache(cache)
    for key, seg in cache.items():
        for j, mem in (seg.items() if key.startswith("s") else [(None, seg)]):
            st = staged[key][j] if j is not None else staged[key]
            for name, leaf in mem.items():
                if name in SLOT_KEYS:
                    ax = 1 if key.startswith("s") else 0
                    assert st[name].shape == leaf.narrow(ax, 0, 1).shape
                    assert st[name] is not leaf
                else:
                    assert st[name] is leaf


# ------------------------------------------------------------- the engine

def test_engine_prefills_through_the_entries():
    """The engine builds one prefill entry over its own table and cache
    and calls it once an admission; on the CPU no graph, no counts added,
    one shape key per padded block count."""
    from repro_torch.kernels.flash_attention import ops as fa
    cfg, _, eng = _engine("deepseek_7b")
    assert isinstance(eng._prefill, PrefillGraphs)
    assert eng._prefill.table is eng._table_buf
    assert eng._prefill.cache is eng.cache
    n = fa.flash_attention.launches
    for rid, n_tok in enumerate((9, 10, 5)):
        eng.submit(Request(rid=rid, prompt=list(range(1, n_tok + 1)),
                           max_new_tokens=3))
    eng.run(max_steps=30)
    assert eng._prefill.calls == eng.stats.prefills == 3
    assert eng._prefill.graphs == {("full", 3): None, ("full", 2): None}
    assert fa.flash_attention.launches == n
