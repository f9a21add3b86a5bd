"""The engine's compiled decode entry (``repro_torch.serving.compiled``) on
the CPU: the step a CUDA graph captures must not sync with the host, and
its capturable pieces must give the bits the masked, per-call forms gave.

* :class:`HostSyncGuard` (a ``TorchDispatchMode``) fails on every op that
  syncs with the host on the card; the decode entry of each of the ten
  smoke archs (and mamba2 / jamba with their mamba layers live) runs under
  it after one warm-up call, as the capture does.
* The mask-free ``write_token_kv`` against the masked scatter it replaced,
  bit for bit, where a naive clamp of dropped rows would race a live row.
* ``_const`` and the M-RoPE channel index, cached, against today's.
* Two steps through :class:`DecodeGraph`'s static buffers against two
  eager ``decode_step`` calls, bit for bit, and one step against the
  reference's ``decode_step`` (bf16 compute on both sides: 2e-2 of the
  largest logit, the repo's bf16 tolerance).

The engine tests (``test_torch_engine.py`` and the family, zoo, tiering,
prefix and resilience files) hold the whole engine, now decoding through
this entry, to the reference.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.models import (PagedLayout, cache_init, decode_step,
                                materialize, model_spec, transformer)
from repro_torch.models import common
from repro_torch.models import decode as port_decode
from repro_torch.models.common import BF16
from repro_torch.models.decode import write_token_kv
from repro_torch.serving import Request, ServingEngine, compiled
from repro_torch.serving.compiled import (DecodeGraph, HostSyncGuard,
                                          decode_entry)

ARCHS = ("deepseek_7b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
         "gemma3_27b", "qwen2_vl_7b", "nemotron_4_15b", "phi3_mini_3p8b",
         "mamba2_1p3b", "jamba_v0_1_52b", "whisper_medium")
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


def _step_inputs(seed: int, cfg):
    """A table of distinct blocks per row, lengths, tokens and an active
    mask with one inactive row."""
    rng = np.random.default_rng(seed)
    blocks = rng.permutation(LAYOUT.num_blocks)[:B * 8].reshape(B, 8)
    table = np.full((B, LAYOUT.max_blocks), -1, np.int32)
    table[:, :8] = blocks
    lengths = rng.integers(5, 8 * LAYOUT.block_tokens - 1, B).astype(np.int32)
    tokens = rng.integers(1, cfg.vocab, B).astype(np.int32)
    active = np.array([True, False, True])
    return table, lengths, tokens, active


def _live_mamba(monkeypatch):
    """Plans of kind "mamba" for the "m" layers, so the decode step takes
    its mamba branch (the served plans carry "m", as the reference's)."""
    orig = transformer.build_layer_plans

    def plans(cfg, *, decoder=True):
        return [dataclasses.replace(p, kind="mamba") if p.kind == "m"
                else p for p in orig(cfg, decoder=decoder)]
    monkeypatch.setattr(transformer, "build_layer_plans", plans)
    monkeypatch.setattr(port_decode, "build_layer_plans", plans)


# --------------------------------------------------------------- the guard

def _masked_index():
    x = torch.arange(6.)
    return x[x > 2]


def _masked_put():
    x = torch.arange(6.)
    x[x > 2] = 0.0


GUARD_CASES = {
    "mask index": _masked_index,
    "mask index_put": _masked_put,
    "nonzero": lambda: torch.arange(4).nonzero(),
    "item": lambda: torch.arange(4).sum().item(),
    "bool()": lambda: bool(torch.ones(())),
    "torch.tensor": lambda: torch.tensor([1.0, 2.0]),
    "from_numpy": lambda: torch.from_numpy(np.zeros(3)) + 1,
    "repeat_interleave": lambda: torch.repeat_interleave(
        torch.arange(3), torch.ones(3, dtype=torch.long)),
    "unique": lambda: torch.unique(torch.arange(4)),
    "bincount": lambda: torch.bincount(torch.arange(4)),
    "masked_select": lambda: torch.masked_select(torch.arange(4),
                                                 torch.arange(4) > 1),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guard_fails_on_host_syncs(case):
    with pytest.raises(RuntimeError, match="must not sync with the host"):
        with HostSyncGuard():
            GUARD_CASES[case]()


def test_guard_passes_sync_free_ops():
    x = torch.arange(12.).reshape(3, 4)
    with HostSyncGuard() as g:
        idx = torch.arange(2)
        x[idx] = x[idx.flip(0)] * 2
        ones = torch.ones(3, dtype=torch.long)
        torch.repeat_interleave(torch.arange(3), ones, output_size=3)
        (x > 1).repeat_interleave(2, dim=1)
        torch.where(x > 3, x, torch.zeros_like(x)).argmax()
    assert g.last is not None


@pytest.mark.parametrize("arch,live", [(a, False) for a in ARCHS]
                         + [("mamba2_1p3b", True), ("jamba_v0_1_52b", True)],
                         ids=list(ARCHS) + ["mamba2_1p3b-live-mamba",
                                            "jamba_v0_1_52b-live-mamba"])
def test_decode_entry_does_not_sync_with_the_host(monkeypatch, arch, live):
    """The capture's procedure on the CPU: one warm-up call, then the
    entry under the guard must dispatch no syncing op."""
    if live:
        _live_mamba(monkeypatch)
    cfg, params = _model(arch)
    cache = cache_init(cfg, LAYOUT, B, device="cpu")
    table, lengths, tokens, active = _step_inputs(1, cfg)
    tb = torch.from_numpy(table)
    args = (params, cfg, cache, tb, LAYOUT, torch.from_numpy(tokens),
            torch.from_numpy(lengths), torch.from_numpy(active))
    decode_entry(*args)
    with HostSyncGuard() as g:
        logits, heat = decode_entry(*args)
    assert g.last is not None
    assert logits.shape[0] == B and heat.shape == (B, LAYOUT.max_blocks)
    assert torch.isfinite(logits[torch.from_numpy(active)]).all()


# ------------------------------------------------------ the mask-free append

def _masked_write(pool, new_kv, block_table, lengths, *, block_tokens):
    """The boolean-mask scatter the mask-free form replaced."""
    blk = (lengths // block_tokens).long()
    off = (lengths % block_tokens).long()
    raw = torch.gather(block_table, 1, blk[:, None])[:, 0].long()
    ok = raw >= 0
    pool[raw[ok], off[ok]] = new_kv[ok].to(pool.dtype)
    return pool


def _write_case(name: str):
    """(table [4, 4], lengths [4]) of a case; block size 4."""
    t = np.array([[5, 6, 7, -1], [0, 1, -1, -1], [9, 10, 11, 12],
                  [2, 3, -1, -1]], np.int32)
    n = np.array([9, 9, 13, 2], np.int32)          # row 1's block is -1
    if name == "dropped row clamps onto a live cell":
        # row 1 is dropped at offset 3 (its block 1 is -1); row 3 writes
        # block 0 at offset 3, where a clamp of row 1 to block 0 would land
        t[1] = [8, -1, -1, -1]
        n[1] = 7
        t[3, 0] = 0
        n[3] = 3
    elif name == "every row inactive":
        t[:] = -1
    elif name == "a whole -1 row":
        t[2] = -1
    elif name == "one live row":
        t[1:] = -1
    return torch.from_numpy(t), torch.from_numpy(n)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("case", ["mixed", "dropped row clamps onto a live "
                                  "cell", "every row inactive",
                                  "a whole -1 row", "one live row"])
def test_mask_free_append_matches_masked_scatter(case, dtype):
    g = torch.Generator().manual_seed(3)
    table, lengths = _write_case(case)
    pool = torch.randn(16, 4, 2, 3, generator=g).to(dtype)
    new = torch.randn(4, 2, 3, generator=g)
    want = _masked_write(pool.clone(), new, table, lengths, block_tokens=4)
    got = write_token_kv(pool.clone(), new, table, lengths, block_tokens=4)
    assert torch.equal(got.view(torch.int16 if dtype == BF16 else
                                torch.int32),
                       want.view(torch.int16 if dtype == BF16 else
                                 torch.int32))
    if case == "every row inactive":
        assert torch.equal(got, pool)


def test_mask_free_append_collision_case_is_one():
    """The collision case really collides: a dropped row clamped to block
    0 would write the cell a live row writes."""
    table, lengths = _write_case("dropped row clamps onto a live cell")
    raw = torch.gather(table, 1, (lengths // 4).long()[:, None])[:, 0]
    dropped = raw < 0
    live = {(int(b), int(o)) for b, o, d in zip(raw, lengths % 4, dropped)
            if not d}
    assert any((0, int(o)) in live for o, d in zip(lengths % 4, dropped)
               if d)


# ----------------------------------------------- constants and M-RoPE index

@pytest.mark.parametrize("dtype", [torch.float32, BF16, torch.float16])
def test_const_is_cached_with_the_same_bits(dtype):
    like = torch.zeros(2, dtype=dtype)
    for v in (math.sqrt(2 / math.pi), 0.044715, 0.5, 1e-6):
        a = common._const(v, like)
        assert a.dtype == dtype and a.shape == ()
        assert torch.equal(a, torch.tensor(v, dtype=dtype))
        assert common._const(v, like) is a
    x = torch.randn(64, generator=torch.Generator().manual_seed(0)).to(dtype)
    with HostSyncGuard():
        y = common.gelu_tanh(x)
    x3 = x * (x * x)
    c = lambda v: torch.tensor(v, dtype=dtype)  # noqa: E731
    want = x * (c(0.5) * (1 + torch.tanh(c(math.sqrt(2 / math.pi))
                                         * (x + c(0.044715) * x3))))
    assert torch.equal(y, want)


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128), ((2, 1, 1), 8)])
def test_mrope_index_is_cached_with_the_same_values(sections, hd):
    want = torch.repeat_interleave(torch.arange(3), torch.tensor(sections),
                                   output_size=hd // 2)
    got = common._mrope_sections(sections, hd // 2, torch.device("cpu"))
    assert torch.equal(got, want)
    assert common._mrope_sections(sections, hd // 2,
                                  torch.device("cpu")) is got
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 1, 4, hd, generator=g).to(BF16)
    pos = torch.randint(0, 60, (3, 2, 1), generator=g)
    cos_t, sin_t = common.rope_table(64, hd, 1e6, "cpu")
    p = pos.long()[want].movedim(0, -1)
    chan = torch.arange(hd // 2)
    cos, sin = cos_t[p, chan][..., None, :], sin_t[p, chan][..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    ref = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                    dim=-1).to(x.dtype)
    with HostSyncGuard():
        out = common.apply_mrope(x, pos, sections, max_pos=64, theta=1e6)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


# ------------------------------------------------------- the entry's buffers

@pytest.mark.parametrize("arch", ["deepseek_7b", "qwen2_vl_7b",
                                  "whisper_medium"])
def test_two_steps_through_the_entry_equal_eager_decode_steps(arch):
    cfg, params = _model(arch)
    g = torch.Generator().manual_seed(2)
    cache = cache_init(cfg, LAYOUT, B, device="cpu")
    for key, seg in cache.items():              # non-zero pools and slots
        for mem in (seg.values() if key.startswith("s") else [seg]):
            for leaf in mem.values():
                leaf.copy_(torch.randn(leaf.shape, generator=g))
    ref = {k: ({j: {n: t.clone() for n, t in m.items()}
                for j, m in seg.items()} if k.startswith("s")
               else {n: t.clone() for n, t in seg.items()})
           for k, seg in cache.items()}
    table, lengths, tokens, active = _step_inputs(4, cfg)
    tb = torch.from_numpy(table)
    entry = DecodeGraph(cfg, params, cache, tb.clone(), LAYOUT)
    assert entry.graph is None and not entry.per_replay
    for step in range(2):
        lg, heat = entry(tokens, lengths, active)
        pos3d = torch.from_numpy(lengths)[None, :, None].expand(3, B, 1) \
            if cfg.vlm_patches else None
        want, _, want_heat = decode_step(
            params, cfg, ref, torch.from_numpy(tokens),
            torch.from_numpy(lengths), tb, LAYOUT,
            active=torch.from_numpy(active), pos3d=pos3d)
        assert np.array_equal(lg, want.numpy()), step
        assert np.array_equal(heat, want_heat.numpy()), step
        tokens = want.argmax(-1).int().numpy()
        lengths = lengths + 1
    for k, seg in cache.items():
        for j, mem in (seg.items() if k.startswith("s") else [(None, seg)]):
            want = ref[k][j] if j is not None else ref[k]
            for n, leaf in mem.items():
                assert torch.equal(leaf, want[n]), (k, j, n)


def test_entry_matches_the_reference_decode_step():
    """One step of the entry against the reference's ``decode_step`` on the
    same converted params, cache and inputs (bf16 compute on both)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_smoke_config as jax_smoke
    from repro.models import materialize as jax_materialize
    from repro.models import model_spec as jax_spec
    from repro.models.decode import PagedLayout as JaxLayout
    from repro.models.decode import cache_init as jax_cache_init
    from repro.models.decode import decode_step as jax_decode_step
    from repro_torch.convert import params_from_jax

    jcfg = jax_smoke("deepseek_7b")
    jparams = jax_materialize(jax.random.PRNGKey(0), jax_spec(jcfg))
    cfg = get_smoke_config("deepseek_7b")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(5)
    jl = JaxLayout(LAYOUT.num_blocks, LAYOUT.block_tokens, LAYOUT.max_blocks)
    jcache = jax_cache_init(jcfg, jl, B, jnp.bfloat16)
    pools = {k: rng.normal(size=jcache["s0"]["m0"][k].shape).astype(
        np.float32) for k in ("pool_k", "pool_v")}
    jcache["s0"]["m0"] = {k: jnp.asarray(v, jnp.bfloat16)
                          for k, v in pools.items()}
    cache = cache_init(cfg, LAYOUT, B, device="cpu")
    for k, v in pools.items():
        cache["s0"]["m0"][k].copy_(torch.from_numpy(v))
    table, lengths, tokens, active = _step_inputs(6, cfg)
    entry = DecodeGraph(cfg, params, cache, torch.from_numpy(table), LAYOUT)
    lg, heat = entry(tokens, lengths, active)
    jlog, _, jheat = jax_decode_step(
        jparams, jcfg, jcache, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(table), jl, active=jnp.asarray(active))
    jlog, jheat = np.asarray(jlog), np.asarray(jheat)
    tol = 2e-2 * max(1.0, float(np.abs(jlog[active]).max()))
    np.testing.assert_allclose(lg[active], jlog[active], rtol=0, atol=tol)
    np.testing.assert_allclose(heat, jheat, rtol=0, atol=2e-2)


def test_engine_decodes_through_the_entry():
    """The engine builds one entry over its own table and cache and calls
    it once a decode step; on the CPU no graph, no counts added."""
    cfg, params = _model("deepseek_7b")
    eng = ServingEngine(cfg, params, LAYOUT, max_batch=2, policy="thp",
                        device="cpu")
    assert isinstance(eng._decode, DecodeGraph)
    assert eng._decode.table is eng._table_buf
    assert eng._decode.cache is eng.cache and eng._decode.graph is None
    calls = []
    real = eng._decode._run
    eng._decode._run = lambda: (calls.append(1), real())[1]
    n = pa.paged_decode_attention.launches
    eng.submit(Request(rid=0, prompt=list(range(1, 10)), max_new_tokens=4))
    eng.run(max_steps=20)
    assert len(calls) == eng.stats.decode_tokens == eng._decode.calls == 3
    assert pa.paged_decode_attention.launches == n


def test_round_trip_on_the_cpu():
    """On the CPU a ``RoundTrip``'s host mirrors are its device buffers
    themselves: nothing is pinned or copied, an identity run hands its
    input back, and a tracing hub records the run as ``dev <name>``.  The
    engine's decode and prefill entries each hold one."""
    from repro_torch.kernels.roundtrip import RoundTrip
    from repro_torch.obs import Telemetry
    rt = RoundTrip((2, 3), torch.int64, (2, 3), torch.int64, "cpu", "test")
    assert not rt.pinned
    assert rt.pin_in is rt.dev_in and rt.pin_out is rt.dev_out
    assert not rt.dev_in.is_pinned() and not rt.dev_out.is_pinned()
    assert np.shares_memory(rt.host_in, rt.dev_in.numpy())
    assert np.shares_memory(rt.host_out, rt.dev_out.numpy())
    assert not rt.host_in.any() and not rt.host_out.any()
    want = np.arange(6).reshape(2, 3)
    rt.host_in[:] = want
    tel = Telemetry(trace=True)
    rt(lambda: rt.dev_out.copy_(rt.dev_in), tel)
    np.testing.assert_array_equal(rt.host_out, want)
    assert [s[:3] for s in tel.spans] == [("dev test", "device", "stream")]
    rt.host_in[:] = 7
    rt(lambda: rt.dev_out.copy_(rt.dev_in))
    assert (rt.host_out == 7).all() and len(tel.spans) == 1
    cfg, params = _model("deepseek_7b")
    eng = ServingEngine(cfg, params, LAYOUT, max_batch=2, policy="thp",
                        device="cpu")
    assert isinstance(eng._decode.trip, RoundTrip)
    assert isinstance(eng._prefill.trip, RoundTrip)
    assert eng._decode.trip.span == "dev decode"
    assert eng._prefill.trip.span == "dev prefill"

def test_launch_counters_cover_every_kernel_wrapper():
    names = {(fn.__name__, attr) for fn, attr in compiled._launch_counters()}
    assert {("paged_decode_attention", "launches"),
            ("paged_decode_multi", "launches"),
            ("paged_decode_partials", "launches"),
            ("flash_attention", "launches"),
            ("block_copy", "launches"),
            ("policy_exec", "launches"),
            ("head_logits", "launches"),
            ("paged_decode_mla", "launches"),
            ("moe_apply", "routed_rows"),
            ("moe_apply", "computed_rows")} <= names


@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("head_dtype", [BF16, torch.float32])
@pytest.mark.parametrize("tied", [False, True])
def test_head_logits_is_the_reference_product_off_the_card(M, head_dtype,
                                                           tied):
    """Off the card the LM head's logits are ``x.float() @ head.float()``
    bit for bit (bf16 ``x``; a bf16 or float32 head, untied [d, V] or the
    tied ``embed.T``), the card route's count does not move, and a
    ``meta`` trace gives the same shape and dtype."""
    rng = np.random.default_rng(M)
    d, V = 64, 512
    x = torch.from_numpy(rng.standard_normal((M, d), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((V, d) if tied else (d, V),
                                             dtype=np.float32))
    x, w = x.to(BF16), w.to(head_dtype)
    head = w.T if tied else w
    n = common.head_logits.launches
    got = common.head_logits(x, head)
    assert got.dtype == torch.float32
    assert torch.equal(got, x.float() @ head.float())
    meta = common.head_logits(x.to("meta"), head.to("meta"))
    assert meta.shape == got.shape and meta.dtype == got.dtype
    assert common.head_logits.launches == n


def _named_leaves(tree, names) -> list:
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in ([v] if k in names and isinstance(v, torch.Tensor)
                          else _named_leaves(v, names))]
    return []


def test_slot_state_is_mamba_state_only(monkeypatch):
    """The leaves the capture's warm-up puts back: every mamba ``ssm`` and
    ``conv`` leaf of the cache, and nothing of an attention-only model."""
    _live_mamba(monkeypatch)
    cfg, _ = _model("jamba_v0_1_52b")
    cache = cache_init(cfg, LAYOUT, B, device="cpu")
    got = {id(leaf) for leaf in compiled._slot_state(cache)}
    want = {id(leaf) for leaf in _named_leaves(cache, ("ssm", "conv"))}
    assert got == want and len(want) > 0
    assert not compiled._slot_state(cache_init(
        get_smoke_config("deepseek_7b"), LAYOUT, B, device="cpu"))
