"""The port's prefix cache and suffix prefill against the reference.

* Manager level: the ``PrefixCache`` scripts of ``tests/test_prefix_cache``
  (shared mappings and copy-on-write, admission with a partial tail, whole
  blocks only, misses, dedup, ghost feedback, pinning, the tiered HOOK_EVICT
  scan, the doorkeeper) replay through both packages: matches, entries,
  snapshots, ``MMStats`` and moves identical.
* Suffix prefill: the port's ``prefill_suffix_step`` (flash attention with a
  query offset over the pool-gathered prefix) against the reference's, in
  float32: logits and every pool cell within 2e-5 (the repo's float32
  tolerance); and against the port's own full prefill of the same prompt.
* Engine level: the ``TestEnginePrefixCache`` workload (a shared 16-token
  system prompt plus 8 tokens of each of 4 requests, served one after
  another) with the cache off and on, and its mixed-traffic workload (cap 4
  blocks, ``lfu-evict``): step records, moves, hook counters and the
  ``prefix_cache`` snapshot identical to the reference engine's, with the
  reference's tokens replayed (``test_torch_engine.assert_replay_agrees``
  holds the port's own greedy choices); the port's cache-on run gives the
  cache-off run's tokens, free-running.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from test_torch_engine import assert_same_run, drive, run_reference
from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

BT = 4
PROMPT = list(range(200, 216))          # 16 tokens = 4 whole blocks

PREFIX_BASE = {"num_blocks": 256, "max_batch": 2, "policy": "never",
               "n_req": 4, "shared": list(range(1, 17)), "tail": 8,
               "tail_base": 100, "new": 8, "serial": True, "max_steps": 200}


def _spec_cases() -> dict:
    return {
        "prefix/off": dict(PREFIX_BASE, engine={"prefix_cache": False}),
        "prefix/on": dict(PREFIX_BASE, engine={"prefix_cache": True}),
        "prefix/mixed": dict(PREFIX_BASE, n_req=5, tail_base=200, new=6,
                             serial=False, max_steps=400, mixed=True,
                             doorkeeper=False,
                             engine={"prefix_cache": 4,
                                     "evict_policy": "lfu-evict"}),
    }


# ------------------------------------------------------------ manager level
def _mm(pkg, blocks=64, *, tiered=False, host=64):
    c = importlib.import_module(f"{pkg}.core")
    cost = c.make_cost_model(c.HWSpec(), kv_heads=4, head_dim=64)
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    if tiered:
        return c, c.TieredMemoryManager(blocks, cost, host_blocks=host,
                                        default_mode="thp", **kw)
    return c, c.MemoryManager(blocks, cost, default_mode="thp", **kw)


def _serving(pkg):
    return importlib.import_module(f"{pkg}.serving")


def _seeded(pkg, prompt, *, cap_blocks=32, tiered=False):
    c, mm = _mm(pkg, tiered=tiered)
    cache = _serving(pkg).PrefixCache(mm, BT, cap_blocks=cap_blocks,
                                      doorkeeper=False)
    mm.create_process(1, app="app", vma_blocks=16)
    mm.fault_range(1, 0, len(prompt) // BT)
    n = cache.insert(1, prompt)
    return c, mm, cache, n


def _match(m):
    if m is None:
        return None
    return {"tokens": m.tokens, "blocks": [list(b) for b in m.blocks],
            "cow": m.cow_logical,
            "entries": [[e.depth, e.refcount] for e in m.entries]}


def _cache_state(mm, cache, rec: dict) -> dict:
    rec["snapshot"] = cache.snapshot()
    rec["entries"] = sorted([e.key.hex(), e.depth, e.blk.tier, e.blk.phys,
                             e.refcount, e.hits] for e in
                            cache.entries.values())
    rec["ghost"] = [k.hex() for k in cache.ghost]
    rec["door"] = len(cache.door)
    rec["mm"] = mm.stats.snapshot()
    rec["moves"] = [list(m) for m in mm.drain_moves()]
    return rec


def _s_shared_primitives(pkg):
    c, mm = _mm(pkg)
    phys = mm.cache_alloc_block()
    mm.create_process(1, app="app", vma_blocks=8)
    mm.map_shared(1, 0, [(0, phys)])
    rec = {"cow": [list(m) for m in mm.cow_break(1, 0)],
           "cow_again": mm.cow_break(1, 0),
           "page": [mm.procs[1].page_table[0].phys_start,
                    mm.procs[1].page_table[0].shared]}
    mm.fault_range(1, 1, 3)
    mm.free_process(1)
    mm.cache_free_block(0, phys)
    rec["free"] = mm.buddy.free_blocks_total()
    return _json(rec)


def _s_admission(pkg):
    c, mm, cache, n = _seeded(pkg, PROMPT)
    rec = {"inserted": n}
    mm.create_process(2, app="app", vma_blocks=16)
    m = cache.acquire(2, PROMPT)
    rec["full"] = _match(m)
    cache.release(m)
    cache.release(m)
    other = PROMPT[:8] + [9] * 8
    m2 = cache.acquire(2, other)
    rec["diverging"] = _match(m2)
    cache.release(m2)
    rec["miss"] = _match(cache.acquire(2, [1, 2, 3, 4, 5, 6, 7, 8]))
    mm.fault_range(2, 0, 4)
    rec["dedup"] = cache.insert(2, PROMPT)
    return _json(_cache_state(mm, cache, rec))


def _s_ghost(pkg):
    c, mm, cache, n = _seeded(pkg, PROMPT, cap_blocks=2)
    mm.create_process(2, app="app", vma_blocks=16)
    rec = {"inserted": n, "again": _match(cache.acquire(2, PROMPT))}
    return _json(_cache_state(mm, cache, rec))


def _s_pinned(pkg):
    c, mm, cache, n = _seeded(pkg, PROMPT)
    mm.create_process(2, app="app", vma_blocks=16)
    m = cache.acquire(2, PROMPT)
    cache.cap_blocks = 0
    rec = {"freed": cache.scan(need_blocks=8), "left": len(cache.entries)}
    cache.release(m)
    return _json(_cache_state(mm, cache, rec))


def _s_tiered_scan(pkg):
    c, mm, cache, n = _seeded(pkg, PROMPT, tiered=True)
    mm.attach_evict_program(c.evict_lru_program(min_age_ticks=1))
    cache.cap_blocks = 1
    mm.ktime_ns += 50_000_000
    rec = {"freed": cache.scan()}
    mm.create_process(2, app="app", vma_blocks=16)
    mm.fault_range(2, 0, 4)
    rec["inserted"] = cache.insert(2, [9000 + i for i in range(16)])
    mm.ktime_ns += 50_000_000
    rec["freed2"] = cache.scan()
    return _json(_cache_state(mm, cache, rec))


def _s_doorkeeper(pkg):
    c, mm = _mm(pkg)
    cache = _serving(pkg).PrefixCache(mm, BT, cap_blocks=32)
    mm.create_process(1, app="app", vma_blocks=16)
    mm.fault_range(1, 0, 4)
    other = PROMPT[:8] + [7000 + i for i in range(8)]
    rec = {"ins": [cache.insert(1, PROMPT), cache.insert(1, other),
                   cache.insert(1, other), cache.insert(1, PROMPT)]}
    cache.cap_blocks = 0
    rec["freed"] = cache.scan(need_blocks=8)
    rec["readmit"] = cache.insert(1, PROMPT)
    cache.door_capacity = 8
    rng = np.random.default_rng(11)
    for _ in range(10):
        cache.insert(1, rng.integers(1, 10_000, 16).tolist())
    return _json(_cache_state(mm, cache, rec))


def _heats(c, cache) -> dict:
    """Every entry's heat, bit for bit (``float.hex``), and the eviction
    ctx's PAGE_HEAT column, by entry id."""
    cands = sorted(cache.entries.values(), key=lambda e: e.eid)
    col = cache._build_evict_ctx(cands)[:, c.CTX.PAGE_HEAT] if cands else []
    return {"heat": [[e.eid, float(e.heat).hex()] for e in cands],
            "page_heat": [int(v) for v in col]}


def _fold(cache, matches, rng, lengths) -> None:
    """One decode step's folds, row by row: heat rows drawn as the engine's
    float32 heat, some shorter and some longer than their chain, a few
    past the PAGE_HEAT clamp."""
    for m, n in zip(matches, lengths):
        h = rng.random(n).astype(np.float32) * np.float32(3.0)
        if n > 2:
            h[n // 2] = np.float32(rng.random()) * np.float32(1e-7)
        if rng.random() < 0.1:
            h[0] = np.float32(1e15)
        cache.note_heat(m, h)


def _s_heat(pkg):
    """Borrowers folding heat into shared chains, then the chains evicted
    and their blocks cached again: heats and PAGE_HEAT after each."""
    c, mm, cache, n = _seeded(pkg, PROMPT)
    other = PROMPT[:8] + [7000 + i for i in range(8)]
    rec = {"inserted": [n, cache.insert(1, other)]}
    for pid in (2, 3, 4, 5):
        mm.create_process(pid, app="app", vma_blocks=16)
    # full chain, the partial tail of the same chain, the other chain's
    # whole blocks, and the two blocks both chains share
    matches = [cache.acquire(2, PROMPT + [5]), cache.acquire(3, PROMPT),
               cache.acquire(4, other + [6]), cache.acquire(5, PROMPT[:9])]
    rec["matches"] = [_match(m) for m in matches]
    rng = np.random.default_rng(5)
    for _ in range(12):
        _fold(cache, matches, rng, rng.integers(1, 8, len(matches)))
    rec["folded"] = _heats(c, cache)
    for m in matches:
        cache.release(m)
    cache.cap_blocks = 0
    rec["freed"] = cache.scan(need_blocks=16)
    rec["left"] = len(cache.entries)
    cache.cap_blocks = 32
    third = [8000 + i for i in range(12)]
    rec["reinserted"] = [cache.insert(1, PROMPT), cache.insert(1, third)]
    rec["fresh"] = _heats(c, cache)
    again = [cache.acquire(2, PROMPT + [5]), cache.acquire(3, third + [1])]
    for _ in range(5):
        _fold(cache, again, rng, rng.integers(1, 8, len(again)))
    rec["refolded"] = _heats(c, cache)
    return _json(_cache_state(mm, cache, rec))


SCRIPTS = {
    "shared_primitives": _s_shared_primitives,
    "admission": _s_admission,
    "ghost": _s_ghost,
    "pinned": _s_pinned,
    "tiered_scan": _s_tiered_scan,
    "doorkeeper": _s_doorkeeper,
    "heat": _s_heat,
}


def _json(x):
    import json
    return json.loads(json.dumps(x, default=int))


def _reference_extra(params) -> dict:
    return {"scripts": {name: fn("repro") for name, fn in SCRIPTS.items()}}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, "test_torch_prefix")


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_prefix_cache_scripts_match_reference(reference, name):
    results, _ = reference
    assert SCRIPTS[name]("repro_torch") == results["extra"]["scripts"][name]


@pytest.mark.parametrize("case", list(_spec_cases()))
def test_engine_prefix_cache_matches_reference(reference, case):
    results, params = reference
    ref = results[case]
    port = drive("repro_torch", _spec_cases()[case], params,
                 replay=ref["samples"])
    assert_same_run(ref, port, replayed=True)
    final = ref["final"]["engine"]
    assert final["completed"] == _spec_cases()[case]["n_req"]
    if case == "prefix/on":
        snap = ref["prefix_cache"]
        # doorkeeper: req 0 notes the chain, req 1 admits it, 2 and 3 hit
        assert snap["hits"] == 2 and snap["tokens_skipped"] >= 2 * 15
        assert final["prefill_tokens"] < \
            results["prefix/off"]["final"]["engine"]["prefill_tokens"]
    if case == "prefix/mixed":
        assert ref["prefix_cache"]["scans"] > 0


def test_cache_changes_no_tokens(reference):
    """Free-running on the port: the cache-on run samples the cache-off
    run's tokens (the suffix prefill reproduces the full prefill's rows),
    while skipping prefill work."""
    _, params = reference
    off = drive("repro_torch", _spec_cases()["prefix/off"], params)
    on = drive("repro_torch", _spec_cases()["prefix/on"], params)
    assert on["finished"] == off["finished"]
    assert on["prefix_cache"]["hits"] == 2
    assert on["final"]["engine"]["prefill_tokens"] < \
        off["final"]["engine"]["prefill_tokens"]


def test_heat_slots_are_reused_and_grow():
    """A dropped entry's slot goes to the next insert, which starts at heat
    0.0; a full slot array doubles and every entry keeps its heat."""
    from repro_torch.serving.prefix_cache import HeatSlots
    c, mm, cache, n = _seeded("repro_torch", PROMPT)
    mm.create_process(2, app="app", vma_blocks=16)
    m = cache.acquire(2, PROMPT + [5])
    cache.note_heat(m, np.full(4, 0.75))
    cache.release(m)
    old = {e.slot for e in cache.entries.values()}
    cache.cap_blocks = 0
    cache.scan(need_blocks=16)
    assert not cache.entries and cache.heats.ema[list(old)].tolist() == \
        [0.75] * 4
    cache.cap_blocks = 32
    cache.insert(1, PROMPT)
    assert {e.slot for e in cache.entries.values()} == old
    assert [e.heat for e in cache.entries.values()] == [0.0] * 4

    slots = HeatSlots(1)
    taken = [slots.take() for _ in range(40)]
    assert sorted(taken) == list(range(40)) and slots.ema.size == 64
    c, mm = _mm("repro_torch", blocks=256)
    cache = _serving("repro_torch").PrefixCache(mm, BT, cap_blocks=64,
                                                doorkeeper=False)
    assert cache.heats.ema.size == 128
    cache.heats = HeatSlots(1)
    assert cache.heats.ema.size == 16
    mm.create_process(3, app="app", vma_blocks=64)
    mm.fault_range(3, 0, 20)
    long = [3000 + i for i in range(80)]
    first = cache.insert(3, long[:40])
    m0 = cache.acquire(3, long[:40] + [1])
    cache.note_heat(m0, np.full(10, 0.5))
    assert first == 10 and cache.insert(3, long) == 10
    assert cache.heats.ema.size == 32
    cache.release(m0)
    m = cache.acquire(3, long + [1])
    want = [0.5] * 10 + [0.0] * 10
    for step in range(3):
        h = np.arange(1, 21, dtype=np.float64) / (step + 3)
        cache.note_heat(m, h)
        want = [0.5 * w + float(x) for w, x in zip(want, h)]
    chain = sorted(cache.entries.values(), key=lambda e: e.depth)
    assert [e.heat for e in chain] == want


def test_heat_counters():
    """``prefix.heat_rows`` / ``prefix.heat_entries`` count the rows folded
    and the entries of each, the shorter of the chain and the heat row;
    nothing without telemetry."""
    from repro_torch.obs import Telemetry
    c, mm, cache, n = _seeded("repro_torch", PROMPT)
    cache.telemetry = tel = Telemetry()
    mm.create_process(2, app="app", vma_blocks=16)
    m = cache.acquire(2, PROMPT + [5])
    for rows in (2, 4, 7):
        cache.note_heat(m, np.ones(rows))
    assert tel.counters["prefix.heat_rows"] == 3
    assert tel.counters["prefix.heat_entries"] == 2 + 4 + 4
    cache.telemetry = None
    cache.note_heat(m, np.ones(4))
    assert tel.counters["prefix.heat_rows"] == 3


# ------------------------------------------------------ engine heat fold
def _doc_requests(cfg, shared: bool):
    """24 requests over two 24-token documents (or, unshared, each over a
    document of its own), each with a 3-5 token question."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(17)
    docs = [rng.integers(1, cfg.vocab, 24).tolist() for _ in range(2)]
    out = []
    for rid in range(24):
        doc = (docs[int(rng.integers(0, 2))] if shared
               else rng.integers(1, cfg.vocab, 24).tolist())
        q = rng.integers(1, cfg.vocab, int(rng.integers(3, 6))).tolist()
        out.append(Request(rid=rid, prompt=doc + q, max_new_tokens=12,
                           app="doc"))
    return out


def _evict_cold_program(min_heat: int):
    """mm_evict: over budget, drop unpinned entries whose PAGE_HEAT is
    below ``min_heat`` (so the eviction order follows the heat)."""
    from repro_torch.core import CTX, EVICT_DROP
    from repro_torch.core.isa import Asm
    a = Asm()
    a.ldctx("r1", CTX.CACHE_REFCOUNT)
    a.jgei("r1", 1, "keep")
    a.ldctx("r2", CTX.CACHE_USED_BLOCKS)
    a.ldctx("r3", CTX.CACHE_CAP_BLOCKS)
    a.jle("r2", "r3", "keep")
    a.ldctx("r4", CTX.PAGE_HEAT)
    a.jgei("r4", min_heat, "keep")
    a.movi("r0", EVICT_DROP)
    a.exit()
    a.label("keep")
    a.ldctx("r0", CTX.PAGE_TIER)
    a.exit()
    return a.build("evict_cold")


def _serve_docs(monkeypatch, *, shared=True, fold=None, trace=False):
    """The document mix on a smoke engine (cap 10 blocks, the evict program
    above): finished tokens, every entry's heat by key, the entry ids in
    the order they were dropped, the telemetry and the steps run."""
    from repro_torch.core import HOOK_EVICT
    from repro_torch.serving import PrefixCache, ServingEngine
    from test_torch_engine import _smoke_engine_args
    dropped: list[int] = []
    drop = PrefixCache._drop

    def logged(self, e, gone):
        before = dict(self.entries)
        freed = drop(self, e, gone)
        dropped.extend(x.eid for k, x in before.items()
                       if k not in self.entries)
        return freed
    cfg, params, layout = _smoke_engine_args()
    with monkeypatch.context() as mp:
        if fold is not None:
            mp.setattr(PrefixCache, "note_heat", fold)
        mp.setattr(PrefixCache, "_drop", logged)
        eng = ServingEngine(cfg, params, layout, max_batch=4,
                            policy="never", prefix_cache=10,
                            evict_policy="default", telemetry=True,
                            trace=trace, device="cpu")
        eng.mm.attach_evict_program(_evict_cold_program(2500))
        eng.mm.hooks.warm(HOOK_EVICT, max_batch=32)
        for req in _doc_requests(cfg, shared):
            eng.submit(req)
        steps = 0
        while eng.step():
            steps += 1
    heat = {k.hex(): float(e.heat).hex()
            for k, e in eng.prefix_cache.entries.items()}
    return {"finished": eng.finished, "heat": heat, "dropped": dropped,
            "steps": steps, "tel": eng.telemetry,
            "snapshot": eng.prefix_cache.snapshot(), "eng": eng}


def test_engine_heat_fold_matches_per_entry_loop(monkeypatch):
    """The document mix served with the array fold and with the
    reference's per-entry loop: every cached entry's heat bit for bit, the
    same entries dropped in the same order, the same tokens."""
    from repro.serving.prefix_cache import PrefixCache as RefCache
    arrays = _serve_docs(monkeypatch)
    loop = _serve_docs(monkeypatch, fold=RefCache.note_heat)
    snap = arrays["snapshot"]
    assert arrays["steps"] >= 40 and snap["hits"] >= 6
    assert snap["evict_drops"] > 0 and arrays["dropped"]
    assert arrays["finished"] == loop["finished"]
    assert len(arrays["finished"]) == 24
    assert arrays["heat"] == loop["heat"] and arrays["heat"]
    assert arrays["dropped"] == loop["dropped"]
    assert snap == loop["snapshot"]


def test_engine_heat_counters(monkeypatch, tmp_path):
    """On the document mix the counters equal the rows and chain entries
    folded (each row the shorter of its chain and its heat row), and reach
    ``snapshot()`` and the Chrome trace's entry counts; on a mix with no
    prefix hit both read 0."""
    import json
    from repro_torch.serving import PrefixCache
    folded = {"rows": 0, "entries": 0}
    fold = PrefixCache.note_heat

    def counted(self, match, heat_rows):
        folded["rows"] += 1
        folded["entries"] += min(len(match.entries), len(heat_rows))
        fold(self, match, heat_rows)
    run = _serve_docs(monkeypatch, fold=counted, trace=True)
    counters = run["tel"].snapshot()["counters"]
    assert folded["rows"] > 0 and folded["entries"] > folded["rows"]
    assert counters["prefix.heat_rows"] == folded["rows"]
    assert counters["prefix.heat_entries"] == folded["entries"]
    run["eng"].write_trace(tmp_path / "t.json")
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    entry = [e for e in events if e["name"] == "entry counts"]
    assert entry and entry[0]["args"]["prefix.heat_rows"] == folded["rows"]
    assert entry[0]["args"]["prefix.heat_entries"] == folded["entries"]

    folded.update(rows=0, entries=0)
    cold = _serve_docs(monkeypatch, shared=False, fold=counted)
    assert cold["snapshot"]["hits"] == 0 and len(cold["finished"]) == 24
    counters = cold["tel"].snapshot()["counters"]
    assert folded["rows"] == 0
    assert counters.get("prefix.heat_rows", 0) == 0
    assert counters.get("prefix.heat_entries", 0) == 0


# ----------------------------------------------------------- suffix prefill
NB, MB = 64, 16
TOL = 2e-5


@pytest.fixture(scope="module")
def models():
    import jax
    from repro.configs.base import get_smoke_config as jax_cfg
    from repro.models import materialize, model_spec
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.convert import params_from_jax
    jcfg = jax_cfg("deepseek_7b")
    jparams = materialize(jax.random.PRNGKey(0), model_spec(jcfg))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, get_smoke_config("deepseek_7b"), tparams


def _pool_arrays(cache):
    return {k: np.asarray(cache["s0"]["m0"][k], np.float32)
            if not isinstance(cache["s0"]["m0"][k], torch.Tensor)
            else cache["s0"]["m0"][k].float().numpy()
            for k in ("pool_k", "pool_v")}


@pytest.mark.parametrize("S0,L", [(8, 23), (10, 23), (13, 14)])
def test_prefill_suffix_matches_reference(models, S0, L):
    """Prefix KV written by a prefill of the first S0 tokens (whole blocks
    and, for S0 % 4 != 0, a partial tail the suffix then writes into), then
    the suffix [S0, L) through ``prefill_suffix_step``: logits and every
    pool cell agree with the reference's; and with the port's own full
    prefill of the L-token prompt."""
    import jax
    import jax.numpy as jnp
    from repro.models.decode import PagedLayout as JL
    from repro.models.decode import cache_init as jci
    from repro.models.decode import prefill_step as jpre
    from repro.models.decode import prefill_suffix_step as jsfx
    from repro_torch.models import PagedLayout, cache_init, prefill_step
    from repro_torch.models.common import F32
    from repro_torch.models.decode import prefill_suffix_step
    jcfg, jparams, tcfg, tparams = models
    jl, tl = JL(NB, BT, MB), PagedLayout(NB, BT, MB)
    rng = np.random.default_rng(S0 * 100 + L)
    prompt = rng.integers(1, jcfg.vocab, L).astype(np.int32)
    KB = -(-L // BT)
    table = np.full((1, MB), -1, np.int32)
    table[0, :KB] = rng.choice(NB, KB, replace=False)
    pb = -(-S0 // BT)
    pre = np.zeros((1, pb * BT), np.int32)
    pre[0, :S0] = prompt[:S0]
    sb = -(-(L - S0) // BT) * BT
    sfx = np.zeros((1, sb), np.int32)
    sfx[0, :L - S0] = prompt[S0:]
    last = np.asarray([L - S0 - 1], np.int32)

    jc = jci(jcfg, jl, 1, jnp.float32)
    _, jc = jpre(jparams, jcfg, jc, jnp.asarray(pre), jnp.asarray(table),
                 jl, compute_dtype=jnp.float32, chunk=8)
    jlog, jc = jax.jit(lambda p, c, t, tb, plen, li: jsfx(
        p, jcfg, c, t, tb, jl, prefix_len=plen, key_blocks=KB,
        compute_dtype=jnp.float32, chunk=8, last_index=li))(
        jparams, jc, jnp.asarray(sfx), jnp.asarray(table),
        jnp.asarray(S0, jnp.int32), jnp.asarray(last))

    tc = cache_init(tcfg, tl, 1, F32, device="cpu")
    prefill_step(tparams, tcfg, tc, torch.from_numpy(pre),
                 torch.from_numpy(table), tl, compute_dtype=F32, chunk=8)
    tlog, _ = prefill_suffix_step(
        tparams, tcfg, tc, torch.from_numpy(sfx), torch.from_numpy(table),
        tl, prefix_len=S0, key_blocks=KB, compute_dtype=F32, chunk=8,
        last_index=torch.from_numpy(last))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=TOL,
                               atol=TOL)
    jp, tp = _pool_arrays(jc), _pool_arrays(tc)
    for k in jp:
        assert np.array_equal(jp[k] != 0, tp[k] != 0), k
        np.testing.assert_allclose(tp[k], jp[k], rtol=TOL, atol=TOL,
                                   err_msg=k)

    # the port's full prefill of the whole prompt: same last-token logits
    # and the same KV in every cell the prompt occupies
    full = np.zeros((1, KB * BT), np.int32)
    full[0, :L] = prompt
    fc = cache_init(tcfg, tl, 1, F32, device="cpu")
    flog, _ = prefill_step(tparams, tcfg, fc, torch.from_numpy(full),
                           torch.from_numpy(table), tl, compute_dtype=F32,
                           chunk=8, last_index=torch.tensor([L - 1]))
    np.testing.assert_allclose(tlog.numpy(), flog.numpy(), rtol=TOL,
                               atol=TOL)
    fp = _pool_arrays(fc)
    for k in fp:
        rows = table[0, :KB]
        got = tp[k][:, rows].reshape(tp[k].shape[0], -1, *tp[k].shape[3:])
        want = fp[k][:, rows].reshape(got.shape)
        np.testing.assert_allclose(got[:, :L], want[:, :L], rtol=TOL,
                                   atol=TOL, err_msg=k)
