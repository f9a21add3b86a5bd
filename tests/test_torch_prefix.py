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


SCRIPTS = {
    "shared_primitives": _s_shared_primitives,
    "admission": _s_admission,
    "ghost": _s_ghost,
    "pinned": _s_pinned,
    "tiered_scan": _s_tiered_scan,
    "doorkeeper": _s_doorkeeper,
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
