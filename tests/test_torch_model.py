"""The port's paged prefill and decode against the reference's, on the
deepseek_7b smoke config with the reference's params converted.

Both run in float32 (compute and cache), so the comparison holds the
algorithm — paging, masking, RoPE, the KV scatters, exact heat — rather than
two frameworks' bf16 rounding, which ``tests/test_torch_engine.py`` covers
end to end.  Tolerance 2e-5, the repo's float32 tolerance: the two sides
sum their float32 matrix products in different orders.

The KV pools must hold the same cells after prefill and every decode step
(every cell written by one side is written by the other, and no other cell
changes), with the ``active`` mask exercised: an inactive row's scatter is
dropped, so its next block stays untouched.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import materialize as jax_materialize
from repro.models import model_spec as jax_model_spec
from repro.models.decode import PagedLayout as JaxLayout
from repro.models.decode import cache_init as jax_cache_init
from repro.models.decode import decode_step as jax_decode_step
from repro.models.decode import prefill_step as jax_prefill_step

from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import PagedLayout, cache_init, decode_step, \
    prefill_step
from repro_torch.models.common import F32

TOL = 2e-5
NB, BT, MB = 64, 4, 16


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("deepseek_7b")
    jparams = jax_materialize(jax.random.PRNGKey(0), jax_model_spec(jcfg))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, get_smoke_config("deepseek_7b"), tparams


def _pools(jcache, tcache):
    j = {k: np.asarray(jcache["s0"]["m0"][k]) for k in ("pool_k", "pool_v")}
    t = {k: tcache["s0"]["m0"][k].numpy() for k in ("pool_k", "pool_v")}
    return j, t


def _check_pools(jcache, tcache, what):
    j, t = _pools(jcache, tcache)
    for k in j:
        assert np.array_equal(j[k] != 0, t[k] != 0), f"{what}: {k} cells"
        np.testing.assert_allclose(t[k], j[k], rtol=TOL, atol=TOL,
                                   err_msg=f"{what}: {k}")


def test_prefill_and_decode_match_reference(models):
    jcfg, jparams, tcfg, tparams = models
    jl, tl = JaxLayout(NB, BT, MB), PagedLayout(NB, BT, MB)
    jcache = jax_cache_init(jcfg, jl, 2, jnp.float32)
    tcache = cache_init(tcfg, tl, 2, F32, device="cpu")
    rng = np.random.default_rng(0)
    table = np.full((2, MB), -1, np.int32)
    table[0, :9] = rng.choice(NB // 2, 9, replace=False)
    table[1, :8] = NB // 2 + rng.choice(NB // 2, 8, replace=False)
    prompts = [rng.integers(1, jcfg.vocab, 24), rng.integers(1, jcfg.vocab, 19)]
    jpf = jax.jit(lambda p, c, t, tb, last: jax_prefill_step(
        p, jcfg, c, t, tb, jl, compute_dtype=jnp.float32, chunk=8,
        last_index=last))
    for row, prompt in enumerate(prompts):
        S = -(-len(prompt) // BT) * BT
        toks = np.zeros((1, S), np.int32)
        toks[0, :len(prompt)] = prompt
        last = np.asarray([len(prompt) - 1], np.int32)
        jlog, jcache = jpf(jparams, jcache, jnp.asarray(toks),
                           jnp.asarray(table[row:row + 1]), jnp.asarray(last))
        tlog, _ = prefill_step(tparams, tcfg, tcache, torch.from_numpy(toks),
                               torch.from_numpy(table[row:row + 1]), tl,
                               compute_dtype=F32, chunk=8,
                               last_index=torch.from_numpy(last))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=TOL,
                                   atol=TOL, err_msg=f"prefill row {row}")
    _check_pools(jcache, tcache, "after prefill")

    jdec = jax.jit(lambda p, c, t, ln, tb, act: jax_decode_step(
        p, jcfg, c, t, ln, tb, jl, active=act, compute_dtype=jnp.float32))
    lengths = np.asarray([len(p) for p in prompts], np.int32)
    tokens = np.asarray([p[-1] for p in prompts], np.int32)
    for step in range(6):
        active = np.asarray([True, step % 3 != 1])
        jlog, jcache, jheat = jdec(jparams, jcache, jnp.asarray(tokens),
                                   jnp.asarray(lengths), jnp.asarray(table),
                                   jnp.asarray(active))
        before = tcache["s0"]["m0"]["pool_k"].clone()
        tlog, _, theat = decode_step(
            tparams, tcfg, tcache, torch.from_numpy(tokens),
            torch.from_numpy(lengths), torch.from_numpy(table), tl,
            active=torch.from_numpy(active), compute_dtype=F32)
        what = f"decode step {step}"
        np.testing.assert_allclose(tlog.numpy()[active],
                                   np.asarray(jlog)[active], rtol=TOL,
                                   atol=TOL, err_msg=what)
        np.testing.assert_allclose(theat.numpy(), np.asarray(jheat),
                                   rtol=TOL, atol=TOL, err_msg=what)
        _check_pools(jcache, tcache, what)
        if not active[1]:
            blk = table[1, lengths[1] // BT]
            assert torch.equal(tcache["s0"]["m0"]["pool_k"][:, blk],
                               before[:, blk]), "inactive row scattered KV"
            assert not theat[1].any()
        tokens = np.array(jnp.argmax(jlog, axis=-1), np.int32)
        lengths = lengths + active.astype(np.int32)
