"""The port's ``expand_moves`` / ``apply_moves`` (``repro_torch.kernels.
block_copy.ops``) and ``mla_absorbed_decode`` (``repro_torch.models.
attention``) against the reference's.

``apply_moves`` is held to the reference's ``apply_moves(interpret=True)``
(the Pallas block copy in interpret mode) bit for bit, with the self-copy
padding of ``expand_moves``; the port runs its plain version on CPU
tensors.  ``mla_absorbed_decode`` is held to the reference's at
deepseek-v2-lite smoke's MLA shapes in float32 (1e-5) and bf16 (2e-2).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

PLANS = [
    [(3, 40, 1), (100, 7, 0)],               # a 4-block run and one block
    [(0, 64, 2), (20, 5, 0), (21, 6, 0)],    # a 16-block run
    [],                                      # nothing: padding only
]


@pytest.mark.parametrize("pad_to", [None, 24])
@pytest.mark.parametrize("plan", PLANS)
def test_expand_moves_matches_reference(plan, pad_to):
    from repro.kernels.block_copy.ops import expand_moves as ref
    from repro_torch.kernels.block_copy.ops import expand_moves
    got, want = expand_moves(plan, pad_to), ref(plan, pad_to)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plan", PLANS)
def test_apply_moves_matches_reference_interpret(plan, dtype):
    import jax.numpy as jnp
    from repro.kernels.block_copy.ops import apply_moves as ref
    from repro.kernels.block_copy.ops import expand_moves
    from repro_torch.kernels.block_copy.ops import apply_moves
    rng = np.random.default_rng(len(plan))
    pool = rng.normal(size=(128, 4, 2, 8)).astype(np.float32)
    orig = pool.copy()
    src, dst = expand_moves(plan, pad_to=24)
    jpool = jnp.array(pool, dtype=getattr(jnp, dtype))     # a copy
    want = np.asarray(ref(jpool, jnp.asarray(src), jnp.asarray(dst),
                          interpret=True).astype(jnp.float32))
    tpool = torch.from_numpy(pool).to(getattr(torch, dtype))
    got = apply_moves(tpool, src, dst)
    assert got is tpool                      # in place
    np.testing.assert_array_equal(got.float().numpy(), want)
    before = np.asarray(jnp.array(orig, dtype=getattr(jnp, dtype))
                        .astype(jnp.float32))
    assert np.array_equal(want, before) == (not plan)


def test_apply_moves_needs_a_card_for_cuda_only():
    from repro_torch.kernels.block_copy import ops as bc
    before = bc.block_copy.launches
    pool = torch.zeros(8, 3)
    pool[1] = 1.0
    bc.apply_moves(pool, *bc.expand_moves([(1, 5, 0)], pad_to=4))
    assert pool[5].tolist() == [1.0, 1.0, 1.0]
    assert bc.block_copy.launches == before       # plain version: no launch


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_mla_absorbed_decode_matches_reference(dtype, tol):
    import jax.numpy as jnp
    from repro.configs.base import get_smoke_config
    from repro.models.attention import mla_absorbed_decode as ref
    from repro_torch.models.attention import mla_absorbed_decode
    m = get_smoke_config("deepseek_v2_lite_16b").mla
    H = get_smoke_config("deepseek_v2_lite_16b").n_heads
    B, S = 3, 40
    rng = np.random.default_rng(7)
    arrs = [rng.normal(size=s).astype(np.float32) for s in (
        (B, H, m.qk_nope), (B, H, m.qk_rope), (B, S, m.kv_lora),
        (B, S, m.qk_rope), (H, m.kv_lora, m.qk_nope),
        (H, m.kv_lora, m.v_head))]
    lengths = np.array([40, 17, 1], np.int32)
    jd = getattr(jnp, dtype)
    want = np.asarray(ref(*(jnp.asarray(a, jd) for a in arrs[:4]),
                          jnp.asarray(lengths),
                          *(jnp.asarray(a, jd) for a in arrs[4:]))
                      .astype(jnp.float32))
    td = getattr(torch, dtype)
    got = mla_absorbed_decode(*(torch.from_numpy(a).to(td)
                                for a in arrs[:4]),
                              torch.from_numpy(lengths),
                              *(torch.from_numpy(a).to(td)
                                for a in arrs[4:]))
    assert got.dtype == td and got.shape == (B, H, m.v_head)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * scale)
