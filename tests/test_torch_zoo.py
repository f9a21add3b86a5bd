"""The port's last four model families against the reference: MLA
(deepseek-v2-lite), mamba2, jamba (hybrid) and Whisper (encoder-decoder),
each on its smoke config with the reference's params converted and inputs
drawn from numpy seeds.

  * per module: ``mla_expand_attention`` (with a query offset),
    ``paged_decode_attention_mla_gather`` (output and heat),
    ``decode_attention_dense``, ``_causal_conv``, ``ssd_chunked``,
    ``mamba_apply`` with its state, a chain of ``mamba_decode_step``s,
    ``encoder_forward``, the cross-attention and the sinusoidal helpers:
    float32 to 2e-5 and bf16 to 2e-2 (the tolerances of
    ``tests/test_kernels.py``), the SSD scan to 1e-4 (``tests/
    test_layers.py``'s), the sinusoids bit for bit;
  * ``model_spec`` and ``params_from_jax`` over every leaf of the four
    specs, the encoder's stacked subtree included;
  * ``prefill_step`` + ``decode_step`` per arch in float32: logits, heat and
    every pool and state cell;
  * the serving engine per arch on the batched route, and a prefix-cache
    run on dsv2lite-smoke, against the reference run in a child process
    (``test_torch_engine.run_reference_archs``), the reference's tokens and
    heat replayed;
  * the prefix-cache guard and the suffix prefill's rejections.

Layer kinds: the reference's plans carry the config's kind ("a" / "m") and
its layer code takes the mamba branch for kind "mamba", which no plan has.
So both packages serve mamba2 (no MLP) and jamba with attention at every
layer, and the engine tests hold the port to that.  The mamba branches of
``prefill_step`` / ``decode_step`` / ``cache_init`` are held to the
reference's same branches by patching both packages' plans to kind
"mamba" (``live_mamba``).

Whisper's engine runs with ``max_batch=3``: at 2, equal to whisper-smoke's
two stacked decoder layers, the reference's per-slot view slices the layer
axis instead of the slot axis and its prefill scan fails.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_configs
from repro.models import attention as jax_attention
from repro.models import common as jax_common
from repro.models import decode as jax_decode
from repro.models import mamba2 as jax_mamba
from repro.models import materialize as jax_materialize
from repro.models import transformer as jax_transformer
from repro.serving.engine import ServingEngine as JaxEngine

from repro_torch.configs import base as configs
from repro_torch.convert import params_from_jax
from repro_torch.kernels.block_copy.ops import block_copy
from repro_torch.models import (PagedLayout, cache_init, decode_step,
                                model_spec, prefill_step)
from repro_torch.models import attention, common, mamba2, transformer
from repro_torch.models import decode as port_decode
from repro_torch.models.common import BF16, F32

from test_torch_engine import (assert_same_run, drive, run_reference_archs,
                               workload_spec)
from test_torch_families import _np, _pair, _shapes, _unstacked
from test_torch_prefix import PREFIX_BASE

ZOO = ("deepseek_v2_lite_16b", "mamba2_1p3b", "jamba_v0_1_52b",
       "whisper_medium")
TOL = {F32: 2e-5, BF16: 2e-2}
DTYPES = pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
NB, BT, MB = 64, 4, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(out, ref, dtype, tol=None, what=""):
    tol = TOL[dtype] if tol is None else tol
    np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol,
                               err_msg=what)


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ------------------------------------------------------------- attention

@DTYPES
@pytest.mark.parametrize("offset", [0, 8])
def test_mla_expand_attention(dtype, offset):
    """MLA's expanded prefill (query/key heads of 16 + 8, value heads of
    16), causal, and the suffix prefill's query offset (queries for the
    last Sk - offset positions)."""
    rng = np.random.default_rng(offset)
    B, Sk, H, L, Dn, Dr, Dv = 2, 24, 4, 32, 16, 8, 16
    Sq = Sk - offset
    arrs = [_rand(rng, B, Sq, H, Dn), _rand(rng, B, Sq, H, Dr),
            _rand(rng, B, Sk, L), _rand(rng, B, Sk, Dr),
            _rand(rng, H, L, Dn, scale=0.2), _rand(rng, H, L, Dv, scale=0.2)]
    pairs = [_pair(a, dtype) for a in arrs]
    ref = jax_attention.mla_expand_attention(*(j for j, _ in pairs),
                                             chunk=8, q_offset=offset)
    out = attention.mla_expand_attention(*(t for _, t in pairs), chunk=8,
                                         q_offset=offset)
    assert out.shape == (B, Sq, H, Dv) and out.dtype == dtype
    _close(out, ref, dtype)


@DTYPES
def test_paged_decode_attention_mla_gather(dtype):
    """The latent gather over the paged pool: output and the exact per-block
    heat, with an unmapped tail, a short row and an inactive row."""
    rng = np.random.default_rng(1)
    B, H, L, Dr, bt, nb, mb = 3, 4, 32, 8, 4, 40, 10
    q_eff, q_rope = _rand(rng, B, H, L), _rand(rng, B, H, Dr)
    pool = _rand(rng, nb, bt, L + Dr)
    table = np.stack([rng.choice(nb, mb, replace=False)
                      for _ in range(B)]).astype(np.int32)
    table[1, 6:] = -1
    table[2] = -1
    lengths = np.asarray([37, 23, 0], np.int32)
    jq, tq = _pair(q_eff, dtype)
    jr, tr = _pair(q_rope, dtype)
    jp, tp = _pair(pool, dtype)
    ref = jax_decode.paged_decode_attention_mla_gather(
        jq, jr, jp, jnp.asarray(table), jnp.asarray(lengths), block_tokens=bt,
        kv_lora=L, qk_nope=16)
    out = port_decode.paged_decode_attention_mla_gather(
        tq, tr, tp, torch.from_numpy(table), torch.from_numpy(lengths),
        block_tokens=bt, kv_lora=L, qk_nope=16)
    for o, r, what in zip(out, ref, ("o_lat", "heat")):
        _close(o, r, F32, tol=TOL[dtype], what=what)
    assert float(out[1].sum()) == pytest.approx(2 * H, rel=1e-5)


@DTYPES
@pytest.mark.parametrize("kw", [{}, {"window": 5, "soft_cap": 20.0}],
                         ids=["plain", "window-softcap"])
def test_decode_attention_dense(dtype, kw):
    """Whisper's cross-attention decode against the dense per-slot cache,
    GQA 2:1, ragged lengths."""
    rng = np.random.default_rng(2)
    B, H, KVH, S, D = 3, 4, 2, 16, 16
    q, k, v = _rand(rng, B, H, D), _rand(rng, B, S, KVH, D), \
        _rand(rng, B, S, KVH, D)
    lengths = np.asarray([16, 9, 1], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    ref = jax_attention.decode_attention_dense(jq, jk, jv,
                                               jnp.asarray(lengths), **kw)
    out = attention.decode_attention_dense(tq, tk, tv,
                                           torch.from_numpy(lengths), **kw)
    assert out.dtype == dtype
    _close(out, ref, dtype)


# ---------------------------------------------------------------- mamba2

MCFG = dict(d_state=8, head_dim=8, expand=2, chunk=4, conv_dim=4)


def _mamba_params(d, seed=0):
    jcfg = jax_configs.MambaCfg(**MCFG)
    jp = jax_materialize(jax.random.PRNGKey(seed),
                         jax_mamba.mamba_spec(d, jcfg))
    # non-trivial decays, skips and biases (the spec inits them to 0 / 1)
    rng = np.random.default_rng(seed)
    jp = dict(jp)
    for name in ("A_log", "dt_bias", "conv_b", "D"):
        jp[name] = jnp.asarray(_rand(rng, *jp[name].shape, scale=0.5))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, configs.MambaCfg(**MCFG), jp, tp


@DTYPES
def test_causal_conv(dtype):
    rng = np.random.default_rng(3)
    u, w, b = _rand(rng, 2, 11, 24), _rand(rng, 4, 24, scale=0.5), \
        _rand(rng, 24)
    (ju, tu), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (u, w, b))
    _close(mamba2._causal_conv(tu, tw, tb),
           jax_mamba._causal_conv(ju, jw, jb), dtype)


@pytest.mark.parametrize("S,chunk", [(16, 4), (12, 12), (24, 8)])
def test_ssd_chunked(S, chunk):
    """The chunked SSD scan and its final state, to the 1e-4 that
    ``tests/test_layers.py`` holds the reference's scan to."""
    rng = np.random.default_rng(S)
    Bsz, H, P, N = 2, 3, 8, 4
    x = _rand(rng, Bsz, S, H, P)
    dt = np.abs(_rand(rng, Bsz, S, H)) * 0.5
    A = -np.abs(_rand(rng, H))
    Bm, Cm = _rand(rng, Bsz, S, N), _rand(rng, Bsz, S, N)
    ref = jax_mamba.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                                chunk)
    out = mamba2.ssd_chunked(*(torch.from_numpy(a)
                               for a in (x, dt, A, Bm, Cm)), chunk)
    for o, r in zip(out, ref):
        _close(o, r, F32, tol=1e-4)
    with pytest.raises(AssertionError, match="divisible"):
        mamba2.ssd_chunked(*(torch.from_numpy(a[:, :S - 1]) if a.ndim > 1
                             else torch.from_numpy(a)
                             for a in (x, dt, A, Bm, Cm)), chunk)


@DTYPES
@pytest.mark.parametrize("S", [2, 12])
def test_mamba_apply_with_state(dtype, S):
    """The full-sequence path and the decode state it hands over (``ssm``
    in the input's dtype, the last K-1 conv inputs; a prompt shorter than
    K-1 is left-padded)."""
    d = 16
    jcfg, cfg, jp, tp = _mamba_params(d)
    x = _rand(np.random.default_rng(4), 2, S, d)
    jx, tx = _pair(x, dtype)
    jout, jst = jax.jit(lambda p, x: jax_mamba.mamba_apply(
        p, x, jcfg, return_state=True))(jp, jx)
    out, st = mamba2.mamba_apply(tp, tx, cfg, return_state=True)
    _close(out, jout, dtype, tol=max(TOL[dtype], 1e-4))
    for key in ("ssm", "conv"):
        assert st[key].dtype == dtype and st[key].shape == jst[key].shape
        _close(st[key], jst[key], dtype, tol=max(TOL[dtype], 1e-4),
               what=key)


@DTYPES
def test_mamba_decode_chain(dtype):
    """A prefill's state, then six decode steps, each fed the previous
    step's state (stored in the state's dtype, rounded every step)."""
    d = 16
    jcfg, cfg, jp, tp = _mamba_params(d, seed=1)
    rng = np.random.default_rng(5)
    jx, tx = _pair(_rand(rng, 2, 8, d), dtype)
    _, jst = jax.jit(lambda p, x: jax_mamba.mamba_apply(
        p, x, jcfg, return_state=True))(jp, jx)
    _, st = mamba2.mamba_apply(tp, tx, cfg, return_state=True)
    jstep = jax.jit(lambda p, y, st: jax_mamba.mamba_decode_step(p, y, st,
                                                                  jcfg))
    tol = max(TOL[dtype], 1e-4)
    for step in range(6):
        jy, ty = _pair(_rand(rng, 2, d), dtype)
        jout, jst = jstep(jp, jy, jst)
        out, st = mamba2.mamba_decode_step(tp, ty, st, cfg)
        _close(out, jout, dtype, tol=tol, what=f"step {step}")
        for key in ("ssm", "conv"):
            _close(st[key], jst[key], dtype, tol=tol, what=f"{key} {step}")
    init = mamba2.mamba_state_init(3, d, cfg, BF16, device="cpu")
    jinit = jax_mamba.mamba_state_init(3, d, jcfg, jnp.bfloat16)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in jinit.items()}


# --------------------------------------------------------------- whisper

def _whisper(dtype):
    jcfg = jax_configs.get_smoke_config("whisper_medium")
    cfg = configs.get_smoke_config("whisper_medium")
    jparams = jax_materialize(jax.random.PRNGKey(0),
                              jax_transformer.model_spec(jcfg))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


@DTYPES
def test_encoder_forward(dtype):
    jcfg, cfg, jparams, params = _whisper(dtype)
    frames = _rand(np.random.default_rng(6), 2, jcfg.enc_frames,
                   jcfg.d_model)
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    ref = jax.jit(lambda p, f: jax_transformer.encoder_forward(
        p, jcfg, f, compute_dtype=jdt, chunk=8, remat=False))(
            jparams["encoder"], jnp.asarray(frames))
    out = transformer.encoder_forward(
        params["encoder"], cfg, torch.from_numpy(frames),
        compute_dtype=dtype, chunk=8)
    assert out.dtype == dtype
    _close(out, ref, dtype)


@DTYPES
def test_xattn_forward(dtype):
    """Decoder rows against the encoder's frames (non-causal, Sq != Sk);
    the cached K/V are the projections the reference caches."""
    jcfg, cfg, jparams, params = _whisper(dtype)
    rng = np.random.default_rng(7)
    h, enc = _rand(rng, 2, 10, jcfg.d_model), _rand(rng, 2, jcfg.enc_frames,
                                                    jcfg.d_model)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["s0"]["m0"]["xattn"])
    tp = params["blocks"]["s0"][0]["m0"]["xattn"]
    (jh, th), (je, te) = _pair(h, dtype), _pair(enc, dtype)
    ref = jax_transformer._xattn_forward(jcfg, jp, jh, je, 8)
    k, v = transformer._xattn_kv(cfg, tp, te)
    out = transformer._xattn_forward(cfg, tp, th, k, v, 8)
    _close(out, ref, dtype)
    jk = (je @ jp["wk"].astype(je.dtype)).reshape(k.shape)
    _close(k, jk, dtype)


def test_sinusoidal_helpers_bit_for_bit():
    for d in (64, 1024):
        assert np.array_equal(common.sinusoidal_positions(300, d).numpy(),
                              np.asarray(jax_common.sinusoidal_positions(
                                  300, d)))
        pos = np.asarray([0, 1, 7, 99, 127, 300], np.int32)
        ref = jax_common.sinusoidal_position_at(jnp.asarray(pos), d)
        out = common.sinusoidal_position_at(torch.from_numpy(pos), d,
                                            max_pos=301)
        assert out.dtype == F32 and np.array_equal(out.numpy(),
                                                   np.asarray(ref))


# ------------------------------------------------------ spec and convert

# (arch, live): each family as served, and the two with mamba-kind layers
# with those layers live (``live_mamba``)
ARCH_CASES = pytest.mark.parametrize(
    "arch,live", [(a, False) for a in ZOO]
    + [("mamba2_1p3b", True), ("jamba_v0_1_52b", True)],
    ids=[f"{a}-served" for a in ZOO]
    + ["mamba2_1p3b-live-mamba", "jamba_v0_1_52b-live-mamba"])

def live_mamba(monkeypatch):
    """Give both packages' mamba-kind layers plan kind "mamba", so their
    layer code takes its mamba branch (the reference's plans carry "m",
    which its branches never test for)."""
    def patch(mod_t, mod_d):
        orig = mod_t.build_layer_plans

        def plans(cfg, *, decoder=True):
            return [dataclasses.replace(p, kind="mamba") if p.kind == "m"
                    else p for p in orig(cfg, decoder=decoder)]
        monkeypatch.setattr(mod_t, "build_layer_plans", plans)
        monkeypatch.setattr(mod_d, "build_layer_plans", plans)
    patch(jax_transformer, jax_decode)
    patch(transformer, port_decode)


@ARCH_CASES
def test_model_spec_and_convert_cover_the_reference(monkeypatch, arch,
                                                    live):
    """The port's spec has the reference's leaves and shapes (segments and
    Whisper's encoder unstacked), and ``params_from_jax`` carries every leaf
    of the reference's params into exactly that tree: MLA's ``w_dkv``,
    ``kv_norm``, ``w_uk``, ``w_uv``; mamba's ``in_proj`` .. ``out_proj``
    (with the plans patched live); the encoder's blocks and final norm."""
    if live:
        live_mamba(monkeypatch)
    cfg = configs.get_smoke_config(arch)
    jcfg = jax_configs.get_smoke_config(arch)
    jspec = jax_transformer.model_spec(jcfg)
    spec = _shapes(model_spec(cfg))
    want = _unstacked(jspec)
    if "encoder" in jspec:
        enc = jspec["encoder"]
        want["encoder"] = {
            "blocks": _unstacked({"blocks": {"s": enc["blocks"]}})[
                "blocks"]["s"],
            "final_norm": enc["final_norm"]}
    assert spec == _shapes(want)
    jparams = jax_materialize(jax.random.PRNGKey(0), jspec)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert _shapes(params) == spec
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    assert sum(int(np.prod(s)) for s in spec.values()) == n_ref
    names = {k.rsplit("/", 1)[-1] for k in spec}
    if cfg.mla is not None:
        assert {"w_dkv", "kv_norm", "w_uk", "w_uv"} <= names
    if live:
        assert {"in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D",
                "norm", "out_proj"} <= names
    if cfg.enc_dec:
        assert any(k.startswith("/encoder/blocks[") for k in spec)


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_every_arch_builds_spec_and_cache(arch):
    """No arch is rejected: every config builds a spec and a serving cache
    whose leaves have the reference's shapes."""
    cfg = configs.get_smoke_config(arch)
    model_spec(cfg)
    cache = cache_init(cfg, PagedLayout(NB, BT, MB), 3, device="cpu")
    ref = jax_decode.cache_init(jax_configs.get_smoke_config(arch),
                                jax_decode.PagedLayout(NB, BT, MB), 3)
    assert _shapes(cache) == _shapes(ref)


# ------------------------------------------------- prefill and decode

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, (tree.float().numpy() if isinstance(tree, torch.Tensor)
                       else np.asarray(jnp.asarray(tree).astype(jnp.float32)))


def _ref_slot(jcache, batch):
    """What the reference engine's per-slot cache helpers read of it."""
    return types.SimpleNamespace(cache=jcache, max_batch=batch,
                                 _POOL_KEYS=JaxEngine._POOL_KEYS)


@ARCH_CASES
def test_prefill_and_decode_match_reference(monkeypatch, arch, live):
    """float32 prefill of three prompts, each through its slot's view of
    the cache (the reference's own ``_slot_cache_view`` /
    ``_merge_slot_cache``, the port's ``slot_cache_view``), then six decode
    steps with one row inactive every third step: logits, heat and every
    pool and state cell (MLA latents, K/V, mamba ``ssm``/``conv``,
    Whisper's ``xk``/``xv``) to 2e-5.  Live mamba pads its prompts to a
    multiple of the SSD chunk (the reference's divisibility rule)."""
    if live:
        live_mamba(monkeypatch)
    jcfg = jax_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    jparams = jax_materialize(jax.random.PRNGKey(0),
                              jax_transformer.model_spec(jcfg))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    R = 3
    jl, tl = jax_decode.PagedLayout(NB, BT, MB), PagedLayout(NB, BT, MB)
    jcache = jax_decode.cache_init(jcfg, jl, R, jnp.float32)
    cache = cache_init(cfg, tl, R, F32, device="cpu")
    rng = np.random.default_rng(0)
    table = np.full((R, MB), -1, np.int32)
    blocks = rng.permutation(NB)
    for r, n in enumerate((9, 8, 7)):
        table[r, :n] = blocks[r * 16:r * 16 + n]
    prompts = [rng.integers(1, jcfg.vocab, n) for n in (24, 19, 14)]
    frames = _rand(rng, 1, jcfg.enc_frames, jcfg.d_model)
    pad = 8 if live else BT
    jpre = jax.jit(lambda p, c, t, tb, last, kw: jax_decode.prefill_step(
        p, jcfg, c, t, tb, jl, compute_dtype=jnp.float32, chunk=8,
        last_index=last, **kw))
    for row, prompt in enumerate(prompts):
        S = -(-len(prompt) // pad) * pad
        toks = np.zeros((1, S), np.int32)
        toks[0, :len(prompt)] = prompt
        last = np.asarray([len(prompt) - 1], np.int32)
        jkw, kw = {}, {}
        if jcfg.enc_dec:
            jkw, kw = ({"frames": jnp.asarray(frames)},
                       {"frames": torch.from_numpy(frames)})
        eng = _ref_slot(jcache, R)
        jlog, jnew = jpre(jparams, JaxEngine._slot_cache_view(eng, row),
                          jnp.asarray(toks), jnp.asarray(table[row:row + 1]),
                          jnp.asarray(last), jkw)
        JaxEngine._merge_slot_cache(eng, row, jnew)
        jcache = eng.cache
        log, _ = prefill_step(params, cfg,
                              port_decode.slot_cache_view(cache, row),
                              torch.from_numpy(toks),
                              torch.from_numpy(table[row:row + 1]), tl,
                              compute_dtype=F32, chunk=8,
                              last_index=torch.from_numpy(last), **kw)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=2e-5,
                                   atol=2e-5, err_msg=f"prefill row {row}")

    def check_cells(what):
        got = dict(_leaves(cache))
        want = dict(_leaves(jcache))
        assert sorted(got) == sorted(want)
        for path, a in want.items():
            b = got[path]
            assert np.array_equal(a != 0, b != 0), f"{what}: {path} cells"
            np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-5,
                                       err_msg=f"{what}: {path}")
    check_cells("after prefill")
    jdec = jax.jit(lambda p, c, t, ln, tb, act: jax_decode.decode_step(
        p, jcfg, c, t, ln, tb, jl, active=act, compute_dtype=jnp.float32))
    lengths = np.asarray([len(p) for p in prompts], np.int32)
    tokens = np.asarray([p[-1] for p in prompts], np.int32)
    for step in range(6):
        active = np.asarray([True, step % 3 != 1, True])
        jlog, jcache, jheat = jdec(jparams, jcache, jnp.asarray(tokens),
                                   jnp.asarray(lengths), jnp.asarray(table),
                                   jnp.asarray(active))
        log, _, heat = decode_step(
            params, cfg, cache, torch.from_numpy(tokens),
            torch.from_numpy(lengths), torch.from_numpy(table), tl,
            active=torch.from_numpy(active), compute_dtype=F32)
        what = f"decode step {step}"
        np.testing.assert_allclose(log.numpy()[active],
                                   np.asarray(jlog)[active], rtol=2e-5,
                                   atol=2e-5, err_msg=what)
        np.testing.assert_allclose(heat.numpy(), np.asarray(jheat),
                                   rtol=2e-5, atol=2e-5, err_msg=what)
        check_cells(what)
        tokens = np.array(jnp.argmax(jlog, axis=-1), np.int32)
        lengths = lengths + active.astype(np.int32)


def test_slot_cache_view_axes():
    """A scan segment's per-slot leaves narrow on axis 1 ([reps, B, ...]),
    a plain layer's on axis 0 — at reps == B too — the pools stay whole,
    and writes through a view land in the cache."""
    cache = {"s0": {"m0": {"pool_k": torch.zeros(2, 8, 4, 1, 2),
                           "xk": torch.zeros(2, 2, 5, 1, 2)}},
             "p1": {"pool_ckv": torch.zeros(8, 4, 3),
                    "ssm": torch.zeros(2, 3, 4, 4)}}
    view = port_decode.slot_cache_view(cache, 1)
    assert view["s0"]["m0"]["pool_k"] is cache["s0"]["m0"]["pool_k"]
    assert view["s0"]["m0"]["xk"].shape == (2, 1, 5, 1, 2)
    assert view["p1"]["ssm"].shape == (1, 3, 4, 4)
    assert view["p1"]["pool_ckv"] is cache["p1"]["pool_ckv"]
    view["s0"]["m0"]["xk"].fill_(1.0)
    view["p1"]["ssm"].fill_(2.0)
    assert cache["s0"]["m0"]["xk"][:, 1].eq(1).all()
    assert cache["s0"]["m0"]["xk"][:, 0].eq(0).all()
    assert cache["p1"]["ssm"][1].eq(2).all() and cache["p1"]["ssm"][0].eq(
        0).all()


def test_pool_leaves_and_empty_block_copy():
    """``pool_leaves`` collects MLA's latent pools (block copy and the tier
    moves carry them) and nothing of the per-slot state; block copy over no
    leaf moves nothing."""
    cfg = configs.get_smoke_config("deepseek_v2_lite_16b")
    cache = cache_init(cfg, PagedLayout(NB, BT, MB), 2, device="cpu")
    leaves = port_decode.pool_leaves(cache)
    assert [tuple(x.shape) for x in leaves] == [(1, NB, BT, 40)] * 3
    leaves[0][0, 3].fill_(1.0)
    block_copy(leaves, np.asarray([3], np.int32), np.asarray([9], np.int32))
    assert cache["s0"]["m0"]["pool_ckv"][0, 9].eq(1).all()
    wcfg = configs.get_smoke_config("whisper_medium")
    wcache = cache_init(wcfg, PagedLayout(NB, BT, MB), 3, device="cpu")
    assert [tuple(x.shape) for x in port_decode.pool_leaves(wcache)] == \
        [(2, NB, BT, 4, 16)] * 2
    block_copy([], np.asarray([0], np.int32), np.asarray([1], np.int32))


def test_suffix_prefill_rejects_sequential_state():
    """As in the reference: encoder-decoders and VLMs are rejected outright,
    and a mamba-kind or cross-attention layer cannot skip its prefix."""
    from repro_torch.models.decode import prefill_suffix_step
    toks = torch.zeros(1, 4, dtype=torch.long)
    tbl = torch.zeros(1, 4, dtype=torch.int32)
    lay = PagedLayout(NB, BT, MB)
    for arch in ("whisper_medium", "qwen2_vl_7b"):
        with pytest.raises(ValueError, match="plain decoder"):
            prefill_suffix_step({}, configs.get_smoke_config(arch), {}, toks,
                                tbl, lay, prefix_len=4, key_blocks=2)
    cfg = configs.get_smoke_config("jamba_v0_1_52b")
    params = {"embed": torch.zeros(512, cfg.d_model), "blocks": {
        "s0": [{f"m{j}": {} for j in range(8)}]}}
    cache = cache_init(cfg, lay, 1, F32, device="cpu")
    with pytest.raises(ValueError, match="layer kind 'm'"):
        prefill_suffix_step(params, cfg, cache, toks, tbl, lay,
                            prefix_len=4, key_blocks=2, compute_dtype=F32)


# ---------------------------------------------------------------- engine

def _spec_cases() -> dict:
    cases = {}
    for arch in ZOO:
        spec = {**workload_spec("W1", "ebpf", True), "arch": arch}
        if arch == "whisper_medium":
            spec["max_batch"] = 3
        cases[f"{arch}/W1/ebpf/batch"] = spec
    cases["deepseek_v2_lite_16b/prefix"] = dict(
        PREFIX_BASE, arch="deepseek_v2_lite_16b",
        engine={"prefix_cache": True})
    return cases


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_archs(tmp_path_factory, "test_torch_zoo",
                               per_arch=True)


@pytest.mark.parametrize("arch", ZOO)
def test_engine_matches_reference(reference, arch):
    """W1 (4 requests, prompt 100, 28 new, 256 blocks) on the batched
    route: per-step stats, ``MMStats``, moves, khugepaged and hook counters
    identical to the reference's, its tokens and heat replayed; the port's
    own greedy choice equals the reference's token wherever the top-2
    margin is at least 0.02.  MLA decodes through the latent gather and
    block copy moves its latent pools; Whisper feeds the reference's
    frames to each slot's encoder run."""
    results, params = reference
    name = f"{arch}/W1/ebpf/batch"
    ref = results[name]
    port = drive("repro_torch", _spec_cases()[name], params[arch],
                 replay=ref["samples"], replay_heat=ref["accesses"])
    assert_same_run(ref, port, replayed=True)
    assert len(ref["moves"]) >= 1 and ref["khugepaged"][0] >= 1
    assert ref["final"]["engine"]["completed"] == 4


def test_engine_prefix_cache_mla_matches_reference(reference):
    """The prefix-cache stream on dsv2lite-smoke: two hits prefill only
    their suffix over the latent pools (gathered prefix latents expanded,
    flash with a query offset); the run equals the reference's."""
    results, params = reference
    name = "deepseek_v2_lite_16b/prefix"
    ref = results[name]
    port = drive("repro_torch", _spec_cases()[name],
                 params["deepseek_v2_lite_16b"], replay=ref["samples"],
                 replay_heat=ref["accesses"])
    assert_same_run(ref, port, replayed=True)
    assert ref["prefix_cache"]["hits"] == 2
    assert ref["final"]["engine"]["completed"] == PREFIX_BASE["n_req"]


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "jamba_v0_1_52b",
                                  "whisper_medium"])
def test_prefix_cache_guard_matches_reference(reference, arch):
    """The prefix cache needs a plain all-attention decoder: layers of kind
    "m" (mamba2, jamba) and encoder-decoders (Whisper) are rejected by both
    engines."""
    from test_torch_executor import x64_shim
    from repro.models import PagedLayout as JaxLayout
    from repro_torch.serving import ServingEngine
    _, params = reference
    kw = dict(policy="thp", prefix_cache=True, batch_faults=False)
    with x64_shim(), pytest.raises(ValueError, match="prefix_cache"):
        JaxEngine(jax_configs.get_smoke_config(arch), {},
                  JaxLayout(NB, BT, MB), **kw)
    with pytest.raises(ValueError, match="prefix_cache"):
        ServingEngine(configs.get_smoke_config(arch), params[arch],
                      PagedLayout(NB, BT, MB), device="cpu", **kw)
