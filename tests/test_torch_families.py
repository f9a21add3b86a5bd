"""The port's model families against the reference: nemotron-4 (LayerNorm,
squared-ReLU MLP, GQA 8:2), phi-3 (dense), gemma-3 (5:1-style local:global
sliding window, QK-norm, GeGLU), deepseek-MoE (fine-grained routed experts
+ shared experts) and qwen2-VL (M-RoPE, stub patch embeddings), each on its
smoke config with the reference's params converted.

  * configs: every ``ARCH_IDS`` entry resolves to the reference's values
    (the other four families, MLA, mamba2, jamba and Whisper, are held to
    the reference in ``test_torch_zoo.py``);
  * the numeric helpers (``layer_norm``, ``activate``, ``apply_mrope``,
    QK-norm) and ``moe_apply`` — with a forced capacity that drops tokens,
    and the shared experts — against the reference's: float32 to 2e-5 and
    bf16 to 2e-2, the tolerances of ``tests/test_kernels.py``; the bf16
    activations bit for bit (the port evaluates them op by op, as XLA
    rounds them); ``moe_apply`` drops the same tokens;
  * ``model_spec`` shapes and ``params_from_jax`` coverage per arch;
  * ``prefill_step`` + ``decode_step`` in float32: logits, heat and every KV
    pool cell to 2e-5;
  * the serving engine per arch on a W1-like workload (4 requests, prompt
    100, 28 new, ``max_batch=2``, 256 blocks; longer than gemma-3-smoke's
    window of 8, so the window bites) on the batched route: per-step stats,
    ``MMStats``, moves and hook counters identical to the reference's,
    which runs in a child process (``test_torch_engine.run_reference``),
    with its tokens and heat replayed; the port's own greedy tokens agree
    outside near-ties (free-running, four of the five archs gave the
    reference's tokens bit for bit; phi-3-smoke flipped one at step 27).

M-RoPE: the reference evaluates cos/sin of runtime angles
``pos * freq`` in XLA; the port reads them from the same libm table RoPE
uses (channel c of stream s at position pos_s), which agrees with XLA's
CPU backend to one float32 unit in a rare angle (bf16 outputs: 1 element
in 19200 off by one unit at the smoke shape; logits within 2e-5 in
float32).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_configs
from repro.models import common as jax_common
from repro.models import materialize as jax_materialize
from repro.models import model_spec as jax_model_spec
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro.models.decode import PagedLayout as JaxLayout
from repro.models.decode import cache_init as jax_cache_init
from repro.models.decode import decode_step as jax_decode_step
from repro.models.decode import prefill_step as jax_prefill_step

from repro_torch.configs import base as configs
from repro_torch.convert import params_from_jax
from repro_torch.models import (PagedLayout, cache_init, decode_step,
                                model_spec, prefill_step)
from repro_torch.models import common, moe, transformer
from repro_torch.models.common import BF16, F32

from test_torch_engine import (assert_same_run, drive, run_reference_archs,
                               workload_spec)
from test_torch_prefix import PREFIX_BASE

ARCHS = ("nemotron_4_15b", "phi3_mini_3p8b", "gemma3_27b",
         "deepseek_moe_16b", "qwen2_vl_7b")
TOL = {F32: 2e-5, BF16: 2e-2}
NB, BT, MB = 64, 4, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(x: np.ndarray, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(dtype)


# ------------------------------------------------------------------ configs

# the fields the port's config dataclasses add to the reference's, and the
# published values DeepSeek-V2-Lite's full config gives them (its
# ``rope_scaling`` and ``norm_topk_prob``); every other config keeps them at
# their defaults
PORT_ONLY = {"attn": ("yarn_factor", "yarn_original_max_pos",
                      "yarn_beta_fast", "yarn_beta_slow", "yarn_mscale",
                      "yarn_mscale_all_dim"),
             "moe": ("norm_topk_prob",)}
PUBLISHED = {("deepseek_v2_lite_16b", "get_config"): {
    "attn": {"yarn_factor": 40.0, "yarn_original_max_pos": 4096,
             "yarn_beta_fast": 32.0, "yarn_beta_slow": 1.0,
             "yarn_mscale": 0.707, "yarn_mscale_all_dim": 0.707},
    "moe": {"norm_topk_prob": False}}}


def _split_port_only(d: dict) -> tuple[dict, dict]:
    """(the config's asdict without the port-only fields, those fields)."""
    d, extra = dict(d), {}
    for sub, names in PORT_ONLY.items():
        if d.get(sub) is not None:
            d[sub] = dict(d[sub])
            extra[sub] = {n: d[sub].pop(n) for n in names}
    return d, extra


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_configs_resolve_to_the_reference(arch):
    """Every arch id resolves in the port (full and smoke config), with
    the reference's values in every field the reference's dataclasses
    have; the fields only the port has sit at their defaults, except in
    DeepSeek-V2-Lite's full config, which gives them the published
    values."""
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    defaults = {"attn": dataclasses.asdict(configs.AttnCfg()),
                "moe": {"norm_topk_prob": True}}
    for get in ("get_config", "get_smoke_config"):
        port, extra = _split_port_only(
            dataclasses.asdict(getattr(configs, get)(arch)))
        ref = dataclasses.asdict(getattr(jax_configs, get)(arch))
        assert port == ref, get
        want = PUBLISHED.get((arch, get), {})
        for sub, vals in extra.items():
            expect = {n: want.get(sub, {}).get(n, defaults[sub][n])
                      for n in vals}
            assert vals == expect, (get, sub)


# ---------------------------------------------------------- numeric helpers

@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_layer_norm(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(256, 64)) * 3).astype(np.float32)
    sc, bi = (rng.normal(size=64).astype(np.float32) for _ in range(2))
    jx, tx = _pair(x, dtype)
    ref = jax_common.layer_norm(jx, jnp.asarray(sc), jnp.asarray(bi))
    out = common.layer_norm(tx, torch.from_numpy(sc), torch.from_numpy(bi))
    assert out.dtype == dtype
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("kind", ["gelu", "relu2", "silu", "relu"])
def test_activate_bf16_bit_for_bit(kind):
    """bf16 activations op by op: equal to the reference's, element for
    element (eager JAX rounds every op, as XLA does with excess precision
    off); float32 to 2e-5."""
    x = (np.random.default_rng(1).normal(size=(512, 64)) * 3
         ).astype(np.float32)
    for dtype in (BF16, F32):
        jx, tx = _pair(x, dtype)
        with jax.disable_jit():
            ref = jax_common.activate(jx, kind)
        out = common.activate(tx, kind)
        if dtype == BF16:
            assert np.array_equal(_np(out), _np(ref))
        else:
            np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5,
                                       atol=2e-5)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sections,hd,theta", [((4, 2, 2), 16, 1e4),
                                               ((16, 24, 24), 128, 1e6)])
def test_apply_mrope(dtype, sections, hd, theta):
    """M-RoPE with three distinct position streams (and, in the engine,
    equal ones)."""
    rng = np.random.default_rng(2)
    S = 96
    x = rng.normal(size=(2, S, 3, hd)).astype(np.float32)
    pos = np.stack([np.arange(S) // 4, np.arange(S) % 7,
                    np.arange(S)]).astype(np.int64)[:, None].repeat(2, 1)
    jx, tx = _pair(x, dtype)
    ref = jax_common.apply_mrope(jx, jnp.asarray(pos, jnp.float32), sections,
                                 theta=theta)
    out = common.apply_mrope(tx, torch.from_numpy(pos), sections, max_pos=S,
                             theta=theta)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])
    with pytest.raises(ValueError, match="sections"):
        common.apply_mrope(tx, torch.from_numpy(pos), (1, 1, 1), max_pos=S)


def test_qk_norm_projection():
    """``_project_qkv`` with QK-norm (gemma-3): q and k are RMS-normed per
    head over head_dim with their own scales, v is not."""
    jcfg = jax_configs.get_smoke_config("gemma3_27b")
    cfg = configs.get_smoke_config("gemma3_27b")
    rng = np.random.default_rng(3)
    p = {k: rng.normal(size=s.shape).astype(np.float32)
         for k, s in jax_transformer._attn_spec(jcfg).items()}
    h = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    ref = jax_transformer._project_qkv(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h))
    out = transformer._project_qkv(
        cfg, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(h))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(_np(o), _np(r), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------- MoE

MOE_CASES = {
    # name: (experts, top_k, d_ff_expert, shared, tokens, capacity, mlp)
    "smoke": (4, 2, 32, 1, 64, None, "swiglu"),
    "drops": (4, 2, 32, 1, 64, 6, "swiglu"),
    "fine-grained": (64, 6, 24, 2, 40, None, "swiglu"),
    "relu2-drops": (8, 2, 16, 0, 30, 3, "relu2"),
    "geglu": (8, 3, 16, 1, 30, None, "geglu"),
}


def _ref_dropped(jparams, x, cfg, capacity) -> int:
    """How many (token, expert) routes the reference's dispatch drops."""
    probs = jax.nn.softmax(x.astype(jnp.float32)
                           @ jparams["router"].astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=cfg.num_experts)
    if capacity is None:
        capacity = max(8, int(x.shape[0] * cfg.top_k / cfg.num_experts
                              * cfg.capacity_factor) + 1)
    return int(np.maximum(counts - capacity, 0).sum())


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case):
    E, K, fe, shared, T, cap, mlp = MOE_CASES[case]
    kw = dict(num_experts=E, top_k=K, d_ff_expert=fe, num_shared=shared)
    jcfg, cfg = jax_configs.MoECfg(**kw), configs.MoECfg(**kw)
    jparams = jax_materialize(jax.random.PRNGKey(1),
                              jax_moe.moe_spec(64, jcfg, mlp))
    params = params_from_jax({"blocks": {}, **jax.tree.map(np.asarray,
                                                           jparams)},
                             device="cpu")
    x = np.random.default_rng(4).normal(size=(T, 64)).astype(np.float32)
    dropped = _ref_dropped(jparams, jnp.asarray(x), jcfg, cap)
    if "drops" in case:
        assert dropped > 0
    outs = {}
    for dtype in (F32, BF16):
        jx, tx = _pair(x, dtype)
        with jax.disable_jit():
            ref, ref_aux = jax_moe._moe_apply_local(jparams, jx, jcfg, mlp,
                                                    capacity=cap)
        out, aux = moe.moe_apply(params, tx, cfg, mlp, capacity=cap)
        assert out.dtype == dtype and out.shape == (T, 64)
        np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=str(dtype))
        np.testing.assert_allclose(aux.item(), float(ref_aux), rtol=1e-5)
        outs[dtype] = out
    if cap is not None:
        # the dropped routes' gate mass is lost: at the default capacity
        # the output moves
        full, _ = moe.moe_apply(params, torch.from_numpy(x), cfg, mlp)
        assert (full - outs[F32]).abs().max() > 1e-3


def test_moe_combine_is_ordered():
    """Each token's routed contributions add in bf16 in increasing expert
    order, one rounding per add (the reference's scatter-add): a token whose
    contributions do not associate in bf16 gets the ordered sum."""
    cfg = configs.MoECfg(num_experts=4, top_k=3, d_ff_expert=8,
                         num_shared=0)
    d = 8
    eye = torch.eye(d)
    params = {"router": torch.zeros(d, 4),
              "w_in": torch.stack([eye] * 4), "w_gate": torch.stack([eye] * 4),
              "w_out": torch.stack([eye] * 4)}
    params["router"][0] = torch.tensor([3.0, 2.0, 1.0, 0.0])
    x = torch.zeros(1, d, dtype=BF16)
    x[0, 0] = 4.0
    y, _ = moe.moe_apply(params, x, cfg, "relu2")
    probs = torch.softmax(torch.tensor([12.0, 8.0, 4.0, 0.0]), 0)[:3]
    g = (probs / probs.sum()).to(BF16)
    acc = torch.zeros((), dtype=BF16)
    for e in range(3):                  # experts 0, 1, 2 in that order
        acc = acc + torch.tensor(16.0, dtype=BF16) * g[e]
    assert y[0, 0] == acc


# ------------------------------------------------------------ spec, convert

def _shapes(tree, prefix=""):
    """{path: shape} of a param spec or param tree, the reference's
    stacked ``[reps, ...]`` segment leaves unstacked as the port keeps
    them."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = tuple(tree.shape)
    return out


def _unstacked(jtree):
    blocks = {}
    for key, seg in jtree["blocks"].items():
        if key.startswith("s"):
            reps = next(iter(_shapes(seg).values()))[0]
            blocks[key] = [jax.tree.map(
                lambda p, r=r: jax.ShapeDtypeStruct(p.shape[1:], jnp.float32), seg,
                is_leaf=lambda p: hasattr(p, "shape")) for r in range(reps)]
        else:
            blocks[key] = seg
    return {**{k: v for k, v in jtree.items() if k != "blocks"},
            "blocks": blocks}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_spec_and_convert_cover_the_reference(arch):
    """The port's spec has the reference's leaves and shapes (segments
    unstacked), and ``params_from_jax`` carries every leaf of the
    reference's materialized params into exactly that tree."""
    cfg = configs.get_smoke_config(arch)
    jcfg = jax_configs.get_smoke_config(arch)
    spec = _shapes(model_spec(cfg))
    assert spec == _shapes(_unstacked(jax_model_spec(jcfg)))
    jparams = jax_materialize(jax.random.PRNGKey(0), jax_model_spec(jcfg))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert _shapes(params) == spec
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    assert sum(int(np.prod(s)) for s in spec.values()) == n_ref


# ------------------------------------------------------- prefill and decode

def _pool_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pool_leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree) if not isinstance(
            tree, torch.Tensor) else tree.numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """float32 prefill of two prompts and six decode steps (one row
    inactive every third step): logits, heat and every KV pool cell to
    2e-5.  qwen2-VL gets stub patches and position streams, as its engine
    makes them."""
    jcfg = jax_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    jparams = jax_materialize(jax.random.PRNGKey(0), jax_model_spec(jcfg))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jl, tl = JaxLayout(NB, BT, MB), PagedLayout(NB, BT, MB)
    jcache = jax_cache_init(jcfg, jl, 2, jnp.float32)
    cache = cache_init(cfg, tl, 2, F32, device="cpu")
    rng = np.random.default_rng(0)
    table = np.full((2, MB), -1, np.int32)
    table[0, :9] = rng.choice(NB // 2, 9, replace=False)
    table[1, :8] = NB // 2 + rng.choice(NB // 2, 8, replace=False)
    prompts = [rng.integers(1, jcfg.vocab, 24),
               rng.integers(1, jcfg.vocab, 19)]
    jpre = jax.jit(lambda p, c, t, tb, last, kw: jax_prefill_step(
        p, jcfg, c, t, tb, jl, compute_dtype=jnp.float32, chunk=8,
        last_index=last, **kw))
    for row, prompt in enumerate(prompts):
        S = -(-len(prompt) // BT) * BT
        toks = np.zeros((1, S), np.int32)
        toks[0, :len(prompt)] = prompt
        last = np.asarray([len(prompt) - 1], np.int32)
        jkw, kw = {}, {}
        if jcfg.vlm_patches:
            patches = rng.normal(size=(1, jcfg.vlm_patches, jcfg.d_model)
                                 ).astype(np.float32)
            pos = np.tile(np.arange(S), (3, 1, 1))
            jkw = dict(patches=jnp.asarray(patches),
                       pos3d=jnp.asarray(pos, jnp.float32))
            kw = dict(patches=torch.from_numpy(patches),
                      pos3d=torch.from_numpy(pos))
        jlog, jcache = jpre(jparams, jcache, jnp.asarray(toks),
                            jnp.asarray(table[row:row + 1]),
                            jnp.asarray(last), jkw)
        log, _ = prefill_step(params, cfg, cache, torch.from_numpy(toks),
                              torch.from_numpy(table[row:row + 1]), tl,
                              compute_dtype=F32, chunk=8,
                              last_index=torch.from_numpy(last), **kw)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=2e-5,
                                   atol=2e-5, err_msg=f"prefill row {row}")

    def check_pools(what):
        for (path, a), (_, b) in zip(_pool_leaves(jcache),
                                     _pool_leaves(cache)):
            assert np.array_equal(a != 0, b != 0), f"{what}: {path} cells"
            np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-5,
                                       err_msg=f"{what}: {path}")
    check_pools("after prefill")
    jdec = jax.jit(lambda p, c, t, ln, tb, act, kw: jax_decode_step(
        p, jcfg, c, t, ln, tb, jl, active=act, compute_dtype=jnp.float32,
        **kw))
    lengths = np.asarray([len(p) for p in prompts], np.int32)
    tokens = np.asarray([p[-1] for p in prompts], np.int32)
    for step in range(6):
        active = np.asarray([True, step % 3 != 1])
        jkw, kw = {}, {}
        if jcfg.vlm_patches:
            jkw = dict(pos3d=jnp.asarray(np.tile(
                lengths.astype(np.float32)[None, :, None], (3, 1, 1))))
            kw = dict(pos3d=torch.from_numpy(lengths)[None, :, None]
                      .expand(3, 2, 1))
        jlog, jcache, jheat = jdec(jparams, jcache, jnp.asarray(tokens),
                                   jnp.asarray(lengths), jnp.asarray(table),
                                   jnp.asarray(active), jkw)
        log, _, heat = decode_step(
            params, cfg, cache, torch.from_numpy(tokens),
            torch.from_numpy(lengths), torch.from_numpy(table), tl,
            active=torch.from_numpy(active), compute_dtype=F32, **kw)
        what = f"decode step {step}"
        np.testing.assert_allclose(log.numpy()[active],
                                   np.asarray(jlog)[active], rtol=2e-5,
                                   atol=2e-5, err_msg=what)
        np.testing.assert_allclose(heat.numpy(), np.asarray(jheat),
                                   rtol=2e-5, atol=2e-5, err_msg=what)
        check_pools(what)
        tokens = np.array(jnp.argmax(jlog, axis=-1), np.int32)
        lengths = lengths + active.astype(np.int32)


def test_suffix_prefill_rejects_vlm():
    from repro_torch.models.decode import prefill_suffix_step
    cfg = configs.get_smoke_config("qwen2_vl_7b")
    with pytest.raises(ValueError, match="plain decoder"):
        prefill_suffix_step({}, cfg, {}, torch.zeros(1, 4, dtype=torch.long),
                            torch.zeros(1, 4, dtype=torch.int32),
                            PagedLayout(NB, BT, MB), prefix_len=4,
                            key_blocks=2)


# ------------------------------------------------------------------ engine

PREFIX_ARCHS = ("nemotron_4_15b", "gemma3_27b", "deepseek_moe_16b")


def _spec_cases() -> dict:
    cases = {f"{arch}/W1/ebpf/batch": {**workload_spec("W1", "ebpf", True),
                                       "arch": arch}
             for arch in ARCHS}
    for arch in PREFIX_ARCHS:
        cases[f"{arch}/prefix"] = dict(PREFIX_BASE, arch=arch,
                                       engine={"prefix_cache": True})
    return cases


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_archs(tmp_path_factory, "test_torch_families")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(reference, arch):
    """Per-step stats, ``MMStats``, moves, khugepaged and hook counters of
    the batched route identical to the reference's, with the reference's
    tokens and DAMON heat replayed (as the tiered and prefix-cache engine
    tests do); the port's own greedy choice equals the reference's token at
    every sample whose top-2 margin is at least 0.02."""
    results, params = reference
    name = f"{arch}/W1/ebpf/batch"
    ref = results[name]
    port = drive("repro_torch", _spec_cases()[name], params[arch],
                 replay=ref["samples"], replay_heat=ref["accesses"])
    assert_same_run(ref, port, replayed=True)
    assert len(ref["moves"]) >= 1 and ref["khugepaged"][0] >= 1
    assert ref["hooks"]["batch_calls"]["mm_fault"] >= 1


@pytest.mark.parametrize("arch", PREFIX_ARCHS)
def test_engine_prefix_cache_matches_reference(reference, arch):
    """The prefix-cache stream of ``test_torch_prefix.py`` (a shared
    16-token prompt + 8 own tokens, one request after another) on the
    families' suffix prefill: LayerNorm and squared ReLU, windows of 8
    with QK-norm, MoE layers whose capacity counts the suffix rows.  Two
    hits skip their prefix; the run equals the reference's."""
    results, params = reference
    name = f"{arch}/prefix"
    ref = results[name]
    port = drive("repro_torch", _spec_cases()[name], params[arch],
                 replay=ref["samples"], replay_heat=ref["accesses"])
    assert_same_run(ref, port, replayed=True)
    assert ref["prefix_cache"]["hits"] == 2
    assert ref["final"]["engine"]["completed"] == PREFIX_BASE["n_req"]


def test_engine_rejects_prefix_cache_for_vlm(reference):
    from repro_torch.serving import ServingEngine
    _, params = reference
    cfg = configs.get_smoke_config("qwen2_vl_7b")
    with pytest.raises(ValueError, match="prefix_cache"):
        ServingEngine(cfg, params["qwen2_vl_7b"], PagedLayout(NB, BT, MB),
                      policy="thp", prefix_cache=True, device="cpu")
