"""DeepSeek-V2-Lite's configuration at smoke size with the published flags
(YaRN rope scaling, unnormalised top-k gates, a dropless capacity): the
program's prefill and decode through the paged latent cache against the
plain reference's full forward, a prefix-cache hit against a full prefill
at every layer, the reference's router against the program's, and the
harness on a smoke stand-in of ``dsv2lite.longdoc``, whose check fails
when tokens are altered where they are produced."""

import copy
import dataclasses

import pytest
import torch

from portbench import manifest
from portbench.reference import deepseek_v2 as ref
from portbench.serve import model_config, run_cell
from portbench.tests import smoke
from portbench.tests.test_portbench_faults import altered_tokens
from portbench.weights import make_params

SEED = 2 ** 31 + 3030
F32 = torch.float32


def config() -> dict:
    """``dsv2lite.json`` with every width and count shrunk, the published
    flags kept (YaRN, ``norm_topk_prob`` false, a capacity of E / K: no
    token dropped), at a deployment that fits a CPU run."""
    conf = copy.deepcopy(manifest.Manifest().config("dsv2lite"))
    m = conf["model"]
    m.update(n_layers=3, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
             vocab=512)
    m["mla"].update(kv_lora=32, qk_nope=16, qk_rope=8, v_head=16)
    m["moe"].update(num_experts=8, top_k=2, d_ff_expert=32, num_shared=1,
                    capacity_factor=4.0)
    conf["deployment"].update(max_batch=4, layout={
        "num_blocks": 256, "block_tokens": 16, "max_blocks": 16})
    return conf


def _model():
    from repro_torch.models import model_spec
    conf = config()
    cfg = model_config(conf["model"])
    params = make_params(model_spec(cfg), SEED, device="cpu", dtype=F32)
    return conf, cfg, params


def test_smoke_keeps_the_published_flags():
    conf, cfg, _ = _model()
    assert cfg.attn.yarn_factor == 40.0 and cfg.attn.yarn_mscale_all_dim
    assert cfg.moe.norm_topk_prob is False
    assert cfg.moe.capacity_factor * cfg.moe.top_k / cfg.moe.num_experts >= 1
    full = model_config(manifest.Manifest().config("dsv2lite")["model"])
    assert dataclasses.replace(cfg.attn) == full.attn


def _serve(cfg, params, prompt, decode_tokens):
    """The program's float32 prefill of ``prompt`` into the paged latent
    pool, then one decode step per token of ``decode_tokens``: the logits
    of the prompt's last position and of each decode step."""
    from repro_torch.models import (PagedLayout, cache_init, decode_step,
                                    prefill_step)
    from repro_torch.models.decode import slot_cache_view
    lay = PagedLayout(num_blocks=32, block_tokens=16, max_blocks=8)
    cache = cache_init(cfg, lay, 1, F32, device="cpu")
    table = torch.full((1, 8), -1, dtype=torch.int32)
    table[0, :8] = torch.tensor([5, 2, 9, 11, 3, 7, 20, 1])
    n = len(prompt)
    padded = -(-n // 16) * 16
    toks = torch.tensor([prompt + [0] * (padded - n)])
    out = [prefill_step(params, cfg, slot_cache_view(cache, 0), toks, table,
                        lay, compute_dtype=F32,
                        last_index=torch.tensor([n - 1]))[0][0]]
    length = n
    for t in decode_tokens:
        lg, _, _ = decode_step(params, cfg, cache, torch.tensor([t]),
                               torch.tensor([length], dtype=torch.int32),
                               table, lay, compute_dtype=F32)
        out.append(lg[0])
        length += 1
    return torch.stack(out)[:, :cfg.vocab], cache


def test_prefill_then_decode_equals_the_reference():
    """The program's prefill and decode through the paged latent cache
    against the reference's full forward over the same tokens, float32 on
    both sides.  Tolerance 2e-4 absolute / 1e-4 relative on logits of
    magnitude ~1-5: the two sum in other orders (the program's flash
    chunks, absorbed decode, batched expert products) and compute the rope
    angles with other sin/cos routines; a lost YaRN channel, a gate
    normalised or a wrong softmax scale moves them by 1e-2 or more."""
    conf, cfg, params = _model()
    g = torch.Generator().manual_seed(7)
    seq = torch.randint(1, cfg.vocab, (45,), generator=g).tolist()
    got, _ = _serve(cfg, params, seq[:37], seq[37:45])
    want = ref.logits_at(params, conf["model"], [seq], [36])[0]
    assert got.shape == want.shape == (9, cfg.vocab)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)
    # the published flags matter at this size: plain rope, normalised
    # gates or the plain softmax scale each move the reference's logits
    # far past the tolerance
    for change in ({"attn": dict(conf["model"]["attn"], yarn_factor=1.0)},
                   {"moe": dict(conf["model"]["moe"], norm_topk_prob=True)}):
        other = ref.logits_at(params, dict(conf["model"], **change), [seq],
                              [36])[0]
        assert float((other - want).abs().max()) > 1e-2


def test_prefix_hit_equals_a_full_prefill_at_every_layer():
    """A prefix-cache hit (the first two blocks from the pool, the rest
    through the suffix prefill) writes the same latents into every
    layer's pool and gives the same logits as a full prefill of the
    prompt: with a dropless capacity the expert layer routes each token
    as it would in any batch.  Float32; 1e-5 covers the products' other
    shapes."""
    from repro_torch.models import PagedLayout, cache_init, prefill_step
    from repro_torch.models.decode import (pool_leaves, prefill_suffix_step,
                                           slot_cache_view)
    _conf, cfg, params = _model()
    lay = PagedLayout(num_blocks=16, block_tokens=16, max_blocks=4)
    g = torch.Generator().manual_seed(11)
    prompt = torch.randint(1, cfg.vocab, (1, 64), generator=g)
    table = torch.tensor([[3, 8, 1, 12]], dtype=torch.int32)
    full = cache_init(cfg, lay, 1, F32, device="cpu")
    want, _ = prefill_step(params, cfg, slot_cache_view(full, 0), prompt,
                           table, lay, compute_dtype=F32)
    hit = cache_init(cfg, lay, 1, F32, device="cpu")
    prefill_step(params, cfg, slot_cache_view(hit, 0), prompt[:, :32],
                 table, lay, compute_dtype=F32)
    got, _ = prefill_suffix_step(params, cfg, hit, prompt[:, 32:], table,
                                 lay, prefix_len=32, key_blocks=4,
                                 compute_dtype=F32)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    rows = table[0].long()
    for a, b in zip(pool_leaves(hit), pool_leaves(full)):
        assert a.shape[0] == cfg.n_layers or a.shape[0] >= 1
        torch.testing.assert_close(a[:, rows], b[:, rows], atol=1e-5,
                                   rtol=1e-5)


def test_router_is_the_references():
    """The program's expert layer (unnormalised top-2 of 8, one shared
    expert, dropless) against the reference's, float32."""
    from repro_torch.models.moe import moe_apply
    conf, cfg, params = _model()
    layer = ref.layers(params)[1]["moe"]
    x = torch.randn(20, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    got, _ = moe_apply(layer, x, cfg.moe, "swiglu")
    want = ref.moe(x, layer, conf["model"], lambda w: w)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_yarn_matches_the_programs_frequencies():
    """The reference's float32 YaRN frequencies (the published code's
    arithmetic) and the program's (float64, rounded once) agree to a few
    float32 units at the published settings."""
    from repro_torch.models import common
    full = manifest.Manifest().config("dsv2lite")["model"]
    cfg = model_config(full)
    got = torch.from_numpy(common.rope_freqs(64, 10000.0,
                                             common.yarn_of(cfg.attn)))
    want = ref.yarn_inv_freq(64, full["attn"])
    torch.testing.assert_close(got, want, rtol=4e-7, atol=0)
    assert ref.softmax_scale(full) == pytest.approx(0.11472, abs=5e-6)


def _cell(patch=None):
    """A smoke run of ``dsv2lite.longdoc`` whose check samples every
    request finished in the window."""
    from portbench import check
    mix = smoke.mix("longdoc")
    saved = check.SAMPLE_REQUESTS, check.SAMPLE_MAX
    check.SAMPLE_REQUESTS = check.SAMPLE_MAX = 10 ** 6
    try:
        return run_cell(config(), mix, smoke.LIMITS, seed=SEED, seconds=1.0,
                        trace=False, device="cpu", patch=patch)
    finally:
        check.SAMPLE_REQUESTS, check.SAMPLE_MAX = saved


def test_the_sound_path_is_correct():
    res = _cell()
    assert res["correct"] is True, res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_one_token_in_five_altered_is_not_correct():
    res = _cell(altered_tokens(5))
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["check"].values())


def test_traced_run_reads_the_cells_metrics():
    """A traced smoke run of ``dsv2lite.longdoc``: the readers of the
    program's ``dev decode`` spans and of the prefill calls find what they
    read; those of the profiled MLA kernels and of the card's peak find
    nothing on the CPU and are left out, and so is every reader on a
    record whose profile has no MLA kernel (a program that gathers)."""
    from types import SimpleNamespace
    man = manifest.Manifest()
    layer = man.per_layer("dsv2lite.longdoc")
    assert {m["name"] for m in layer} == {
        "mla_decode_roofline", "mla.decode_ms_per_step",
        "dsv2lite.decode_ms_per_step", "dsv2lite.prefill_ms_per_ktok",
        "dsv2lite.mfu"}
    readers = {m["name"]: manifest.reader(m["name"]) for m in layer}
    res = run_cell(config(), smoke.mix("longdoc"), smoke.LIMITS, seed=SEED,
                   seconds=1.0, trace=True, device="cpu",
                   layer_metrics=layer, readers=readers)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"dsv2lite.decode_ms_per_step",
                                   "dsv2lite.prefill_ms_per_ktok"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    gather = SimpleNamespace(
        profile=SimpleNamespace(decode=[{"kv_tokens": 10}], prefill=[],
                                kernels=[("paged_split_kernel", 0, 5)]),
        counts=manifest.module("counts", "mla_moe"),
        model=config()["model"], rows=4, layout={"max_blocks": 16},
        peak={"hbm_byte_s": 3.35e12})
    assert readers["mla_decode_roofline"](gather) is None
    assert readers["mla.decode_ms_per_step"](gather) is None


def test_counts_by_hand():
    """``counts/mla_moe.py`` at the published widths, against counts made
    by hand: per layer MLA's q (2,048 x 16 x 192), latent (2,048 x 576),
    up-projections (16 x 512 x (128 + 128)) and output (16 x 128 x 2,048);
    one dense SwiGLU (3 x 2,048 x 10,944), then 26 layers of a 64-wide
    router and 6 routed + 2 shared experts of 3 x 2,048 x 1,408 (2.24 B a
    token, 2.45 B with the head: the published 2.4 B active)."""
    from portbench.counts import mla_moe as c
    m = manifest.Manifest().config("dsv2lite")["model"]
    attn = 2048 * 16 * 192 + 2048 * 576 + 16 * 512 * 256 + 16 * 128 * 2048
    P = 27 * attn + 3 * 2048 * 10944 + 26 * (2048 * 64
                                             + 8 * 3 * 2048 * 1408)
    assert c.token_params(m) == P == 2_241_593_344
    head = 2 * 2048 * 102400
    assert c.decode_flops(m, [100, 300]) == \
        2 * (2 * P + head) + 2 * 16 * (576 + 512) * 400 * 27
    keys = sum(8192 + i + 1 for i in range(64))
    assert c.prefill_flops(m, 64, 8192) == \
        2 * P * 64 + 2 * 16 * (192 + 128) * keys * 27 + head
    assert c.mla_bytes(m, 400, 64, 640) == \
        400 * 576 * 2 + 64 * (16 * 576 * 4 + 16 * 512 * 4 + 640 * 8 + 4)
    f, b = c.flash_cost(m, 64, 8256, 8192)
    assert f == 2 * 16 * 320 * keys
    assert b == (64 + 8256) * 16 * 320 * 2


def test_file_holds_the_published_config_at_its_top_level():
    """The catalog's config of DeepSeek-V2-Lite stands in the file's top
    level, key for key, and again under ``published``, which the manifest's
    checks read: the two copies agree, and nothing was cut."""
    conf = manifest.Manifest().config("dsv2lite")
    pub = conf["published"]
    assert {k: conf[k] for k in pub} == pub
    assert conf["reduced"] == []
    assert pub["first_k_dense_replace"] == conf["model"]["moe"]["first_dense"]
    assert pub["norm_topk_prob"] == conf["model"]["moe"]["norm_topk_prob"]
    y, a = pub["rope_scaling"], conf["model"]["attn"]
    assert (y["factor"], y["original_max_position_embeddings"],
            y["beta_fast"], y["beta_slow"], y["mscale"],
            y["mscale_all_dim"]) == (
        a["yarn_factor"], a["yarn_original_max_pos"], a["yarn_beta_fast"],
        a["yarn_beta_slow"], a["yarn_mscale"], a["yarn_mscale_all_dim"])
