"""DeepSeek-V2-Lite's published semantics in the port, each held to a
plain float64 (or float32) formula, not to the JAX package: YaRN's inverse
frequencies, cos/sin and softmax scale; the router with its gates left
unnormalised; every other config bit-identical with the new fields at
their defaults; the paged MLA decode's split plan and the expert layer's
counters."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (ARCH_IDS, AttnCfg, MoECfg, get_config,
                                      get_smoke_config)
from repro_torch.kernels.mla_decode import ops as mla_ops
from repro_torch.models import common, moe
from repro_torch.models.transformer import mla_scale

V2 = get_config("deepseek_v2_lite_16b")


def yarn_f64(dim, base, factor, orig, fast, slow):
    """DeepSeek-V2's YaRN inverse frequencies in float64, written out."""
    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))
    low = max(math.floor(corr(fast)), 0)
    high = min(math.ceil(corr(slow)), dim - 1)
    out = []
    for i in range(dim // 2):
        f = base ** (-2 * i / dim)
        ramp = min(1.0, max(0.0, (i - low) / (high - low)))
        out.append(f / factor * ramp + f * (1 - ramp))
    return np.array(out)


@pytest.mark.parametrize("dim,factor,orig", [(64, 40.0, 4096), (8, 40.0, 4096),
                                             (16, 4.0, 64)])
def test_yarn_inverse_frequencies(dim, factor, orig):
    """The published settings (64 rope channels), a smoke size, and a
    small original context where the ramp lies inside the channels."""
    attn = AttnCfg(yarn_factor=factor, yarn_original_max_pos=orig,
                   yarn_beta_fast=32.0, yarn_beta_slow=1.0, yarn_mscale=0.707,
                   yarn_mscale_all_dim=0.707)
    got = common.rope_freqs(dim, 10000.0, common.yarn_of(attn))
    want = yarn_f64(dim, 10000.0, factor, orig, 32.0, 1.0)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2 ** -23)


def test_yarn_at_the_published_settings():
    """64 channels over 4,096 positions: the fast correction dimension
    floors to 10 and the slow one ceils to 23, so channels 0-9 keep their
    frequency, 23-31 are divided by 40, and the ramp blends 10-22."""
    f = common.rope_freqs(64, 10000.0, common.yarn_of(V2.attn))
    plain = common.rope_freqs(64, 10000.0)
    assert np.array_equal(f[:10], plain[:10])
    np.testing.assert_allclose(f[23:], plain[23:] / 40, rtol=2 ** -22)
    assert all(plain[i] / 40 < f[i] < plain[i] for i in range(11, 23))


def test_yarn_softmax_scale():
    """m = 0.1 * 0.707 * ln 40 + 1; the scale is 192^-1/2 * m^2."""
    m = 0.1 * 0.707 * math.log(40.0) + 1.0
    assert mla_scale(V2) == pytest.approx(m * m / math.sqrt(192), rel=1e-15)
    assert mla_scale(V2) == pytest.approx(0.11472, abs=5e-6)
    assert m * m == pytest.approx(1.5896, abs=5e-5)


def test_yarn_cos_sin_table():
    """The table's angles are the float32 positions times the float32
    YaRN frequencies, cos/sin to float32 rounding (the mscale ratio is 1
    at the published settings: mscale == mscale_all_dim)."""
    yarn = common.yarn_of(V2.attn)
    cos, sin = common.rope_table(5000, 64, 10000.0, "cpu", yarn)
    ang = (np.arange(5000, dtype=np.float32)[:, None]
           * common.rope_freqs(64, 10000.0, yarn)).astype(np.float64)
    np.testing.assert_allclose(cos[:5000].numpy(), np.cos(ang), atol=2e-7)
    np.testing.assert_allclose(sin[:5000].numpy(), np.sin(ang), atol=2e-7)


def test_yarn_mscale_ratio_scales_cos_sin():
    """Where mscale differs from mscale_all_dim, cos and sin carry their
    ratio (DeepSeek-V2's ``_mscale``)."""
    attn = dataclasses.replace(V2.attn, yarn_mscale=1.0)
    cos, _ = common.rope_table(8, 64, 10000.0, "cpu", common.yarn_of(attn))
    ratio = (0.1 * 1.0 * math.log(40) + 1) / (0.1 * 0.707 * math.log(40) + 1)
    assert float(cos[0, 0]) == pytest.approx(ratio, rel=1e-6)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_defaults_keep_every_config_bit_identical(arch):
    """With the new fields at their defaults (every config but V2-Lite's
    full one) the rope frequencies, the softmax scale and the router's
    gates are the old formulas' bit for bit."""
    for cfg in ((get_smoke_config(arch),) if arch == "deepseek_v2_lite_16b"
                else (get_config(arch), get_smoke_config(arch))):
        assert common.yarn_of(cfg.attn) is None
        hd = cfg.head_dim
        assert np.array_equal(
            common.rope_freqs(hd, cfg.attn.rope_theta),
            (1.0 / (float(cfg.attn.rope_theta)
                    ** (np.arange(0, hd, 2) / hd))).astype(np.float32))
        if cfg.mla is not None:
            assert mla_scale(cfg) == \
                1.0 / math.sqrt(cfg.mla.qk_nope + cfg.mla.qk_rope)
        if cfg.moe is not None:
            assert cfg.moe.norm_topk_prob
            g = torch.Generator().manual_seed(3)
            x = torch.randn(16, cfg.d_model, generator=g)
            router = torch.randn(cfg.d_model, cfg.moe.num_experts,
                                 generator=g)
            gates, idx, _ = moe._route(x, router, cfg.moe)
            probs = torch.softmax(x @ router, -1)
            top = torch.gather(probs, 1, idx)
            assert torch.equal(
                gates, top / top.sum(-1, keepdim=True).clamp_min(1e-9))


def test_route_without_normalisation():
    """``norm_topk_prob=False``: the gates are the top-k softmax
    probabilities as they are, against a float64 softmax and sort."""
    cfg = MoECfg(num_experts=64, top_k=6, d_ff_expert=8,
                 norm_topk_prob=False)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(40, 32, generator=g)
    router = torch.randn(32, 64, generator=g) * 0.3
    gates, idx, _ = moe._route(x, router, cfg)
    p64 = torch.softmax(x.double() @ router.double(), -1)
    want_g, want_i = p64.sort(-1, descending=True)
    assert torch.equal(idx, want_i[:, :6])
    torch.testing.assert_close(gates.double(), want_g[:, :6], rtol=1e-6,
                               atol=1e-9)
    assert float(gates.sum(-1).max()) < 1.0


def test_expert_counters_and_no_drop_at_a_dropless_capacity():
    """``routed_rows`` and ``computed_rows`` grow by each call's static
    counts; the device counter of dropped rows stays at 0 when every
    expert can take every token (capacity factor >= E / K) and counts the
    overflow when it cannot."""
    from repro_torch.models.common import ParamSpec, materialize
    cfg = MoECfg(num_experts=8, top_k=2, d_ff_expert=16, num_shared=1,
                 capacity_factor=4.0, norm_topk_prob=False)
    spec = moe.moe_spec(32, cfg, "swiglu")
    assert all(isinstance(p, ParamSpec) for p in spec.values())
    params = materialize(torch.Generator().manual_seed(1), spec, device="cpu")
    x = torch.randn(24, 32, generator=torch.Generator().manual_seed(2))
    r0, c0 = moe.moe_apply.routed_rows, moe.moe_apply.computed_rows
    d0 = int(moe.dropped_rows("cpu"))
    moe.moe_apply(params, x, cfg, "swiglu")
    C = moe._capacity(cfg, 24)
    assert C >= 24
    assert moe.moe_apply.routed_rows - r0 == 24 * 2
    assert moe.moe_apply.computed_rows - c0 == 8 * C
    assert int(moe.dropped_rows("cpu")) == d0
    # every token routed to the same two experts, capacity 8: 16 of 24
    # rows find each expert full
    skew = dataclasses.replace(cfg, capacity_factor=0.1)
    p2 = dict(params, router=torch.zeros_like(params["router"]))
    p2["router"][:, :2] = 1.0
    moe.moe_apply(p2, x.abs() + 1, skew, "swiglu", capacity=8)
    assert int(moe.dropped_rows("cpu")) - d0 == 2 * (24 - 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("capacity", [None, 5])
def test_expert_groups_keep_the_bits(monkeypatch, dtype, capacity):
    """With ``FFN_GROUP_BYTES`` cut to three experts' intermediates, the
    expert products run in groups of 2 (a power of two), and ``moe_apply`` gives
    the ungrouped call's output bit for bit, with (capacity 5) and without
    dropped rows."""
    from repro_torch.models.common import materialize
    cfg = MoECfg(num_experts=8, top_k=2, d_ff_expert=16, num_shared=1,
                 capacity_factor=4.0, norm_topk_prob=False)
    params = materialize(torch.Generator().manual_seed(3),
                         moe.moe_spec(32, cfg, "swiglu"), device="cpu",
                         dtype=dtype)
    x = torch.randn(24, 32, generator=torch.Generator().manual_seed(4)
                    ).to(dtype)
    whole, _ = moe.moe_apply(params, x, cfg, "swiglu", capacity=capacity)
    C = capacity or moe._capacity(cfg, 24)
    calls = []
    real = moe._expert_group
    monkeypatch.setattr(moe, "_expert_group", lambda p, xe, k, e: (
        calls.append(xe.shape[0]), real(p, xe, k, e))[1])
    monkeypatch.setattr(moe, "FFN_GROUP_BYTES",
                        3 * C * 16 * x.element_size())
    grouped, _ = moe.moe_apply(params, x, cfg, "swiglu", capacity=capacity)
    assert calls == [2, 2, 2, 2]
    assert torch.equal(grouped, whole)


def test_combine_adds_nothing_for_a_dropped_row():
    """The combine against its plain form over the expert rows padded with
    a zero row (where every dropped entry's destination ``E * C`` points):
    equal bit for bit, in bf16, with a third of the entries dropped."""
    g = torch.Generator().manual_seed(5)
    T, K, E, C, d = 12, 3, 4, 6, 8
    expert_idx = torch.stack([torch.randperm(E, generator=g)[:K]
                              for _ in range(T)])
    gate_vals = torch.rand(T, K, generator=g)
    x = torch.randn(T, d, generator=g).to(torch.bfloat16)
    _, order, dest = moe._dispatch(x, expert_idx, E, C)
    assert int((dest == E * C).sum()) == T * K - E * C
    y = torch.randn(E * C, d, generator=g).to(torch.bfloat16)
    got = moe._combine(y, order, dest, expert_idx, gate_vals, torch.bfloat16)
    y_pad = torch.cat([y, torch.zeros(1, d, dtype=torch.bfloat16)])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K)
    want = torch.zeros(T, d, dtype=torch.bfloat16)
    for e in range(E):                  # each token's entries, by expert
        for t in range(T):
            k = (expert_idx[t] == e).nonzero()
            if len(k):
                k = int(k[0, 0])
                want[t] = want[t] + y_pad[dest[inv[t * K + k]]] * \
                    gate_vals[t, k].to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,MB,bt", [(64, 640, 16), (1, 640, 16),
                                     (3, 16, 4), (4, 64, 8)])
def test_mla_split_plan(B, MB, bt):
    """Splits own a whole number of 64-token tiles and cover the table;
    at the cell's shape (64 rows, 640 slots) the grid is about four
    blocks per SM of a 132-SM card."""
    pps = mla_ops.split_slots(MB, B, bt, 132)
    assert (pps * bt) % 64 == 0
    ns = -(-MB // pps)
    assert ns * pps >= MB and (ns - 1) * pps < MB
    if (B, MB) == (64, 640):
        assert pps == 72 and ns == 9 and B * ns == 576


def test_mla_plain_is_the_gather():
    """The kernel's plain version, on random latents with unmapped slots
    and an inactive row, against the attention written out per row in
    float64 (exact softmax mass per block for the heat)."""
    g = torch.Generator().manual_seed(5)
    B, H, L, R, bt, MB = 3, 4, 32, 8, 4, 6
    pool = torch.randn(20, bt, L + R, generator=g)
    table = torch.tensor([[3, 7, -1, 2, -1, -1], [0, 1, 4, 5, 6, 8],
                          [-1] * 6], dtype=torch.int32)
    lengths = torch.tensor([14, 21, 0], dtype=torch.int32)
    q_eff = torch.randn(B, H, L, generator=g)
    q_rope = torch.randn(B, H, R, generator=g)
    o, heat = mla_ops.paged_decode_mla_plain(
        q_eff, q_rope, pool, table, lengths, block_tokens=bt, kv_lora=L,
        scale=0.3)
    for b in range(B):
        toks = [(j, t) for j in range(MB) for t in range(bt)
                if table[b, j] >= 0 and j * bt + t < lengths[b]]
        if not toks:
            assert float(o[b].abs().max()) == 0 and float(heat[b].sum()) == 0
            continue
        lat = torch.stack([pool[table[b, j], t] for j, t in toks]).double()
        s = 0.3 * (q_eff[b].double() @ lat[:, :L].T
                   + q_rope[b].double() @ lat[:, L:].T)
        p = torch.softmax(s, -1)
        torch.testing.assert_close(o[b].double(), p @ lat[:, :L], rtol=1e-5,
                                   atol=1e-5)
        want = torch.zeros(MB, dtype=torch.float64)
        for (j, _t), mass in zip(toks, p.sum(0)):
            want[j] += mass
        torch.testing.assert_close(heat[b].double(), want, rtol=1e-5,
                                   atol=1e-6)


def test_replayed_counts_reach_the_telemetry():
    """A captured entry's replay adds its per-replay counts to the
    wrappers and, with an enabled hub, to its counters as
    ``<wrapper>.<count>``; device counters (probes) are read into
    ``snapshot()``'s counters only when asked; the Chrome trace's device
    process carries both at its end.  A disabled hub counts nothing."""
    from repro_torch.obs import Telemetry, chrome_trace
    from repro_torch.serving.compiled import Captured

    class Graph:
        def replay(self):
            pass
    per = {(mla_ops.paged_decode_mla, "launches"): 27,
           (moe.moe_apply, "routed_rows"): 384}
    saved = mla_ops.paged_decode_mla.launches, moe.moe_apply.routed_rows
    try:
        tel = Telemetry(trace=True)
        c = Captured(Graph(), per, [], 0, 0.0, tel)
        c.replay()
        c.replay()
        assert mla_ops.paged_decode_mla.launches == saved[0] + 54
        assert moe.moe_apply.routed_rows == saved[1] + 768
        assert tel.counters == {"paged_decode_mla.launches": 54,
                                "moe_apply.routed_rows": 768}
        reads = []
        tel.probes["moe.dropped_rows"] = lambda: reads.append(1) or 0
        assert not reads
        assert tel.snapshot()["counters"]["moe.dropped_rows"] == 0
        assert reads == [1]
        tel.spans.append(("dev decode", "device", "device", 1000, 500))
        ev = [e for e in chrome_trace(tel)["traceEvents"]
              if e.get("name") == "entry counts"]
        assert ev[0]["args"] == {"paged_decode_mla.launches": 54,
                                 "moe_apply.routed_rows": 768,
                                 "moe.dropped_rows": 0}
        off = Telemetry(enabled=False)
        Captured(Graph(), per, [], 0, 0.0, off).replay()
        assert off.counters == {}
    finally:
        mla_ops.paged_decode_mla.launches, moe.moe_apply.routed_rows = saved
