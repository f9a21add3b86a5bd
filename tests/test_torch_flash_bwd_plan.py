"""The flash backward's launch plan on the CPU: which kernels a call takes
(route), at which widths (zero-padded to a multiple of 8 for bf16), and with
which softmax scale (the real head dim's), at the head dims the port trains
(smoke 12, Whisper 64, deepseek 128, gemma-3 168, MLA 192 / 128, 256).

The kernels themselves run only on the card (``tests/test_torch_gpu.py``).
Here the padding the launcher does is held to the reference: the plain
backward on the padded copies, at the plan's scale and sliced back, against
``jax.vjp`` of the reference's jnp attention at the real widths.  And the
kernels' rounding points (P and dS to bf16 before their products) are
modelled in torch to show what they cost against the float32 formula.

Tolerances: the padded plain backward to 1e-5 of each gradient's largest
magnitude (float32 sums in another order than XLA's); the rounding model to
1e-2 (what the bf16 kernels should hold on the card, inside the repo's 2e-2
bf16 tolerance).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attention

from repro_torch.kernels.flash_attention import ops as fa

BF16, F32 = torch.bfloat16, torch.float32

# (hd, hdv, dtype) -> (route, kernel hd, kernel hdv)
PLANS = {
    (12, 12, BF16): ("wgmma", 16, 16),
    (64, 64, BF16): ("wgmma", 64, 64),
    (128, 128, BF16): ("wgmma", 128, 128),
    (168, 168, BF16): ("wgmma", 168, 168),
    (192, 128, BF16): ("wgmma", 192, 128),
    (256, 256, BF16): ("wgmma", 256, 256),
    (12, 12, F32): ("fma", 12, 12),
    (64, 64, F32): ("fma", 64, 64),
    (128, 128, F32): ("fma", 128, 128),
    (168, 168, F32): ("fma", 168, 168),
    (192, 128, F32): ("fma", 192, 128),
    (256, 256, F32): ("fma", 256, 256),
}


@pytest.mark.parametrize("hd,hdv,dtype", sorted(PLANS, key=str),
                         ids=lambda x: str(x).replace("torch.", ""))
def test_bwd_plan(hd, hdv, dtype):
    plan = fa._bwd_plan(hd, hdv, dtype)
    assert (plan.route, plan.hd, plan.hdv) == PLANS[hd, hdv, dtype]
    # the scale is the real head dim's, whatever the padding
    assert plan.scale == 1.0 / math.sqrt(hd)


@pytest.mark.parametrize("hd,hdv", [(0, 64), (64, 0), (264, 264),
                                    (128, 264)])
def test_bwd_plan_rejects_head_dims_past_the_kernels(hd, hdv):
    for dtype in (BF16, F32):
        with pytest.raises(ValueError, match="head dims"):
            fa._bwd_plan(hd, hdv, dtype)


def _inputs(B, S, H, KVH, hd, hdv, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hdv),
             (B, S, H, hdv))]


# (B, S, H, KVH, hd, hdv, causal, window, soft cap)
PAD_CASES = {
    "smoke_hd12": (2, 33, 4, 2, 12, 12, True, None, None),
    "hd20_window": (1, 40, 4, 2, 20, 20, True, 9, None),
    "dv_lt_d_odd": (1, 36, 2, 2, 30, 14, True, None, None),
    "soft_cap_hd12": (1, 30, 2, 1, 12, 12, True, None, 5.0),
}


@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_padded_backward_matches_reference(case):
    """What the launcher hands the bf16 kernels — q, k, v and dO zero-padded
    to the plan's widths, the real head dim's scale — gives the reference's
    gradients once sliced back; the padded width's own scale would not."""
    B, S, H, KVH, hd, hdv, causal, window, cap = PAD_CASES[case]
    q, k, v, do = _inputs(B, S, H, KVH, hd, hdv)
    kw = dict(causal=causal, window=window, soft_cap=cap)
    ref_out, vjp = jax.vjp(lambda a, b, c: jax_attention.flash_attention(
        a, b, c, chunk=16, **kw), q, k, v)
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = fa.flash_attention_plain(tq, tk, tv, chunk=16,
                                        return_lse=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-6)
    plan = fa._bwd_plan(hd, hdv, BF16)
    assert (plan.hd, plan.hdv) == (-(-hd // 8) * 8, -(-hdv // 8) * 8)
    padded = (fa._pad_last(tq, plan.hd), fa._pad_last(tk, plan.hd),
              fa._pad_last(tv, plan.hdv), fa._pad_last(tdo, plan.hdv))
    D = fa.flash_bwd_preprocess_plain(out, tdo)
    got = fa._bwd_plain(*padded, lse, D, scale=plan.scale, chunk=16, **kw)
    for g, r, width in zip(got, ref, (hd, hd, hdv)):
        r = np.asarray(r)
        assert not g[..., width:].any()        # the padded columns stay 0
        err = np.abs(fa._unpad(g, width).numpy() - r).max()
        assert err <= 1e-5 * np.abs(r).max(), (err, np.abs(r).max())
    # the trap: the padded head dim's scale gives other gradients
    wrong = fa._bwd_plain(*padded, lse, D, chunk=16, **kw)
    assert not torch.allclose(wrong[0][..., :hd], got[0][..., :hd],
                              atol=1e-3)


def _rounded_bwd(q, k, v, dout, lse, D, *, causal):
    """The bf16 kernels' arithmetic on whole matrices: products of bf16
    operands summed in float32, P and dS rounded to bf16 before their
    products, dkdv's dS from the rounded P (dq's from the float32 P)."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)

    def r(x):
        return x.to(BF16).float()

    qg = r(q).reshape(B, S, KVH, G, hd)
    dog = r(dout).reshape(B, S, KVH, G, -1)
    kf, vf = r(k), r(v)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, kf) * scale
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask = mask.tril()
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KVH, G, S, 1)), 0.)
    dp = torch.einsum("bqkgd,bckd->bkgqc", dog, vf)
    dsum = D.reshape(B, KVH, G, S, 1)
    ds_kv = r(r(p) * (dp - dsum))
    ds_q = r(p * (dp - dsum))
    dv = torch.einsum("bkgqc,bqkgd->bckd", r(p), dog)
    dk = torch.einsum("bkgqc,bqkgd->bckd", ds_kv, qg) * scale
    dq = torch.einsum("bkgqc,bckd->bqkgd", ds_q, kf) * scale
    return dq.reshape(B, S, H, hd), dk, dv


@pytest.mark.parametrize("hd,KVH", [(128, 4), (64, 1)])
def test_bf16_rounding_model_within_prediction(hd, KVH):
    """Rounding P and dS to bf16 before their products (as the forward
    rounds P, and as SDPA does) moves each gradient by under 1e-2 of its
    largest magnitude against the float32 formula, on the bf16 inputs."""
    torch.manual_seed(0)
    B, S, H = 1, 256, 4
    q, k, v, do = (torch.randn(*s).to(BF16).float() for s in
                   ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd),
                    (B, S, H, hd)))
    out, lse = fa.flash_attention_plain(q, k, v, chunk=64, return_lse=True)
    out = out.to(BF16).float()                 # the forward's bf16 output
    want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, chunk=64)
    got = _rounded_bwd(q, k, v, do, lse, fa.flash_bwd_preprocess_plain(
        out, do), causal=True)
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-2 * scale


def test_cpu_backward_counts_no_route():
    """CPU tensors run the plain backward: no launch, no route counted."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 2, 8, 8))
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    before = (fa.flash_bwd_dkdv.launches, dict(fa.flash_bwd_dkdv.routes),
              fa.flash_bwd_dq.launches, dict(fa.flash_bwd_dq.routes))
    fa.flash_attention_bwd(q, k, v, out, do, lse)
    assert before == (fa.flash_bwd_dkdv.launches,
                      dict(fa.flash_bwd_dkdv.routes),
                      fa.flash_bwd_dq.launches, dict(fa.flash_bwd_dq.routes))
