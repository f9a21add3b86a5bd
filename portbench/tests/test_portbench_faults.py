"""The output check fails what it should: the harness driven on the CPU
(its look for a card skipped) with the timed path broken underneath, and
the lower-precision control (the reference on float8 weights) at a size a
test run holds.  The same run on the card is marked ``gpu``."""

import pytest
import torch

from portbench import check
from portbench.reference import deepseek as ref
from portbench.serve import model_config, run_cell
from portbench.tests import smoke
from portbench.weights import make_params

SEED = 2 ** 31 + 4242


def run(cell, patch=None, device="cpu"):
    """A smoke run of ``cell`` whose check samples every request finished
    in the window (a fault confined to some slots is then always in the
    sample, however many steps the window holds)."""
    conf, mix = smoke.cell(cell)
    saved = check.SAMPLE_REQUESTS, check.SAMPLE_MAX
    check.SAMPLE_REQUESTS = check.SAMPLE_MAX = 10 ** 6
    try:
        return run_cell(conf, mix, smoke.LIMITS, seed=SEED, seconds=1.0,
                        trace=False, device=device, patch=patch)
    finally:
        check.SAMPLE_REQUESTS, check.SAMPLE_MAX = saved


def altered_tokens(every):
    """A token altered where it is produced: every ``every``-th sampled
    token is the next id after the one the logits chose."""
    def patch(eng):
        sample, n = eng.sampler.sample, [0]

        def wrong(logits, vocab, temperature=0.0):
            tok = sample(logits, vocab, temperature)
            n[0] += 1
            return (tok + 1) % vocab if n[0] % every == 0 else tok
        eng.sampler.sample = wrong
    return patch


def stale_step(eng):
    """A decode step that returns the previous step's logits."""
    decode, last = eng._decode, []

    def stale(*a):
        logits, heat = decode(*a)
        out = last[0] if last else logits.copy()
        last[:] = [logits.copy()]
        return out, heat
    eng._decode = stale


CELLS = ["ds7b.chat", "ds7b.rag"]


def half_batch(eng):
    """A decode step that leaves out the second half of the batch: those
    rows run as inactive (no KV, no context) and their tokens come from
    what that computes."""
    decode = eng._decode

    def half(tokens, lengths, active):
        active = active.copy()
        active[len(active) // 2:] = False
        return decode(tokens, lengths, active)
    eng._decode = half


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["every token", "one in five",
                                   "stale step", "half the batch"])
def test_a_broken_path_is_not_correct(cell, fault):
    patch = {"every token": altered_tokens(1),
             "one in five": altered_tokens(5),
             "stale step": stale_step, "half the batch": half_batch}[fault]
    res = run(cell, patch)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["check"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_path_is_correct(cell):
    assert run(cell)["correct"] is True


@pytest.mark.parametrize("name", ["ds7b", "dsmoe"])
def test_the_float8_control_fails_the_limit(name):
    """The reference put in the program's place on float8 (e4m3) weights:
    the token it puts first at each position of the same sequences lies
    further below the float32 reference's best than the limit allows, on
    three seeds."""
    from repro_torch.models import model_spec
    conf = smoke.config(name)
    cfg = model_config(conf["model"])
    for seed in (SEED, SEED + 1, SEED + 2):
        params = make_params(model_spec(cfg), seed, device="cpu",
                             dtype=torch.bfloat16)
        g = torch.Generator().manual_seed(seed)
        seqs = [torch.randint(1, cfg.vocab, (n,), generator=g).tolist()
                for n in (40, 64, 90)]
        hi = ref.logits_at(params, conf["model"], seqs, [10, 10, 10])
        lo = ref.logits_at(params, conf["model"], seqs, [10, 10, 10],
                           quant=ref.fp8_weights)
        worst = float(check.control_gaps(hi, lo).max())
        assert worst > smoke.LIMITS["served_gap_max"], (seed, worst)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["ds7b.chat", "ds7b.rag"])
def test_on_the_card(card, cell):
    assert run(cell, device=card)["correct"] is True
    res = run(cell, altered_tokens(1), device=card)
    assert res["correct"] is False
