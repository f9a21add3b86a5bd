"""The plain reference agrees with the program's plain CPU path on the
smoke configurations: the program's float32 forward (``model_forward``)
on the benchmark's weights, and its served bf16 tokens through the whole
harness."""

import pytest
import torch

from portbench.reference import deepseek as ref
from portbench.serve import model_config, run_cell
from portbench.tests import smoke
from portbench.weights import make_params


@pytest.mark.parametrize("name", ["ds7b", "dsmoe"])
def test_reference_equals_the_programs_float32_forward(name):
    from repro_torch.models import model_forward, model_spec
    conf = smoke.config(name)
    cfg = model_config(conf["model"])
    params = make_params(model_spec(cfg), 2 ** 31 + 5, device="cpu",
                         dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    seqs = [torch.randint(1, cfg.vocab, (n,), generator=g).tolist()
            for n in (37, 64)]
    want = [model_forward(params, cfg, torch.tensor([s]),
                          compute_dtype=torch.float32,
                          remat=False)[0][0, 5:, :cfg.vocab] for s in seqs]
    got = ref.logits_at(params, conf["model"], seqs, [5, 5])
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=2e-4, rtol=1e-4), \
            (a - b).abs().max()


@pytest.mark.parametrize("cell", ["ds7b.chat", "ds7b.rag"])
def test_served_tokens_agree_with_the_reference(cell):
    conf, mix = smoke.cell(cell)
    res = run_cell(conf, mix, smoke.LIMITS, seed=2 ** 31 + 99, seconds=1.0,
                   trace=False, device="cpu")
    assert res["correct"], res["check"]
    assert res["check"]["served_gap_max"]["value"] < 0.05
    assert set(res["check"]) == {"served_gap_max"}
    assert res["attempted"] > 0 and res["failed"] == 0
