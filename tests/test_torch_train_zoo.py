"""The training forward of the MoE, MLA, hybrid, SSM and encoder-decoder
archs against the reference: each smoke config's ``lm_loss`` (ce, z-loss,
MoE aux) and every gradient leaf against ``jax.value_and_grad`` at float32
compute, relative error <= 1e-4 of each leaf's largest magnitude
(``test_torch_training.check_loss_and_grads_f32``).  mamba2's and jamba's
"m" layers run attention in both packages, as the reference's plans never
reach its mamba branch.  The GQA/MHA families are in
``test_torch_train_families.py``, so the two halves run on two workers."""

import pytest

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)
from test_torch_training import check_loss_and_grads_f32


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "deepseek_v2_lite_16b",
                                  "jamba_v0_1_52b", "mamba2_1p3b",
                                  "whisper_medium"])
def test_lm_loss_and_grads_match_reference_f32(arch):
    check_loss_and_grads_f32(arch)
