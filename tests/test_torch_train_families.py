"""The training forward of the GQA/MHA families against the reference:
gemma-3 (local/global windows, QK-norm), nemotron-4 (LayerNorm, squared
ReLU), phi-3 and qwen2-VL (M-RoPE over the stub patches' ``pos3d``), each
smoke config's ``lm_loss`` and every gradient leaf against
``jax.value_and_grad`` at float32 compute, relative error <= 1e-4 of each
leaf's largest magnitude (``test_torch_training.check_loss_and_grads_f32``).
"""

import pytest

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)
from test_torch_training import check_loss_and_grads_f32


@pytest.mark.parametrize("arch", ["gemma3_27b", "nemotron_4_15b",
                                  "phi3_mini_3p8b", "qwen2_vl_7b"])
def test_lm_loss_and_grads_match_reference_f32(arch):
    check_loss_and_grads_f32(arch)
