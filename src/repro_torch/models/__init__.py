"""Model code (the port of ``repro.models``): paged serving prefill/decode
and the full-sequence training forward and loss, for every arch."""

from .common import materialize, pad_vocab
from .decode import PagedLayout, cache_init, decode_step, prefill_step
from .moe import moe_apply
from .transformer import (build_layer_plans, build_segments, lm_loss,
                          model_forward, model_spec)

__all__ = ["materialize", "pad_vocab", "PagedLayout", "cache_init",
           "decode_step", "prefill_step", "moe_apply", "build_layer_plans",
           "build_segments", "lm_loss", "model_forward", "model_spec"]
