"""Decoder model code for the paged serving path (the inference subset of
``repro.models``): dense, MoE and VLM families."""

from .common import materialize, pad_vocab
from .decode import PagedLayout, cache_init, decode_step, prefill_step
from .moe import moe_apply
from .transformer import build_layer_plans, build_segments, model_spec

__all__ = ["materialize", "pad_vocab", "PagedLayout", "cache_init",
           "decode_step", "prefill_step", "moe_apply", "build_layer_plans",
           "build_segments", "model_spec"]
