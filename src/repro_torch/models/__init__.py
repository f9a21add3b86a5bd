"""Dense decoder model code for the paged serving path (the inference
subset of ``repro.models``)."""

from .common import materialize, pad_vocab
from .decode import PagedLayout, cache_init, decode_step, prefill_step
from .transformer import build_layer_plans, build_segments, model_spec

__all__ = ["materialize", "pad_vocab", "PagedLayout", "cache_init",
           "decode_step", "prefill_step", "build_layer_plans",
           "build_segments", "model_spec"]
