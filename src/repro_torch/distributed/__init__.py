"""Distributed runtime: sharding rules, the sharded flash-decoding path,
gradient compression, fault tolerance / elasticity — the counterpart of
``repro.distributed``, run per rank under ``torch.distributed``."""

from .compression import (compress_residual, compressed_grad_mean_tree,
                          compressed_psum_mean, dequantize_int8,
                          quantize_int8)
from .fault import (HeartbeatRegistry, RestartableLoop, SimulatedFailure,
                    StepWatchdog, elastic_plan)
from .flashdecode import (get_decode_mesh, paged_decode_attention_sharded,
                          paged_mla_decode_sharded, set_decode_mesh)
from .sharding import (DEFAULT_RULES, batch_spec, shardings_for_tree,
                       spec_for, specs_for_tree, zero1_shardings_for_tree,
                       zero1_spec)

__all__ = [n for n in dir() if not n.startswith("_")]
