from .base import (ARCH_IDS, SHAPES, AttnCfg, MambaCfg, MLACfg, ModelConfig,
                   MoECfg, ShapeSpec, get_config, get_smoke_config,
                   supports_shape)
