from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "linear_warmup_cosine"]
