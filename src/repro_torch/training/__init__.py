from .train_step import make_train_step, split_microbatches
from .trainer import Trainer, TrainerConfig

__all__ = ["make_train_step", "split_microbatches", "Trainer", "TrainerConfig"]
