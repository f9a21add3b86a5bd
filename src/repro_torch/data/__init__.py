from .pipeline import SyntheticLMDataset, make_batch_iter, synthetic_batch

__all__ = ["SyntheticLMDataset", "make_batch_iter", "synthetic_batch"]
