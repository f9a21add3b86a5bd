"""Token sampling (greedy / temperature) over the padded-vocab logits."""

from __future__ import annotations

import numpy as np


class Sampler:
    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def sample(self, logits: np.ndarray, vocab: int,
               temperature: float = 0.0) -> int:
        logits = np.asarray(logits, np.float64)[:vocab]   # mask vocab padding
        if temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits / temperature
        z -= z.max()
        p = np.exp(z)
        s = p.sum()
        # Degenerate distributions: all logits -inf (z.max() is -inf so p is
        # all-NaN), a NaN logit poisoning the row, or a sum that under/over-
        # flows.  rng.choice would raise (or worse, sample from garbage);
        # deterministic argmax is the only defensible answer.
        if not np.isfinite(s) or s <= 0.0 or not np.all(np.isfinite(p)):
            return int(np.argmax(np.nan_to_num(logits, nan=-np.inf)))
        p /= s
        return int(self.rng.choice(vocab, p=p))
