"""Data pipeline (``repro.data.pipeline``): deterministic synthetic LM token
streams (Zipf-ish unigram mixture with local bigram structure so losses
actually decrease) and per-arch batch assembly (frames/patches/pos3d for the
modality stubs).

Everything is drawn with numpy from the reference's seeds, so the tokens,
frames, patches and ``pos3d`` are bit-identical to the reference's; a batch
is returned as torch tensors on an explicit device."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..configs.base import ModelConfig


def resolve_device(device) -> torch.device:
    """``device``, or CUDA when it is None; CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=\"cpu\" to run on "
                           "the CPU")
    return dev


@dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    seed: int = 0
    shard_index: int = 0
    num_shards: int = 1
    zipf_a: float = 1.2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # fixed bigram transition structure -> learnable signal
        self._next = rng.integers(0, self.vocab, size=self.vocab)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = 1.0 / np.power(ranks, self.zipf_a)
        self._p = p / p.sum()

    def sample(self, batch: int, step: int) -> np.ndarray:
        """[batch, seq_len+1] int32 tokens (inputs+labels)."""
        rng = np.random.default_rng(
            (self.seed, step, self.shard_index))
        S = self.seq_len + 1
        toks = np.empty((batch, S), np.int32)
        toks[:, 0] = rng.choice(self.vocab, size=batch, p=self._p)
        noise = rng.random((batch, S))
        rand = rng.choice(self.vocab, size=(batch, S), p=self._p)
        for t in range(1, S):
            follow = self._next[toks[:, t - 1]]
            toks[:, t] = np.where(noise[:, t] < 0.75, follow, rand[:, t])
        return toks


def synthetic_batch(cfg: ModelConfig, batch: int, seq_len: int, step: int,
                    *, seed: int = 0, shard_index: int = 0,
                    num_shards: int = 1, device=None) -> dict:
    """One batch as tensors on ``device`` (default CUDA; ``"cpu"`` on a
    machine without a card): ``tokens`` [batch, seq_len+1] int32, and
    ``frames`` / ``patches`` [batch, n, d] float32 and ``pos3d`` [3, batch,
    seq_len] float32 where the arch has them."""
    dev = resolve_device(device)
    ds = SyntheticLMDataset(cfg.vocab, seq_len, seed=seed,
                            shard_index=shard_index, num_shards=num_shards)
    out = {"tokens": ds.sample(batch, step)}
    rng = np.random.default_rng((seed + 1, step))
    if cfg.enc_dec:
        out["frames"] = rng.normal(
            size=(batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.vlm_patches:
        out["patches"] = rng.normal(
            size=(batch, cfg.vlm_patches, cfg.d_model)).astype(np.float32)
        # text follows the patch grid: t = position, h/w = patch grid coords
        pos = np.tile(np.arange(seq_len, dtype=np.float32), (3, batch, 1))
        side = max(1, int(np.sqrt(cfg.vlm_patches)))
        grid = np.arange(cfg.vlm_patches)
        pos[1, :, :cfg.vlm_patches] = grid // side
        pos[2, :, :cfg.vlm_patches] = grid % side
        pos[0, :, :cfg.vlm_patches] = 0
        out["pos3d"] = pos
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def batch_specs_for(cfg: ModelConfig, batch: int, seq_len: int, *,
                    train: bool = True, device="meta") -> dict:
    """Shape-only stand-ins of one batch (empty tensors on ``device``, by
    default ``meta``), as :func:`synthetic_batch` makes it: ``tokens``
    [batch, seq_len (+1 to train)] int32, and ``frames`` / ``patches`` /
    ``pos3d`` float32 where the arch has them."""
    def leaf(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)
    S = seq_len + 1 if train else seq_len
    specs = {"tokens": leaf((batch, S), torch.int32)}
    if cfg.enc_dec:
        specs["frames"] = leaf((batch, cfg.enc_frames, cfg.d_model))
    if cfg.vlm_patches:
        specs["patches"] = leaf((batch, cfg.vlm_patches, cfg.d_model))
        specs["pos3d"] = leaf((3, batch, seq_len))
    return specs


def make_batch_iter(cfg: ModelConfig, batch: int, seq_len: int, *,
                    seed: int = 0, shard_index: int = 0,
                    num_shards: int = 1, device=None) -> Iterator[dict]:
    """The batches of steps 0, 1, 2, ... on ``device`` (checked now, not at
    the first batch)."""
    dev = resolve_device(device)

    def batches():
        step = 0
        while True:
            yield synthetic_batch(cfg, batch, seq_len, step, seed=seed,
                                  shard_index=shard_index,
                                  num_shards=num_shards, device=dev)
            step += 1
    return batches()
