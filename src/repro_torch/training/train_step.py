"""Training step (``repro.training.train_step``): loss -> grads -> AdamW,
with microbatch gradient accumulation in float32, mixed precision (bf16
compute over float32 master weights and moments), and remat applied inside
the model's layers.

PyTorch runs it eagerly: the reference's ``jax.value_and_grad`` is
``torch.autograd.grad`` over the param leaves, its ``lax.scan`` over
microbatches a loop.  On the card every attention runs the flash kernels,
forward and backward."""

from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from ..models.common import BF16
from ..models.transformer import lm_loss
from ..optim.adamw import AdamWState, adamw_update, tree_leaves, tree_map
from ..optim.schedule import linear_warmup_cosine

Pytree = Any
F32 = torch.float32


def split_microbatches(batch: dict, num_micro: int) -> dict:
    """[B, ...] -> [num_micro, B/num_micro, ...] for every leaf with a batch
    dim (pos3d has it at axis 1)."""
    def one(k, v):
        if k == "pos3d":
            m = v.shape[1] // num_micro
            return v.reshape(v.shape[0], num_micro, m, *v.shape[2:]) \
                .transpose(0, 1)
        m = v.shape[0] // num_micro
        return v.reshape(num_micro, m, *v.shape[1:])
    return {k: one(k, v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, *, num_micro: int = 1,
                    base_lr: float = 3e-4, warmup_steps: int = 100,
                    total_steps: int = 10_000, weight_decay: float = 0.1,
                    clip_norm: float = 1.0, chunk: int = 1024,
                    remat: bool = True, compute_dtype=BF16):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  The step writes the new params and moments into the given
    tensors (:func:`~repro_torch.optim.adamw.adamw_update`)."""

    def grads_of(params, micro):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = lm_loss(p, cfg, micro, compute_dtype=compute_dtype,
                          chunk=chunk, remat=remat)
        leaves = tree_leaves(p)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        return loss.detach(), tree_map(lambda _: next(grads), p)

    def train_step(params, opt_state: AdamWState, batch: dict):
        if num_micro > 1:
            micros = split_microbatches(batch, num_micro)
            gsum = tree_map(lambda t: torch.zeros(t.shape, dtype=F32,
                                                  device=t.device), params)
            lsum = torch.zeros((), dtype=F32, device=opt_state.step.device)
            for i in range(num_micro):
                loss, grads = grads_of(params, {k: v[i]
                                                for k, v in micros.items()})
                gsum = tree_map(lambda a, g: a + g.float(), gsum, grads)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / num_micro, gsum)
            loss = lsum / num_micro
        else:
            loss, grads = grads_of(params, batch)

        lr = linear_warmup_cosine(opt_state.step, base_lr=base_lr,
                                  warmup_steps=warmup_steps,
                                  total_steps=total_steps)
        with torch.no_grad():
            params, opt_state, om = adamw_update(
                params, grads, opt_state, lr=lr, weight_decay=weight_decay,
                clip_norm=clip_norm)
        return params, opt_state, {"loss": loss, "lr": lr, **om}

    return train_step
