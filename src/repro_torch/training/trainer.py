"""Trainer (``repro.training.trainer``): the fault-tolerant outer loop tying
data, step, checkpoints, watchdog and restarts together.

As in the reference, a restart restores the params and optimizer state of
the latest checkpoint but does not rewind the data iterator: the steps
replayed after a failure see the batches that come next.  The step updates
the params in place, so the trainer trains the tensors it is given."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ..checkpoint.store import CheckpointStore
from ..distributed.fault import RestartableLoop, StepWatchdog
from ..optim.adamw import adamw_init, tree_leaves
from .train_step import make_train_step

Pytree = Any


@dataclass
class TrainerConfig:
    num_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    num_micro: int = 1
    base_lr: float = 3e-4
    warmup_steps: int = 10
    chunk: int = 512
    keep_checkpoints: int = 3


class Trainer:
    def __init__(self, cfg: TrainerConfig, model_cfg, params: Pytree,
                 data_iter, store: CheckpointStore, *,
                 failure_hook: Callable | None = None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.data_iter = data_iter
        self.store = store
        self.watchdog = StepWatchdog()
        self.failure_hook = failure_hook
        self.metrics_log: list[dict] = []
        self.device = tree_leaves(params)[0].device

        self.step_fn = make_train_step(
            model_cfg, num_micro=cfg.num_micro, base_lr=cfg.base_lr,
            warmup_steps=cfg.warmup_steps, total_steps=cfg.num_steps,
            chunk=cfg.chunk)
        self.state = {"params": params, "opt": adamw_init(params)}
        self.start_step = 0
        # resume if a checkpoint exists (crash-only design)
        latest = store.latest_step()
        if latest is not None:
            self.state, self.start_step = self._restore()

    def _save(self, state, step):
        self.store.save(state, step=step, keep=self.cfg.keep_checkpoints)

    def _restore(self):
        step = self.store.latest_step()
        state, meta = self.store.restore(step, like=self.state,
                                         device=self.device)
        return state, meta["step"]

    def run(self) -> dict:
        loop = RestartableLoop(self._save, self._restore)

        def one_step(state, step):
            if self.failure_hook is not None:
                self.failure_hook(step)          # may raise SimulatedFailure
            self.watchdog.start()
            batch = next(self.data_iter)
            params, opt, metrics = self.step_fn(state["params"], state["opt"],
                                                batch)
            loss = metrics["loss"].item()        # waits for the device
            wd = self.watchdog.stop()
            last = step == self.cfg.num_steps - 1
            if step % self.cfg.log_every == 0 or last:
                self.metrics_log.append({
                    "step": step, "loss": loss,
                    "grad_norm": metrics["grad_norm"].item(),
                    "lr": metrics["lr"].item(),
                    "sec": wd["duration"], "slow": wd["slow"]})
            return {"params": params, "opt": opt}

        self.state, final_step = loop.run(
            self.state, self.start_step, self.cfg.num_steps, one_step,
            checkpoint_every=self.cfg.checkpoint_every)
        self._save(self.state, final_step)
        return {"final_step": final_step,
                "restarts": loop.restarts,
                "metrics": self.metrics_log}
