"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_1p3b \
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Drives the fault-tolerant ``Trainer`` on one device: the CUDA card by
default, the CPU with ``--device cpu``.  ``--smoke`` selects the reduced
config.  The weights are drawn from ``--seed`` with a ``torch.Generator``
on the device; :func:`run` also takes them given (tests pass the
reference's, converted).
"""

from __future__ import annotations

import argparse
import json
import tempfile

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.pipeline import make_batch_iter
from repro_torch.models import materialize, model_spec
from repro_torch.training.trainer import Trainer, TrainerConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(args, params=None) -> dict:
    """Train ``args.steps`` steps; returns the Trainer's result (metrics,
    final step, restarts) with ``ckpt_dir``."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if params is None:
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        params = materialize(gen, model_spec(cfg), device=args.device)
    data = make_batch_iter(cfg, args.batch, args.seq, device=args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    trainer = Trainer(
        TrainerConfig(num_steps=args.steps, checkpoint_every=args.ckpt_every,
                      base_lr=args.lr, num_micro=args.micro,
                      chunk=min(512, args.seq)),
        cfg, params, data, CheckpointStore(ckpt_dir))
    return dict(trainer.run(), ckpt_dir=ckpt_dir)


def main(argv=None) -> None:
    out = run(parser().parse_args(argv))
    print(json.dumps(out["metrics"], indent=1))
    first, last = out["metrics"][0], out["metrics"][-1]
    print(f"loss {first['loss']:.3f} -> {last['loss']:.3f} over "
          f"{out['final_step']} steps (ckpts in {out['ckpt_dir']})")


if __name__ == "__main__":
    main()
