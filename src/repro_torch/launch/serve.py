"""Serving launcher: continuous batching with the eBPF-mm paged KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_27b \
        --smoke --policy ebpf --requests 8 --max-new 24

``--device cpu`` runs on the CPU (the kernels' plain versions); the default
is the CUDA card.  The weights are drawn from ``--seed`` with a
``torch.Generator`` on the device; :func:`run` also takes them given
(tests pass the reference's, converted).  Prints the engine's stats as
JSON, as the reference's launcher does.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core import Profile, ProfileRegion
from repro_torch.models import PagedLayout, materialize, model_spec
from repro_torch.serving import Request, ServingEngine


def default_profile(max_blocks: int) -> Profile:
    """A serving profile: hot shared prefix, cold tail — what DAMON replay
    produces for chat workloads (system prompt + few-shot header is hot)."""
    hot_end = max(4, max_blocks // 4)
    return Profile("chat", [
        ProfileRegion(0, hot_end, (0, 150_000, 600_000, 2_500_000)),
        ProfileRegion(hot_end, max_blocks, (0, 0, 0, 0)),
    ])


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--policy", default="ebpf",
                    choices=["ebpf", "thp", "never", "thp-prog", "never-prog"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=512)
    ap.add_argument("--block-tokens", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(args, params=None) -> tuple[ServingEngine, dict]:
    """Serve ``args.requests`` seeded requests; returns (engine, stats)."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if params is None:
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        params = materialize(gen, model_spec(cfg), device=args.device)
    max_blocks = -(-(args.prompt_len + args.max_new) // args.block_tokens) + 8
    layout = PagedLayout(num_blocks=args.blocks,
                         block_tokens=args.block_tokens,
                         max_blocks=max_blocks)
    prof = default_profile(max_blocks) if args.policy == "ebpf" else None
    eng = ServingEngine(cfg, params, layout, max_batch=args.batch,
                        policy=args.policy, profile=prof, device=args.device)
    rng = np.random.default_rng(0)
    for r in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        eng.submit(Request(
            rid=r, prompt=rng.integers(1, cfg.vocab, plen).tolist(),
            max_new_tokens=args.max_new, app="chat"))
    return eng, eng.run()


def main(argv=None) -> None:
    _, out = run(parser().parse_args(argv))
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
