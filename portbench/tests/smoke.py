"""Smoke-size stand-ins of the benchmark's configurations and mixes, for
runs of the harness on the CPU: every width and count of the published
model shrunk, the deployment and traffic shrunk to match.

``dsmoe`` is DeepSeekMoE 16B (arXiv:2401.06066), whose cell waits on the
program (it always divides the top-k gates by their sum; the published
model does not): its model block is kept here so that the reference's MoE
path and the MoE counts stay held to the program's and to hand counts."""

from __future__ import annotations

import copy

from portbench import manifest

LIMITS = {"served_gap_max": 0.05}

DSMOE_MODEL = {
    "name": "deepseek-moe-16b", "family": "moe", "n_layers": 28,
    "d_model": 2048, "n_heads": 16, "kv_heads": 16, "d_ff": 10944,
    "vocab": 102400, "mlp": "swiglu", "norm": "rms",
    "attn": {"rope_theta": 10000.0},
    "moe": {"num_experts": 64, "top_k": 6, "d_ff_expert": 1408,
            "num_shared": 2, "every": 1, "first_dense": 1,
            "capacity_factor": 10.67}}

# cell -> (configuration, mix)
CELLS = {"ds7b.chat": ("ds7b", "chat"), "ds7b.rag": ("ds7b", "rag")}


def config(name: str) -> dict:
    conf = copy.deepcopy(manifest.Manifest().config("ds7b"))
    if name == "dsmoe":
        conf.update(name="dsmoe", arch="deepseek_moe_16b",
                    model=copy.deepcopy(DSMOE_MODEL))
    m = conf["model"]
    m.update(n_layers=3, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
             vocab=512)
    if m.get("moe"):
        m["moe"].update(num_experts=8, top_k=2, d_ff_expert=32,
                        num_shared=1)
    conf["deployment"].update(max_batch=4, layout={
        "num_blocks": 256, "block_tokens": 16, "max_blocks": 16})
    return conf


def mix(name: str) -> dict:
    mx = copy.deepcopy(manifest.traffic(name))
    mx.update(clients=4, ramp_steps=6, round=8)
    for app in mx["apps"].values():
        app["output"].update(min=4, max=24, median=8)
        if app.get("docs"):
            app["docs"].update(count=2, blocks=4)
            app["prompt"].update(min=2, max=40, median=12)
            app["profile"] = [[0, 4, [0, 150000, 600000, 2500000]],
                              [4, 16, [0, 0, 0, 0]]]
        else:
            app["prompt"].update(min=4, max=64, median=24)
            app["profile"] = [[0, 2, [0, 150000, 600000, 2500000]],
                              [2, 16, [0, 0, 0, 0]]]
    return mx


def cell(name: str) -> tuple[dict, dict]:
    """The smoke configuration and mix of ``name``."""
    conf, traffic = CELLS[name]
    return config(conf), mix(traffic)
