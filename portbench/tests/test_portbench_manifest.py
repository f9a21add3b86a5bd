"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic, limits and metric readers by name, and the
manifest keeps to the benchmark's contract (names, units, bounds, the run
length that fits a full check)."""

import json
import re

import pytest

from portbench import manifest
from portbench.serve import model_config

MAN = manifest.Manifest()
B = MAN.bench
CELLS = [w["name"] for w in B["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert len(json.dumps(B)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    w = MAN.cell(cell)
    conf = MAN.config(w["config"])
    mix = manifest.traffic(w["traffic"])
    lim = manifest.limits(cell)
    assert lim and set(lim) <= {"served_gap_max", "served_gap_p99",
                                "served_gap_mean"}
    assert mix["loop"] in ("closed", "open")
    assert manifest.module("reference", conf["reference"]).logits_at
    assert manifest.module("counts", conf["counts"]).token_params
    for m in MAN.per_layer(cell):
        assert callable(manifest.reader(m["name"]))
    e2e = {m["name"] for m in MAN.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert MAN.per_layer(cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in B[k]}) == len(B[k])
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    assert "setup_s" in e2e
    layers = {}
    for m in B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in B["per_layer"])


def test_a_full_check_fits():
    per_run = B["run_seconds"] + 60
    cells = 24
    assert (2 + 14 * cells) * per_run + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", [c["name"] for c in B["configs"]])
def test_configuration_is_the_published_model(name):
    entry = next(c for c in B["configs"] if c["name"] == name)
    conf = MAN.config(name)
    assert conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    pub, m = conf["published"], conf["model"]
    assert m["d_model"] == pub["hidden_size"]
    assert m["n_layers"] == pub["num_hidden_layers"]
    assert m["n_heads"] == pub["num_attention_heads"]
    assert m["kv_heads"] == pub["num_key_value_heads"]
    assert m["d_ff"] == pub["intermediate_size"]
    assert m["vocab"] == pub["vocab_size"]
    assert m["attn"]["rope_theta"] == pub["rope_theta"]
    if "moe" in m:
        e = m["moe"]
        assert e["num_experts"] == pub["n_routed_experts"]
        assert e["top_k"] == pub["num_experts_per_tok"]
        assert e["d_ff_expert"] == pub["moe_intermediate_size"]
        assert e["num_shared"] == pub["n_shared_experts"]
        assert e["first_dense"] == pub["first_k_dense_replace"]
        # no routed token dropped: a capacity of at least the step's tokens
        assert e["capacity_factor"] * e["top_k"] / e["num_experts"] >= 1
    changed = {k for k, v in conf.get("run_as", {}).items()
               if pub.get(k) != v}
    assert changed == set(conf["reduced"])


@pytest.mark.parametrize("name", [c["name"] for c in B["configs"]])
def test_model_block_is_the_programs_config(name):
    from repro_torch.configs.base import get_config
    conf = MAN.config(name)
    ours, prog = model_config(conf["model"]), get_config(conf["arch"])
    if prog.moe is not None:
        from dataclasses import replace
        prog = replace(prog, moe=replace(
            prog.moe, capacity_factor=ours.moe.capacity_factor))
    assert ours == prog
