"""A traced run and an open-loop run of the harness on the CPU: the
readers find what they read (those that need the card's profiler or its
peaks find nothing here and are left out), the breakdown is given, and
``check`` comes last in the line."""

import json

from portbench import manifest
from portbench.serve import run_cell
from portbench.tests import smoke

MAN = manifest.Manifest()
CPU_READABLE = {"engine.host_ms_per_step", "mm.tick_ms_per_step",
                "policy.fault_us_per_batch", "prefix.hit_tok_pct",
                "decode.device_ms_per_step", "prefill.device_ms_per_ktok",
                "device_idle_pct"}


def test_traced_run():
    layer = MAN.per_layer("ds7b.rag")
    res = run_cell(smoke.config("ds7b"), smoke.mix("rag"),
                   smoke.LIMITS, seed=2 ** 31 + 17, seconds=1.0,
                   trace=True, device="cpu", layer_metrics=layer,
                   readers={m["name"]: manifest.reader(m["name"])
                            for m in layer})
    assert res["correct"] is True
    assert set(res["metrics"]) == CPU_READABLE
    assert 0 < res["metrics"]["prefix.hit_tok_pct"]["value"] < 100
    assert 0 < res["metrics"]["device_idle_pct"]["value"] < 100
    gaps = res["breakdown"]["idle_gaps"]
    assert gaps and len(gaps) <= 10 and all(s > 0 for _, s in gaps)
    assert list(res)[-1] == "check"
    json.dumps(res)


def test_open_loop_run():
    mix = smoke.mix("chat")
    del mix["clients"]
    mix.update(loop="open", arrival={"rate": 40.0, "burst_every": 8,
                                     "burst_size": 3})
    res = run_cell(smoke.config("ds7b"), mix, smoke.LIMITS,
                   seed=2 ** 31 + 18, seconds=1.0, trace=False,
                   device="cpu", e2e=MAN.end_to_end("ds7b.chat"))
    assert res["correct"] is True and res["attempted"] > 10
    assert res["failed"] == 0
    assert {"out_tok_s", "ttft_p95_ms", "itl_p95_ms", "setup_s"} == \
        set(res["metrics"])
