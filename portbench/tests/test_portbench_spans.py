"""The readers of the program's own spans: each on a synthetic record
(and None on a record without the spans, as a program without them
gives), and all five in a traced run of ``ds7b.chat``'s smoke stand-in on
the CPU, where the device spans are host-clock readings."""

from types import SimpleNamespace

import pytest

from portbench import manifest
from portbench.serve import run_cell
from portbench.tests import smoke

MAN = manifest.Manifest()
SPAN_METRICS = ("engine.sample_ms_per_step", "mm.access_ms_per_step",
                "prefix.host_us_per_admit", "engine.queue_ms_p95",
                "policy.device_us_per_batch")


def _rec():
    ms = 1_000_000
    spans = [("step 0", 40 * ms), ("step 1", 42 * ms), ("decode", 30 * ms),
             ("sample", 3 * ms), ("sample", 5 * ms), ("sample", ms // 2),
             ("access", 2 * ms), ("access", ms), ("prefill rid=7", 9 * ms),
             ("prefill rid=8", 9 * ms), ("prefix", 300_000),
             ("prefix", 100_000), ("prefix", 200_000),
             ("dev policy", 12_000), ("dev policy", 18_000),
             ("dev decode", 22 * ms)]
    spans += [(f"queue rid={i}", i * ms) for i in range(1, 21)]
    return SimpleNamespace(spans=spans)


def test_readers_on_a_synthetic_record():
    got = {m: manifest.reader(m)(_rec()) for m in SPAN_METRICS}
    assert got == pytest.approx({
        "engine.sample_ms_per_step": 8.5 / 2,
        "mm.access_ms_per_step": 3.0 / 2,
        "prefix.host_us_per_admit": 600.0 / 2,
        "engine.queue_ms_p95": 19.05,
        "policy.device_us_per_batch": 15.0})


def test_readers_find_nothing_without_the_spans():
    """The spans a program without this tracing records (``step N``,
    ``decode``, ``mm-tick``, ``prefill rid=N``, ``req N``): every reader
    returns None."""
    rec = SimpleNamespace(spans=[("step 0", 5), ("decode", 3),
                                 ("mm-tick", 1), ("prefill rid=0", 2),
                                 ("req 0", 9)])
    assert all(manifest.reader(m)(rec) is None for m in SPAN_METRICS)
    assert all(manifest.reader(m)(SimpleNamespace(spans=[])) is None
               for m in SPAN_METRICS)


def test_manifest_lists_the_span_metrics():
    entries = {m["name"]: m for m in MAN.per_layer("ds7b.chat")}
    for name in SPAN_METRICS:
        assert entries[name]["source"] == "program_span"
        assert entries[name]["better"] == "lower"


def test_traced_chat_run_reads_the_program_spans():
    layer = MAN.per_layer("ds7b.chat")
    res = run_cell(smoke.config("ds7b"), smoke.mix("chat"), smoke.LIMITS,
                   seed=2 ** 31 + 29, seconds=1.0, trace=True,
                   device="cpu", layer_metrics=layer,
                   readers={m["name"]: manifest.reader(m["name"])
                            for m in layer})
    assert res["correct"] is True
    got = res["metrics"]
    assert set(SPAN_METRICS) <= set(got)
    assert all(got[m]["value"] > 0 for m in SPAN_METRICS)
    assert got["engine.queue_ms_p95"]["unit"] == "ms"
    assert got["prefix.host_us_per_admit"]["unit"] == "us"
