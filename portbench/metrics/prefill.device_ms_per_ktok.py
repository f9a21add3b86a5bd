"""Model step: device milliseconds of the window's prefill calls (full and
suffix) by CUDA events, per 1,000 prompt tokens they ran."""


def read(rec):
    run = sum(p["prompt"] - p["prefix"] for p in rec.prefill)
    if run <= 0:
        return None
    return sum(p["ms"] for p in rec.prefill) / (run / 1000.0)
