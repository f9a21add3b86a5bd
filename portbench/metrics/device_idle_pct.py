"""Device: the share of the traced window in which no bracketed device
entry ran (1 - the entries' CUDA-event time / the window), in percent.
Not from the profiler, which slows a graph's launch."""


def read(rec):
    busy = sum(s["device_ms"] for s in rec.steps) / 1e3
    if rec.window_s <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / rec.window_s)
