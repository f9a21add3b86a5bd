"""Engine loop: the host's milliseconds of sampling per engine step — the
program's ``sample`` spans (a decode step's pass over its rows, and each
prefill's first token) over the window's ``step N`` spans."""


def read(rec):
    steps = sum(1 for name, _d in rec.spans if name.startswith("step "))
    sample = [d for name, d in rec.spans if name == "sample"]
    if not steps or not sample:
        return None
    return sum(sample) / 1e6 / steps
