"""MM plane: the program's ``mm-tick`` span (khugepaged, prefix-cache
eviction, the move drain's launches, the MM tick), milliseconds per step
of the window."""


def read(rec):
    ticks = [d for name, d in rec.spans if name == "mm-tick"]
    if not ticks:
        return None
    return sum(ticks) / 1e6 / len(ticks)
