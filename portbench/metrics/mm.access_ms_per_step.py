"""MM plane: the host's milliseconds per engine step that hand the
attention heat to the memory manager — the program's ``access`` spans
(``record_access`` for each prefill; in a decode step the pass over its
rows: heat, prefix-cache heat, lengths, finishing) over the window's
``step N`` spans."""


def read(rec):
    steps = sum(1 for name, _d in rec.spans if name.startswith("step "))
    access = [d for name, d in rec.spans if name == "access"]
    if not steps or not access:
        return None
    return sum(access) / 1e6 / steps
