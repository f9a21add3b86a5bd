"""Model step: device milliseconds of one decode-graph call (the inputs'
copy, the replay, the logits' and heat's copy back), by CUDA events, over
the window's calls."""


def read(rec):
    if not rec.decode:
        return None
    return sum(d["ms"] for d in rec.decode) / len(rec.decode)
