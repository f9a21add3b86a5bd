"""Prefix cache: the share of the prompt tokens admitted in the window
that the cache spared from prefill (1 - tokens run / prompt tokens), in
percent."""


def read(rec):
    prompt = sum(p["prompt"] for p in rec.prefill)
    if prompt <= 0:
        return None
    return 100.0 * (1.0 - rec.prefill_tokens / prompt)
