"""Prefix cache: the host's microseconds of prefix-cache work per
admission — the program's ``prefix`` spans (the lookup and the mapping of
a hit's blocks, and the insert of the prompt's blocks after its prefill)
over the window's ``prefill rid=N`` spans."""


def read(rec):
    admits = sum(1 for name, _d in rec.spans
                 if name.startswith("prefill rid="))
    prefix = [d for name, d in rec.spans if name == "prefix"]
    if not admits or not prefix:
        return None
    return sum(prefix) / 1e3 / admits
