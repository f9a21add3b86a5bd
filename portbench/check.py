"""How ``correct`` is decided for a served model.

Once the window has closed: a sample, drawn from the seed, of the requests
finished in the window, the one with the most served tokens always in it,
then others until it holds ``SAMPLE_REQUESTS`` requests and
``SAMPLE_TOKENS`` served tokens, or ``SAMPLE_MAX`` requests.  The plain reference runs once over each prompt and its served
tokens; for every served token the number compared is the gap by which the
reference's logit of that token lies below the reference's best logit at
that position.  ``served_gap_max``, the widest gap of the sample, is held
to its limit (``portbench/limits/<cell>.json``): greedy tokens of a sound
program lie on or near the reference's best.
"""

from __future__ import annotations

import sys

import torch

from .traffic import rng_for

SAMPLE_REQUESTS = 8
SAMPLE_TOKENS = 512
SAMPLE_MAX = 32


def sample(finished: dict, seed: int) -> list[int]:
    """rids drawn from ``finished`` ({rid: (prompt, served)}): the one with
    the most served tokens first, then others in a seeded order."""
    if not finished:
        return []
    rids = sorted(finished)
    top = max(rids, key=lambda r: (len(finished[r][1]), -r))
    rest = [r for r in rids if r != top]
    rng_for(seed, 2).shuffle(rest)
    out, n = [top], len(finished[top][1])
    for r in rest:
        if (n >= SAMPLE_TOKENS and len(out) >= SAMPLE_REQUESTS) or \
                len(out) >= SAMPLE_MAX:
            break
        out.append(r)
        n += len(finished[r][1])
    return out


def gaps(ref_logits: list, served: list) -> torch.Tensor:
    """Per served token, the reference's best logit minus its logit of
    the served token, over all requests of the sample."""
    out = []
    for lg, toks in zip(ref_logits, served):
        t = torch.as_tensor(toks, device=lg.device).long()
        out.append(lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0])
    return torch.cat(out)


def control_gaps(ref_logits: list, low_logits: list) -> torch.Tensor:
    """The gap, in the reference's logits, of the token that a lower
    precision puts first at each position."""
    return gaps(ref_logits, [lo.argmax(dim=-1) for lo in low_logits])


def summary(name: str, g: torch.Tensor) -> dict:
    """``<name>_gap_max``, ``_p99`` and ``_mean`` of the gaps ``g``."""
    g = g.double()
    return {f"{name}_gap_max": float(g.max()),
            f"{name}_gap_p99": float(torch.quantile(g, 0.99)),
            f"{name}_gap_mean": float(g.mean())}


def reference_inputs(finished: dict, rids: list) -> tuple[list, list, list]:
    """(sequences, first logit position, served tokens) of the sampled
    requests: each prompt followed by its served tokens but the last."""
    seqs, starts, served = [], [], []
    for r in rids:
        prompt, toks = finished[r]
        seqs.append(list(prompt) + list(toks[:-1]))
        starts.append(len(prompt) - 1)
        served.append(list(toks))
    return seqs, starts, served


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit (at most the limit passes); prints
    each beside its limit on standard error.  A missing number fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
        print(f"check {name} {v} limit {limit} {'ok' if good else 'FAIL'}",
              file=sys.stderr, flush=True)
    return ok, out
