"""The general traffic generator: one traffic file of parameters in, a
seeded, reproducible stream of requests out.

A traffic file (``portbench/traffic/<mix>.json``) names its loop and its
apps:

* ``"loop": "closed"`` with ``"clients"``: each client sends its next
  request as soon as its last one finished;
  ``"loop": "open"`` with ``"arrival": {"rate", "burst_every",
  "burst_size"}``: requests are due on a schedule whatever the system does.
* ``"round"``: requests are made in rounds of this many.  Every round holds
  the same multiset of sizes (and of arrival gaps), drawn by quantile from
  the file's distributions and paired (prompt, output, document rank)
  the same way for every seed; the seed draws the token ids and the
  documents' tokens and, unless ``"order": "fixed"``, orders each round.
  So every seed asks for the same work; with a fixed order, in the same
  sequence (a trace replayed with other tokens).
* ``"apps"``: name -> ``{"weight", "prompt": {"median", "sigma", "min",
  "max"}, "output": {...the same}, "docs": {"count", "blocks", "zipf"}
  (optional), "profile": [[start, end, [benefit per page order]], ...]}``.
  Lengths are in tokens, each a lognormal of the given median and sigma
  clipped to ``[min, max]``, drawn at the quantiles ``(i + 0.5) / n`` of
  the app's ``n`` requests a round.  A prompt is its document (when the app
  has docs: ``blocks`` whole blocks, ranked by a Zipf law of exponent
  ``zipf``) and then ``prompt`` fresh tokens; ``output`` is each request's
  ``max_new_tokens`` (greedy decoding, no early stop).
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass

import numpy as np

SEED_MASK = (1 << 64) - 1


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any whole number) and ``salt``."""
    return np.random.default_rng([int(seed) & SEED_MASK, *salt])


@dataclass
class Req:
    rid: int
    app: str
    prompt: list
    max_new: int
    doc: int | None = None      # document index, for apps with docs
    due: float | None = None    # open loop: seconds after the window opens


def spread(weights, n: int) -> list[int]:
    """How many of ``n`` items each weight gets: floor shares, the rest to
    the largest remainders (ties to the first)."""
    w = np.asarray(weights, np.float64)
    share = w / w.sum() * n
    out = np.floor(share).astype(int)
    left = n - int(out.sum())
    order = sorted(range(len(w)), key=lambda i: (-(share[i] - out[i]), i))
    for i in order[:left]:
        out[i] += 1
    return out.tolist()


def lognormal_quantiles(spec: dict, n: int) -> list[int]:
    """``n`` lengths at the quantiles (i + 0.5) / n of the spec's
    lognormal, clipped and rounded."""
    nd = statistics.NormalDist()
    med, sig = float(spec["median"]), float(spec["sigma"])
    return [int(min(spec["max"], max(spec["min"], round(
        med * math.exp(sig * nd.inv_cdf((i + 0.5) / n))))))
        for i in range(n)]


def zipf_weights(count: int, s: float) -> list[float]:
    return [1.0 / (r + 1) ** s for r in range(count)]


class Traffic:
    """The request stream of one mix for one seed.  ``next()`` gives the
    next request; ``docs`` the shared documents (token lists)."""

    def __init__(self, mix: dict, seed: int, *, vocab: int,
                 block_tokens: int):
        self.mix, self.vocab, self.bt = mix, int(vocab), int(block_tokens)
        self.rng = rng_for(seed, 1)
        self.order = (rng_for(0, 5) if mix.get("order") == "fixed"
                      else self.rng)
        self.docs: dict[str, list] = {}
        for name, app in sorted(mix["apps"].items()):
            d = app.get("docs")
            if d:
                self.docs[name] = [self._ids(d["blocks"] * self.bt)
                                   for _ in range(d["count"])]
        self._queue: list[Req] = []
        self._rid = 0
        self._clock = 0.0

    def _ids(self, n: int) -> list:
        return self.rng.integers(1, self.vocab, n).tolist()

    def _round(self) -> list[Req]:
        mix = self.mix
        reqs = []
        for name, prompts, outs, docs in round_sizes(mix):
            for q, out, doc in zip(prompts, outs, docs):
                prompt = (list(self.docs[name][doc]) if doc is not None
                          else [])
                prompt += self._ids(q)
                reqs.append(Req(rid=0, app=name, prompt=prompt,
                                max_new=int(out), doc=doc))
        self.order.shuffle(reqs)
        arrival = mix.get("arrival")
        if mix["loop"] == "open":
            gaps = self._gaps(arrival, int(mix["round"]))
            self.order.shuffle(gaps)
            for r, g in zip(reqs, gaps):
                self._clock += g
                r.due = self._clock
        return reqs

    @staticmethod
    def _gaps(arrival: dict, n: int) -> list[float]:
        """Arrival gaps of one round: exponential quantiles at the rate,
        every ``burst_every``-th arrival bringing ``burst_size`` requests
        at once (gap 0 after the first of them)."""
        rate = float(arrival["rate"])
        every = int(arrival.get("burst_every", 0))
        size = int(arrival.get("burst_size", 1))
        gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
        if every > 0 and size > 1:
            for i in range(0, n, every):
                for j in range(i + 1, min(i + size, n)):
                    gaps[j] = 0.0
        return gaps

    def next(self) -> Req:
        if not self._queue:
            self._queue = self._round()
            self._queue.reverse()
        r = self._queue.pop()
        r.rid = self._rid
        self._rid += 1
        return r


def round_sizes(mix: dict) -> list[tuple]:
    """(app, prompt tokens, output tokens, document ranks) of one round:
    the same lists for every round and seed, paired the same way."""
    pairing = rng_for(0, 4)
    names = sorted(mix["apps"])
    per_app = spread([mix["apps"][a]["weight"] for a in names],
                     int(mix["round"]))
    out = []
    for name, n in zip(names, per_app):
        app = mix["apps"][name]
        prompts = lognormal_quantiles(app["prompt"], n)
        outs = lognormal_quantiles(app["output"], n)
        d = app.get("docs")
        docs = ([r for r, c in enumerate(spread(
            zipf_weights(d["count"], d["zipf"]), n)) for _ in range(c)]
                if d else [None] * n)
        for lst in (prompts, outs, docs):
            pairing.shuffle(lst)
        out.append((name, prompts, outs, docs))
    return out


def prompt_shapes(mix: dict, block_tokens: int) -> tuple[set, set]:
    """The prefill shapes a mix makes: the padded block counts of a whole
    prompt (a prefix-cache miss), and the (suffix blocks, prompt blocks)
    pairs of a prefix-cache hit on a whole document."""
    full, suffix = set(), set()
    for name, prompts, _outs, _docs in round_sizes(mix):
        d = mix["apps"][name].get("docs")
        doc = d["blocks"] if d else 0
        for q in prompts:
            nb = -(-q // block_tokens)
            full.add(doc + nb)
            if doc:
                suffix.add((nb, doc + nb))
    return full, suffix
