"""The client's side of a run: when each request was sent (or due) and
when each of its tokens came back, and the end-to-end metrics taken from
that alone.

Times are host-clock seconds.  A token "comes back" at the return of the
engine step that produced it (after the card finished that step's work);
tokens of one request that come back from one step share that time, so
the gap between them is 0.  Every metric is over the whole window
``[t0, t1]``: a rate counts every token of the window over all of its
seconds, a tail is taken over every sample the window holds.
"""

from __future__ import annotations

import numpy as np


class Timeline:
    def __init__(self) -> None:
        self.sent: dict[int, float] = {}      # rid -> submitted (or due)
        self.arrivals: dict[int, list] = {}   # rid -> [(t, n tokens)]
        self.seen: dict[int, int] = {}        # rid -> tokens seen so far
        self.done: dict[int, float] = {}      # rid -> time of its last token

    def send(self, rid: int, t: float) -> None:
        self.sent[rid] = t
        self.arrivals[rid] = []
        self.seen[rid] = 0

    def tokens(self, rid: int, total: int, t: float) -> int:
        """The request now has ``total`` tokens at time ``t``; returns how
        many are new (a request preempted and run again counts a token once,
        the first time it came)."""
        new = total - self.seen[rid]
        if new > 0:
            self.arrivals[rid].append((t, new))
            self.seen[rid] = total
        return max(new, 0)

    def finish(self, rid: int, t: float) -> None:
        self.done[rid] = t

    # ------------------------------------------------------------ reductions
    def tokens_in(self, t0: float, t1: float) -> int:
        return sum(n for arr in self.arrivals.values() for t, n in arr
                   if t0 <= t <= t1)

    def ttfts(self, t0: float, t1: float) -> list[float]:
        """Seconds from sending to the first token, for every request whose
        first token came in the window."""
        return [arr[0][0] - self.sent[rid]
                for rid, arr in self.arrivals.items()
                if arr and t0 <= arr[0][0] <= t1]

    def itls(self, t0: float, t1: float) -> list[float]:
        """Every gap between consecutive tokens of a request, both inside
        the window."""
        out: list[float] = []
        for arr in self.arrivals.values():
            prev = None
            for t, n in arr:
                if t0 <= t <= t1:
                    if prev is not None and prev >= t0:
                        out.append(t - prev)
                    out.extend([0.0] * (n - 1))
                prev = t
        return out


def percentile(values, q: float) -> float | None:
    """The q-th percentile over all values (linear between order
    statistics); None with no value."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(tl: Timeline, t0: float, t1: float) -> dict:
    """The end-to-end metrics of the window ``[t0, t1]`` (None where the
    window holds no sample)."""
    tt, it = tl.ttfts(t0, t1), tl.itls(t0, t1)
    p_tt, p_it = percentile(tt, 95), percentile(it, 95)
    return {
        "out_tok_s": tl.tokens_in(t0, t1) / (t1 - t0),
        "ttft_p95_ms": None if p_tt is None else p_tt * 1e3,
        "itl_p95_ms": None if p_it is None else p_it * 1e3,
        "samples": {"ttft": len(tt), "itl": len(it)},
    }
