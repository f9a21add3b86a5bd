"""The end-to-end reductions: a rate over the whole window, tails over
every sample, and a stall that both of them see."""

import numpy as np
import pytest

from portbench.timeline import Timeline, end_to_end, percentile


def synthetic(stalls=(), clients=32, steps=200, step_s=0.03, out=40):
    """A closed loop on a synthetic clock: every step returns one token to
    each of ``clients`` requests; a request ends after ``out`` tokens and
    its client sends the next at once; steps in ``stalls`` take 10x."""
    tl = Timeline()
    t, rid = 0.0, 0
    live = {}
    for _ in range(clients):
        tl.send(rid, t)
        live[rid] = 0
        rid += 1
    for k in range(steps):
        t += step_s * (10 if k in stalls else 1)
        for r in list(live):
            live[r] += 1
            tl.tokens(r, live[r], t)
            if live[r] == out:
                tl.finish(r, t)
                del live[r]
                tl.send(rid, t)
                live[rid] = 0
                rid += 1
    return tl, t


def test_rate_is_every_token_over_the_whole_window():
    tl, end = synthetic()
    e = end_to_end(tl, 0.0, end)
    assert e["out_tok_s"] == pytest.approx(32 * 200 / end)
    # half the window: half the tokens over half the seconds
    assert end_to_end(tl, 0.0, end / 2)["out_tok_s"] == \
        pytest.approx(32 / 0.03, rel=0.02)


def test_a_stall_moves_the_rate_and_the_tails():
    base, end0 = synthetic()
    stalls = set(range(20, 200, 15))
    stalled, end1 = synthetic(stalls=stalls)
    a, b = end_to_end(base, 0.0, end0), end_to_end(stalled, 0.0, end1)
    # the same tokens over the stalls' extra seconds
    assert b["out_tok_s"] == pytest.approx(
        a["out_tok_s"] * 200 / (200 + 9 * len(stalls)))
    assert b["itl_p95_ms"] > 5 * a["itl_p95_ms"]
    assert b["ttft_p95_ms"] > 5 * a["ttft_p95_ms"]


def test_tails_are_over_all_samples():
    tl, end = synthetic(stalls={50, 51})
    t0, t1 = 0.5, end
    itl = tl.itls(t0, t1)
    # every gap of every request inside the window, not chunk medians
    assert len(itl) == sum(
        1 for arr in tl.arrivals.values()
        for (a, _), (b, _) in zip(arr, arr[1:]) if t0 <= a and b <= t1)
    assert end_to_end(tl, t0, t1)["itl_p95_ms"] == \
        pytest.approx(np.percentile(itl, 95) * 1e3)
    assert max(itl) == pytest.approx(0.3)


def test_ttft_counts_requests_whose_first_token_is_in_the_window():
    tl = Timeline()
    tl.send(1, 0.0)
    tl.tokens(1, 1, 0.5)            # before the window
    tl.send(2, 0.8)                 # sent before, first token inside
    tl.tokens(2, 2, 1.3)            # two tokens from one step: gap 0
    tl.tokens(2, 3, 1.4)
    tl.tokens(1, 2, 1.2)
    assert sorted(tl.ttfts(1.0, 2.0)) == [pytest.approx(0.5)]
    assert sorted(tl.itls(1.0, 2.0)) == [0.0, pytest.approx(0.1)]
    # a request run again after a preemption: its tokens count once
    assert tl.tokens(2, 1, 1.5) == 0 and tl.tokens(2, 4, 1.6) == 1
    assert tl.tokens_in(1.0, 2.0) == 5


def test_percentile_empty():
    assert percentile([], 95) is None
