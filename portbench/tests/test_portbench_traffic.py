"""The traffic generator: reproducible from the seed, the same work for
every seed, and the distributions its files state."""

from collections import Counter

import numpy as np
import pytest

from portbench import manifest
from portbench.traffic import (Traffic, lognormal_quantiles, prompt_shapes,
                               spread, zipf_weights)

BT = 16
BIG = 2 ** 31 + 977


def take(mix, seed, n, vocab=102400):
    tr = Traffic(mix, seed, vocab=vocab, block_tokens=BT)
    return tr, [tr.next() for _ in range(n)]


def doc_tokens(mix):
    d = next(iter(mix["apps"].values())).get("docs")
    return d["blocks"] * BT if d else 0


def shape(r, doc=0):
    """(prompt tokens after the document, output tokens)."""
    return len(r.prompt) - doc, r.max_new


@pytest.mark.parametrize("mix", ["chat", "rag"])
def test_same_seed_same_requests(mix):
    m = manifest.traffic(mix)
    _, a = take(m, BIG, 200)
    _, b = take(m, BIG, 200)
    assert [(r.prompt, r.max_new, r.app, r.doc) for r in a] == \
        [(r.prompt, r.max_new, r.app, r.doc) for r in b]
    _, c = take(m, BIG + 1, 200)
    assert [r.prompt for r in a] != [r.prompt for r in c]


@pytest.mark.parametrize("mix", ["chat", "rag"])
def test_every_seed_same_work_per_round(mix):
    m = manifest.traffic(mix)
    R, db = m["round"], doc_tokens(m)
    rounds = []
    for seed in (3, BIG):
        _, reqs = take(m, seed, 2 * R)
        for k in range(2):
            rnd = reqs[k * R:(k + 1) * R]
            rounds.append((Counter(shape(r, db) for r in rnd),
                           Counter(r.doc for r in rnd)))
    assert all(r == rounds[0] for r in rounds)


def test_a_fixed_order_is_the_same_for_every_seed():
    """``"order": "fixed"``: every seed sends the same sizes in the same
    sequence, with other tokens; by default the seed orders each round."""
    m = manifest.traffic("chat")
    assert m["order"] == "fixed"
    _, a = take(m, 3, 3 * m["round"])
    _, b = take(m, BIG, 3 * m["round"])
    assert [shape(r) for r in a] == [shape(r) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in b]
    seeded = {k: v for k, v in m.items() if k != "order"}
    _, c = take(seeded, 3, m["round"])
    _, d = take(seeded, BIG, m["round"])
    assert [shape(r) for r in c] != [shape(r) for r in d]
    assert sorted(shape(r) for r in c) == sorted(shape(r) for r in d)


@pytest.mark.parametrize("mix", ["chat", "rag"])
def test_lengths_follow_the_file(mix):
    """Prompt and output lengths: the file's lognormals, clipped; many
    distinct prompt lengths, not a few snapped ones."""
    m = manifest.traffic(mix)
    app = next(iter(m["apps"].values()))
    _, reqs = take(m, BIG, 10 * m["round"])
    db = doc_tokens(m)
    for key, vals in (("prompt", [shape(r, db)[0] for r in reqs]),
                      ("output", [r.max_new for r in reqs])):
        spec, v = app[key], np.array(vals)
        assert v.min() >= spec["min"] and v.max() <= spec["max"]
        assert abs(np.median(v) - spec["median"]) <= 0.05 * spec["median"]
        # the lognormal's spread: ~84% of the mass under median * e^sigma
        assert np.mean(v <= spec["median"] * np.exp(spec["sigma"])) == \
            pytest.approx(0.84, abs=0.03)
    assert len({shape(r, db)[0] for r in reqs}) >= 0.5 * m["round"]
    assert all(1 <= t < 102400 for r in reqs[:20] for t in r.prompt)


def test_rag_documents_follow_zipf():
    m = manifest.traffic("rag")
    d = m["apps"]["rag"]["docs"]
    tr, reqs = take(m, BIG, 4 * m["round"])
    counts = Counter(r.doc for r in reqs)
    want = spread(zipf_weights(d["count"], d["zipf"]), m["round"])
    assert [counts[i] for i in range(d["count"])] == [4 * w for w in want]
    assert counts[0] > counts[1] > counts[3] > counts[7]
    for r in reqs[:50]:
        doc = tr.docs["rag"][r.doc]
        assert r.prompt[:len(doc)] == doc
        assert len(doc) == d["blocks"] * BT


@pytest.mark.parametrize("mix", ["chat", "rag"])
def test_prompt_shapes_cover_the_traffic(mix):
    """The warm-up's shapes are exactly those the requests make: every
    padded prompt, and with documents every (suffix, prompt) pair of a
    hit on a whole document."""
    m = manifest.traffic(mix)
    full, suffix = prompt_shapes(m, BT)
    _, reqs = take(m, BIG, 3 * m["round"])
    db = doc_tokens(m) // BT
    nbs = {-(-len(r.prompt) // BT) for r in reqs}
    assert nbs == full
    if db:
        assert suffix == {(nb - db, nb) for nb in nbs}
    else:
        assert suffix == set()


def test_open_loop_schedule():
    m = {"loop": "open", "round": 50,
         "arrival": {"rate": 20.0, "burst_every": 10, "burst_size": 3},
         "apps": {"a": {"weight": 1,
                        "prompt": {"median": 16, "sigma": 0.5, "min": 2,
                                   "max": 64},
                        "output": {"median": 8, "sigma": 0.5, "min": 2,
                                   "max": 32}}}}
    _, a = take(m, BIG, 100)
    _, b = take(m, BIG, 100)
    due = [r.due for r in a]
    assert due == [r.due for r in b]
    assert all(x <= y for x, y in zip(due, due[1:]))
    gaps = np.diff([0.0] + due)
    assert (gaps == 0).sum() >= 2 * 100 // 10 - 2       # the bursts
    assert due[-1] == pytest.approx(100 / 20.0, rel=0.25)


def test_quantiles_and_spread():
    assert spread([0.35, 0.30, 0.20, 0.15], 64) == [22, 19, 13, 10]
    q = lognormal_quantiles({"median": 64, "sigma": 0.8, "min": 16,
                             "max": 384}, 1001)
    assert q[500] == 64 and q[0] == 16 and q == sorted(q)
