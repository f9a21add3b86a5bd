"""Chrome trace-event JSON exporter (perfetto / chrome://tracing loadable).

Two process tracks:

  * pid 1 ``host`` — the engine's wall-clock spans (step / prefill /
    decode) as complete ("X") events, one thread row per span ``tid``;
  * pid 2 ``modeled`` — the event ring as instant ("i") events.  Program
    and mm events carry the modeled ktime clock, host-side events a wall
    timestamp; both are offset-normalized so the track starts near 0.
    Migration-hop events additionally render as complete ("X") spans on a
    dedicated ``mm migration`` thread row — each hop carries its modeled
    transfer duration (``a2`` ns), so a multi-hop demotion reads as a
    chain of adjacent spans instead of dimensionless ticks.  Profiler
    events get their own ``mm profiler`` row: EV_WSS samples render as
    counter ("C") series (the WSS curve per process), program-emitted
    heat-histogram samples as per-bucket counters, and profile reloads
    as instants.

Timestamps are microseconds (the trace-event format's unit); sub-``us``
durations survive as fractions.

Host spans on an asynchronous device: the spans are host wall time, and the
engine adds no device synchronization to take them.  A span that ends with
a device-to-host copy (the decode span ends after ``logits.cpu()``) waits
for the device work queued before that copy, so it includes it.  A span
that only launches device work does not: the mm-tick span launches the
block copies of its move drain and returns, and their device time lands in
whichever later span next waits on the device (the next decode span).
"""

from __future__ import annotations

import json

from .ringbuf import (EV_MIGRATE_HOP, EV_PROFILE, EV_WSS, PROF_TAG_HEAT,
                      tag_name)


def chrome_trace(tel) -> dict:
    events = []
    tids: dict[str, int] = {}

    def tid_of(name: str) -> int:
        if name not in tids:
            tids[name] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tids[name], "args": {"name": name}})
        return tids[name]

    events.append({"ph": "M", "name": "process_name", "pid": 1,
                   "args": {"name": "host"}})
    events.append({"ph": "M", "name": "process_name", "pid": 2,
                   "args": {"name": "modeled"}})
    for name, cat, tid, ts0, dur in tel.spans:
        events.append({"ph": "X", "name": name, "cat": cat, "pid": 1,
                       "tid": tid_of(tid), "ts": ts0 / 1000.0,
                       "dur": dur / 1000.0})
    ring = tel.ring.peek()
    base = int(ring[:, 0].min()) if len(ring) else 0
    have_hops = False
    have_prof = False

    def profiler_thread() -> None:
        nonlocal have_prof
        if not have_prof:
            have_prof = True
            events.append({"ph": "M", "name": "thread_name", "pid": 2,
                           "tid": 3, "args": {"name": "mm profiler"}})

    for row in ring:
        ts, tag, a0, a1, a2 = (int(x) for x in row)
        events.append({"ph": "i", "name": tag_name(tag), "cat": "ring",
                       "pid": 2, "tid": 1, "ts": (ts - base) / 1000.0,
                       "s": "t", "args": {"a0": a0, "a1": a1, "a2": a2}})
        if tag == EV_WSS:
            # WSS curve: one counter track per process (working set vs
            # mapped blocks render as stacked series in Perfetto)
            profiler_thread()
            events.append({"ph": "C", "name": f"wss pid{a0}", "pid": 2,
                           "tid": 3, "ts": (ts - base) / 1000.0,
                           "args": {"wss_blocks": a1,
                                    "mapped_blocks": a2 - a1
                                    if a2 > a1 else 0}})
        elif tag == PROF_TAG_HEAT:
            # program-emitted log2 heat histogram: per-bucket region-block
            # counters (a1 = bucket, a2 = blocks in the sampled region)
            profiler_thread()
            events.append({"ph": "C", "name": f"heat b{a1} pid{a0}",
                           "pid": 2, "tid": 3, "ts": (ts - base) / 1000.0,
                           "args": {"blocks": a2}})
        elif tag == EV_PROFILE:
            profiler_thread()
            events.append({"ph": "i", "name": f"profile reload v{a2}",
                           "cat": "profiler", "pid": 2, "tid": 3,
                           "ts": (ts - base) / 1000.0, "s": "t",
                           "args": {"pid": a0, "regions": a1,
                                    "version": a2}})
        if tag == EV_MIGRATE_HOP:
            # span view of the same hop: a0 packs (src_tier<<8)|dst_tier,
            # a2 is the modeled transfer time of this edge
            if not have_hops:
                have_hops = True
                events.append({"ph": "M", "name": "thread_name", "pid": 2,
                               "tid": 2, "args": {"name": "mm migration"}})
            events.append({"ph": "X", "cat": "migration",
                           "name": f"hop t{a0 >> 8}->t{a0 & 0xff}",
                           "pid": 2, "tid": 2, "ts": (ts - base) / 1000.0,
                           "dur": a2 / 1000.0,
                           "args": {"bytes": a1, "ns": a2}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(tel, path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(tel), f)
