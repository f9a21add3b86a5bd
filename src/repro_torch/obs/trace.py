"""Chrome trace-event JSON exporter (perfetto / chrome://tracing loadable),
and the split of the device's idle time by host phase.

Two process tracks, and a third when the hub holds device spans:

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
    as instants;
  * pid 3 ``device`` (only with spans of category ``"device"``) — the
    device spans on a ``stream`` row, and an ``idle`` row whose slices
    are the device's idle time between its first and last span, each
    named after the host phase it fell in (:func:`idle_segments`).

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


# categories of host spans that stand for a phase of the host's work (the
# engine's spans, their ``phase`` children, the capture's ``setup`` spans);
# the ``wait`` and ``request`` spans overlap them and stand for none
HOST_PHASES = ("engine", "phase", "setup")


def phase_label(name: str) -> str:
    """A span's name without its instance id ("step 12" -> "step",
    "prefill rid=3" -> "prefill")."""
    head, _, tail = name.rpartition(" ")
    return head if head and any(c.isdigit() for c in tail) else name


def _phase_pieces(spans) -> list:
    """The host's time as ``(start, end, label)`` pieces that do not
    overlap, each labelled by the innermost host phase open over it
    (spans of one thread nest; one that overruns its parent is cut)."""
    phases = sorted(((ts, ts + dur, phase_label(name))
                     for name, cat, _tid, ts, dur in spans
                     if cat in HOST_PHASES and dur > 0),
                    key=lambda p: (p[0], -p[1]))
    pieces: list = []
    stack: list = []                    # open (end, label), innermost last
    pos = 0

    def close_until(t) -> None:
        nonlocal pos
        while stack and stack[-1][0] <= t:
            end, label = stack.pop()
            if end > pos:
                pieces.append((pos, end, label))
                pos = end
    for a, b, label in phases:
        close_until(a)
        if stack and a > pos:
            pieces.append((pos, a, stack[-1][1]))
        pos = max(pos, a)
        stack.append((min(b, stack[-1][0]) if stack else b, label))
    close_until(float("inf"))
    return pieces


def idle_segments(spans, t0: int, t1: int) -> list:
    """The device's idle time in ``[t0, t1]`` (ns on the spans' clock): the
    instants no ``device`` span covers, as ``(start, end, label)`` with the
    label of the innermost host phase open there (:data:`HOST_PHASES`,
    :func:`phase_label`), or ``"unattributed"`` outside every phase."""
    busy = sorted((max(ts, t0), min(ts + dur, t1))
                  for _n, cat, _tid, ts, dur in spans
                  if cat == "device" and ts + dur > t0 and ts < t1)
    idle, pos = [], t0
    for a, b in busy:
        if a > pos:
            idle.append((pos, a))
        pos = max(pos, b)
    if pos < t1:
        idle.append((pos, t1))
    pieces = _phase_pieces(spans)
    out, k = [], 0
    for a, b in idle:
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        j = k
        while a < b:
            if j < len(pieces) and pieces[j][0] < b:
                pa, pb, label = pieces[j]
                if pa > a:
                    out.append((a, pa, "unattributed"))
                    a = pa
                out.append((a, min(pb, b), label))
                a = min(pb, b)
                j += 1
            else:
                out.append((a, b, "unattributed"))
                a = b
    return out


def idle_by_phase(spans, t0: int, t1: int) -> dict:
    """Device-idle nanoseconds in ``[t0, t1]`` per host phase
    (:func:`idle_segments`), ``"unattributed"`` included when nonzero."""
    out: dict = {}
    for a, b, label in idle_segments(spans, t0, t1):
        out[label] = out.get(label, 0) + (b - a)
    return out


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
    device = []
    for name, cat, tid, ts0, dur in tel.spans:
        if cat == "device":
            device.append((name, ts0, dur))
            continue
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
    if device:
        events += [{"ph": "M", "name": "process_name", "pid": 3,
                    "args": {"name": "device"}},
                   {"ph": "M", "name": "thread_name", "pid": 3, "tid": 1,
                    "args": {"name": "stream"}},
                   {"ph": "M", "name": "thread_name", "pid": 3, "tid": 2,
                    "args": {"name": "idle"}}]
        events += [{"ph": "X", "name": name, "cat": "device", "pid": 3,
                    "tid": 1, "ts": ts0 / 1000.0, "dur": dur / 1000.0}
                   for name, ts0, dur in device]
        t0 = min(ts0 for _n, ts0, _d in device)
        t1 = max(ts0 + dur for _n, ts0, dur in device)
        events += [{"ph": "X", "name": label, "cat": "idle", "pid": 3,
                    "tid": 2, "ts": a / 1000.0, "dur": (b - a) / 1000.0}
                   for a, b, label in idle_segments(tel.spans, t0, t1)]
        # the captured entries' counts (kernel launches, expert rows), the
        # prefix cache's heat folds and the device's own counters (dropped
        # expert rows), at the end
        entry = {k: v for k, v in tel.counters.items() if "." in k}
        entry.update((k, int(f())) for k, f in tel.probes.items())
        if entry:
            events.append({"ph": "C", "name": "entry counts", "pid": 3,
                           "tid": 1, "ts": t1 / 1000.0, "args": entry})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(tel, path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(tel), f)
