"""Telemetry hub: one object tying the event ring, the per-hook latency
histograms, plain counters and (optionally) Chrome-trace spans together.

Cost model: the hot paths guard every tracepoint with a single ``tel is
None or not tel.enabled`` check, so an engine built without telemetry (the
default) pays one attribute read + ``is None`` per candidate site and
allocates nothing.  A constructed-but-disabled hub (``enabled=False``) is
the benchmark's "attached, tracing off" lane — every site short-circuits
at the ``enabled`` flag.  Span sites also check ``trace_enabled`` before
they build a name, so tracing off formats no string.

Device spans (:meth:`Telemetry.device_span`, category ``"device"``) put
the device's own time on the same clock as the host spans, :meth:`now`,
without a synchronisation of their own.  On CUDA a span is a pair of
timing events on the current stream, kept pending; the sites call
:meth:`Telemetry.resolve_device` right after a synchronisation they make
anyway (a decode or prefill entry's fetch, a policy batch's copy down),
which turns every completed pair into a span and records a new anchor: an
event recorded there, with the host time read beside it.  A device
timestamp is the anchor's host time plus the anchor's elapsed time to the
event.  Before the first resolve, the first span records the anchor
itself.  On the CPU the work is synchronous and a mark is a host-clock
reading; the spans still wait for a resolve, as on the card.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import numpy as np

from .hist import Log2Hist
from .ringbuf import EventRing, tag_name

# what a span site enters when tracing is off: one shared no-op context
NO_SPAN = nullcontext()


class Telemetry:
    def __init__(self, *, ring_capacity: int = 8192, trace: bool = False,
                 enabled: bool = True) -> None:
        self.enabled = bool(enabled)
        # spans (Chrome-trace timeline) are opt-in on top of metrics: span
        # bookkeeping appends per step/prefill/decode, which callers only
        # want when they intend to export a trace.
        self.trace_enabled = bool(trace) and self.enabled
        self.ring = EventRing(ring_capacity)
        self.hook_invoke_ns: dict[str, Log2Hist] = {}
        self.hook_batch_size: dict[str, Log2Hist] = {}
        self.migrate_path_ns = Log2Hist()   # modeled cost per migration hop
        self.mgmt_step_ns = Log2Hist()      # wall per management step (bench)
        # Per-request serving latency: wall ns from submit to the first
        # sampled token, and wall ns per generated decode token.
        self.request_ttft_ns = Log2Hist()
        self.decode_token_ns = Log2Hist()
        self.counters: dict[str, int] = {}
        # counters kept on the device (name -> a reader that syncs), read
        # into the counters only by snapshot()
        self.probes: dict = {}
        # drops at the PROGRAM layer: per-lane event slots exhausted inside
        # one invocation (distinct from ring overflow, which is host-side)
        self.prog_lane_drops = 0
        # per-(tier, order) residency in block-ticks, grown on demand
        self._residency = np.zeros((1, 1), np.int64)
        self.spans: list[tuple] = []        # (name, cat, tid, ts0_ns, dur_ns)
        self._t0 = time.perf_counter_ns()
        # device spans: (name, anchor, start mark, end mark) waiting for a
        # resolve; the anchor (host ns, event); spent events for reuse
        self._pending: list[tuple] = []
        self._anchor: tuple | None = None
        self._spare: list = []

    @classmethod
    def disabled(cls) -> "Telemetry":
        return cls(ring_capacity=1, enabled=False)

    def now(self) -> int:
        """Wall clock (ns) relative to telemetry start."""
        return time.perf_counter_ns() - self._t0

    # ------------------------------------------------------------ producers
    def emit(self, tag: int, a0: int = 0, a1: int = 0, a2: int = 0,
             ts: int | None = None) -> None:
        if not self.enabled:
            return
        self.ring.push(self.now() if ts is None else int(ts), tag,
                       int(a0), int(a1), int(a2))

    def inc(self, name: str, v: int = 1) -> None:
        if not self.enabled:
            return
        self.counters[name] = self.counters.get(name, 0) + v

    def observe_hook(self, hook: str, wall_ns: int, batch: int) -> None:
        if not self.enabled:
            return
        h = self.hook_invoke_ns.get(hook)
        if h is None:
            h = self.hook_invoke_ns[hook] = Log2Hist()
            self.hook_batch_size[hook] = Log2Hist()
        h.observe(wall_ns)
        self.hook_batch_size[hook].observe(batch)

    def observe_migrate(self, ns: int) -> None:
        if self.enabled:
            self.migrate_path_ns.observe(ns)

    def observe_ttft(self, wall_ns: int) -> None:
        if self.enabled:
            self.request_ttft_ns.observe(wall_ns)

    def observe_decode_token(self, wall_ns: int, tokens: int = 1) -> None:
        """Per-token decode latency: a decode step that produced ``tokens``
        tokens in ``wall_ns`` contributes one observation per token at the
        per-token share."""
        if self.enabled and tokens > 0:
            self.decode_token_ns.observe(wall_ns // tokens, tokens)

    def observe_residency(self, tiers, orders, sizes) -> None:
        """Accumulate per-(tier, order) resident block-ticks — callers pass
        the mapping arrays of one process at one sampling tick."""
        if not self.enabled:
            return
        tiers = np.asarray(tiers, np.int64)
        orders = np.asarray(orders, np.int64)
        sizes = np.asarray(sizes, np.int64)
        if tiers.size == 0:
            return
        t_hi = int(tiers.max()) + 1
        o_hi = int(orders.max()) + 1
        if t_hi > self._residency.shape[0] or o_hi > self._residency.shape[1]:
            grown = np.zeros((max(t_hi, self._residency.shape[0]),
                              max(o_hi, self._residency.shape[1])), np.int64)
            grown[:self._residency.shape[0], :self._residency.shape[1]] = \
                self._residency
            self._residency = grown
        np.add.at(self._residency, (tiers, orders), sizes)

    @contextmanager
    def span(self, name: str, cat: str = "engine", tid: str = "engine"):
        """Chrome-trace complete-event span; a cheap no-op pass-through when
        span collection is off."""
        if not self.trace_enabled:
            yield
            return
        t0 = self.now()
        try:
            yield
        finally:
            self.spans.append((name, cat, tid, t0, self.now() - t0))

    # --------------------------------------------------------- device spans
    def _event(self):
        if self._spare:
            return self._spare.pop()
        import torch
        return torch.cuda.Event(enable_timing=True)

    def _mark(self, cuda: bool):
        if not cuda:
            return self.now()
        ev = self._event()
        ev.record()
        return ev

    def _new_anchor(self) -> None:
        ev = self._event()
        ev.record()
        self._anchor = (self.now(), ev)

    @contextmanager
    def device_span(self, name: str, device):
        """Time the device work enqueued inside the ``with`` block on
        ``device`` (category ``"device"``, tid ``"stream"``): on CUDA two
        timing events on the current stream; the span appears in
        :attr:`spans` at the first :meth:`resolve_device` after its work
        completed.  The caller enters it only when ``trace_enabled`` is
        set."""
        cuda = getattr(device, "type", str(device).split(":")[0]) == "cuda"
        if cuda and self._anchor is None:
            self._new_anchor()
        m0 = self._mark(cuda)
        yield
        self._pending.append((name, self._anchor if cuda else None, m0,
                              self._mark(cuda)))

    def resolve_device(self) -> None:
        """Call right after a host-device synchronisation: every pending
        device span whose end has completed becomes a span on
        :meth:`now`'s clock, and (on CUDA) a new anchor is recorded.
        Waits for nothing."""
        keep, spent = [], []
        for name, anchor, m0, m1 in self._pending:
            if anchor is None:                  # host-clock marks
                self.spans.append((name, "device", "stream", m0, m1 - m0))
                continue
            if not m1.query():
                keep.append((name, anchor, m0, m1))
                continue
            host, ev = anchor
            ts0 = host + round(ev.elapsed_time(m0) * 1e6)
            ts1 = host + round(ev.elapsed_time(m1) * 1e6)
            self.spans.append((name, "device", "stream", ts0, ts1 - ts0))
            spent += (m0, m1)
        self._pending = keep
        if self._anchor is not None:
            if not any(p[1] is self._anchor for p in keep):
                spent.append(self._anchor[1])
            self._new_anchor()
        self._spare += spent

    # ----------------------------------------------------------- consumers
    def poll_events(self) -> list[dict]:
        """LIVE ring consumer (bpftool ``map event_pipe`` style): drain and
        return every pending event mid-run, oldest first, as
        ``{"ts", "tag", "name", "a0", "a1", "a2"}`` dicts.

        Draining CONSUMES: polled events no longer appear in a later
        Chrome-trace export (the exporter peeks at whatever is still
        pending).  Callers that want both should export the trace first or
        accept the split.  Returns ``[]`` when telemetry is off.
        """
        if not self.enabled:
            return []
        return [{"ts": int(ts), "tag": int(tag), "name": tag_name(int(tag)),
                 "a0": int(a0), "a1": int(a1), "a2": int(a2)}
                for ts, tag, a0, a1, a2 in self.ring.drain()]

    # ------------------------------------------------------------- exports
    def snapshot(self) -> dict:
        hooks = {}
        for name, h in self.hook_invoke_ns.items():
            hooks[name] = {"invoke_ns": h.snapshot(),
                           "batch_size": self.hook_batch_size[name].snapshot()}
        ring = self.ring.snapshot()
        ring["prog_lane_drops"] = int(self.prog_lane_drops)
        return {
            "enabled": self.enabled,
            "ring": ring,
            "hooks": hooks,
            "migrate_path_ns": self.migrate_path_ns.snapshot(),
            "mgmt_step_ns": self.mgmt_step_ns.snapshot(),
            "request_ttft_ns": self.request_ttft_ns.snapshot(),
            "decode_token_ns": self.decode_token_ns.snapshot(),
            "counters": {**self.counters,
                         **{k: int(f()) for k, f in self.probes.items()}},
            "residency_block_ticks": {
                f"t{t}_o{o}": int(v)
                for (t, o), v in np.ndenumerate(self._residency) if v},
        }
