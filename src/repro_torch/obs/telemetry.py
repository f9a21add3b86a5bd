"""Telemetry hub: one object tying the event ring, the per-hook latency
histograms, plain counters and (optionally) Chrome-trace spans together.

Cost model: the hot paths guard every tracepoint with a single ``tel is
None or not tel.enabled`` check, so an engine built without telemetry (the
default) pays one attribute read + ``is None`` per candidate site and
allocates nothing.  A constructed-but-disabled hub (``enabled=False``) is
the benchmark's "attached, tracing off" lane — every site short-circuits
at the ``enabled`` flag.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np

from .hist import Log2Hist
from .ringbuf import EventRing, tag_name


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
        # drops at the PROGRAM layer: per-lane event slots exhausted inside
        # one invocation (distinct from ring overflow, which is host-side)
        self.prog_lane_drops = 0
        # per-(tier, order) residency in block-ticks, grown on demand
        self._residency = np.zeros((1, 1), np.int64)
        self.spans: list[tuple] = []        # (name, cat, tid, ts0_ns, dur_ns)
        self._t0 = time.perf_counter_ns()

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
            per = wall_ns // tokens
            for _ in range(tokens):
                self.decode_token_ns.observe(per)

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
            "counters": dict(self.counters),
            "residency_block_ticks": {
                f"t{t}_o{o}": int(v)
                for (t, o), v in np.ndenumerate(self._residency) if v},
        }
