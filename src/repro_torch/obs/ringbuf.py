"""BPF-style event ring buffer.

One fixed record shape for every producer — ``(ts, tag, a0, a1, a2)``,
five int64 words — so the ring is a preallocated ``[capacity, 5]`` numpy
array, not a list of heterogeneous objects.  Overflow follows
``bpf_ringbuf_reserve`` semantics: when the ring is full the *producer*
loses the event and a drop counter increments; nothing is overwritten
(consumers drain explicitly, as bpftool does).

Timestamp convention: events emitted by verified programs and by the
memory-manager tracepoints carry the MODELED clock (``ctx[KTIME_NS]`` /
``mm.ktime_ns``) so their streams are deterministic and bit-identical
across executors; host-side events (hook invocation wall time, compiles)
carry a wall-clock timestamp relative to telemetry start.  The trace
exporter keeps the two timelines on separate tracks.
"""

from __future__ import annotations

import numpy as np

EVENT_FIELDS = ("ts", "tag", "a0", "a1", "a2")

# Framework tracepoint tags (a0/a1/a2 payloads documented per site):
EV_FAULT = 1          # a0=pid, a1=addr, a2=order | hinted<<8
EV_MIGRATE_HOP = 2    # a0=(src_tier<<8)|dst_tier, a1=bytes, a2=modeled ns
EV_RECLAIM = 3        # a0=pid (victim / prefer, -1 none), a1=freed, a2=needed
EV_PREEMPT = 4        # a0=victim pid, a1=blocks freed
EV_HOOK = 5           # a0=hook index, a1=batch size, a2=wall ns
EV_COMPILE = 6        # a0=hook index, a1=1 predicated / -1 pc-walk fallback, a2=wall ns
EV_CACHE = 7          # a0=unroll hits, a1=misses | corrupt_misses<<24
                      # (miss-reason field), a2=disk hits (snapshot at build)
EV_COMPACT = 8        # a0=tier, a1=blocks moved, a2=modeled ns
EV_COLLAPSE = 9       # a0=pid, a1=addr, a2=order

# Resilience tracepoints (modeled-clock timestamps):
EV_DETACH = 10        # a0=hook index, a1=strikes, a2=detach reason
EV_QUARANTINE = 11    # a0=edge, a1=backoff window ns, a2=backoff level
EV_RETRY = 12         # a0=edge, a1=attempt, a2=backoff charged (modeled ns)
EV_READMIT = 13       # a0=edge, a1=errors so far, a2=successes so far

# Prefix-cache tracepoints (modeled-clock timestamps):
EV_CACHE_HIT = 14     # a0=pid, a1=blocks reused, a2=tokens skipped
EV_EVICT = 15         # a0=entry id, a1=blocks, a2=target tier | dropped<<8

# Online-profiling tracepoints (modeled-clock timestamps):
EV_PROFILE = 17       # a0=pid, a1=regions in synthesized profile, a2=version
EV_WSS = 18           # a0=pid, a1=WSS estimate (blocks), a2=mapped blocks

# Program-emitted tags: HELPER_TRACE lands on EV_PROG_TRACE (a0 = r1);
# bpf_ringbuf_output carries an arbitrary program tag in r1 — programs
# should use tags >= EV_PROG_BASE to stay clear of the framework range.
EV_PROG_TRACE = 16
EV_PROG_BASE = 32

# Well-known profiler program tags (mm_profile programs emit these through
# bpf_ringbuf_output; >= EV_PROG_BASE like every program tag).  Defined here
# rather than next to the programs so the exporters can key on them without
# importing the core package:
PROF_TAG_WSS = EV_PROG_BASE + 1       # a0=pid, a1=WSS contribution, a2=blocks
PROF_TAG_HEAT = EV_PROG_BASE + 2      # a0=pid, a1=log2 heat bucket, a2=blocks
PROF_TAG_BENEFIT = EV_PROG_BASE + 3   # a0=region start, a1=best order, a2=net ns

_TAG_NAMES = {
    EV_FAULT: "mm_fault", EV_MIGRATE_HOP: "migrate_hop",
    EV_RECLAIM: "reclaim", EV_PREEMPT: "preempt", EV_HOOK: "hook_invoke",
    EV_COMPILE: "compile", EV_CACHE: "cache", EV_COMPACT: "compact",
    EV_COLLAPSE: "collapse", EV_DETACH: "detach",
    EV_QUARANTINE: "quarantine", EV_RETRY: "migrate_retry",
    EV_READMIT: "readmit", EV_CACHE_HIT: "cache_hit", EV_EVICT: "evict",
    EV_PROG_TRACE: "prog_trace", EV_PROFILE: "profile_reload",
    EV_WSS: "wss_sample", PROF_TAG_WSS: "prof_wss",
    PROF_TAG_HEAT: "prof_heat", PROF_TAG_BENEFIT: "prof_benefit",
}


def tag_name(tag: int) -> str:
    return _TAG_NAMES.get(tag, f"prog_{tag}" if tag >= EV_PROG_BASE
                          else f"tag_{tag}")


class EventRing:
    """Preallocated typed event buffer with drop-on-overflow."""

    def __init__(self, capacity: int = 8192) -> None:
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = int(capacity)
        self.buf = np.zeros((self.capacity, len(EVENT_FIELDS)), np.int64)
        self._n = 0          # live (undrained) records
        self.emitted = 0     # lifetime successful pushes
        self.dropped = 0     # lifetime overflow drops

    def __len__(self) -> int:
        return self._n

    def push(self, ts: int, tag: int, a0: int = 0, a1: int = 0,
             a2: int = 0) -> bool:
        """Append one record; False (and a drop count) when full."""
        if self._n >= self.capacity:
            self.dropped += 1
            return False
        self.buf[self._n] = (ts, tag, a0, a1, a2)
        self._n += 1
        self.emitted += 1
        return True

    def peek(self) -> np.ndarray:
        """Live records (oldest first) WITHOUT consuming them."""
        return self.buf[:self._n]

    def drain(self) -> np.ndarray:
        """Consume and return all live records (oldest first)."""
        out = self.buf[:self._n].copy()
        self._n = 0
        return out

    def snapshot(self) -> dict:
        return {"capacity": self.capacity, "pending": self._n,
                "emitted": self.emitted, "dropped": self.dropped}
