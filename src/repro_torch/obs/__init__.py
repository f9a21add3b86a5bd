"""Low-overhead telemetry in the Linux BPF observability mold, ported.

Three layers, as in the reference package:

  * :mod:`ringbuf` — a preallocated, fixed-capacity, typed event ring
    (``bpf_ringbuf`` style: producers drop on overflow, a counter records
    how many) that both the framework tracepoints and verified programs
    (via the ``bpf_ringbuf_output`` helper) emit into;
  * :mod:`hist` — log2-bucketed histograms (bpftool-profile style) for
    latency/size distributions;
  * :mod:`telemetry` — the per-engine hub tying ring + histograms +
    counters + trace spans (host phases, and the device's own spans on the
    same clock) together, with :mod:`trace` (Chrome trace-event JSON,
    perfetto-loadable, and the device's idle time by host phase) and
    :mod:`metrics` (flat Prometheus-style snapshot) as exporters.

This package is numpy-only and imports nothing from :mod:`repro_torch.core`,
so the core pipeline can depend on it without cycles.
"""

from .hist import Log2Hist
from .metrics import flatten_metrics, render_prometheus
from .ringbuf import (EV_CACHE, EV_CACHE_HIT, EV_COLLAPSE, EV_COMPACT,
                      EV_COMPILE, EV_DETACH, EV_EVICT, EV_FAULT, EV_HOOK,
                      EV_MIGRATE_HOP, EV_PREEMPT, EV_PROFILE, EV_PROG_BASE,
                      EV_PROG_TRACE, EV_QUARANTINE, EV_READMIT, EV_RECLAIM,
                      EV_RETRY, EV_WSS, EVENT_FIELDS, PROF_TAG_BENEFIT,
                      PROF_TAG_HEAT, PROF_TAG_WSS, EventRing, tag_name)
from .telemetry import Telemetry
from .trace import (chrome_trace, idle_by_phase, idle_segments,
                    write_chrome_trace)

__all__ = [
    "EventRing", "EVENT_FIELDS", "tag_name",
    "EV_FAULT", "EV_MIGRATE_HOP", "EV_RECLAIM", "EV_PREEMPT", "EV_HOOK",
    "EV_COMPILE", "EV_CACHE", "EV_COMPACT", "EV_COLLAPSE",
    "EV_DETACH", "EV_QUARANTINE", "EV_RETRY", "EV_READMIT",
    "EV_CACHE_HIT", "EV_EVICT", "EV_PROFILE", "EV_WSS",
    "EV_PROG_TRACE", "EV_PROG_BASE",
    "PROF_TAG_WSS", "PROF_TAG_HEAT", "PROF_TAG_BENEFIT",
    "Log2Hist", "Telemetry",
    "chrome_trace", "write_chrome_trace", "idle_by_phase", "idle_segments",
    "flatten_metrics", "render_prometheus",
]
