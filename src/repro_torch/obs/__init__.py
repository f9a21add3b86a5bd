"""Observability, ported subset: the BPF-style event ring and its tags.
Telemetry, histograms and the exporters are still to port (ROADMAP)."""

from .ringbuf import EVENT_FIELDS, EventRing, tag_name

__all__ = ["EVENT_FIELDS", "EventRing", "tag_name"]
