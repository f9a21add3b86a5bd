"""Seeded, deterministic fault injection.

The injector is the chaos half of the resilience layer: it decides, at
named sites threaded through the stack, whether this particular operation
fails.  Two properties are load-bearing:

* **Deterministic replay.**  Every decision is a pure function of
  ``(seed, site, key...)`` via a splitmix64-style stateless PRF — no wall
  time, no mutable RNG stream.  Two replicas that reach the same site with
  the same key (pid/addr/edge/modeled ktime/attempt) see the same fault,
  regardless of call ORDER, so the scalar and batched fault paths replay
  an identical failure schedule and the differential harness can assert
  bit-identical end state.
* **Zero cost when disarmed.**  A site with no configured rate returns
  ``False`` after one dict probe; an absent injector (``None``) costs a
  single ``is None`` check at each site.  The telemetry-overhead CI gate
  holds the disabled layer within 2% of baseline steps/s.

Sites:

========================  ====================================================
``SITE_MIGRATE_COPY``     one migration-hop copy attempt fails on an edge
``SITE_TIER_ALLOC``       a per-tier buddy allocation transiently fails
``SITE_LINK_FLAP``        a tier link (ICI/PCIe/NVMe) is down for a whole
                          modeled-time window — keyed on ``ktime // window``
                          so every attempt inside the window fails together
``SITE_HOOK_RUN``         a hook program invocation hits a runtime error
``SITE_CACHE_CORRUPT``    a pickled compiler artifact reads back corrupt
========================  ====================================================
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1

SITE_MIGRATE_COPY = "migrate_copy"
SITE_TIER_ALLOC = "tier_alloc"
SITE_LINK_FLAP = "link_flap"
SITE_HOOK_RUN = "hook_run"
SITE_CACHE_CORRUPT = "cache_corrupt"

SITES = (SITE_MIGRATE_COPY, SITE_TIER_ALLOC, SITE_LINK_FLAP,
         SITE_HOOK_RUN, SITE_CACHE_CORRUPT)
_SITE_ID = {s: i + 1 for i, s in enumerate(SITES)}

# Default modeled-time width of one link-flap outage window.  4 engine
# ticks at the default 1ms tick: a flap takes the link down long enough to
# exhaust a bounded retry and trip the health monitor's backoff.
FLAP_WINDOW_NS = 4_000_000


def _fold(word) -> int:
    """Map one key word (int or str) to a 64-bit lattice point.

    Strings fold byte-by-byte (NOT python ``hash()``, which is salted per
    process and would break cross-process replay)."""
    if isinstance(word, str):
        h = 0
        for b in word.encode():
            h = (h * 131 + b) & _MASK64
        return h
    return int(word) & _MASK64


def _mix(*words) -> int:
    """splitmix64-style stateless PRF over a tuple of 64-bit words."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h + w + 0x9E3779B97F4A7C15) & _MASK64
        h ^= h >> 30
        h = (h * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h


class FailureInjector:
    """Per-site seeded failure schedule with hit/check accounting.

    ``rates`` maps site name -> probability in [0, 1]; sites absent from
    the dict (or at rate 0) never fire and cost one dict probe per check.
    """

    def __init__(self, seed: int = 0, rates: dict | None = None, *,
                 flap_window_ns: int = FLAP_WINDOW_NS):
        unknown = set(rates or ()) - set(SITES)
        if unknown:
            raise ValueError(f"unknown failure sites: {sorted(unknown)}")
        self.seed = int(seed)
        self.rates = {s: float(r) for s, r in (rates or {}).items()
                      if float(r) > 0.0}
        self.flap_window_ns = int(flap_window_ns)
        self.checks = {s: 0 for s in SITES}
        self.fired = {s: 0 for s in SITES}

    @classmethod
    def uniform(cls, seed: int, rate: float,
                sites: tuple = SITES, **kw) -> "FailureInjector":
        """One rate across ``sites`` — the `--chaos SEED` convenience."""
        return cls(seed, {s: rate for s in sites}, **kw)

    @property
    def armed(self) -> bool:
        return bool(self.rates)

    def site_armed(self, site: str) -> bool:
        return site in self.rates

    def fires(self, site: str, *key) -> bool:
        """Does the operation identified by ``key`` fail at ``site``?

        Pure in (seed, site, key): re-asking with the same key gives the
        same answer (callers that must re-check — e.g. the batched fault
        discipline pass mirroring the scalar route — stay consistent).
        Check/fire counters are for reporting only.
        """
        rate = self.rates.get(site)
        if not rate:
            return False
        self.checks[site] += 1
        u = _mix(self.seed, _SITE_ID[site], *[_fold(w) for w in key])
        hit = u < rate * 2.0**64
        if hit:
            self.fired[site] += 1
        return hit

    def link_down(self, edge: int, now_ns: int) -> bool:
        """Is the tier link ``edge`` inside an injected outage window?

        Windowed on modeled time: every check within the same
        ``flap_window_ns`` window agrees, so a flap looks like a transient
        outage (repeated retry failures), not i.i.d. noise.
        """
        return self.fires(SITE_LINK_FLAP, edge, now_ns // self.flap_window_ns)

    def snapshot(self) -> dict:
        """Numeric-only accounting (safe for ``flatten_metrics``)."""
        out = {"seed": self.seed, "flap_window_ns": self.flap_window_ns}
        for s in SITES:
            out[s] = {"rate": self.rates.get(s, 0.0),
                      "checks": self.checks[s], "fired": self.fired[s]}
        return out
