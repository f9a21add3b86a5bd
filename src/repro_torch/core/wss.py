"""Online profile synthesis: the host side of the mm_profile plane.

The source paper builds its region/benefit profiles OFFLINE with DAMON and
loads them before the run.  The profiling plane closes that loop: a verified
profiler program (``core.programs.profile_wss_program`` and friends) runs on
the live DAMON region stream via the sampled ``HOOK_PROFILE`` surface, and
the :class:`ProfileSynthesizer` here folds its per-region observations into
profiles in the existing :mod:`repro_torch.core.profiles` format, hot-reloading
them into the attached fault/tier/evict policies mid-run — a run started
with NO profile converges to the placement an offline profiling run would
have produced.

Division of labor (mirrors the kernel/userspace split):
  * the PROGRAM classifies — per-region hot score through the batched,
    parity-pinned executors, observations out through bpf_ringbuf_output;
  * the SYNTHESIZER aggregates — merges region scans across the app's
    processes, runs the same hot-run/benefit arithmetic as the offline
    :func:`repro_torch.core.profiles.profile_from_heat`, and writes the result
    through ``mm.load_profile`` (a map WRITE, so attached programs keep
    their verified map ids).

Attribution: every reload emits ``EV_PROFILE`` and every scan emits
``EV_WSS`` on the modeled clock, the WSS curve is kept per process for
plotting, and :meth:`snapshot` exposes per-region gauges for the
Prometheus export.
"""

from __future__ import annotations

import json

import numpy as np

from ..obs.ringbuf import EV_PROFILE, EV_WSS
from .context import FIXED_POINT, NUM_ORDERS
from .profiles import MAX_PROFILE_REGIONS, Profile, ProfileRegion

# History cap per process for the WSS curve (one sample per profiler tick).
WSS_CURVE_CAP = 4096


class ProfileSynthesizer:
    """Drains ``HOOK_PROFILE`` scans into per-app profiles and hot-reloads.

    ``period`` rate-limits synthesis to every N-th :meth:`tick` call (the
    engine ticks once per step); ``max_regions`` caps synthesized profiles
    (keep it at the bound the attached fault program was verified with);
    ``hot_quantile`` / ``min_region_blocks`` are the thresholds the offline
    ``profile_from_heat`` uses, applied only to scan rows whose program
    score was POLICY_FALLBACK (the program's own hot/cold verdict wins
    otherwise).
    """

    def __init__(self, mm, hw, *, period: int = 4,
                 max_regions: int = MAX_PROFILE_REGIONS,
                 hot_quantile: float = 0.7, min_region_blocks: int = 4,
                 telemetry=None) -> None:
        self.mm = mm
        self.hw = hw
        self.period = max(1, int(period))
        self.max_regions = min(int(max_regions), MAX_PROFILE_REGIONS)
        self.hot_quantile = float(hot_quantile)
        self.min_region_blocks = int(min_region_blocks)
        self.telemetry = telemetry
        self.scans = 0                 # profile_scan calls that ran a program
        self.reloads = 0               # profiles hot-reloaded into the maps
        self.versions: dict[str, int] = {}     # app -> reload generation
        self.profiles: dict[str, Profile] = {}  # app -> last synthesized
        self.wss_blocks: dict[int, int] = {}    # pid -> latest WSS estimate
        self.wss_curve: dict[int, list[tuple[int, int, int]]] = {}
        self._ticks = 0

    # --------------------------------------------------------------- scanning
    def tick(self, active: list[tuple[int, str]]) -> list[str]:
        """One engine tick.  Every ``period`` ticks, runs the profiler scan
        over each active ``(pid, app)``, synthesizes per-app profiles from
        the merged region observations, and hot-reloads any profile whose
        regions changed.  Returns the list of apps reloaded this tick."""
        self._ticks += 1
        if self._ticks % self.period:
            return []
        per_app: dict[str, list[tuple[int, list[tuple]]]] = {}
        for pid, app in active:
            rows = self.mm.profile_scan(pid)
            if rows is None:           # program detached / never attached
                return []
            self.scans += 1
            self._note_wss(pid, rows)
            if app is not None:
                per_app.setdefault(app, []).append((pid, rows))
        reloaded = []
        for app, scans in per_app.items():
            prof = self._synthesize(app, scans)
            if prof is None:
                continue
            prev = self.profiles.get(app)
            if prev is not None and prev.regions == prof.regions:
                continue               # converged: nothing to reload
            self.mm.load_profile(prof)
            self.profiles[app] = prof
            self.versions[app] = self.versions.get(app, 0) + 1
            self.reloads += 1
            reloaded.append(app)
            tel = self.telemetry
            if tel is not None and tel.enabled:
                tel.emit(EV_PROFILE, scans[0][0], len(prof.regions),
                         self.versions[app], ts=self.mm.ktime_ns)
                tel.inc("profile_reloads")
        return reloaded

    def _note_wss(self, pid: int, rows: list[tuple]) -> None:
        """Fold one scan into the per-process WSS curve: a region counts
        toward the working set when the program scored it hot (score > 0),
        or — for FALLBACK rows — when it saw any access this window."""
        wss = 0
        for start, end, heat_milli, _age, score in rows:
            hot = score > 0 if score >= 0 else heat_milli > 0
            if hot:
                wss += end - start
        mapped = len(self.mm.procs[pid].mapped) if pid in self.mm.procs else 0
        self.wss_blocks[pid] = wss
        curve = self.wss_curve.setdefault(pid, [])
        if len(curve) < WSS_CURVE_CAP:
            curve.append((self.mm.ktime_ns, wss, mapped))
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.emit(EV_WSS, pid, wss, mapped, ts=self.mm.ktime_ns)
            tel.inc("profile_scans")

    # -------------------------------------------------------------- synthesis
    def _synthesize(self, app: str, scans: list[tuple[int, list[tuple]]]
                    ) -> Profile | None:
        """Merge region scans from every process of ``app`` into one dense
        per-block view and run the offline synthesis arithmetic over it.

        Merging takes the elementwise MAX across processes — the profile
        must serve the hottest use of each block any instance of the app
        exhibits (same convention as merging offline traces).  The program's
        per-region verdict drives the hot mask; rows it deferred
        (POLICY_FALLBACK) fall back to the ``hot_quantile`` threshold over
        raw heat, exactly like ``profile_from_heat``.
        """
        space = max((max(r[1] for r in rows)
                     for _pid, rows in scans if rows), default=0)
        if space == 0:
            return None
        heat = np.zeros(space, dtype=np.float64)
        verdict = np.full(space, -1, dtype=np.int64)   # -1 = program deferred
        for _pid, rows in scans:
            for start, end, heat_milli, _age, score in rows:
                end = min(end, space)
                if end <= start:
                    continue
                h = heat_milli / FIXED_POINT
                np.maximum(heat[start:end], h, out=heat[start:end])
                if score >= 0:
                    np.maximum(verdict[start:end], int(score > 0),
                               out=verdict[start:end])
        if (heat > 0).any():
            thresh = max(float(np.quantile(heat[heat > 0],
                                           self.hot_quantile)), 1e-12)
        else:
            thresh = np.inf
        hot = np.where(verdict >= 0, verdict > 0, heat >= thresh)
        regions: list[ProfileRegion] = []
        i = 0
        while i < space:
            if not hot[i]:
                i += 1
                continue
            j = i
            while j < space and hot[j]:
                j += 1
            if j - i >= self.min_region_blocks:
                mean_heat = float(heat[i:j].mean())
                benefit = tuple(
                    self.hw.access_benefit_ns(order, mean_heat)
                    if (4 ** order) <= (j - i) else 0
                    for order in range(NUM_ORDERS))
                regions.append(ProfileRegion(i, j, benefit))
            i = j
        return Profile(app, regions[:self.max_regions])

    # --------------------------------------------------------------- exports
    def snapshot(self) -> dict:
        """Numeric gauges for ``engine.metrics()`` / the Prometheus export:
        global scan/reload counters plus, per app, the reload generation and
        per-region start/end/benefit gauges (the attribution surface — each
        promotion the fault program makes traces back to exactly one of
        these regions)."""
        apps = {}
        for app, prof in self.profiles.items():
            apps[app] = {
                "version": self.versions.get(app, 0),
                "regions": len(prof.regions),
                "region_start": [r.start for r in prof.regions],
                "region_end": [r.end for r in prof.regions],
                "region_benefit_top": [int(max(r.benefit))
                                       for r in prof.regions],
            }
        return {
            "scans": self.scans,
            "reloads": self.reloads,
            "wss_blocks": {str(pid): int(w)
                           for pid, w in sorted(self.wss_blocks.items())},
            "apps": apps,
        }

    def wss_curve_doc(self) -> dict:
        """The WSS curve per process as a JSON-ready document — samples are
        ``(modeled ktime ns, WSS blocks, mapped blocks)`` per profiler
        tick; plot WSS/mapped over time to read convergence."""
        return {str(pid): [[int(t), int(w), int(m)] for t, w, m in curve]
                for pid, curve in sorted(self.wss_curve.items())}

    def write_wss_curve(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.wss_curve_doc(), f, indent=1)
