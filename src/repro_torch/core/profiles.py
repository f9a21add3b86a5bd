"""Userspace application profiles.

The paper: "a profile consists of memory regions of interest and their
expected benefit from being backed by pages of 64KB, 2MB and 32MB".  Here an
"application" is a serving workload class (or a training buffer class); its
address space is measured in logical base blocks of its KV region.  Profiles
are produced offline by the profiler (:mod:`repro.core.damon` replay) and
loaded into an eBPF-style array map the fault program searches.

Map encoding (what the bytecode sees), REGION_STRIDE int64s per region:
    [start_block, end_block, benefit_o0, benefit_o1, benefit_o2, benefit_o3]
Benefits are modeled-ns-saved-per-access, FIXED_POINT-free (already ns).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from .context import NUM_ORDERS
from .maps import ArrayMap

REGION_STRIDE = 2 + NUM_ORDERS
MAX_PROFILE_REGIONS = 64   # keeps the verified search loop bounded


@dataclass
class ProfileRegion:
    start: int                      # logical block, inclusive
    end: int                        # logical block, exclusive
    benefit: tuple[float, ...]      # ns saved per access, per order

    def encode(self) -> list[int]:
        if len(self.benefit) != NUM_ORDERS:
            raise ValueError(f"benefit must have {NUM_ORDERS} entries")
        if not (0 <= self.start < self.end):
            raise ValueError(f"bad region [{self.start}, {self.end})")
        return [int(self.start), int(self.end)] + [int(b) for b in self.benefit]


@dataclass
class Profile:
    """Per-application profile, loadable into a map."""
    app: str
    regions: list[ProfileRegion] = field(default_factory=list)

    def __post_init__(self) -> None:
        if len(self.regions) > MAX_PROFILE_REGIONS:
            raise ValueError(
                f"profile {self.app!r}: {len(self.regions)} regions > "
                f"{MAX_PROFILE_REGIONS} (verifier loop bound)")
        srt = sorted(self.regions, key=lambda r: r.start)
        for a, b in zip(srt, srt[1:]):
            if a.end > b.start:
                raise ValueError(f"profile {self.app!r}: overlapping regions")
        self.regions = srt

    def encode(self) -> np.ndarray:
        flat: list[int] = []
        for r in self.regions:
            flat.extend(r.encode())
        return np.asarray(flat, dtype=np.int64)

    def load_into(self, m: ArrayMap) -> None:
        m.load(self.encode())

    def lookup(self, addr: int) -> ProfileRegion | None:
        for r in self.regions:
            if r.start <= addr < r.end:
                return r
        return None

    # ---- (de)serialization — the userspace framework's on-disk format ----
    def to_json(self) -> str:
        return json.dumps({
            "app": self.app,
            "regions": [
                {"start": r.start, "end": r.end, "benefit": list(r.benefit)}
                for r in self.regions
            ],
        }, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Profile":
        d = json.loads(s)
        return cls(app=d["app"], regions=[
            ProfileRegion(r["start"], r["end"], tuple(r["benefit"]))
            for r in d["regions"]
        ])


def profile_from_heat(app: str, heat_per_block: np.ndarray, hw, *,
                      hot_quantile: float = 0.7,
                      min_region_blocks: int = 4) -> Profile:
    """Offline profiling: turn a measured per-block heat trace into a profile.

    This is the DAMON-replay step of the paper's workflow: identify hot
    regions and precompute the expected per-access benefit of each page size
    for them (ns saved vs 4K-analogue backing, from the HW model).
    """
    heat = np.asarray(heat_per_block, dtype=np.float64)
    if heat.size == 0:
        return Profile(app, [])
    thresh = np.quantile(heat[heat > 0], hot_quantile) if (heat > 0).any() else np.inf
    hot = heat >= max(thresh, 1e-12)
    regions: list[ProfileRegion] = []
    i = 0
    n = heat.size
    while i < n:
        if not hot[i]:
            i += 1
            continue
        j = i
        while j < n and hot[j]:
            j += 1
        if j - i >= min_region_blocks:
            mean_heat = float(heat[i:j].mean())
            # a page larger than the hot region would back cold blocks too:
            # its benefit is zeroed so the fault program prefers the largest
            # page that still fits the region (cf. the paper only hinting
            # sizes whose reach matches the profiled region)
            benefit = tuple(
                hw.access_benefit_ns(order, mean_heat)
                if (4 ** order) <= (j - i) else 0
                for order in range(NUM_ORDERS))
            regions.append(ProfileRegion(i, j, benefit))
        i = j
    return Profile(app, regions[:MAX_PROFILE_REGIONS])
