"""Bounded array maps — the eBPF-map analogue.

The paper's userspace framework loads application profiles into eBPF maps
that the fault-hook program then searches.  We model maps as fixed-capacity
int64 arrays registered with the VM; lookups are bounds-clamped (a verified
program can therefore never fault on a map access, mirroring how the eBPF
verifier + helpers make map access safe).
"""

from __future__ import annotations

import numpy as np


class ArrayMap:
    """Fixed-capacity flat int64 array map."""

    def __init__(self, capacity: int, name: str = "map") -> None:
        if capacity <= 0:
            raise ValueError("map capacity must be positive")
        self.name = name
        self.capacity = int(capacity)
        self._data = np.zeros(self.capacity, dtype=np.int64)
        self._len = 0
        self.version = 0      # bumped on every userspace write

    def __len__(self) -> int:
        return self._len

    def load(self, values) -> None:
        values = np.asarray(values, dtype=np.int64).ravel()
        if values.size > self.capacity:
            raise ValueError(f"map {self.name}: {values.size} > capacity {self.capacity}")
        self._data[:] = 0
        self._data[:values.size] = values
        self._len = int(values.size)
        self.version += 1

    def lookup(self, idx: int) -> int:
        """Bounds-clamped lookup; out-of-range reads return 0 (missing key)."""
        if 0 <= idx < self._len:
            return int(self._data[idx])
        return 0

    def update(self, idx: int, value: int) -> None:
        if not 0 <= idx < self.capacity:
            raise IndexError(f"map {self.name}: index {idx} out of capacity")
        self._data[idx] = np.int64(value)
        self._len = max(self._len, idx + 1)
        self.version += 1

    def as_array(self) -> np.ndarray:
        return self._data.copy()

    def live_array(self) -> np.ndarray:
        """Zero-copy view for the jnp JIT path (padded to capacity)."""
        return self._data


class MapRegistry:
    """Numbered map table a program is verified and executed against.

    Map ids are stable for the registry's lifetime — programs are verified
    against them — so userspace RELOADS data into an existing map (found by
    name) rather than registering a fresh one; see
    :meth:`~repro.core.mm.MemoryManager.load_profile`.
    """

    def __init__(self) -> None:
        self._maps: list[ArrayMap] = []

    def register(self, m: ArrayMap) -> int:
        self._maps.append(m)
        return len(self._maps) - 1

    def find(self, name: str) -> int | None:
        """Map id of the map registered under ``name`` (None if absent)."""
        for i, m in enumerate(self._maps):
            if m.name == name:
                return i
        return None

    def __len__(self) -> int:
        return len(self._maps)

    def __getitem__(self, map_id: int) -> ArrayMap:
        return self._maps[map_id]

    def lens(self) -> list[int]:
        return [len(m) for m in self._maps]

    def version(self) -> tuple:
        """Registry-wide content version — lets executors cache device-side
        map arguments until userspace reloads a profile."""
        return (len(self._maps), tuple(m.version for m in self._maps))
