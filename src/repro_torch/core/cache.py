"""Cross-session artifact cache for the policy pipeline's unroll.

Building a batch executor flattens every verifier-bounded loop of the
lowered program (the 64-region Figure-1 flattening alone walks ~900
lowered insns).  That work depends only on the program bytes and the
map-shape contract, so the ``(code, cuts)`` unroll artifacts are pickled
per :meth:`LoweredProgram.digest` — a key covering the instruction stream,
the map-registry shape contract (slot count + capacities), the ctx layout
width (``CTX_LEN``) and the IR version — and read back in later sessions.

The reference's cache also points jax's persistent compilation cache at
``<root>/xla`` (``enable_xla_cache``), which keeps one compiled executable
per program and batch bucket.  The port needs no counterpart: on the card
every program and bucket runs on one generic kernel
(``csrc/policy_exec.cu``, which interprets the packed code), built once
per source hash by ``kernels/build.py`` into ``build/kernels/<hash>/``, so
nothing is compiled per program for such a cache to keep.

The port keeps its pickles in a directory of its own, ``<root>/ebpf_torch``.
Its digests are built like the reference's, and the reference writes
``<root>/ebpf/unroll-<digest>.pkl``: a reference pickle holds the
reference's ``LIns`` objects, which would import the JAX package on
unpickling, so the port never looks there.

Environment: ``REPRO_CACHE_DIR`` overrides the root (default ``.cache`` in
the working directory); ``REPRO_CACHE_DIR=0`` (or ``off``) disables disk
persistence entirely — everything still works, just cold every session.
``REPRO_CACHE_MAX_BYTES`` caps the on-disk artifact directory: when a write
pushes the total over the cap, the least-recently-USED pickles (read hits
refresh mtime) are evicted oldest-first until it fits.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from pathlib import Path

from .lower import LoweredProgram, unroll_lowered

_DISABLED = ("0", "off", "none", "")

# the port's artifact directory under the cache root (the reference's is
# "ebpf"; see the module docstring)
SUBDIR = "ebpf_torch"

# Default on-disk artifact budget — far above a normal session's handful of
# unroll pickles, small enough that a long-lived cache can't grow without
# bound across program-shape churn.
DEFAULT_MAX_BYTES = 256 * 1024 * 1024


class ArtifactCache:
    """Two-level (in-process dict, on-disk pickle) cache for unrolled
    program artifacts.  On-disk entries are LRU-evicted by last-used time
    under a size cap."""

    def __init__(self, root: str | os.PathLike | None = None,
                 max_bytes: int | None = None) -> None:
        if root is None:
            env = os.environ.get("REPRO_CACHE_DIR")
            if env is not None and env.lower() in _DISABLED:
                root = None
            else:
                root = env or ".cache"
        if max_bytes is None:
            max_bytes = int(os.environ.get("REPRO_CACHE_MAX_BYTES",
                                           DEFAULT_MAX_BYTES))
        self.root = Path(root) if root else None
        self.max_bytes = max_bytes
        self._unrolled: dict[str, tuple] = {}   # in-proc, by program digest
        # miss_absent/miss_corrupt split unroll_misses by reason: nothing on
        # disk vs an artifact that was there but failed to load back.
        self.stats = {"unroll_disk_hits": 0, "unroll_hits": 0,
                      "unroll_misses": 0, "miss_absent": 0,
                      "miss_corrupt": 0, "evictions": 0}

    @property
    def enabled(self) -> bool:
        return self.root is not None

    @property
    def dir(self) -> Path | None:
        """Where this cache's pickles live (None with persistence off)."""
        return None if self.root is None else self.root / SUBDIR

    # ------------------------------------------------------------ lowering
    def unrolled(self, lp: LoweredProgram, injector=None) -> tuple:
        """``(code, cuts)`` for ``lp`` — memoized in-process and persisted
        on disk keyed by the program digest.  Raises ``ValueError`` (not
        cached) when the flattened form exceeds the pipeline limit.

        A corrupt/truncated on-disk artifact NEVER raises out of here — it
        counts a ``miss_corrupt`` and recompiles (the rewrite heals the
        entry).  ``injector`` (a resilience FailureInjector) can force the
        corrupt path on an otherwise-good disk hit, keyed on the digest so
        the schedule replays.
        """
        key = lp.digest()
        hit = self._unrolled.get(key)
        if hit is not None:
            self.stats["unroll_hits"] += 1
            return hit
        art, miss_reason = self._read(f"unroll-{key}")
        if art is not None and injector is not None and injector.fires(
                "cache_corrupt", key):
            art, miss_reason = None, "corrupt"
        if art is not None:
            self.stats["unroll_hits"] += 1
            self.stats["unroll_disk_hits"] += 1
            self._unrolled[key] = art
            return art
        self.stats["unroll_misses"] += 1
        self.stats[f"miss_{miss_reason}"] += 1
        art = unroll_lowered(lp)
        self._unrolled[key] = art
        self._write(f"unroll-{key}", art)
        return art

    # ---------------------------------------------------------------- disk
    def _path(self, name: str) -> Path:
        return self.dir / f"{name}.pkl"

    def _read(self, name: str):
        """``(artifact, miss_reason)``: ``(obj, None)`` on a hit,
        ``(None, "absent")`` when nothing is on disk (or persistence is
        off), ``(None, "corrupt")`` when a pickle exists but cannot be
        loaded back — truncated/garbled/stale artifacts recompile, they
        never propagate an exception into engine construction."""
        if not self.enabled:
            return None, "absent"
        path = self._path(name)
        try:
            with open(path, "rb") as f:
                obj = pickle.load(f)
            os.utime(path)          # LRU: a read hit refreshes last-used
            return obj, None
        except FileNotFoundError:
            return None, "absent"
        except Exception:
            return None, "corrupt"

    def _write(self, name: str, obj) -> None:
        if not self.enabled:
            return
        try:
            path = self._path(name)
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                pickle.dump(obj, f)
            os.replace(tmp, path)   # atomic: readers never see partials
            self._evict_lru(keep=path)
        except OSError:             # read-only fs etc: stay in-memory only
            pass

    def _evict_lru(self, keep: Path | None = None) -> None:
        """Drop the oldest-used artifact pickles until the directory fits
        ``max_bytes``.  The just-written entry is exempt so a single
        oversized artifact does not evict itself into a write loop."""
        if not self.enabled or self.max_bytes <= 0:
            return
        try:
            entries = []
            for p in self.dir.glob("*.pkl"):
                st = p.stat()
                entries.append((st.st_mtime, st.st_size, p))
        except OSError:
            return
        total = sum(size for _, size, _ in entries)
        entries.sort()              # oldest last-used first
        for _, size, p in entries:
            if total <= self.max_bytes:
                break
            if keep is not None and p == keep:
                continue
            try:
                p.unlink()
            except OSError:
                continue
            total -= size
            self.stats["evictions"] += 1


# The port's process-wide default instance: every HookRegistry uses it
# unless handed a private one.
artifact_cache = ArtifactCache()
