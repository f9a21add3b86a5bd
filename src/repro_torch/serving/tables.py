"""Device-resident block tables: the decode step's management plane on-device.

Before this module the engine re-captured a fresh ``[B, max_blocks]`` block
table from :meth:`MemoryManager.block_table` every step for every occupied
slot — O(B * max_blocks) host work plus a full-table host->device upload per
dispatch, despite the tables being maintained INCREMENTALLY on host
and changing only when a fault installs, compaction/migration moves, or an
unmap clears a span.

:class:`DeviceBlockTables` keeps the authoritative decode-time table as a
persistent device buffer and uploads only DIRTY ROWS.  Staleness is decided
by the per-process ``table_version`` generation counter
(:meth:`MemoryManager.table_version`), which ``core.mm`` bumps on every span
write or unmap — including tier-migration re-placements via ``_note_mapped``
— so a same-step migration can never publish a stale device row: the move
bumps the version, the row re-uploads before the decode dispatch.

The sync does NOT touch the device buffer itself; it returns the dirty row
indices/payloads for the engine to fold into its fused (table-install +
decode) jit entry, so the whole step stays one dispatch.  Rows of freed
slots are re-blanked to ``-1`` and the slot's active bit drops — the
explicit active-row mask is what makes a PERSISTENT table safe: a vacated
slot's old row otherwise still holds live-looking physical indices (the
scatter-to-block-0 bug class, one level up).

Dirty rows are additionally DELTA-ENCODED: the common steady-state change
is append-only (a fault maps one new block; every changed cell was ``-1``
in the mirror), which ships as ``(row, col, value)`` int32 triples — a
handful of cells instead of a ``max_blocks``-wide row.  Rows whose change
rewrites live cells (slot blanking, compaction/migration remaps, slot
reuse without an intervening blank sync) fall back to the full-row path;
the mirror comparison decides per row, so the device buffer always matches
the mirror bit-for-bit either way.
"""

from __future__ import annotations

import numpy as np


class DeviceBlockTables:
    """Host mirror + dirty-row change tracking for a ``[B, max_blocks]``
    device-resident block-table buffer owned by the serving engine.

    The engine calls :meth:`sync` once per decode step with the current
    slot->pid assignment; the returned ``(dirty_idx, dirty_rows, active,
    triples)`` feed the fused decode dispatch.  ``uploads``/``synced_rows``
    count the dirty-row traffic for the bench's crossings-per-step lane;
    ``delta_rows``/``delta_cells`` count the rows that shipped as triples
    and how many cells they carried."""

    def __init__(self, batch_size: int, max_blocks: int) -> None:
        self.B = batch_size
        self.MB = max_blocks
        self.host = np.full((batch_size, max_blocks), -1, dtype=np.int32)
        # (pid, table_version) recorded at last upload, per slot; None for
        # a slot whose device row is blank (-1s)
        self._slot_key: list[tuple[int, int] | None] = [None] * batch_size
        self.syncs = 0          # sync() calls
        self.synced_rows = 0    # dirty rows shipped (full + delta)
        self.blank_rows = 0     # rows re-blanked on slot free
        self.full_rows = 0      # dirty rows that shipped full-width
        self.delta_rows = 0     # dirty rows that shipped as triples
        self.delta_cells = 0    # total (row, col, value) triples shipped

    def sync(self, mm, slot_pids) -> tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
        """Refresh the host mirror against ``mm`` for ``slot_pids`` (a
        length-B sequence of pid or ``None`` for an empty slot).

        Returns ``(dirty_idx int32[K], dirty_rows int32[K, MB], active
        bool[B], triples int32[T, 3])`` — K == T == 0 when nothing
        changed.  Append-only row changes (every rewritten cell was ``-1``
        in the mirror — the fault-installs-a-new-block steady state) ship
        as ``(row, col, value)`` triples; rows that blank or rewrite live
        cells (slot free, migration/compaction remap, slot reuse) ship
        full-width.  The caller scatters both into its persistent device
        buffer (inside the fused decode dispatch) and must treat
        ``active`` as authoritative: rows of inactive slots may still hold
        stale physical indices on device until their next reuse."""
        dirty: list[int] = []
        triples: list[np.ndarray] = []
        active = np.zeros(self.B, dtype=bool)
        for slot, pid in enumerate(slot_pids):
            if pid is None:
                if self._slot_key[slot] is not None:
                    self._slot_key[slot] = None
                    self.host[slot, :] = -1
                    self.blank_rows += 1
                    self.full_rows += 1
                    dirty.append(slot)
                continue
            active[slot] = True
            key = (pid, mm.table_version(pid))
            if self._slot_key[slot] != key:
                new = np.asarray(mm.block_table(pid, self.MB), np.int32)
                old = self.host[slot]
                changed = np.nonzero(new != old)[0]
                if changed.size and np.all(old[changed] == -1):
                    t = np.empty((changed.size, 3), np.int32)
                    t[:, 0] = slot
                    t[:, 1] = changed
                    t[:, 2] = new[changed]
                    triples.append(t)
                    self.delta_rows += 1
                    self.delta_cells += changed.size
                elif changed.size:
                    dirty.append(slot)
                    self.full_rows += 1
                self.host[slot, :] = new
                self._slot_key[slot] = key
        self.syncs += 1
        self.synced_rows += len(dirty) + len(triples)
        idx = np.asarray(dirty, dtype=np.int32)
        tri = (np.concatenate(triples, axis=0) if triples
               else np.empty((0, 3), np.int32))
        return idx, self.host[idx], active, tri
