"""The port's policy pipeline and memory-management plane against the
reference, bit for bit.

* Every program the serving slice attaches (the Figure-1 fault program,
  its ring-emitting variant, the THP/never baselines as programs and the
  reclaim program) runs in the port's ``PolicyVM`` and in the reference's
  on the same seeded ctx rows: returns, step counts and ring events must be
  identical — including rows of extreme int64 values, where the ALU wraps.
* The seeded workload scripts of ``tests/test_differential.py`` replay
  through both packages' ``MemoryManager`` on the scalar fault route
  (``ensure_range`` / ``ensure_mapped``): page tables, block tables,
  ``MMStats`` and each step's ``drain_moves()`` must be identical.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from test_differential import VMA_MAX, make_script

PKGS = ("repro", "repro_torch")


def core(pkg: str):
    return importlib.import_module(f"{pkg}.core")


def _profile(c):
    return c.Profile("app", [
        c.ProfileRegion(0, 8, (0, 150_000, 600_000, 0)),
        c.ProfileRegion(8, VMA_MAX, (0, 0, 0, 0)),
    ])


PROGRAMS = {
    "ebpf_mm": lambda c: c.ebpf_mm_program(max_regions=8),
    "ebpf_mm_traced": lambda c: c.ebpf_mm_program(max_regions=8, trace=True),
    "thp_always": lambda c: c.thp_always_program(),
    "never": lambda c: c.never_program(),
    "reclaim_lru": lambda c: c.reclaim_lru_program(),
}


def _ctx_rows(c, n: int, seed: int) -> np.ndarray:
    """Seeded ctx rows: plausible fault contexts (profile hits and misses,
    every fault order, free/fragmentation/heat spread) plus rows of raw
    int64 values at the extremes, where the ALU wraps around."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        fc = c.FaultContext(
            addr=int(rng.integers(0, 64)), pid=int(rng.integers(1, 9)),
            vma_start=0, vma_end=int(rng.integers(8, 64)),
            fault_max_order=int(rng.integers(0, 4)),
            has_profile=int(rng.integers(0, 2)), profile_map_id=0,
            profile_nregions=int(rng.integers(0, 3)),
            free_blocks=tuple(int(x) for x in rng.integers(0, 200, 4)),
            frag=tuple(int(x) for x in rng.integers(0, 1000, 4)),
            heat=tuple(int(x) for x in rng.integers(0, 5000, 4)),
            zero_ns_per_block=int(rng.integers(100, 2000)),
            compact_ns_per_block=int(rng.integers(100, 4000)),
            descriptor_ns=800, block_bytes=65536,
            ktime_ns=int(rng.integers(0, 10**9)),
            mem_pressure=int(rng.integers(0, 1000)),
            fault_kind=int(rng.integers(0, 2)), seq_len=64)
        rows.append(fc.vector())
    for _ in range(n // 4):
        rows.append(rng.integers(-(2**62), 2**62, c.CTX_LEN, dtype=np.int64))
    return np.stack(rows)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_policy_vm_bit_identical(name):
    vms = {}
    for pkg in PKGS:
        c = core(pkg)
        mm = c.MemoryManager(64, c.make_cost_model(c.HWSpec(), 4, 64))
        mm.load_profile(_profile(c))
        vms[pkg] = c.PolicyVM(PROGRAMS[name](c), mm.maps)
    ref, port = vms["repro"], vms["repro_torch"]
    assert port.lowered.digest() == ref.lowered.digest()
    for i, row in enumerate(_ctx_rows(core("repro"), 64, seed=len(name))):
        a, b = ref.run(row), port.run(row)
        assert (b.ret, b.steps, b.trace, b.dropped) == \
            (a.ret, a.steps, a.trace, a.dropped), f"row {i}"
        assert [tuple(map(int, e)) for e in b.events] == \
            [tuple(map(int, e)) for e in a.events], f"row {i}"
    if name == "ebpf_mm_traced":
        assert ref.helper_state.rb_cap > 0


class Replay:
    """One package's MemoryManager driven by a differential script on the
    scalar fault route, with the harness's deterministic OOM relief."""

    def __init__(self, pkg: str):
        c = self.c = core(pkg)
        self.mm = c.MemoryManager(
            96, c.make_cost_model(c.HWSpec(), kv_heads=4, head_dim=64),
            default_mode="thp")
        self.mm.load_profile(_profile(c))
        self.mm.attach_fault_program(c.ebpf_mm_program(max_regions=8))
        self.vma: dict[int, int] = {}

    def _relieve(self, need: int) -> None:
        mm = self.mm
        victim = max(mm.procs, key=lambda p: (len(mm.procs[p].page_table), -p))
        st = mm.procs[victim]
        freed = 0
        for lg in sorted(st.page_table, reverse=True):
            if freed >= need:
                break
            freed += self.c.order_blocks(st.page_table[lg].order)
            mm.unmap(victim, lg)

    def _with_relief(self, fn, need: int) -> None:
        for _ in range(12):
            try:
                fn()
                return
            except self.c.MMOutOfMemory:
                self._relieve(need)
        raise AssertionError("workload does not fit")

    def step(self, s) -> dict:
        mm = self.mm
        for pid in s.completes:
            if pid in self.vma:
                mm.free_process(pid)
                del self.vma[pid]
        for pid, vma, prompt in s.admits:
            mm.create_process(pid, app="app", vma_blocks=vma)
            self.vma[pid] = vma
            self._with_relief(lambda: mm.ensure_range(pid, 0, prompt), prompt)
        reqs = []
        for pid in s.decodes:
            if pid not in self.vma:
                continue
            st = mm.procs[pid]
            free = [a for a in range(st.vma_end) if a not in st.mapped]
            if free:
                reqs.append((pid, free[0]))

        def scalar():
            for pid, addr in reqs:
                mm.ensure_mapped(pid, addr, self.c.FaultKind.FIRST_TOUCH)
        if reqs:
            self._with_relief(scalar, len(reqs))
        for pid, heat in s.heats.items():
            if pid in self.vma:
                mm.record_access(pid, heat)
        for pid, addr, order in s.collapses:
            if pid in self.vma and addr < self.vma[pid]:
                mm.collapse(pid, addr, order)
        mm.tick()
        return {
            "moves": [tuple(map(int, m)) for m in mm.drain_moves()],
            "stats": mm.stats.snapshot(),
            "tables": {pid: sorted((m.logical_start, m.phys_start, m.order)
                                   for m in st.page_table.values())
                       for pid, st in mm.procs.items()},
            "block_tables": {pid: mm.block_table(pid, VMA_MAX).tolist()
                             for pid in mm.procs},
            "versions": {pid: mm.table_version(pid) for pid in mm.procs},
            "hooks": dict(mm.hooks.invocations),
        }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mm_plane_bit_identical_on_differential_scripts(seed):
    ref, port = Replay("repro"), Replay("repro_torch")
    for i, s in enumerate(make_script(seed)):
        a, b = ref.step(s), port.step(s)
        for key in a:
            assert b[key] == a[key], f"seed {seed} step {i}: {key} diverged"
