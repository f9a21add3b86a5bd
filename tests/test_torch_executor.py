"""The port's batched policy executor against its interpreter and against
the reference's batched executors, bit for bit.

* Plan parity: for every program of ``programs.py`` (plus the 512/514-insn
  boundary programs), the port's unroll, cut points, scan stages and
  segments equal the reference's ``LIns`` tuples.
* Port parity: on seeded ctx batches, the port's ``PredicatedPolicy``
  (one span over the whole unroll), its pc-walking ``JitPolicy`` and the hook registry's
  bucketed ``run_batch`` at every batch size 1..64 give the decisions, ring
  events and drop counts of the port's ``PolicyVM``.
* Reference parity: the reference's ``PredicatedPolicy`` (every bucket
  4..64) and ``JitPolicy`` (bucket 64) give the same decisions and ring
  events on the same rows.
* Edge cases: the ALU at INT64_MIN / INT64_MAX / 0 / negative operands,
  the 512/514 segment boundary, and a program over ``MAX_UNROLLED``, which
  the registry routes to the fallback.

The reference's batched executors call ``jax.experimental.enable_x64``,
which jax 0.9.0 removed.  Each reference call here runs under
:func:`x64_shim`, which installs ``jax.enable_x64`` under the old name and
restores the module as it was afterwards.  It must never be installed at
module level: under ``pytest -n 6 --dist loadfile`` a leaked patch would
make the reference's own test files pass or fail depending on which files
share a worker.

The reference's XLA ALU body divides magnitudes with a floor divide, so
its DIV / MOD differ from its own interpreter when an operand is INT64_MIN
(``abs`` wraps).  The port follows the interpreter; the rows held against
the reference's XLA executors therefore stay in each column's real domain
(orders 0..3, tiers below NTIERS, ...), and the extreme rows are held to
the interpreters only.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import pytest

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

PKGS = ("repro", "repro_torch")
SEG_LIMIT = 512          # the reference's per-segment budget
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


@contextlib.contextmanager
def x64_shim():
    """Run reference batch executors on jax 0.9: alias the removed
    ``jax.experimental.enable_x64`` to ``jax.enable_x64`` for the duration
    of the block only."""
    import jax
    import jax.experimental as je
    had = hasattr(je, "enable_x64")
    old = getattr(je, "enable_x64", None)
    je.enable_x64 = jax.enable_x64
    try:
        yield
    finally:
        if had:
            je.enable_x64 = old
        else:
            del je.enable_x64


def core(pkg: str):
    return importlib.import_module(f"{pkg}.core")


def _boundary_program(c, pad: int):
    """Unrolls to exactly 512 + pad insns (test_batched_policy's guard)."""
    a = c.Asm()
    a.movi("r4", 0)
    a.movi("r3", 5)
    a.label("loop")
    for _ in range(100):
        a.addi("r4", 1)
    a.jnzdec("r3", "loop")
    for _ in range(pad):
        a.movi("r6", 0)
    a.ldctx("r5", c.CTX.ADDR)
    a.andi("r5", 3)
    a.add("r4", "r5")
    a.mov("r0", "r4")
    a.exit()
    return a.build(f"boundary_pad{pad}")


def _over_max_program(c):
    """A verified loop whose unroll exceeds MAX_UNROLLED (64 trips, the
    verifier's bound, of a 320-insn body): the registry must route it to
    the fallback."""
    a = c.Asm()
    a.ldctx("r4", c.CTX.ADDR)
    a.movi("r3", 64)
    a.label("loop")
    for i in range(160):
        a.addi("r4", i + 1)
        a.xori("r4", 0x5a5a)
    a.jnzdec("r3", "loop")
    a.mov("r0", "r4")
    a.andi("r0", 3)
    a.exit()
    return a.build("over_max_unrolled")


def _alu_edge_program(c):
    """Every ALU op, reg and imm forms, over ctx operands that the edge rows
    set to INT64_MIN / INT64_MAX / 0 / -1 / shift counts; the results are
    folded into r0 and emitted as ring events."""
    a = c.Asm()
    a.ldctx("r6", c.CTX.ADDR)
    a.ldctx("r7", c.CTX.PID)
    a.movi("r0", 0)
    for op in ("add", "sub", "mul", "div", "mod", "and_", "or_", "xor",
               "lsh", "rsh", "min_", "max_"):
        name = op.rstrip("_")
        for imm in (-7, 13, -1 if name in ("div", "mod") else 0):
            a.mov("r1", "r6")
            getattr(a, op)("r1", "r7")
            a.xor("r0", "r1")
            a.mov("r2", "r6")
            getattr(a, name + "i")("r2", imm)
            a.add("r0", "r2")
    a.mov("r1", "r6")
    a.neg("r1")
    a.xor("r0", "r1")
    a.mov("r1", "r0")
    a.call(c.HELPER_TRACE)
    a.exit()
    return a.build("alu_edges")


def _programs(c) -> dict:
    return {
        "ebpf_mm_r8": c.ebpf_mm_program(max_regions=8),
        "ebpf_mm_r64": c.ebpf_mm_program(max_regions=64),
        "ebpf_mm_r8_traced": c.ebpf_mm_program(max_regions=8, trace=True),
        "thp_always": c.thp_always_program(),
        "never": c.never_program(),
        "tier_damon": c.tier_damon_program(),
        "tier_lru": c.tier_lru_program(),
        "tier_never": c.tier_never_program(),
        "tier_heat_band": c.tier_heat_band_program(),
        "tier_edge_admission": c.tier_edge_admission_program(),
        "evict_lru": c.evict_lru_program(),
        "evict_lfu": c.evict_lfu_program(),
        "evict_ghost": c.evict_ghost_program(),
        "profile_wss": c.profile_wss_program(),
        "profile_heat_histogram": c.profile_heat_histogram_program(),
        "profile_benefit": c.profile_benefit_program(),
        "reclaim_lru": c.reclaim_lru_program(),
        "boundary_512": _boundary_program(c, 0),
        "boundary_514": _boundary_program(c, 2),
    }


PROGRAM_NAMES = list(_programs(core("repro_torch")))


def _maps(c):
    """One profile map (slot 0): 8 striped regions over 256 blocks for the
    Figure-1 program's indirect profile load."""
    maps = c.MapRegistry()
    m = c.ArrayMap(c.MAX_PROFILE_REGIONS * (2 + c.NUM_ORDERS))
    bounds = np.linspace(0, 256, 9).astype(int)
    c.Profile("app", [
        c.ProfileRegion(int(lo), int(hi),
                        (0, 150_000, 600_000, 0) if i % 2 == 0
                        else (0, 0, 0, 0))
        for i, (lo, hi) in enumerate(zip(bounds, bounds[1:]))]).load_into(m)
    maps.register(m)
    return maps


def ctx_rows(n: int, seed: int) -> np.ndarray:
    """Seeded ctx rows with every column in its real domain: fault, tier,
    evict and profile candidates alike (each program reads its own
    columns)."""
    from repro_torch.core.context import CTX, CTX_LEN
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 1000, (n, CTX_LEN)).astype(np.int64)
    ri = lambda lo, hi: rng.integers(lo, hi, n)         # noqa: E731
    m[:, CTX.ADDR] = ri(0, 256)
    m[:, CTX.PID] = ri(1, 9)
    m[:, CTX.VMA_START] = 0
    m[:, CTX.VMA_END] = ri(8, 257)
    m[:, CTX.FAULT_MAX_ORDER] = ri(0, 4)
    m[:, CTX.HAS_PROFILE] = ri(0, 2)
    m[:, CTX.PROFILE_MAP_ID] = 0
    m[:, CTX.PROFILE_NREGIONS] = ri(0, 9)
    for o in range(4):
        m[:, CTX.FREE_BLOCKS_O0 + o] = ri(0, 3) * ri(0, 200)
        m[:, CTX.HEAT_O0 + o] = ri(0, 5000)
    m[:, CTX.ZERO_NS_PER_BLOCK] = ri(100, 2000)
    m[:, CTX.COMPACT_NS_PER_BLOCK] = ri(100, 4000)
    m[:, CTX.DESCRIPTOR_NS] = 800
    m[:, CTX.BLOCK_BYTES] = 65536
    m[:, CTX.KTIME_NS] = ri(0, 10 ** 9)
    m[:, CTX.MEM_PRESSURE] = ri(0, 1001)
    m[:, CTX.FAULT_KIND] = ri(0, 3)
    m[:, CTX.SEQ_LEN] = ri(0, 1024)
    m[:, CTX.TIER_FREE_BLOCKS] = ri(0, 3) * ri(0, 256)
    m[:, CTX.PCIE_NS_PER_BLOCK] = ri(500, 4000)
    m[:, CTX.NTIERS] = ri(1, 5)
    m[:, CTX.PAGE_TIER] = ri(0, 4) % m[:, CTX.NTIERS]
    m[:, CTX.PAGE_ORDER] = ri(0, 4)
    m[:, CTX.PAGE_AGE] = ri(0, 10)
    m[:, CTX.PAGE_HEAT] = ri(0, 3) * ri(0, 6000)
    for t in range(4):
        m[:, CTX.TIER_FREE_T0 + t] = ri(0, 3) * ri(0, 256)
    setup = np.cumsum(ri(0, 5000)[:, None] * np.ones(4, np.int64), axis=1)
    per = np.cumsum(ri(100, 3000)[:, None] * np.ones(4, np.int64), axis=1)
    for t in range(4):
        m[:, CTX.MIG_CUM_SETUP_T0 + t] = setup[:, t] - setup[:, 0]
        m[:, CTX.MIG_CUM_NS_T0 + t] = per[:, t] - per[:, 0]
    m[:, CTX.BATCH_RESERVED] = ri(0, 16)
    m[:, CTX.CACHE_REFCOUNT] = ri(0, 3)
    m[:, CTX.CACHE_HITS] = ri(0, 5)
    m[:, CTX.CACHE_BLOCKS] = 1
    m[:, CTX.CACHE_GHOST_HITS] = ri(0, 40)
    m[:, CTX.CACHE_ENTRIES] = ri(1, 64)
    m[:, CTX.CACHE_CAP_BLOCKS] = ri(0, 16)
    m[:, CTX.CACHE_USED_BLOCKS] = ri(0, 32)
    m[:, CTX.PROF_REGION_START] = ri(0, 128)
    m[:, CTX.PROF_REGION_END] = m[:, CTX.PROF_REGION_START] + ri(1, 128)
    m[:, CTX.PROF_REGION_HEAT] = ri(0, 3) * ri(0, 3000)
    m[:, CTX.PROF_REGION_AGE] = ri(0, 20)
    m[:, CTX.PROF_MAPPED_BLOCKS] = ri(0, 256)
    return m


def edge_rows(seed: int) -> np.ndarray:
    """Rows of raw int64 extremes: every column drawn from INT64_MIN,
    INT64_MAX, 0, ±1, -7, small shift counts and wide random values —
    except the promotion-cost helper's calibrated constants (zeroing and
    compaction ns per block, fragmentation per order).  That helper
    multiplies before it divides: the interpreter does it on Python ints,
    every compiled executor (the reference's and the port's) on int64, so
    they part once the product passes 2^63, which calibrated constants
    never approach."""
    from repro_torch.core.context import CTX, CTX_LEN
    rng = np.random.default_rng(seed)
    pool = np.array([I64_MIN, I64_MIN + 1, I64_MAX, I64_MAX - 1, 0, 1, -1,
                     -7, 7, 63, 64, 65, -64, 1 << 40, -(1 << 40)],
                    dtype=np.int64)
    m = pool[rng.integers(0, len(pool), (16, CTX_LEN))]
    m[:4] = rng.integers(-(1 << 62), 1 << 62, (4, CTX_LEN))
    m[:, CTX.ZERO_NS_PER_BLOCK] = rng.integers(100, 2000, 16)
    m[:, CTX.COMPACT_NS_PER_BLOCK] = rng.integers(100, 4000, 16)
    for o in range(4):
        m[:, CTX.FRAG_O0 + o] = rng.integers(0, 1001, 16)
    return m


def _vm_results(c, prog, maps, mat):
    vm = c.PolicyVM(prog, maps)
    rets, events, drops = [], [], 0
    for row in mat:
        res = vm.run(row)
        rets.append(int(res.ret))
        events.extend(res.events)
        drops += res.dropped
    return np.asarray(rets, np.int64), events, drops


def _batch_results(backend, mat):
    out = np.asarray(backend.run_batch(mat))
    events, drops = backend.take_events(len(mat))
    return out, events, drops


def _check(got, want, what):
    out, events, drops = got
    w_out, w_events, w_drops = want
    np.testing.assert_array_equal(out, w_out, err_msg=f"{what}: decisions")
    assert list(events) == list(w_events), f"{what}: ring events"
    assert drops == w_drops, f"{what}: drops"


@pytest.mark.parametrize("name", PROGRAM_NAMES)
def test_plan_matches_reference(name):
    """Unroll, cut points, scan stages and segments equal the reference's."""
    plans = {}
    for pkg in PKGS:
        c = core(pkg)
        low = importlib.import_module(f"{pkg}.core.lower")
        maps = _maps(c)
        lp = low.lower(_programs(c)[name], maps)
        code, cuts = low.unroll_lowered(lp)
        stages, traced = low.plan_scan_stages(code, cuts)
        plans[pkg] = {
            "code": [(int(i.op), i.dst, i.src, i.imm, i.src2, i.target)
                     for i in code],
            "cuts": list(cuts), "stages": stages, "traced": traced,
            "segments": low.segment_code(code, cuts, SEG_LIMIT),
        }
    assert plans["repro_torch"] == plans["repro"]


@pytest.mark.parametrize("name", PROGRAM_NAMES + ["alu_edges"])
def test_port_executors_match_interpreter(name):
    """PredicatedPolicy, JitPolicy and the registry's bucketed run_batch at
    every batch size 1..64 == PolicyVM."""
    c = core("repro_torch")
    from repro_torch.core.hooks import HOOK_FAULT, HookRegistry
    from repro_torch.core.predicate import PredicatedPolicy
    maps = _maps(c)
    prog = (_alu_edge_program(c) if name == "alu_edges"
            else _programs(c)[name])
    mat = np.concatenate([ctx_rows(64, 7), edge_rows(8)])
    want = _vm_results(c, prog, maps, mat)
    _check(_batch_results(PredicatedPolicy(prog, maps, device="cpu"), mat),
           want, f"{name} predicated")
    _check(_batch_results(c.JitPolicy(prog, maps, device="cpu"), mat), want,
           f"{name} jit")
    reg = HookRegistry(device="cpu")
    reg.attach(HOOK_FAULT, prog, maps)
    for n in range(1, 65):
        out = reg.run_batch(HOOK_FAULT, mat[:n], discipline=False)
        np.testing.assert_array_equal(out, want[0][:n],
                                      err_msg=f"{name}: batch of {n}")
    assert reg.batch_calls[HOOK_FAULT] == 64
    assert reg.invocations[HOOK_FAULT] == 64 * 65 // 2


REF_BUCKETS = (4, 8, 16, 32, 64)     # the registry's pow2 batch shapes


@pytest.mark.parametrize("name", PROGRAM_NAMES)
def test_reference_executors_match_port(name):
    """The reference's PredicatedPolicy at every batch bucket 4..64 and its
    JitPolicy at bucket 64 (each shape is an XLA compile; the JIT's is the
    slow one), under the scoped shim == the port's PredicatedPolicy:
    decisions, ring events and drops.  Smaller batches pad to bucket 4 in
    both registries."""
    cp = core("repro_torch")
    mat = ctx_rows(64, 11)
    pm = _maps(cp)
    port = cp.PredicatedPolicy(_programs(cp)[name], pm, device="cpu")
    _check(_batch_results(port, mat),
           _vm_results(cp, _programs(cp)[name], pm, mat),
           f"{name} port vs its interpreter")
    want = {b: _batch_results(port, mat[:b]) for b in REF_BUCKETS}
    cr = core("repro")
    rm = _maps(cr)
    prog = _programs(cr)[name]
    with x64_shim():
        pred = cr.PredicatedPolicy(prog, rm)
        jit = cr.JitPolicy(prog, rm)
        got_pred = {b: _batch_results(pred, mat[:b]) for b in REF_BUCKETS}
        got_jit = {64: _batch_results(jit, mat)}
    for b, got in got_pred.items():
        _check(got, want[b], f"{name}: reference predicated, bucket {b}")
    for b, got in got_jit.items():
        _check(got, want[b], f"{name}: reference JIT, bucket {b}")


def test_segment_boundary_routing():
    """At exactly 512 unrolled insns the reference's plan is one segment,
    two insns over it two, both with the counting loop as one scan stage;
    the port plans both alike and its registry runs both on the predicated
    executor (one span: eager torch needs no segments), never on the
    fallback, with the interpreter's decisions."""
    c = core("repro_torch")
    from repro_torch.core.hooks import HOOK_FAULT, HookRegistry
    maps = c.MapRegistry()
    mat = ctx_rows(8, 12)
    for pad, segs in ((0, 1), (2, 2)):
        prog = _boundary_program(c, pad)
        code, cuts = c.unroll_lowered(c.lower(prog, maps))
        assert len(code) == SEG_LIMIT + pad
        assert len(c.segment_code(code, cuts, SEG_LIMIT)) == segs
        stages, _traced = c.plan_scan_stages(code, cuts)
        assert any(s[0] == "scan" for s in stages)
        reg = HookRegistry(device="cpu")
        reg.attach(HOOK_FAULT, prog, maps)
        out = reg.run_batch(HOOK_FAULT, mat)
        ap = reg._hooks[HOOK_FAULT]
        assert ap.pred is not None and ap.jit is None
        assert ap.pred.unrolled_len == SEG_LIMIT + pad
        vm = c.PolicyVM(prog, maps)
        assert list(out) == [vm.run(r).ret for r in mat]


def test_over_max_unrolled_takes_the_fallback():
    """A program whose unroll exceeds MAX_UNROLLED is unfit for the
    predicated executor; the registry runs it on the pc-walking fallback,
    with the interpreter's decisions, and notes the blowup."""
    c = core("repro_torch")
    from repro_torch.core.hooks import HOOK_TIER, HookRegistry
    maps = c.MapRegistry()
    prog = _over_max_program(c)
    with pytest.raises(ValueError, match="too long"):
        c.unroll_lowered(c.lower(prog, maps))
    reg = HookRegistry(device="cpu")
    reg.attach(HOOK_TIER, prog, maps)
    mat = np.concatenate([ctx_rows(5, 13), edge_rows(14)[:3]])
    out = reg.run_batch(HOOK_TIER, mat)
    ap = reg._hooks[HOOK_TIER]
    assert ap.pred_unfit and ap.pred is None and ap.jit is not None
    vm = c.PolicyVM(prog, maps)
    assert list(out) == [vm.run(r).ret for r in mat]
    with x64_shim():
        cr = core("repro")
        ref = cr.JitPolicy(_over_max_program(cr), cr.MapRegistry())
        np.testing.assert_array_equal(ref.run_batch(ctx_rows(5, 13)),
                                      out[:5])


def test_registry_device_defaults_to_cuda():
    """``device=None`` means CUDA: building the batch backend, or either
    executor on its own, raises on a machine without a GPU, naming the CPU
    option; the scalar route needs no device."""
    import torch
    c = core("repro_torch")
    from repro_torch.core.hooks import HOOK_FAULT, HookRegistry
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    reg = HookRegistry()
    maps = _maps(c)
    reg.attach(HOOK_FAULT, c.ebpf_mm_program(max_regions=8), maps)
    row = ctx_rows(1, 15)[0]
    assert reg.run(HOOK_FAULT, row) == c.PolicyVM(
        c.ebpf_mm_program(max_regions=8), maps).run(row).ret
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reg.warm(HOOK_FAULT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reg.run_batch(HOOK_FAULT, ctx_rows(2, 15))
    for executor in (c.PredicatedPolicy, c.JitPolicy):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            executor(c.ebpf_mm_program(max_regions=8), maps)
