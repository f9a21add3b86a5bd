"""The policy-program kernel's table and its plain version, on the CPU.

``repro_torch.kernels.policy_exec`` runs a lowered, verified program over
a fault batch in one launch of ``csrc/policy_exec.cu`` on the card; on CPU
tensors :func:`policy_exec` runs :func:`policy_exec_plain`, the same pc
walk over the same packed table.  Held here, bit for bit:

* ``pack_code`` round-trips the unrolled (predicated route) and the
  looped (JIT route) code of every program of ``test_torch_executor``,
  ``alu_edges`` and ``over_max_unrolled`` (looped only: its unroll is over
  ``MAX_UNROLLED``);
* the plain version over the packed table gives ``PolicyVM``'s decisions,
  ring events and drops on 64 seeded rows plus the int64 edge rows, on
  both routes' code, and the reference's ``PredicatedPolicy`` at bucket 64
  for three programs (under the scoped ``x64_shim``);
* a ring buffer that overflows counts its drops; a lane the fuel stops
  returns its r0 register on the JIT route and 0 on the predicated one,
  as the eager executors do;
* the kernel source's constants (ctx offsets, opcodes, helper ids) equal
  their Python definitions: the kernel itself runs only on the card
  (``tests/test_torch_gpu.py``).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_executor as tx
from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.core.lower import collect_rb_events
from repro_torch.kernels.policy_exec import ops as pe

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
        / "policy_exec.cu")
NAMES = tx.PROGRAM_NAMES + ["alu_edges"]
OVER_MAX = "over_max_unrolled"


def program(c, name):
    if name == "alu_edges":
        return tx._alu_edge_program(c)
    if name == OVER_MAX:
        return tx._over_max_program(c)
    return tx._programs(c)[name]


def route_code(c, prog, maps, route):
    """(code, fuel, halt_returns_r0, rb_cap) of a route, as the executors
    set them."""
    lp = c.lower(prog, maps)
    cap = int(lp.facts.get("rb_cap", 0))
    if route == "jit":
        return lp.insns, lp.facts["max_steps"] + 8, True, cap
    code = c.unroll_lowered(lp)[0]
    return code, len(code), False, cap


def run_plain(code, mat, maps, *, fuel, halt, cap):
    flat, meta = pe.DeviceMaps(maps, torch.device("cpu")).flat()
    out = pe.policy_exec(pe.pack_code(code), torch.from_numpy(mat), flat,
                         meta, rb_cap=cap, fuel=fuel, halt_returns_r0=halt)
    assert out.shape == (len(mat), 3 + 5 * cap) and out.dtype == torch.int64
    r0, ev, cnt, drops = pe.split_out(out, cap)
    for lane in range(len(mat)):          # slots past the count stay zero
        assert not ev[lane, int(cnt[lane]):].any()
    return (r0.numpy(), *collect_rb_events(ev, cnt, drops, len(mat)))


@pytest.mark.parametrize("name", NAMES + [OVER_MAX])
def test_pack_code_round_trips(name):
    """Unrolled and looped code -> table -> the same ``LIns`` tuple; one
    32-byte row an instruction."""
    c = tx.core("repro_torch")
    maps = tx._maps(c)
    lp = c.lower(program(c, name), maps)
    codes = [lp.insns]
    if name == OVER_MAX:
        with pytest.raises(ValueError, match="too long"):
            c.unroll_lowered(lp)
    else:
        codes.append(c.unroll_lowered(lp)[0])
    for code in codes:
        table = pe.pack_code(code)
        assert table.shape == (len(code), 4) and table.dtype == torch.int64
        assert table.numel() * 8 == 32 * len(code)
        assert pe.unpack_code(table) == tuple(code)


@pytest.mark.parametrize("route", ["pred", "jit"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_interpreter(name, route):
    """The plain version over the packed table == PolicyVM: decisions,
    ring events and drops, 64 seeded rows plus the edge rows."""
    c = tx.core("repro_torch")
    maps = tx._maps(c)
    prog = program(c, name)
    mat = np.concatenate([tx.ctx_rows(64, 7), tx.edge_rows(8)])
    code, fuel, halt, cap = route_code(c, prog, maps, route)
    tx._check(run_plain(code, mat, maps, fuel=fuel, halt=halt, cap=cap),
              tx._vm_results(c, prog, maps, mat), f"{name} {route}")


def test_plain_runs_over_max_unrolled_on_the_jit_route():
    """The looped code of a program the predicated route cannot unroll:
    the plain walk runs its 64-trip loop per lane."""
    c = tx.core("repro_torch")
    maps = c.MapRegistry()
    prog = program(c, OVER_MAX)
    mat = np.concatenate([tx.ctx_rows(5, 13), tx.edge_rows(14)[:3]])
    code, fuel, halt, cap = route_code(c, prog, maps, "jit")
    tx._check(run_plain(code, mat, maps, fuel=fuel, halt=halt, cap=cap),
              tx._vm_results(c, prog, maps, mat), OVER_MAX)


@pytest.mark.parametrize("name", ["ebpf_mm_r8_traced", "tier_damon",
                                  "alu_edges"])
def test_plain_matches_reference_predicated(name):
    """The plain version over the unroll == the reference's
    PredicatedPolicy at bucket 64 (rows in each column's real domain: the
    reference's XLA DIV / MOD part from its interpreter at INT64_MIN)."""
    cp, cr = tx.core("repro_torch"), tx.core("repro")
    mat = tx.ctx_rows(64, 11)
    pm = tx._maps(cp)
    code, fuel, halt, cap = route_code(cp, program(cp, name), pm, "pred")
    got = run_plain(code, mat, pm, fuel=fuel, halt=halt, cap=cap)
    with tx.x64_shim():
        ref = cr.PredicatedPolicy(program(cr, name), tx._maps(cr))
        want = tx._batch_results(ref, mat)
    tx._check(got, want, f"{name}: reference predicated, bucket 64")


def _long_program(c, trips: int, body: int):
    """A counting loop whose unroll is about ``trips x (2 body + 1)``
    insns: at 30 x 50 (3,035 insns, 95 KB) the kernel stages its table in
    shared memory above the 48 KB default, at 64 x 55 (7,109 insns, 222
    KB, over its 200 KB stage) it reads the table from global memory."""
    a = c.Asm()
    a.ldctx("r4", c.CTX.ADDR)
    a.movi("r3", trips)
    a.label("loop")
    for i in range(body):
        a.addi("r4", i + 1)
        a.xori("r4", 0x5a5a)
    a.jnzdec("r3", "loop")
    a.mov("r0", "r4")
    a.andi("r0", 3)
    a.exit()
    return a.build(f"long_{trips}x{body}")


LONG = {"long_3k": (30, 50), "long_7k": (64, 55)}


@pytest.mark.parametrize("name", list(LONG))
def test_plain_runs_long_unrolls(name):
    """The unrolls that take the kernel's two other table paths (opt-in
    shared memory, global memory): the plain walk == PolicyVM on both
    routes."""
    c = tx.core("repro_torch")
    maps = c.MapRegistry()
    prog = _long_program(c, *LONG[name])
    mat = np.concatenate([tx.ctx_rows(3, 27), tx.edge_rows(28)[:3]])
    want = tx._vm_results(c, prog, maps, mat)
    for route in ("pred", "jit"):
        code, fuel, halt, cap = route_code(c, prog, maps, route)
        tx._check(run_plain(code, mat, maps, fuel=fuel, halt=halt, cap=cap),
                  want, f"{name} {route}")


def _overflow_program(c):
    """Two emissions per trip of a 64-trip loop: 128 against the 64-slot
    per-run clamp, so every lane drops 64."""
    a = c.Asm()
    a.ldctx("r6", c.CTX.ADDR)
    a.movi("r3", 64)
    a.label("loop")
    a.movi("r1", 7)
    a.mov("r2", "r6")
    a.mov("r4", "r3")
    a.call(c.HELPER_RINGBUF_OUTPUT)
    a.mov("r1", "r3")
    a.call(c.HELPER_TRACE)
    a.jnzdec("r3", "loop")
    a.mov("r0", "r6")
    a.andi("r0", 3)
    a.exit()
    return a.build("ring_overflow")


@pytest.mark.parametrize("route", ["pred", "jit"])
def test_plain_counts_ring_overflow(route):
    c = tx.core("repro_torch")
    maps = c.MapRegistry()
    prog = _overflow_program(c)
    mat = tx.ctx_rows(6, 17)
    code, fuel, halt, cap = route_code(c, prog, maps, route)
    assert cap == 64
    got = run_plain(code, mat, maps, fuel=fuel, halt=halt, cap=cap)
    want = tx._vm_results(c, prog, maps, mat)
    assert want[2] == 6 * 64
    tx._check(got, want, f"overflow {route}")


def test_fuel_and_lanes_that_never_exit():
    """A lane the fuel stops returns its r0 register on the JIT route
    (``JitPolicy``'s walk) and 0 on the predicated route (``_Machine``),
    as the flag says."""
    c = tx.core("repro_torch")
    from repro_torch.core.lower import LIns
    maps = tx._maps(c)
    prog = tx._programs(c)["ebpf_mm_r8"]
    mat = tx.ctx_rows(16, 19)
    jit = c.JitPolicy(prog, maps, device="cpu")
    for fuel in (3, 9, 40):
        jit._fuel = fuel
        want = jit.run_batch(mat)
        got = run_plain(jit.lowered.insns, mat, maps, fuel=fuel, halt=True,
                        cap=0)
        np.testing.assert_array_equal(got[0], want, err_msg=f"fuel {fuel}")
    no_exit = (LIns(c.Op.LDCTX, 0, imm=c.CTX.ADDR), LIns(c.Op.ADDI, 0, imm=5))
    pred = c.PredicatedPolicy(prog, maps, code=no_exit, device="cpu")
    assert not pred.run_batch(mat).any()
    for halt, want in ((False, 0 * mat[:, c.CTX.ADDR]),
                       (True, mat[:, c.CTX.ADDR] + 5)):
        got = run_plain(no_exit, mat, maps, fuel=len(no_exit), halt=halt,
                        cap=0)
        np.testing.assert_array_equal(got[0], want)


def test_device_maps_follow_reloads():
    """One flat buffer with (offset, live length) per slot, rebuilt only
    on a version change; no maps is one slot of length 0."""
    c = tx.core("repro_torch")
    empty = pe.DeviceMaps(c.MapRegistry(), torch.device("cpu"))
    flat, meta = empty.flat()
    assert flat.tolist() == [0] and meta.tolist() == [[0], [0]]
    maps = c.MapRegistry()
    a, b = c.ArrayMap(4, "a"), c.ArrayMap(3, "b")
    maps.register(a)
    maps.register(b)
    a.load([5, 6])
    dm = pe.DeviceMaps(maps, torch.device("cpu"))
    flat, meta = dm.flat()
    assert flat.tolist() == [5, 6, 0, 0, 0, 0, 0]
    assert meta.tolist() == [[0, 4], [2, 0]]
    assert dm.flat()[0] is flat                  # unchanged: no new copy
    b.update(1, 9)
    flat2, meta2 = dm.flat()
    assert flat2 is not flat and flat2.tolist()[4:] == [0, 9, 0]
    assert meta2.tolist() == [[0, 4], [2, 2]]
    arrays, lens = dm.arrays()
    assert [t.tolist() for t in arrays] == [[5, 6, 0, 0], [0, 9, 0]]
    assert lens.tolist() == [2, 2]


def test_pack_code_rejects_what_the_kernel_cannot_index():
    c = tx.core("repro_torch")
    from repro_torch.core.lower import LIns
    with pytest.raises(ValueError, match="register"):
        pe.pack_code((LIns(c.Op.MOV, 11, 0), LIns(c.Op.EXIT)))
    with pytest.raises(ValueError, match="register"):
        pe.pack_code((LIns(c.Op.LDMAPX, 0, 1, src2=12), LIns(c.Op.EXIT)))
    with pytest.raises(ValueError, match="target"):
        pe.pack_code((LIns(c.Op.JA, target=5), LIns(c.Op.EXIT)))


def test_cpu_executors_keep_their_eager_bodies():
    """On the CPU neither executor packs a table: their eager bodies run
    (the kernel is for CUDA tensors only)."""
    c = tx.core("repro_torch")
    maps = tx._maps(c)
    prog = tx._programs(c)["ebpf_mm_r8"]
    n = pe.policy_exec.launches
    for ex in (c.PredicatedPolicy(prog, maps, device="cpu"),
               c.JitPolicy(prog, maps, device="cpu")):
        assert ex._table is None
        ex.run_batch(tx.ctx_rows(4, 3))
    assert pe.policy_exec.launches == n


def _cu_constants() -> dict:
    src = CSRC.read_text()
    consts = {m[0]: int(m[1]) for m in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    for body in re.findall(r"enum \w+ : int \{(.*?)\};", src, re.S):
        consts.update((m[0], int(m[1]))
                      for m in re.findall(r"(k\w+) = (\d+)", body))
    return consts


def test_kernel_constants_match_python():
    """The ctx offsets, opcodes, helper ids and tag the CUDA source
    hard-codes are the Python package's."""
    from repro_torch.core import vm
    from repro_torch.core.context import CTX, CTX_LEN, MAX_TIERS
    from repro_torch.core.isa import NUM_REGS, Op
    from repro_torch.core.lower import RB_FIELDS
    from repro_torch.obs.ringbuf import EV_PROG_TRACE
    k = _cu_constants()
    want = {
        "kNumRegs": NUM_REGS, "kCtxLen": CTX_LEN, "kMaxTiers": MAX_TIERS,
        "kFreeBlocksO0": CTX.FREE_BLOCKS_O0, "kFragO0": CTX.FRAG_O0,
        "kZeroNsPerBlock": CTX.ZERO_NS_PER_BLOCK,
        "kCompactNsPerBlock": CTX.COMPACT_NS_PER_BLOCK,
        "kKtimeNs": CTX.KTIME_NS, "kMigCumSetupT0": CTX.MIG_CUM_SETUP_T0,
        "kMigCumNsT0": CTX.MIG_CUM_NS_T0, "kEvProgTrace": EV_PROG_TRACE,
        "kRbFields": RB_FIELDS,
        "kHelperKtime": vm.HELPER_KTIME, "kHelperTrace": vm.HELPER_TRACE,
        "kHelperPromotionCost": vm.HELPER_PROMOTION_COST,
        "kHelperMigrateCost": vm.HELPER_MIGRATE_COST,
        "kHelperRingbufOutput": vm.HELPER_RINGBUF_OUTPUT,
    }
    names = {"kMovi": "MOVI", "kMaxi": "MAXI", "kNeg": "NEG",
             "kLdctx": "LDCTX", "kLdmap": "LDMAP", "kMapsz": "MAPSZ",
             "kLdmapx": "LDMAPX", "kLdctxr": "LDCTXR", "kJa": "JA",
             "kJeq": "JEQ", "kJset": "JSET", "kJeqi": "JEQI",
             "kJseti": "JSETI", "kJnzdec": "JNZDEC", "kCall": "CALL",
             "kExit": "EXIT"}
    for reg_op in ("MOV", "ADD", "SUB", "MUL", "DIV", "MOD", "AND", "OR",
                   "XOR", "LSH", "RSH", "MIN", "MAX"):
        names["k" + reg_op.capitalize()] = reg_op
    want.update({k_: int(Op[v]) for k_, v in names.items()})
    assert {n: k.get(n) for n in want} == want
    # the kernel maps imm ALU ops and imm jumps onto the reg forms by a
    # fixed offset, and reads JNE..JGE as JEQ + 1..5
    assert all(int(op) - 16 == int(vm._IMM2REG[op])
               for op in vm._IMM2REG)
    assert all(int(op) - 7 == int(vm._JIMM2REG[op])
               for op in vm._JIMM2REG)
    assert [int(Op[n]) for n in ("JNE", "JLT", "JLE", "JGT", "JGE")] == \
        [int(Op.JEQ) + i for i in range(1, 6)]
