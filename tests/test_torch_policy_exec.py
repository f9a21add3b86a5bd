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
* every opcode's pre-decoded row (handler, sub, operand source, operand,
  a jump's truth table) is what the kernel's dispatch needs: that dispatch
  walked in Python over the table's kernel fields alone gives
  ``PolicyVM``'s results;
* ``stage_plan`` lays out the block's shared memory in order, aligned,
  within its budget, staging the maps and the table only when they fit;
* the kernel source's constants (ctx offsets, opcodes, helper ids,
  handlers, control-word bits, budget) equal their Python definitions: the
  kernel itself runs only on the card (``tests/test_torch_gpu.py``).
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
    """Unrolled and looped code -> table -> the same ``LIns`` tuple, read
    back from the kernel's fields alone; one 32-byte row an instruction, its handler, sub-op, operand source and
    operand those of :func:`decode` and :func:`operand`."""
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
        rows = table.numpy().view(pe.CODE_DTYPE)[:, 0]
        assert rows[["h", "sub", "breg", "k", "kctx"]].tolist() == [
            (*pe.decode(ins.op), pe.operand(ins), pe.ctx_index(ins))
            for ins in code]


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
    insns of 32 bytes: at 30 x 50 (3,035 insns, 95 KB) the kernel stages
    its table in shared memory above the 48 KB default, at 64 x 55 (7,109
    insns, 222 KB, over what 227 KB leaves beside a block's ctx rows) it
    reads the table from device memory (``stage_plan``)."""
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


def test_decode_gives_every_opcode_a_handler():
    """Every opcode of the ISA has a kernel handler: MOV, ADD, MUL, LDCTX
    and SUBI (an ADD of -imm) the branch-free arithmetic one, the other
    ALU ops the ALU one as their reg form; every jump a truth table that
    agrees with the interpreter's compare on int64 edge pairs."""
    from repro_torch.core.isa import Op
    from repro_torch.core import vm
    from repro_torch.core.lower import LIns
    for op in Op:
        h, sub, breg = pe.decode(op)
        assert 0 <= h <= pe.H_EXIT and 0 <= sub < 256
    for op, reg in vm._IMM2REG.items():
        h, sub, breg = pe.decode(op)
        assert not breg and pe.decode(reg)[2]
        if reg in (Op.ADD, Op.SUB, Op.MUL):
            assert h == pe.H_ARITH
            assert sub == (pe.AR_MUL if reg == Op.MUL else pe.AR_ADD)
        else:
            assert (h, sub) == pe.decode(reg)[:2] == (pe.H_ALU, int(reg))
    assert pe.decode(Op.SUB) == (pe.H_ALU, int(Op.SUB), True)
    assert pe.decode(Op.MOVI) == (pe.H_ARITH, pe.AR_MOV, False)
    assert pe.decode(Op.LDCTX) == (pe.H_ARITH, pe.AR_CTX, False)
    assert pe.decode(Op.JA) == (pe.H_JUMP, 0xff, False)
    edges = [-(1 << 63), -7, -1, 0, 1, 6, 7, (1 << 63) - 1]
    for op, reg in vm._JIMM2REG.items():
        for j, breg in ((op, False), (reg, True)):
            h, table, got_breg = pe.decode(j)
            assert (h, got_breg) == (pe.H_JUMP, breg)
            for a in edges:
                for b in edges:
                    s = (a == b) | (a < b) << 1 | ((a & b) != 0) << 2
                    assert bool(table >> s & 1) == vm._cmp(reg, a, b)
    assert pe.operand(LIns(Op.SUBI, 1, imm=-(1 << 63))) == -(1 << 63)
    assert pe.operand(LIns(Op.SUBI, 1, imm=5)) == -5
    assert pe.operand(LIns(Op.JEQI, 1, imm=3, src2=-4)) == -4
    assert pe.ctx_index(LIns(Op.LDCTX, 1, imm=99)) == 68
    assert pe.ctx_index(LIns(Op.MOVI, 1, imm=99)) == 0


def _decoded_walk(table, mat, maps, *, fuel, halt, cap):
    """The kernel's loop in Python, one lane at a time, reading of each row
    only what the kernel reads (handler, sub, operand source, registers,
    target, ``k``, ``kctx``; never the opcode): what a wrong pre-decoding
    would change, the CPU can show."""
    from repro_torch.core import vm
    from repro_torch.core.context import CTX, CTX_LEN
    from repro_torch.core.isa import Op, _wrap64
    rows = table.numpy().view(pe.CODE_DTYPE)[:, 0].tolist()
    flat, meta = (t.numpy() for t in
                  pe.DeviceMaps(maps, torch.device("cpu")).flat())
    n_maps = meta.shape[1]
    rets, events, drops = [], [], 0
    for c in mat.tolist():
        st = vm.HelperState(ktime_ns=c[CTX.KTIME_NS], rb_cap=cap)
        r, pc, exited = [0] * 11, 0, False
        for _ in range(fuel):
            h, sub, breg, _, dst, src, target, k, kctx, _ = rows[pc]
            nxt = pc + 1
            x, y = r[dst], r[src]
            b = y if breg else k
            if h == pe.H_ARITH:
                r[dst] = [b, _wrap64(x + b), _wrap64(x * b), c[kctx]][sub]
            elif h == pe.H_JUMP:
                if sub >> ((x == b) | (x < b) << 1 | ((x & b) != 0) << 2) & 1:
                    nxt = target
            elif h == pe.H_ALU:
                r[dst] = (_wrap64(-x) if sub == Op.NEG
                          else vm._alu(Op(sub), x, b))
            elif h == pe.H_LDCTXR:
                r[dst] = c[min(max(y, 0), CTX_LEN - 1)]
            elif h == pe.H_MAP:
                slot = min(max(r[k] if sub == Op.LDMAPX else k, 0),
                           n_maps - 1)
                size = int(meta[1, slot])
                r[dst] = size if sub == Op.MAPSZ else (
                    int(flat[meta[0, slot] + y]) if 0 <= y < size else 0)
            elif h == pe.H_JNZDEC:
                r[dst] = _wrap64(x - 1)
                if r[dst]:
                    nxt = target
            elif h == pe.H_CALL:
                r[0] = _wrap64(int(vm.HELPERS[k](r, c, st)))
            else:
                assert h == pe.H_EXIT
                exited, nxt = True, -1
            if not 0 <= nxt < len(rows):
                break
            pc = nxt
        rets.append(r[0] if exited or halt else 0)
        events.extend(st.rb_events)
        drops += st.rb_drops
    return np.asarray(rets, np.int64), events, drops


@pytest.mark.parametrize("route", ["pred", "jit"])
@pytest.mark.parametrize("name", NAMES + ["ring_overflow"])
def test_decoded_table_carries_what_the_kernel_reads(name, route):
    """The kernel's dispatch over the pre-decoded table == PolicyVM
    (decisions, ring events, drops) on 8 seeded rows plus 8 edge rows."""
    c = tx.core("repro_torch")
    maps = c.MapRegistry() if name == "ring_overflow" else tx._maps(c)
    prog = _overflow_program(c) if name == "ring_overflow" else \
        program(c, name)
    mat = np.concatenate([tx.ctx_rows(8, 31), tx.edge_rows(32)[:8]])
    code, fuel, halt, cap = route_code(c, prog, maps, route)
    tx._check(_decoded_walk(pe.pack_code(code), mat, maps, fuel=fuel,
                            halt=halt, cap=cap),
              tx._vm_results(c, prog, maps, mat), f"{name} {route}")


def _ctx_bytes(lanes):
    return (8 * 69 * lanes + 8 + 15) // 16 * 16


def test_stage_plan_places_ctx_registers_maps_then_table():
    """Regions in order after the 16-byte barrier, 16-byte aligned, each
    with a spare word for an unaligned source; whole warps, at most 128
    lanes a block; the lanes' registers, 88 bytes a lane."""
    assert [pe.block_lanes(b) for b in (1, 31, 32, 33, 64, 65, 128, 129,
                                        257)] == \
        [32, 32, 32, 64, 64, 96, 128, 128, 128]
    for B, lanes in ((64, 64), (65, 96), (128, 128), (4096, 128)):
        p = pe.stage_plan(172, B, 384, 1)
        assert p.threads == lanes and p.ctx == 16
        assert p.regs == 16 + _ctx_bytes(lanes)
        assert p.meta == p.regs + 8 * 11 * lanes
        assert p.maps == p.meta + 32             # 2 words + spare
        assert p.table == p.maps + (8 * 384 + 8 + 15) // 16 * 16
        assert p.smem_bytes == p.table + 32 * 174 + 16   # spare rows
        assert all(o % 16 == 0 for o in p[2:] if o >= 0)


def test_stage_plan_edges_of_the_budget():
    """At 128 lanes: the largest table that fits beside ctx and maps is
    staged and one row more is read in place; maps over the budget stay in
    device memory and the table then takes their room; the plan never
    passes 227 KB."""
    budget = pe.SMEM_BUDGET
    base = pe.stage_plan(1, 128, 384, 1).table
    fits = (budget - base - 80) // 32   # rows; spare rows and word
    edge = pe.stage_plan(fits, 128, 384, 1)
    assert edge.table == base and edge.smem_bytes <= budget
    assert budget - edge.smem_bytes < 32
    over = pe.stage_plan(fits + 1, 128, 384, 1)
    assert over.table == -1 and over.maps >= 0
    assert over.smem_bytes == base
    # maps that do not fit beside ctx: read in place, the table staged
    big = (budget - pe.stage_plan(1, 128, 0, 1).maps) // 8
    p = pe.stage_plan(172, 128, big, 1)
    assert p.maps == -1 and p.table >= 0 and p.smem_bytes <= budget
    # ... and a table too large even for the maps' room: both in place
    room = pe.stage_plan(1, 128, big, 1).table
    assert pe.stage_plan(fits + 1, 128, big, 1).table == room
    huge = (budget - room - 80) // 32 + 1
    assert pe.stage_plan(huge, 128, big, 1)[5:] == (-1, -1)
    assert pe.stage_plan(huge - 1, 128, big, 1).table == room
    # 65 lanes stage 96 threads' rows: the largest table at 64 lanes
    rows = (budget - pe.stage_plan(1, 64, 384, 1).table - 80) // 32
    assert pe.stage_plan(rows, 64, 384, 1).table >= 0
    assert pe.stage_plan(rows, 65, 384, 1).table == -1


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
        "kHArith": pe.H_ARITH, "kHJump": pe.H_JUMP, "kHMap": pe.H_MAP,
        "kHAlu": pe.H_ALU, "kHLdctxr": pe.H_LDCTXR,
        "kHJnzdec": pe.H_JNZDEC, "kHCall": pe.H_CALL, "kHExit": pe.H_EXIT,
        "kArMov": pe.AR_MOV, "kArAdd": pe.AR_ADD, "kArMul": pe.AR_MUL,
        "kArCtx": pe.AR_CTX,
        # the control word's bytes, little-endian
        "kSubShift": 8 * pe.CODE_DTYPE.fields["sub"][1],
        "kBRegBit": 1 << 8 * pe.CODE_DTYPE.fields["breg"][1],
        "kOpShift": 8 * pe.CODE_DTYPE.fields["op"][1],
        "kThreads": pe.MAX_LANES,
        "kSmemBudget": pe.SMEM_BUDGET,
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
    # the kernel's instruction row is the table's
    assert int(re.search(r"sizeof\(PIns\) == (\d+)", CSRC.read_text())[1]) \
        == pe.CODE_DTYPE.itemsize
