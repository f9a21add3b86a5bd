"""A verified policy program over a whole fault batch in one launch.

No TPU kernel: this is the port's counterpart of the reference's compile
step, ``compile_program`` (``repro/core/jit.py``: a ``lax.while_loop``
over a ``lax.switch(pc, ...)``, jitted and vmapped over the batch) and
``compile_predicated`` (``repro/core/predicate.py``).  One generic kernel,
``csrc/policy_exec.cu``, interprets the packed instruction table with one
thread per lane, so nothing is compiled per program or batch bucket.

* :func:`pack_code` turns lowered code (``LIns``: the predicated route's
  unroll or the JIT route's looped ``lowered.insns``) into the ``[n, 6]``
  int64 table the kernel reads, one 32-byte row an instruction
  (:data:`CODE_DTYPE`), with what :func:`decode`, :func:`operand` and
  :func:`ctx_index` make of each (handler, sub, operand source, operand);
  :func:`unpack_code` reads the code back from those fields alone.
* :func:`stage_plan` lays out what a block stages in shared memory
  before its lanes run (ctx rows, registers, maps, table), and which of
  the maps and the table stay in device memory because they do not fit.
* :class:`DeviceMaps` keeps a map registry's device copy, rebuilt only
  when ``maps.version()`` changes: one flat int64 buffer with a
  ``[2, n_maps]`` (offset, live length) table for the kernel, and per-map
  views of it for the eager executors.  With no maps it holds one slot of
  length 0.
* :func:`policy_exec` launches the kernel on CUDA tensors or raises.  It
  counts every launch in ``policy_exec.launches`` and the JIT route's
  (``halt_returns_r0``) also in ``policy_exec.pc_walk_launches``.  On CPU
  tensors it runs :func:`policy_exec_plain`: the pc-walking executor's
  eager body (:mod:`repro_torch.core.pcwalk`) over the code the same
  table holds.

Both return one int64 row a lane, ``[r0, ring count, ring drops, rb_cap x
(ts, tag, a0, a1, a2)]``, ring slots past the count zero
(:func:`split_out` cuts it).  ``fuel`` bounds each lane's steps; a lane
that stops without ``EXIT`` returns its r0 register when
``halt_returns_r0`` (the JIT route, as ``JitPolicy``) and 0 otherwise (the
predicated route, as its ``_Machine``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import build
from ...core.context import CTX_LEN
from ...core.isa import NUM_REGS, Op
from ...core.lower import I64, RB_FIELDS, BatchCtx, LIns
from ...core.pcwalk import pc_walk

# One instruction, 32 bytes (the kernel's ``PIns``), every field one the
# kernel reads: a control word (handler, sub, whether operand b is
# register ``src``, the opcode), the registers, the jump target, the
# operand ``k`` and LDCTX's ``kctx``.
CODE_DTYPE = np.dtype([("h", "u1"), ("sub", "u1"), ("breg", "u1"),
                       ("op", "u1"), ("dst", "<i4"), ("src", "<i4"),
                       ("target", "<i4"), ("k", "<i8"), ("kctx", "<i4"),
                       ("pad", "<i4")])
assert CODE_DTYPE.itemsize == 32
ROW_WORDS = CODE_DTYPE.itemsize // 8

# The kernel's handlers (``Handler``), in the order its loop tests them,
# and the arithmetic handler's results (``ArithCode``).
H_ARITH, H_JUMP, H_MAP, H_ALU, H_LDCTXR, H_JNZDEC, H_CALL, H_EXIT = range(8)
AR_MOV, AR_ADD, AR_MUL, AR_CTX = range(4)

_ARITH = {Op.MOV: AR_MOV, Op.ADD: AR_ADD, Op.SUB: AR_ADD, Op.MUL: AR_MUL}
_IMM_TO_REG = int(Op.MOVI) - int(Op.MOV)
# a compare's outcome on (eq, lt, set), for the truth tables of jumps
_COMPARE = {Op.JEQ: lambda eq, lt, st: eq,
            Op.JNE: lambda eq, lt, st: not eq,
            Op.JLT: lambda eq, lt, st: lt,
            Op.JLE: lambda eq, lt, st: lt or eq,
            Op.JGT: lambda eq, lt, st: not (lt or eq),
            Op.JGE: lambda eq, lt, st: not lt,
            Op.JSET: lambda eq, lt, st: st}


def jump_table(op: Op) -> int:
    """A jump's 8-bit truth table: bit ``eq | lt << 1 | set << 2`` of it
    says whether the jump is taken when (dst, b) compare so."""
    if op == Op.JA:
        return 0xff
    if Op.JEQI <= op <= Op.JSETI:
        op = Op(int(op) - (int(Op.JEQI) - int(Op.JEQ)))
    return sum(1 << s for s in range(8)
               if _COMPARE[op](s & 1, s >> 1 & 1, s >> 2 & 1))


def decode(op: Op) -> tuple[int, int, bool]:
    """``(handler, sub, b from register src)`` of an opcode, as
    :func:`pack_code` stores them: ``sub`` is ``H_ARITH``'s result
    (``AR_*``), ``H_JUMP``'s truth table (:func:`jump_table`), the reg-form
    ALU op of ``H_ALU`` (NEG as itself) and the opcode of ``H_MAP``.
    Raises ``ValueError`` on an opcode the kernel has no handler for."""
    op = Op(op)
    if Op.MOV <= op <= Op.MAX or Op.MOVI <= op <= Op.MAXI:
        reg = op <= Op.MAX
        form = Op(int(op) - (0 if reg else _IMM_TO_REG))
        if form in _ARITH and (form != Op.SUB or not reg):  # SUBI: + -imm
            return H_ARITH, _ARITH[form], reg
        return H_ALU, int(form), reg
    if op == Op.NEG:
        return H_ALU, int(op), False
    if op == Op.LDCTX:
        return H_ARITH, AR_CTX, False
    if op == Op.LDCTXR:
        return H_LDCTXR, 0, False
    if op == Op.JA or Op.JEQ <= op <= Op.JSET or Op.JEQI <= op <= Op.JSETI:
        return H_JUMP, jump_table(op), Op.JEQ <= op <= Op.JSET
    rare = {Op.LDMAP: H_MAP, Op.LDMAPX: H_MAP, Op.MAPSZ: H_MAP,
            Op.JNZDEC: H_JNZDEC, Op.CALL: H_CALL, Op.EXIT: H_EXIT}
    if op in rare:
        return rare[op], int(op) if rare[op] == H_MAP else 0, False
    raise ValueError(f"pack_code: no kernel handler for opcode {op!r}")


def operand(ins) -> int:
    """The ``k`` a row's kernel reads: the immediate b (negated for SUBI),
    JEQI..JSETI's ``src2``, the map slot (LDMAP, MAPSZ) or slot register
    (LDMAPX), the helper id."""
    if ins.op == Op.SUBI:
        return _wrap64(-int(ins.imm))
    if _k_is_src2(ins.op):
        return _wrap64(int(ins.src2))
    return _wrap64(int(ins.imm))


def ctx_index(ins) -> int:
    """LDCTX's ctx column, clamped to the row (0 for other rows): the
    arithmetic handler reads it for every row."""
    return min(max(int(ins.imm), 0), CTX_LEN - 1) if ins.op == Op.LDCTX \
        else 0


def _k_is_src2(op: Op) -> bool:
    """Whether a row's ``k`` is the lowered ``src2`` (its ``imm`` then
    unused), not the lowered ``imm``."""
    return Op.JEQI <= op <= Op.JSETI or op == Op.LDMAPX


def _wrap64(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def pack_code(code) -> torch.Tensor:
    """Lowered code -> the kernel's ``[n, 4]`` int64 instruction table (a
    CPU tensor; the executors move it to their device once).  Raises
    ``ValueError`` on a register outside ``r0..r10``, a jump target
    outside the code or an opcode with no handler: the kernel indexes and
    dispatches with them unchecked."""
    n = len(code)
    rows = np.zeros(n, CODE_DTYPE)
    for pc, ins in enumerate(code):
        regs = (ins.dst, ins.src) + ((ins.src2,) if ins.op == Op.LDMAPX
                                     else ())
        if not all(0 <= r < NUM_REGS for r in regs):
            raise ValueError(f"pack_code: register out of range at {pc}: "
                             f"{ins}")
        if not -1 <= ins.target <= n:
            raise ValueError(f"pack_code: jump target out of range at {pc}: "
                             f"{ins}")
        h, sub, breg = decode(ins.op)
        rows[pc] = (h, sub, breg, int(ins.op), ins.dst, ins.src, ins.target,
                    operand(ins), ctx_index(ins), 0)
    return torch.from_numpy(rows.view(np.int64).reshape(n, ROW_WORDS)
                            .copy())


def unpack_code(table: torch.Tensor) -> tuple[LIns, ...]:
    """The ``LIns`` tuple a table was packed from, read from the fields
    the kernel reads: ``imm`` and ``src2`` come back from ``k`` (a field
    an op does not use is 0, as :class:`LIns` lowers it)."""
    rows = table.cpu().numpy().view(CODE_DTYPE)[:, 0].tolist()
    code = []
    for _, _, _, op, dst, src, target, k, _, _ in rows:
        op = Op(op)
        imm, src2 = (0, k) if _k_is_src2(op) else \
            (_wrap64(-k) if op == Op.SUBI else k, 0)
        code.append(LIns(op, dst, src, imm, src2, target))
    return tuple(code)


# --------------------------------------------------------- the block's layout
SMEM_BUDGET = 232_448    # shared memory a block may opt into on the H100
MAX_LANES = 128          # lanes (threads) a block
_BARRIER = 16            # the prologue's mbarrier, at offset 0


class StagePlan(NamedTuple):
    """A block's shared-memory layout: ``threads`` lanes a block,
    ``smem_bytes`` in all, and the byte offset of each region, -1 for the
    maps or the table when the kernel reads them in place."""
    threads: int
    smem_bytes: int
    ctx: int
    regs: int
    meta: int
    maps: int
    table: int


def _staged_bytes(words: int) -> int:
    """A staged region of ``words`` int64: one spare word, so that a
    source 8 bytes off a 16-byte boundary lands shifted by one word, and
    rounded up to 16 bytes."""
    return (8 * words + 8 + 15) // 16 * 16


def block_lanes(B: int) -> int:
    """Lanes a block for a batch of ``B``: whole warps, at most
    :data:`MAX_LANES` (more lanes take more blocks)."""
    return min(MAX_LANES, max(32, -(-B // 32) * 32))


@functools.lru_cache(maxsize=1024)
def stage_plan(n_code: int, B: int, map_words: int,
               n_maps: int) -> StagePlan:
    """Where a block of the batch puts what its lanes read, in
    :data:`SMEM_BUDGET` bytes: the mbarrier, the block's ctx rows, its
    lanes' registers, the maps' ``[2, n_maps]`` table, then
    the maps' ``map_words`` if they fit beside those, then the
    ``n_code``-row instruction table if it fits beside all of them."""
    threads = block_lanes(B)
    used = _BARRIER

    def take(nbytes: int, always: bool = True) -> int:
        nonlocal used
        if not always and used + nbytes > SMEM_BUDGET:
            return -1
        used += nbytes
        return used - nbytes
    ctx = take(_staged_bytes(threads * CTX_LEN))
    regs = take(8 * NUM_REGS * threads)
    meta = take(_staged_bytes(2 * n_maps))
    maps = take(_staged_bytes(map_words), always=False)
    # two spare rows past the table's end: the kernel fetches the two rows
    # after the one it runs before it knows there are none
    table = take(_staged_bytes(ROW_WORDS * (n_code + 2)), always=False)
    assert used <= SMEM_BUDGET
    return StagePlan(threads, used, ctx, regs, meta, maps, table)


class DeviceMaps:
    """A map registry's copy on ``device``, rebuilt when
    ``maps.version()`` changes (a profile reload), so a batch with
    unchanged maps copies nothing to the device."""

    def __init__(self, maps, device) -> None:
        self.maps = maps
        self.device = device
        self._version = None

    def _refresh(self) -> None:
        ver = self.maps.version()
        if ver == self._version:
            return
        host = [np.ascontiguousarray(self.maps[i].live_array(), np.int64)
                for i in range(len(self.maps))]
        lens = self.maps.lens()
        if not host:                        # one slot of length 0
            host, lens = [np.zeros(1, np.int64)], [0]
        offs = np.cumsum([0] + [h.size for h in host[:-1]])
        self._flat = torch.from_numpy(np.concatenate(host)).to(self.device)
        self._meta = torch.tensor(np.stack([offs, lens]),
                                  dtype=I64).to(self.device)
        self._arrays = tuple(self._flat[o:o + h.size]
                             for o, h in zip(offs.tolist(), host))
        self._version = ver

    def arrays(self):
        """(per-map arrays, lens): the eager executors' form."""
        self._refresh()
        return self._arrays, self._meta[1]

    def flat(self):
        """(flat buffer, ``[2, n_maps]`` offsets and lens): the kernel's."""
        self._refresh()
        return self._flat, self._meta


def split_out(out, rb_cap: int):
    """``(r0, events [B, rb_cap, 5], count, drops)`` of a
    :func:`policy_exec` output (a tensor or its numpy copy); views."""
    B = out.shape[0]
    return (out[:, 0], out[:, 3:].reshape(B, rb_cap, RB_FIELDS), out[:, 1],
            out[:, 2])


def _check(table, ctx, maps, meta, rb_cap: int) -> None:
    dev = ctx.device
    for name, t in (("table", table), ("ctx", ctx), ("maps", maps),
                    ("meta", meta)):
        if t.device != dev or t.dtype != I64 or not t.is_contiguous():
            raise ValueError(f"policy_exec: {name} must be a contiguous "
                             f"int64 tensor on {dev}")
    if (table.dim() != 2 or table.shape[1] != ROW_WORDS
            or table.shape[0] == 0
            or ctx.dim() != 2 or ctx.shape[1] != CTX_LEN
            or meta.dim() != 2 or meta.shape[0] != 2 or meta.shape[1] == 0
            or maps.dim() != 1 or rb_cap < 0):
        raise ValueError(f"policy_exec: table{tuple(table.shape)} "
                         f"ctx{tuple(ctx.shape)} maps{tuple(maps.shape)} "
                         f"meta{tuple(meta.shape)} rb_cap {rb_cap}")


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             *[ctypes.c_int] * 7, ctypes.c_void_p]

def load():
    """The kernel's C launcher, built at first use.  The hook registry
    calls it when it builds a CUDA batch backend (at ``warm``), so a build
    failure raises there and not inside a contained batch."""
    return build.function("policy_exec", "policy_exec_launch", _ARGTYPES)


def policy_exec(table, ctx, maps, meta, *, rb_cap: int,
                fuel: int, halt_returns_r0: bool) -> torch.Tensor:
    """Run the program ``table`` (:func:`pack_code`) on every ``[B,
    CTX_LEN]`` ctx row against ``maps``/``meta`` (:meth:`DeviceMaps.flat`);
    returns the ``[B, 3 + 5 rb_cap]`` int64 rows (module docstring).  CUDA
    tensors take one kernel launch (its shared-memory layout from
    :func:`stage_plan`); CPU tensors run :func:`policy_exec_plain`."""
    out = torch.empty((ctx.shape[0], 3 + RB_FIELDS * rb_cap), dtype=I64,
                      device=ctx.device)
    args = launch_args(table, ctx, maps, meta, out, rb_cap=rb_cap, fuel=fuel,
                       halt_returns_r0=halt_returns_r0)
    if not ctx.is_cuda:
        return out.copy_(policy_exec_plain(table, ctx, maps, meta,
                                           rb_cap=rb_cap, fuel=fuel,
                                           halt_returns_r0=halt_returns_r0))
    if ctx.shape[0]:
        with torch.cuda.device(ctx.device):
            launch(args, torch.cuda.current_stream(ctx.device).cuda_stream)
    return out


def launch_args(table, ctx, maps, meta, out, *, rb_cap: int, fuel: int,
                halt_returns_r0: bool) -> tuple:
    """The C launcher's arguments but the stream, for tensors checked
    here: a caller that launches the same tensors again (the executors'
    staging buffers) keeps them and calls :func:`launch`."""
    _check(table, ctx, maps, meta, rb_cap)
    B = ctx.shape[0]
    width = 3 + RB_FIELDS * rb_cap
    if (out.device != ctx.device or out.dtype != I64
            or out.shape != (B, width) or not out.is_contiguous()):
        raise ValueError(f"policy_exec: out must be a contiguous int64 "
                         f"[{B}, {width}] tensor on {ctx.device}")
    if ctx.is_cuda and table.data_ptr() % 16:
        raise ValueError("policy_exec: the table must be 16-byte aligned")
    n_code, n_maps = table.shape[0], meta.shape[1]
    return (table.data_ptr(), n_code, ctx.data_ptr(), B, maps.data_ptr(),
            maps.numel(), meta.data_ptr(), n_maps, out.data_ptr(), rb_cap,
            fuel, int(halt_returns_r0),
            *stage_plan(n_code, B, maps.numel(), n_maps))


def launch(args: tuple, stream: int) -> None:
    """One launch of the kernel with :func:`launch_args`' arguments on
    ``stream`` (a CUDA stream handle; the current device must be the
    tensors'), counted in ``policy_exec.launches`` (and the JIT route's,
    ``halt_returns_r0``, in ``policy_exec.pc_walk_launches``)."""
    build.check(load()(*args, stream), "policy_exec")
    policy_exec.launches += 1
    policy_exec.pc_walk_launches += bool(args[11])


policy_exec.launches = 0
policy_exec.pc_walk_launches = 0         # the JIT route's share


def empty_launch() -> None:
    """One launch of an empty kernel on the current stream: the latency
    floor :func:`policy_exec` is read against (not counted)."""
    fn = build.function("policy_exec", "policy_exec_empty_launch",
                        [ctypes.c_void_p])
    build.check(fn(torch.cuda.current_stream().cuda_stream),
                "policy_exec_empty_launch")


def policy_exec_plain(table, ctx, maps, meta, *, rb_cap: int, fuel: int,
                      halt_returns_r0: bool) -> torch.Tensor:
    """:func:`policy_exec` in plain PyTorch, on any device: the pc-walking
    executor's eager body (:func:`repro_torch.core.pcwalk.pc_walk`) over
    the code the table's kernel fields hold (:func:`unpack_code`) and the
    flat maps' per-slot views."""
    _check(table, ctx, maps, meta, rb_cap)
    B = ctx.shape[0]
    arrays = torch.tensor_split(maps, meta[0, 1:].tolist())
    r0, rb = pc_walk(unpack_code(table), BatchCtx(ctx), arrays, meta[1],
                     rb_cap=rb_cap, fuel=fuel,
                     halt_returns_r0=halt_returns_r0)
    out = torch.zeros((B, 3 + RB_FIELDS * rb_cap), dtype=I64,
                      device=ctx.device)
    out[:, 0] = r0
    if rb_cap:
        out[:, 3:] = rb[0].reshape(B, -1)
        out[:, 1] = rb[1]
        out[:, 2] = rb[2]
    return out
