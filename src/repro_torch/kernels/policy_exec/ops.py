"""A verified policy program over a whole fault batch in one launch.

No TPU kernel: this is the port's counterpart of the reference's compile
step, ``compile_program`` (``repro/core/jit.py``: a ``lax.while_loop``
over a ``lax.switch(pc, ...)``, jitted and vmapped over the batch) and
``compile_predicated`` (``repro/core/predicate.py``).  One generic kernel,
``csrc/policy_exec.cu``, interprets the packed instruction table with one
thread per lane, so nothing is compiled per program or batch bucket.

* :func:`pack_code` turns lowered code (``LIns``: the predicated route's
  unroll or the JIT route's looped ``lowered.insns``) into the ``[n, 4]``
  int64 table the kernel reads, one 32-byte row an instruction
  (:data:`CODE_DTYPE`); :func:`unpack_code` reads it back.
* :class:`DeviceMaps` keeps a map registry's device copy, rebuilt only
  when ``maps.version()`` changes: one flat int64 buffer with a
  ``[2, n_maps]`` (offset, live length) table for the kernel, and per-map
  views of it for the eager executors.  With no maps it holds one slot of
  length 0.
* :func:`policy_exec` launches the kernel on CUDA tensors or raises.  It
  counts every launch in ``policy_exec.launches`` and the JIT route's
  (``halt_returns_r0``) also in ``policy_exec.pc_walk_launches``.  On CPU
  tensors it runs :func:`policy_exec_plain`: the pc-walking executor's
  eager body (:mod:`repro_torch.core.pcwalk`) over the same table.

Both return one int64 row a lane, ``[r0, ring count, ring drops, rb_cap x
(ts, tag, a0, a1, a2)]``, ring slots past the count zero
(:func:`split_out` cuts it).  ``fuel`` bounds each lane's steps; a lane
that stops without ``EXIT`` returns its r0 register when
``halt_returns_r0`` (the JIT route, as ``JitPolicy``) and 0 otherwise (the
predicated route, as its ``_Machine``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import build
from ...core.context import CTX_LEN
from ...core.isa import NUM_REGS, Op
from ...core.lower import I64, RB_FIELDS, BatchCtx, LIns
from ...core.pcwalk import pc_walk

# One instruction: four int32 fields, then the two int64 ones (32 bytes,
# the kernel's ``PIns``).
CODE_DTYPE = np.dtype([("op", "<i4"), ("dst", "<i4"), ("src", "<i4"),
                       ("target", "<i4"), ("imm", "<i8"), ("src2", "<i8")])
assert CODE_DTYPE.itemsize == 32


def _wrap64(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def pack_code(code) -> torch.Tensor:
    """Lowered code -> the kernel's ``[n, 4]`` int64 instruction table (a
    CPU tensor; the executors move it to their device once).  Raises
    ``ValueError`` on a register outside ``r0..r10`` or a jump target
    outside the code: the kernel indexes with them unchecked."""
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
        rows[pc] = (int(ins.op), ins.dst, ins.src, ins.target,
                    _wrap64(int(ins.imm)), _wrap64(int(ins.src2)))
    return torch.from_numpy(rows.view(np.int64).reshape(n, 4).copy())


def unpack_code(table: torch.Tensor) -> tuple[LIns, ...]:
    """The ``LIns`` tuple a table was packed from."""
    rows = table.cpu().numpy().view(CODE_DTYPE)[:, 0].tolist()
    return tuple(LIns(Op(op), dst, src, imm, src2, target)
                 for op, dst, src, target, imm, src2 in rows)


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
    if (table.dim() != 2 or table.shape[1] != 4 or table.shape[0] == 0
            or ctx.dim() != 2 or ctx.shape[1] != CTX_LEN
            or meta.dim() != 2 or meta.shape[0] != 2 or meta.shape[1] == 0
            or maps.dim() != 1 or rb_cap < 0):
        raise ValueError(f"policy_exec: table{tuple(table.shape)} "
                         f"ctx{tuple(ctx.shape)} maps{tuple(maps.shape)} "
                         f"meta{tuple(meta.shape)} rb_cap {rb_cap}")


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p]


def load():
    """The kernel's C launcher, built at first use.  The hook registry
    calls it when it builds a CUDA batch backend (at ``warm``), so a build
    failure raises there and not inside a contained batch."""
    return build.function("policy_exec", "policy_exec_launch", _ARGTYPES)


def policy_exec(table, ctx, maps, meta, *, rb_cap: int, fuel: int,
                halt_returns_r0: bool) -> torch.Tensor:
    """Run the program ``table`` (:func:`pack_code`) on every ``[B,
    CTX_LEN]`` ctx row against ``maps``/``meta`` (:meth:`DeviceMaps.flat`);
    returns the ``[B, 3 + 5 rb_cap]`` int64 rows (module docstring).  CUDA
    tensors take one kernel launch; CPU tensors run
    :func:`policy_exec_plain`."""
    if not ctx.is_cuda:
        return policy_exec_plain(table, ctx, maps, meta, rb_cap=rb_cap,
                                 fuel=fuel, halt_returns_r0=halt_returns_r0)
    _check(table, ctx, maps, meta, rb_cap)
    if table.data_ptr() % 16:
        raise ValueError("policy_exec: the table must be 16-byte aligned")
    B = ctx.shape[0]
    out = torch.empty((B, 3 + RB_FIELDS * rb_cap), dtype=I64,
                      device=ctx.device)
    if B == 0:
        return out
    with torch.cuda.device(ctx.device):
        err = load()(table.data_ptr(), table.shape[0], ctx.data_ptr(), B,
                     maps.data_ptr(), meta.data_ptr(), meta.shape[1],
                     out.data_ptr(), rb_cap, fuel, int(halt_returns_r0),
                     torch.cuda.current_stream(ctx.device).cuda_stream)
    build.check(err, "policy_exec")
    policy_exec.launches += 1
    policy_exec.pc_walk_launches += bool(halt_returns_r0)
    return out


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
    the table's code and the flat maps' per-slot views."""
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
