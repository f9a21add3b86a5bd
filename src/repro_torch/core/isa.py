"""eBPF-flavored instruction set for userspace-loaded memory-management policies.

This is the TPU-framework analogue of the eBPF bytecode the paper loads into
the Linux page-fault path.  Policies are small register programs that read a
flat ``FaultContext`` struct (the "ctx" pointer of an eBPF program), may look
up bounded array maps (the analogue of eBPF maps holding the userspace
profile), and return the chosen page-size class in ``r0``.

Design notes (mirrors eBPF where it matters):
  * 11 general registers ``r0..r10``; ``r0`` is the return value.
  * 64-bit signed integer arithmetic, wrapping, with eBPF's safe-division
    semantics (``x / 0 == 0``, ``x % 0 == x``).
  * Forward conditional jumps only, plus a single verified bounded-loop
    primitive ``JNZDEC`` (decrement-and-branch-back) whose trip count the
    verifier must be able to bound — the moral equivalent of eBPF's
    bounded-loop support.
  * ``CALL`` invokes a white-listed helper (cf. ``bpf_*`` helpers).
  * Programs must be accepted by :mod:`repro.core.verifier` before they can
    be attached to a hook (load-time verification, like the kernel).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterable, Sequence

NUM_REGS = 11
R0 = 0  # return value
MAX_PROGRAM_LEN = 4096      # eBPF instruction-count limit
MAX_LOOP_ITERS = 64         # verifier bound for a single JNZDEC loop
MAX_SIM_INSNS = 100_000     # total verified instruction budget (cf. 1M in Linux)

INT64_MASK = (1 << 64) - 1


def _wrap64(x: int) -> int:
    """Wrap a python int to signed 64-bit, mirroring kernel u64/s64 math."""
    x &= INT64_MASK
    if x >= 1 << 63:
        x -= 1 << 64
    return x


class Op(enum.IntEnum):
    # ALU, register source
    MOV = 0
    ADD = 1
    SUB = 2
    MUL = 3
    DIV = 4      # safe: /0 -> 0
    MOD = 5      # safe: %0 -> lhs
    AND = 6
    OR = 7
    XOR = 8
    LSH = 9
    RSH = 10     # logical shift right on the 64-bit pattern
    MIN = 11
    MAX = 12
    # ALU, immediate source
    MOVI = 16
    ADDI = 17
    SUBI = 18
    MULI = 19
    DIVI = 20
    MODI = 21
    ANDI = 22
    ORI = 23
    XORI = 24
    LSHI = 25
    RSHI = 26
    MINI = 27
    MAXI = 28
    NEG = 29
    # Loads
    LDCTX = 32   # rd = ctx[imm]
    LDMAP = 33   # rd = map[src2][clamp(rs)]   (imm = map id, rs = index reg)
    MAPSZ = 34   # rd = len(map[imm])
    LDMAPX = 35  # rd = map[clamp(r_src2=imm reg)][clamp(rs)] — indirect map id
                 # (map-in-map analogue; both indices runtime-clamped)
    LDCTXR = 36  # rd = ctx[clamp(rs)] — REGISTER-indexed ctx load.  The
                 # verifier requires rs to be initialized and rejects a
                 # const-tracked index outside [0, CTX_LEN); every backend
                 # lowers the residual dynamic case with the same clamp.
    # Control flow — conditional jumps compare rs against rt (reg) or imm.
    JA = 48      # unconditional forward jump by +imm
    JEQ = 49
    JNE = 50
    JLT = 51
    JLE = 52
    JGT = 53
    JGE = 54
    JSET = 55    # jump if (rs & operand) != 0
    JEQI = 56
    JNEI = 57
    JLTI = 58
    JLEI = 59
    JGTI = 60
    JGEI = 61
    JSETI = 62
    JNZDEC = 63  # rd -= 1; if rd != 0 jump BACK by -imm (verified bounded loop)
    # Misc
    CALL = 80    # helper call, imm = helper id; args r1..r5, ret r0
    EXIT = 81    # return r0


# Ops whose "imm" field is a jump offset.
JUMP_OPS = frozenset({
    Op.JA, Op.JEQ, Op.JNE, Op.JLT, Op.JLE, Op.JGT, Op.JGE, Op.JSET,
    Op.JEQI, Op.JNEI, Op.JLTI, Op.JLEI, Op.JGTI, Op.JGEI, Op.JSETI,
})
COND_JUMP_REG = frozenset({Op.JEQ, Op.JNE, Op.JLT, Op.JLE, Op.JGT, Op.JGE, Op.JSET})
COND_JUMP_IMM = frozenset({Op.JEQI, Op.JNEI, Op.JLTI, Op.JLEI, Op.JGTI, Op.JGEI, Op.JSETI})
ALU_REG_OPS = frozenset({Op.MOV, Op.ADD, Op.SUB, Op.MUL, Op.DIV, Op.MOD, Op.AND,
                         Op.OR, Op.XOR, Op.LSH, Op.RSH, Op.MIN, Op.MAX})
ALU_IMM_OPS = frozenset({Op.MOVI, Op.ADDI, Op.SUBI, Op.MULI, Op.DIVI, Op.MODI,
                         Op.ANDI, Op.ORI, Op.XORI, Op.LSHI, Op.RSHI, Op.MINI,
                         Op.MAXI})


@dataclass(frozen=True)
class Insn:
    """One instruction. Fields are used per-op:

    op     : opcode
    dst    : destination register (or counter register for JNZDEC)
    src    : source register (ALU reg forms, cond-jump rhs, LDMAP index reg)
    imm    : immediate / ctx offset / map id / jump offset / helper id
    src2   : secondary immediate (LDMAP map id)
    """
    op: Op
    dst: int = 0
    src: int = 0
    imm: int = 0
    src2: int = 0

    def __repr__(self) -> str:  # compact disassembly, used in error messages
        return f"{self.op.name}(dst=r{self.dst}, src=r{self.src}, imm={self.imm}, src2={self.src2})"


class Program:
    """A sequence of instructions plus the maps it references."""

    def __init__(self, insns: Sequence[Insn], name: str = "policy") -> None:
        self.insns: list[Insn] = list(insns)
        self.name = name

    def __len__(self) -> int:
        return len(self.insns)

    def __iter__(self) -> Iterable[Insn]:
        return iter(self.insns)

    def disassemble(self) -> str:
        return "\n".join(f"{i:4d}: {insn!r}" for i, insn in enumerate(self.insns))


class Asm:
    """Tiny assembler with labels, so policies read like eBPF assembly.

    Example::

        a = Asm()
        a.ldctx("r1", CTX.FREE_BLOCKS_0)
        a.jeqi("r1", 0, "no_free")
        a.movi("r0", 2)
        a.exit()
        a.label("no_free")
        a.movi("r0", 0)
        a.exit()
        prog = a.build("my_policy")
    """

    def __init__(self) -> None:
        self._insns: list[tuple] = []   # (op, dst, src, imm_or_label, src2)
        self._labels: dict[str, int] = {}

    # -- label handling -------------------------------------------------
    def label(self, name: str) -> "Asm":
        if name in self._labels:
            raise ValueError(f"duplicate label {name!r}")
        self._labels[name] = len(self._insns)
        return self

    @staticmethod
    def _reg(r) -> int:
        if isinstance(r, str):
            if not r.startswith("r"):
                raise ValueError(f"bad register {r!r}")
            r = int(r[1:])
        if not 0 <= r < NUM_REGS:
            raise ValueError(f"register out of range: r{r}")
        return r

    def _emit(self, op: Op, dst=0, src=0, imm=0, src2=0) -> "Asm":
        self._insns.append((op, self._reg(dst),
                            self._reg(src) if isinstance(src, str) else src,
                            imm, src2))
        return self

    # -- ALU ------------------------------------------------------------
    def mov(self, d, s):  return self._emit(Op.MOV, d, self._reg(s))
    def movi(self, d, imm): return self._emit(Op.MOVI, d, 0, imm)
    def add(self, d, s):  return self._emit(Op.ADD, d, self._reg(s))
    def addi(self, d, imm): return self._emit(Op.ADDI, d, 0, imm)
    def sub(self, d, s):  return self._emit(Op.SUB, d, self._reg(s))
    def subi(self, d, imm): return self._emit(Op.SUBI, d, 0, imm)
    def mul(self, d, s):  return self._emit(Op.MUL, d, self._reg(s))
    def muli(self, d, imm): return self._emit(Op.MULI, d, 0, imm)
    def div(self, d, s):  return self._emit(Op.DIV, d, self._reg(s))
    def divi(self, d, imm): return self._emit(Op.DIVI, d, 0, imm)
    def mod(self, d, s):  return self._emit(Op.MOD, d, self._reg(s))
    def modi(self, d, imm): return self._emit(Op.MODI, d, 0, imm)
    def and_(self, d, s): return self._emit(Op.AND, d, self._reg(s))
    def andi(self, d, imm): return self._emit(Op.ANDI, d, 0, imm)
    def or_(self, d, s):  return self._emit(Op.OR, d, self._reg(s))
    def ori(self, d, imm): return self._emit(Op.ORI, d, 0, imm)
    def xor(self, d, s):  return self._emit(Op.XOR, d, self._reg(s))
    def xori(self, d, imm): return self._emit(Op.XORI, d, 0, imm)
    def lsh(self, d, s):  return self._emit(Op.LSH, d, self._reg(s))
    def lshi(self, d, imm): return self._emit(Op.LSHI, d, 0, imm)
    def rsh(self, d, s):  return self._emit(Op.RSH, d, self._reg(s))
    def rshi(self, d, imm): return self._emit(Op.RSHI, d, 0, imm)
    def min_(self, d, s): return self._emit(Op.MIN, d, self._reg(s))
    def mini(self, d, imm): return self._emit(Op.MINI, d, 0, imm)
    def max_(self, d, s): return self._emit(Op.MAX, d, self._reg(s))
    def maxi(self, d, imm): return self._emit(Op.MAXI, d, 0, imm)
    def neg(self, d):     return self._emit(Op.NEG, d)

    # -- loads ------------------------------------------------------------
    def ldctx(self, d, off: int): return self._emit(Op.LDCTX, d, 0, int(off))
    def ldctxr(self, d, idx_reg): return self._emit(Op.LDCTXR, d, self._reg(idx_reg))
    def ldmap(self, d, map_id: int, idx_reg): return self._emit(Op.LDMAP, d, self._reg(idx_reg), 0, int(map_id))
    def ldmapx(self, d, map_reg, idx_reg):
        return self._emit(Op.LDMAPX, d, self._reg(idx_reg), 0,
                          self._reg(map_reg))
    def mapsz(self, d, map_id: int): return self._emit(Op.MAPSZ, d, 0, int(map_id))

    # -- control flow ------------------------------------------------------
    def ja(self, target: str): return self._emit(Op.JA, 0, 0, target)
    def jeq(self, a, b, t):  return self._emit(Op.JEQ, self._reg(a), self._reg(b), t)
    def jne(self, a, b, t):  return self._emit(Op.JNE, self._reg(a), self._reg(b), t)
    def jlt(self, a, b, t):  return self._emit(Op.JLT, self._reg(a), self._reg(b), t)
    def jle(self, a, b, t):  return self._emit(Op.JLE, self._reg(a), self._reg(b), t)
    def jgt(self, a, b, t):  return self._emit(Op.JGT, self._reg(a), self._reg(b), t)
    def jge(self, a, b, t):  return self._emit(Op.JGE, self._reg(a), self._reg(b), t)
    def jset(self, a, b, t): return self._emit(Op.JSET, self._reg(a), self._reg(b), t)
    def jeqi(self, a, imm, t):  return self._emit(Op.JEQI, self._reg(a), 0, t, imm)
    def jnei(self, a, imm, t):  return self._emit(Op.JNEI, self._reg(a), 0, t, imm)
    def jlti(self, a, imm, t):  return self._emit(Op.JLTI, self._reg(a), 0, t, imm)
    def jlei(self, a, imm, t):  return self._emit(Op.JLEI, self._reg(a), 0, t, imm)
    def jgti(self, a, imm, t):  return self._emit(Op.JGTI, self._reg(a), 0, t, imm)
    def jgei(self, a, imm, t):  return self._emit(Op.JGEI, self._reg(a), 0, t, imm)
    def jseti(self, a, imm, t): return self._emit(Op.JSETI, self._reg(a), 0, t, imm)
    def jnzdec(self, counter, target: str):
        return self._emit(Op.JNZDEC, self._reg(counter), 0, target)

    # -- misc ------------------------------------------------------------
    def call(self, helper_id: int): return self._emit(Op.CALL, 0, 0, int(helper_id))
    def exit(self): return self._emit(Op.EXIT)

    # -- build -----------------------------------------------------------
    def build(self, name: str = "policy") -> Program:
        insns: list[Insn] = []
        for pc, (op, dst, src, imm, src2) in enumerate(self._insns):
            if op in JUMP_OPS or op == Op.JNZDEC:
                # For conditional-immediate jumps the comparison immediate was
                # stashed in src2 by the assembler helpers above.
                if isinstance(imm, str):
                    if imm not in self._labels:
                        raise ValueError(f"undefined label {imm!r}")
                    target = self._labels[imm]
                    off = target - (pc + 1)
                else:
                    off = int(imm)
                if op == Op.JNZDEC:
                    if off >= 0:
                        raise ValueError(f"JNZDEC at {pc} must jump backward (got {off})")
                else:
                    if off < 0:
                        raise ValueError(
                            f"{op.name} at {pc}: backward jumps are only allowed "
                            f"via JNZDEC (got offset {off})")
                cmp_imm = src2 if op in COND_JUMP_IMM else 0
                insns.append(Insn(op, dst, src, off, cmp_imm))
            else:
                insns.append(Insn(op, dst, src, _wrap64(int(imm)) if not isinstance(imm, str) else 0, src2))
        return Program(insns, name)
