"""Atomic functional simulator (the paper's gem5 AtomicSimple stand-in).

Executes a program at register/memory semantics with no timing: every
instruction completes in one atomic step.  Produces the dynamic
instruction trace the slicer consumes, plus architectural register
snapshots at requested trace positions (context matrices for the
predictor).

Two interpreters share the same semantics:

``run_compiled``
    the production path: a table-dispatched interpreter over a
    ``CompiledProgram`` (one precompiled closure per static instruction,
    register files as flat lists in ``CONTEXT_REGS`` slot order) emitting
    a columnar ``Trace`` — no per-step dataclass allocation, no dict
    lookups, snapshots as uint64 matrix rows.

``run_reference``
    the original object interpreter (``step`` over ``Instruction``,
    ``List[TraceEntry]`` out).  Kept verbatim as the differential-testing
    golden model and the pre-IR performance baseline.

``run`` keeps the historical object API but executes on the columnar
interpreter, converting at the boundary (and falling back to the
reference path for programs the SoA encoding cannot represent).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from capsim_bench.frontend.compiled import (CIA_SLOT, CR_SLOT, CTR_SLOT, LR_SLOT,
                                N_IREGS, NIA_SLOT, CompiledProgram,
                                CompileError, Trace, compile_program)
from capsim_bench.frontend.isa import CONTEXT_REGS, Instruction

MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class MachineState:
    regs: Dict[str, int]
    fregs: Dict[str, float]
    mem: Dict[int, int]

    @classmethod
    def fresh(cls) -> "MachineState":
        regs = {f"R{i}": 0 for i in range(32)}
        regs.update({"CR": 0, "LR": 0, "CTR": 0, "XER": 0, "FPSCR": 0,
                     "VSCR": 0, "CIA": 0, "NIA": 0})
        fregs = {f"F{i}": 0.0 for i in range(32)}
        return cls(regs=regs, fregs=fregs, mem={})

    def snapshot_context(self) -> Dict[str, int]:
        return {r: self.regs[r] & MASK64 for r in CONTEXT_REGS}


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    pc: int
    inst: Instruction
    ea: Optional[int]          # effective address for mem ops
    taken: Optional[bool]      # branch outcome


@dataclasses.dataclass
class CompiledState:
    """Columnar architectural state: flat register files in slot order
    (``iregs[i]`` is ``CONTEXT_REGS[i]``), shared memory dict."""

    iregs: List[int]                           # len N_IREGS
    fregs: List[float]                         # len 32
    mem: Dict[int, int]

    @classmethod
    def fresh(cls) -> "CompiledState":
        return cls(iregs=[0] * N_IREGS, fregs=[0.0] * 32, mem={})

    @classmethod
    def from_machine(cls, st: MachineState) -> "CompiledState":
        """Adopts ``st.mem`` by reference (mutations stay shared)."""
        return cls(iregs=[st.regs[r] for r in CONTEXT_REGS],
                   fregs=[st.fregs[f"F{i}"] for i in range(32)],
                   mem=st.mem)

    def to_machine(self) -> MachineState:
        st = MachineState.fresh()
        st.mem = self.mem
        self.write_back(st)
        return st

    def write_back(self, st: MachineState) -> None:
        for i, r in enumerate(CONTEXT_REGS):
            st.regs[r] = self.iregs[i]
        for i in range(32):
            st.fregs[f"F{i}"] = self.fregs[i]

    def clone(self) -> "CompiledState":
        """Replay anchor: independent copy (mem is a flat int dict)."""
        return CompiledState(iregs=list(self.iregs), fregs=list(self.fregs),
                             mem=dict(self.mem))

    def snapshot_context(self) -> Dict[str, int]:
        return {r: self.iregs[i] & MASK64
                for i, r in enumerate(CONTEXT_REGS)}


def _val(st: MachineState, name: str):
    if name.startswith("F"):
        return st.fregs[name]
    return st.regs[name]


def _setval(st: MachineState, name: str, v):
    if name.startswith("F"):
        st.fregs[name] = float(v)
    else:
        st.regs[name] = int(v) & MASK64


def _sext(v: int) -> int:
    v &= MASK64
    return v - (1 << 64) if v >> 63 else v


def step(st: MachineState, pc: int, inst: Instruction
         ) -> Tuple[int, Optional[int], Optional[bool]]:
    """Execute one instruction; returns (next_pc, effective_addr, taken)."""
    op = inst.op
    s = inst.srcs
    ea = None
    taken = None
    next_pc = pc + 1
    st.regs["CIA"] = pc

    if op == "addi":
        _setval(st, inst.dsts[0], _val(st, s[0]) + inst.imm if s
                else inst.imm)
    elif op == "add":
        _setval(st, inst.dsts[0], _val(st, s[0]) + _val(st, s[1]))
    elif op == "subf":
        _setval(st, inst.dsts[0], _val(st, s[1]) - _val(st, s[0]))
    elif op == "neg":
        _setval(st, inst.dsts[0], -_val(st, s[0]))
    elif op == "and":
        _setval(st, inst.dsts[0], _val(st, s[0]) & _val(st, s[1]))
    elif op == "or":
        _setval(st, inst.dsts[0], _val(st, s[0]) | _val(st, s[1]))
    elif op == "xor":
        _setval(st, inst.dsts[0], _val(st, s[0]) ^ _val(st, s[1]))
    elif op in ("rldicl", "sld"):
        sh = inst.imm if inst.imm is not None else (_val(st, s[1]) & 63)
        _setval(st, inst.dsts[0], (_val(st, s[0]) << sh) & MASK64)
    elif op == "srd":
        sh = inst.imm if inst.imm is not None else (_val(st, s[1]) & 63)
        _setval(st, inst.dsts[0], (_val(st, s[0]) & MASK64) >> sh)
    elif op == "extsw":
        v = _val(st, s[0]) & 0xFFFFFFFF
        _setval(st, inst.dsts[0], v - (1 << 32) if v >> 31 else v)
    elif op in ("mulld", "mulhd"):
        prod = _sext(_val(st, s[0])) * _sext(_val(st, s[1]))
        _setval(st, inst.dsts[0],
                prod if op == "mulld" else (prod >> 64))
    elif op in ("divd", "modsd"):
        a, b = _sext(_val(st, s[0])), _sext(_val(st, s[1]))
        b = b if b != 0 else 1
        q, r = abs(a) // abs(b), abs(a) % abs(b)
        if (a < 0) != (b < 0):
            q = -q
        _setval(st, inst.dsts[0], q if op == "divd" else r)
    elif op in ("cmpi", "cmpl", "cmpd"):
        a = _sext(_val(st, s[0]))
        b = inst.imm if op == "cmpi" else _sext(_val(st, s[1]))
        st.regs["CR"] = (4 if a < b else (2 if a > b else 1))
    elif op == "fcmpu":
        a, b = _val(st, s[0]), _val(st, s[1])
        st.regs["CR"] = (4 if a < b else (2 if a > b else 1))
    elif op in ("ld", "lwz", "lbz"):
        ea = (_val(st, inst.mem_base) + inst.mem_offset) & MASK64
        v = st.mem.get(ea >> 3, 0)
        if op == "lwz":
            v &= 0xFFFFFFFF
        elif op == "lbz":
            v &= 0xFF
        _setval(st, inst.dsts[0], v)
    elif op == "lfd":
        ea = (_val(st, inst.mem_base) + inst.mem_offset) & MASK64
        raw = st.mem.get(ea >> 3, 0)
        st.fregs[inst.dsts[0]] = float(_sext(raw)) * 2.0 ** -16
    elif op in ("std", "stw", "stb"):
        ea = (_val(st, inst.mem_base) + inst.mem_offset) & MASK64
        st.mem[ea >> 3] = _val(st, s[0]) & MASK64
    elif op == "stfd":
        ea = (_val(st, inst.mem_base) + inst.mem_offset) & MASK64
        st.mem[ea >> 3] = int(st.fregs[s[0]] * 2 ** 16) & MASK64
    elif op in ("fadd", "fsub", "fmul", "fmadd", "fdiv", "fsqrt", "fmr"):
        a = st.fregs[s[0]]
        if op == "fadd":
            r = a + st.fregs[s[1]]
        elif op == "fsub":
            r = a - st.fregs[s[1]]
        elif op == "fmul":
            r = a * st.fregs[s[1]]
        elif op == "fmadd":
            r = a * st.fregs[s[1]] + st.fregs[s[2]]
        elif op == "fdiv":
            d = st.fregs[s[1]]
            r = a / d if abs(d) > 1e-30 else 0.0
        elif op == "fsqrt":
            r = abs(a) ** 0.5
        else:
            r = a
        if abs(r) > 1e30:
            r = 0.0
        st.fregs[inst.dsts[0]] = r
    elif op == "b":
        next_pc = inst.target
        taken = True
    elif op == "bc":
        # branch if CR bit set per imm: 0 -> lt(4), 1 -> gt(2), 2 -> eq(1),
        # 3 -> not-eq
        cr = st.regs["CR"]
        cond = {0: cr & 4, 1: cr & 2, 2: cr & 1, 3: (cr & 1) == 0}[
            inst.imm or 0]
        taken = bool(cond)
        if taken:
            next_pc = inst.target
    elif op == "bl":
        st.regs["LR"] = pc + 1
        next_pc = inst.target
        taken = True
    elif op == "blr":
        next_pc = st.regs["LR"]
        taken = True
    elif op == "bdnz":
        st.regs["CTR"] = (st.regs["CTR"] - 1) & MASK64
        taken = st.regs["CTR"] != 0
        if taken:
            next_pc = inst.target
    elif op == "mtctr":
        st.regs["CTR"] = _val(st, s[0])
    elif op == "mtlr":
        st.regs["LR"] = _val(st, s[0])
    elif op == "mflr":
        _setval(st, inst.dsts[0], st.regs["LR"])
    elif op == "nop":
        pass
    else:
        raise ValueError(f"unimplemented opcode {op}")

    st.regs["NIA"] = next_pc
    return next_pc, ea, taken


# --------------------------------------------------------------------------- #
# Table-dispatched columnar interpreter
# --------------------------------------------------------------------------- #
#
# One closure per *static* instruction: operand slots, immediates, and
# targets are baked in at compile time, so the per-step work is a single
# ``handlers[pc](...)`` call doing flat list indexing.  Every handler
# returns ``(next_pc, ea, taken)`` with ``ea=0`` for non-memory ops and
# ``taken=-1`` for non-branches — the columnar encoding of the object
# interpreter's ``(next_pc, None, None)``.

def _ir_slot(slot: int, what: str) -> int:
    if not 0 <= slot < N_IREGS:
        raise CompileError(f"{what} must be an integer register")
    return slot


def _fr_slot(slot: int, what: str) -> int:
    if slot < N_IREGS:
        raise CompileError(f"{what} must be a float register")
    return slot - N_IREGS


def _make_handler(op: str, d, s, imm, mb, mo, tgt):
    """Build the closure for one static instruction.

    ``d`` is the first destination slot (-1 if none), ``s`` the tuple of
    source slots, ``imm`` the immediate or None, ``mb``/``mo`` the memory
    base slot (-1 if none) and offset, ``tgt`` the branch target or None.
    """
    if op == "addi":
        di = _ir_slot(d, "addi dst")
        if s:
            s0 = _ir_slot(s[0], "addi src")
            def h(ir, fr, mem, pc, di=di, s0=s0, imm=imm):
                ir[di] = (ir[s0] + imm) & MASK64
                return pc + 1, 0, -1
        else:
            val = int(imm) & MASK64
            def h(ir, fr, mem, pc, di=di, val=val):
                ir[di] = val
                return pc + 1, 0, -1
        return h
    if op in ("add", "and", "or", "xor", "subf"):
        di = _ir_slot(d, f"{op} dst")
        s0, s1 = (_ir_slot(x, f"{op} src") for x in s[:2])
        ops = {"add": lambda a, b: a + b, "and": lambda a, b: a & b,
               "or": lambda a, b: a | b, "xor": lambda a, b: a ^ b,
               "subf": lambda a, b: b - a}
        fn = ops[op]
        def h(ir, fr, mem, pc, di=di, s0=s0, s1=s1, fn=fn):
            ir[di] = fn(ir[s0], ir[s1]) & MASK64
            return pc + 1, 0, -1
        return h
    if op == "neg":
        di = _ir_slot(d, "neg dst")
        s0 = _ir_slot(s[0], "neg src")
        def h(ir, fr, mem, pc, di=di, s0=s0):
            ir[di] = (-ir[s0]) & MASK64
            return pc + 1, 0, -1
        return h
    if op in ("rldicl", "sld", "srd"):
        di = _ir_slot(d, f"{op} dst")
        s0 = _ir_slot(s[0], f"{op} src")
        left = op != "srd"
        if imm is not None:
            sh = int(imm)
            if left:
                def h(ir, fr, mem, pc, di=di, s0=s0, sh=sh):
                    ir[di] = (ir[s0] << sh) & MASK64
                    return pc + 1, 0, -1
            else:
                def h(ir, fr, mem, pc, di=di, s0=s0, sh=sh):
                    ir[di] = ir[s0] >> sh
                    return pc + 1, 0, -1
        else:
            s1 = _ir_slot(s[1], f"{op} shift src")
            if left:
                def h(ir, fr, mem, pc, di=di, s0=s0, s1=s1):
                    ir[di] = (ir[s0] << (ir[s1] & 63)) & MASK64
                    return pc + 1, 0, -1
            else:
                def h(ir, fr, mem, pc, di=di, s0=s0, s1=s1):
                    ir[di] = ir[s0] >> (ir[s1] & 63)
                    return pc + 1, 0, -1
        return h
    if op == "extsw":
        di = _ir_slot(d, "extsw dst")
        s0 = _ir_slot(s[0], "extsw src")
        def h(ir, fr, mem, pc, di=di, s0=s0):
            v = ir[s0] & 0xFFFFFFFF
            ir[di] = ((v - (1 << 32)) if v >> 31 else v) & MASK64
            return pc + 1, 0, -1
        return h
    if op in ("mulld", "mulhd"):
        di = _ir_slot(d, f"{op} dst")
        s0, s1 = (_ir_slot(x, f"{op} src") for x in s[:2])
        high = op == "mulhd"
        def h(ir, fr, mem, pc, di=di, s0=s0, s1=s1, high=high):
            prod = _sext(ir[s0]) * _sext(ir[s1])
            ir[di] = ((prod >> 64) if high else prod) & MASK64
            return pc + 1, 0, -1
        return h
    if op in ("divd", "modsd"):
        di = _ir_slot(d, f"{op} dst")
        s0, s1 = (_ir_slot(x, f"{op} src") for x in s[:2])
        want_mod = op == "modsd"
        def h(ir, fr, mem, pc, di=di, s0=s0, s1=s1, want_mod=want_mod):
            a, b = _sext(ir[s0]), _sext(ir[s1])
            b = b if b != 0 else 1
            q, r = abs(a) // abs(b), abs(a) % abs(b)
            if (a < 0) != (b < 0):
                q = -q
            ir[di] = (r if want_mod else q) & MASK64
            return pc + 1, 0, -1
        return h
    if op in ("cmpi", "cmpl", "cmpd"):
        s0 = _ir_slot(s[0], f"{op} src")
        if op == "cmpi":
            b_imm = int(imm) if imm is not None else None
            if b_imm is None:
                raise CompileError("cmpi without immediate")
            def h(ir, fr, mem, pc, s0=s0, b=b_imm):
                a = _sext(ir[s0])
                ir[CR_SLOT] = 4 if a < b else (2 if a > b else 1)
                return pc + 1, 0, -1
        else:
            s1 = _ir_slot(s[1], f"{op} src")
            def h(ir, fr, mem, pc, s0=s0, s1=s1):
                a, b = _sext(ir[s0]), _sext(ir[s1])
                ir[CR_SLOT] = 4 if a < b else (2 if a > b else 1)
                return pc + 1, 0, -1
        return h
    if op == "fcmpu":
        f0, f1 = (_fr_slot(x, "fcmpu src") for x in s[:2])
        def h(ir, fr, mem, pc, f0=f0, f1=f1):
            a, b = fr[f0], fr[f1]
            ir[CR_SLOT] = 4 if a < b else (2 if a > b else 1)
            return pc + 1, 0, -1
        return h
    if op in ("ld", "lwz", "lbz"):
        di = _ir_slot(d, f"{op} dst")
        base = _ir_slot(mb, f"{op} base")
        mask = {"ld": MASK64, "lwz": 0xFFFFFFFF, "lbz": 0xFF}[op]
        def h(ir, fr, mem, pc, di=di, base=base, off=mo, mask=mask):
            ea = (ir[base] + off) & MASK64
            ir[di] = mem.get(ea >> 3, 0) & mask
            return pc + 1, ea, -1
        return h
    if op == "lfd":
        fd = _fr_slot(d, "lfd dst")
        base = _ir_slot(mb, "lfd base")
        def h(ir, fr, mem, pc, fd=fd, base=base, off=mo):
            ea = (ir[base] + off) & MASK64
            fr[fd] = float(_sext(mem.get(ea >> 3, 0))) * 2.0 ** -16
            return pc + 1, ea, -1
        return h
    if op in ("std", "stw", "stb"):
        s0 = _ir_slot(s[0], f"{op} src")
        base = _ir_slot(mb, f"{op} base")
        def h(ir, fr, mem, pc, s0=s0, base=base, off=mo):
            ea = (ir[base] + off) & MASK64
            mem[ea >> 3] = ir[s0] & MASK64
            return pc + 1, ea, -1
        return h
    if op == "stfd":
        f0 = _fr_slot(s[0], "stfd src")
        base = _ir_slot(mb, "stfd base")
        def h(ir, fr, mem, pc, f0=f0, base=base, off=mo):
            ea = (ir[base] + off) & MASK64
            mem[ea >> 3] = int(fr[f0] * 2 ** 16) & MASK64
            return pc + 1, ea, -1
        return h
    if op in ("fadd", "fsub", "fmul", "fdiv"):
        fd = _fr_slot(d, f"{op} dst")
        f0, f1 = (_fr_slot(x, f"{op} src") for x in s[:2])
        ops = {"fadd": lambda a, b: a + b, "fsub": lambda a, b: a - b,
               "fmul": lambda a, b: a * b,
               "fdiv": lambda a, b: a / b if abs(b) > 1e-30 else 0.0}
        fn = ops[op]
        def h(ir, fr, mem, pc, fd=fd, f0=f0, f1=f1, fn=fn):
            r = fn(fr[f0], fr[f1])
            if abs(r) > 1e30:
                r = 0.0
            fr[fd] = r
            return pc + 1, 0, -1
        return h
    if op == "fmadd":
        fd = _fr_slot(d, "fmadd dst")
        f0, f1, f2 = (_fr_slot(x, "fmadd src") for x in s[:3])
        def h(ir, fr, mem, pc, fd=fd, f0=f0, f1=f1, f2=f2):
            r = fr[f0] * fr[f1] + fr[f2]
            if abs(r) > 1e30:
                r = 0.0
            fr[fd] = r
            return pc + 1, 0, -1
        return h
    if op in ("fsqrt", "fmr"):
        fd = _fr_slot(d, f"{op} dst")
        f0 = _fr_slot(s[0], f"{op} src")
        root = op == "fsqrt"
        def h(ir, fr, mem, pc, fd=fd, f0=f0, root=root):
            r = abs(fr[f0]) ** 0.5 if root else fr[f0]
            if abs(r) > 1e30:
                r = 0.0
            fr[fd] = r
            return pc + 1, 0, -1
        return h
    if op == "b":
        if tgt is None:
            raise CompileError("b without target")
        def h(ir, fr, mem, pc, tgt=tgt):
            return tgt, 0, 1
        return h
    if op == "bc":
        if tgt is None:
            raise CompileError("bc without target")
        cond = int(imm or 0)
        if cond not in (0, 1, 2, 3):
            raise CompileError(f"bc condition {cond} out of range")
        bit = {0: 4, 1: 2, 2: 1}.get(cond)
        if bit is not None:
            def h(ir, fr, mem, pc, tgt=tgt, bit=bit):
                if ir[CR_SLOT] & bit:
                    return tgt, 0, 1
                return pc + 1, 0, 0
        else:                                  # cond 3: not-eq
            def h(ir, fr, mem, pc, tgt=tgt):
                if ir[CR_SLOT] & 1:
                    return pc + 1, 0, 0
                return tgt, 0, 1
        return h
    if op == "bl":
        if tgt is None:
            raise CompileError("bl without target")
        def h(ir, fr, mem, pc, tgt=tgt):
            ir[LR_SLOT] = pc + 1
            return tgt, 0, 1
        return h
    if op == "blr":
        def h(ir, fr, mem, pc):
            return ir[LR_SLOT], 0, 1
        return h
    if op == "bdnz":
        if tgt is None:
            raise CompileError("bdnz without target")
        def h(ir, fr, mem, pc, tgt=tgt):
            ctr = (ir[CTR_SLOT] - 1) & MASK64
            ir[CTR_SLOT] = ctr
            if ctr:
                return tgt, 0, 1
            return pc + 1, 0, 0
        return h
    if op in ("mtctr", "mtlr"):
        s0 = _ir_slot(s[0], f"{op} src")
        dst_slot = CTR_SLOT if op == "mtctr" else LR_SLOT
        def h(ir, fr, mem, pc, s0=s0, dst_slot=dst_slot):
            ir[dst_slot] = ir[s0]
            return pc + 1, 0, -1
        return h
    if op == "mflr":
        di = _ir_slot(d, "mflr dst")
        def h(ir, fr, mem, pc, di=di):
            ir[di] = ir[LR_SLOT] & MASK64
            return pc + 1, 0, -1
        return h
    if op == "nop":
        def h(ir, fr, mem, pc):
            return pc + 1, 0, -1
        return h
    raise CompileError(f"no columnar handler for opcode {op!r}")


def build_handlers(cprog: CompiledProgram) -> list:
    """One closure per static instruction, cached on the program."""
    if cprog._handlers is None:
        handlers = []
        for i, inst in enumerate(cprog.insts):
            d = int(cprog.dsts[i, 0])
            s = tuple(int(x) for x in cprog.srcs[i] if x >= 0)
            imm = int(cprog.imm[i]) if cprog.has_imm[i] else None
            mb = int(cprog.mem_base[i])
            mo = int(cprog.mem_offset[i])
            tgt = int(cprog.target[i]) if cprog.has_target[i] else None
            handlers.append(_make_handler(inst.op, d, s, imm, mb, mo, tgt))
        cprog._handlers = handlers
    return cprog._handlers


def run_compiled(cprog: CompiledProgram, max_instructions: int,
                 state: Optional[CompiledState] = None,
                 snapshot_every: Optional[int] = None,
                 snapshot_at: Optional[Sequence[int]] = None,
                 start_pc: int = 0) -> Tuple[Trace, CompiledState]:
    """Columnar ``run``: execute until program exit or
    ``max_instructions``, returning ``(Trace, state)``.

    Snapshot semantics match ``run_reference``: with ``snapshot_every``,
    row i of ``trace.snapshots`` is the architectural context BEFORE
    trace position ``i*snapshot_every``; with ``snapshot_at`` (sorted
    trace positions), one row per requested position.

    ``start_pc`` resumes execution mid-program (the multicore quantum
    scheduler's hook): after any call that retired >= 1 instruction the
    next pc is ``state.iregs[NIA_SLOT]``, so
    ``run_compiled(cprog, q, st, start_pc=st.iregs[NIA_SLOT])`` continues
    exactly where the previous quantum stopped.
    """
    st = state or CompiledState.fresh()
    handlers = build_handlers(cprog)
    ir, fr, mem = st.iregs, st.fregs, st.mem
    n_static = cprog.n_static
    pcs: List[int] = []
    eas: List[int] = []
    takens: List[int] = []
    snaps: List[List[int]] = []
    at = list(snapshot_at) if snapshot_at is not None else None
    at_i = 0
    at_n = len(at) if at is not None else 0
    every = snapshot_every or 0
    next_every = 0 if every else -1
    pc = start_pc
    n = 0
    pcs_append, eas_append = pcs.append, eas.append
    takens_append = takens.append
    while 0 <= pc < n_static and n < max_instructions:
        if n == next_every:
            snaps.append(ir.copy())
            next_every += every
        if at_i < at_n:
            while at_i < at_n and at[at_i] == n:
                snaps.append(ir.copy())
                at_i += 1
        ir[CIA_SLOT] = pc
        next_pc, ea, taken = handlers[pc](ir, fr, mem, pc)
        ir[NIA_SLOT] = next_pc
        pcs_append(pc)
        eas_append(ea)
        takens_append(taken)
        pc = next_pc
        n += 1
    trace = Trace(
        program=cprog,
        pc=np.array(pcs, np.int32),
        ea=np.array(eas, np.uint64),
        taken=np.array(takens, np.int8),
        snapshots=np.array(snaps, np.uint64).reshape(len(snaps), N_IREGS))
    return trace, st


def run_reference(program: Sequence[Instruction], max_instructions: int,
                  state: Optional[MachineState] = None,
                  snapshot_every: Optional[int] = None,
                  snapshot_at: Optional[Sequence[int]] = None
                  ) -> Tuple[List[TraceEntry], List[Dict[str, int]],
                             MachineState]:
    """The original object interpreter (golden model / perf baseline)."""
    st = state or MachineState.fresh()
    trace: List[TraceEntry] = []
    snapshots: List[Dict[str, int]] = []
    at = list(snapshot_at) if snapshot_at is not None else None
    at_i = 0
    pc = 0
    n = 0
    while 0 <= pc < len(program) and n < max_instructions:
        if snapshot_every and n % snapshot_every == 0:
            snapshots.append(st.snapshot_context())
        if at is not None:
            while at_i < len(at) and at[at_i] == n:
                snapshots.append(st.snapshot_context())
                at_i += 1
        inst = program[pc]
        next_pc, ea, taken = step(st, pc, inst)
        trace.append(TraceEntry(pc=pc, inst=inst, ea=ea, taken=taken))
        pc = next_pc
        n += 1
    return trace, snapshots, st


def run(program: Sequence[Instruction], max_instructions: int,
        state: Optional[MachineState] = None,
        snapshot_every: Optional[int] = None,
        snapshot_at: Optional[Sequence[int]] = None
        ) -> Tuple[List[TraceEntry], List[Dict[str, int]], MachineState]:
    """Object-API adapter over the columnar interpreter.

    Same signature and results as ``run_reference`` (the passed
    ``MachineState`` is mutated in place and returned); programs the SoA
    encoding cannot represent fall back to the object path.
    """
    st = state or MachineState.fresh()
    try:
        cprog = compile_program(program)
        cst = CompiledState.from_machine(st)
        trace, cst = run_compiled(cprog, max_instructions, cst,
                                  snapshot_every=snapshot_every,
                                  snapshot_at=snapshot_at)
    except CompileError:
        return run_reference(program, max_instructions, state=st,
                             snapshot_every=snapshot_every,
                             snapshot_at=snapshot_at)
    cst.write_back(st)
    return trace.entries(), trace.snapshot_dicts(), st
