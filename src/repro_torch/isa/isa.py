"""Mini Power-ISA subset (the paper's gem5 model targets Power ISA).

~40 opcodes across integer, floating-point (mapped onto VSR per the paper's
Table I note), load/store, compare and branch classes.  Each opcode carries
its functional-unit class and latency for the O3 timing oracle.

Registers modeled (Table I): R0-R31 (GPR), F0-F31 (VSR/FPR), CR, LR, CTR,
XER, FPSCR, VSCR, CIA, NIA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# functional-unit classes
INT, MUL, DIV, FP, FDIV, LSU, BR = "int", "mul", "div", "fp", "fdiv", "lsu", "br"


@dataclasses.dataclass(frozen=True)
class OpInfo:
    fu: str
    latency: int
    is_load: bool = False
    is_store: bool = False
    is_branch: bool = False
    writes_cr: bool = False
    writes_lr: bool = False
    uses_ctr: bool = False


OPCODES = {
    # integer ALU
    "addi":   OpInfo(INT, 1),
    "add":    OpInfo(INT, 1),
    "subf":   OpInfo(INT, 1),
    "neg":    OpInfo(INT, 1),
    "and":    OpInfo(INT, 1),
    "or":     OpInfo(INT, 1),
    "xor":    OpInfo(INT, 1),
    "rldicl": OpInfo(INT, 1),   # rotate-left + clear (shift family)
    "sld":    OpInfo(INT, 1),
    "srd":    OpInfo(INT, 1),
    "extsw":  OpInfo(INT, 1),
    # integer mul/div
    "mulld":  OpInfo(MUL, 5),
    "mulhd":  OpInfo(MUL, 5),
    "divd":   OpInfo(DIV, 20),
    "modsd":  OpInfo(DIV, 22),
    # compares (write CR)
    "cmpi":   OpInfo(INT, 1, writes_cr=True),
    "cmpl":   OpInfo(INT, 1, writes_cr=True),
    "cmpd":   OpInfo(INT, 1, writes_cr=True),
    # loads
    "ld":     OpInfo(LSU, 2, is_load=True),
    "lwz":    OpInfo(LSU, 2, is_load=True),
    "lbz":    OpInfo(LSU, 2, is_load=True),
    "lfd":    OpInfo(LSU, 3, is_load=True),
    # stores
    "std":    OpInfo(LSU, 1, is_store=True),
    "stw":    OpInfo(LSU, 1, is_store=True),
    "stb":    OpInfo(LSU, 1, is_store=True),
    "stfd":   OpInfo(LSU, 1, is_store=True),
    # floating point (VSR)
    "fadd":   OpInfo(FP, 4),
    "fsub":   OpInfo(FP, 4),
    "fmul":   OpInfo(FP, 4),
    "fmadd":  OpInfo(FP, 5),
    "fdiv":   OpInfo(FDIV, 25),
    "fsqrt":  OpInfo(FDIV, 30),
    "fcmpu":  OpInfo(FP, 2, writes_cr=True),
    "fmr":    OpInfo(FP, 1),
    # branches
    "b":      OpInfo(BR, 1, is_branch=True),
    "bc":     OpInfo(BR, 1, is_branch=True),           # conditional on CR
    "bl":     OpInfo(BR, 1, is_branch=True, writes_lr=True),
    "blr":    OpInfo(BR, 1, is_branch=True),
    "bdnz":   OpInfo(BR, 1, is_branch=True, uses_ctr=True),
    # move to/from special regs
    "mtctr":  OpInfo(INT, 1),
    "mtlr":   OpInfo(INT, 1),
    "mflr":   OpInfo(INT, 1),
    "nop":    OpInfo(INT, 1),
}

GPRS = tuple(f"R{i}" for i in range(32))
FPRS = tuple(f"F{i}" for i in range(32))
SPECIALS = ("CR", "LR", "CTR", "XER", "FPSCR", "VSCR", "CIA", "NIA")
REGS = GPRS + FPRS + SPECIALS

# context-matrix registers (Table I; paper uses the architectural state
# before the clip).  40 registers x (1 name + 8 value-byte tokens) = 360.
CONTEXT_REGS = GPRS + SPECIALS
assert len(CONTEXT_REGS) == 40


@dataclasses.dataclass(frozen=True)
class Instruction:
    op: str
    dsts: Tuple[str, ...] = ()
    srcs: Tuple[str, ...] = ()
    imm: Optional[int] = None
    # memory operand: addr = [mem_base] + mem_offset
    mem_base: Optional[str] = None
    mem_offset: int = 0
    # branch target: label index in the program (resolved), None for blr
    target: Optional[int] = None

    @property
    def info(self) -> OpInfo:
        return OPCODES[self.op]

    def text(self) -> str:
        parts = [self.op]
        if self.dsts:
            parts.append(",".join(self.dsts))
        if self.srcs:
            parts.append(",".join(self.srcs))
        if self.imm is not None:
            parts.append(str(self.imm))
        if self.mem_base is not None:
            parts.append(f"{self.mem_offset}({self.mem_base})")
        if self.target is not None:
            parts.append(f"@{self.target}")
        return " ".join(parts)
