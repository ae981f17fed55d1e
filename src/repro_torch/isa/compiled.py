"""Columnar trace IR: structure-of-arrays program + trace encodings.

The object model (``List[Instruction]`` programs, ``List[TraceEntry]``
traces) is convenient but every downstream layer — slicer, tokenizer,
context builder, timing oracle — pays per-instruction Python attribute
walks and dataclass allocation for it.  This module is the columnar
alternative:

``CompiledProgram``
    a *static* structure-of-arrays encoding of a program, built once per
    benchmark: int32 opcode codes, unified register-slot indices for
    destinations/sources, immediates + presence flags, branch targets,
    and memory base/offset columns.  It also carries a precomputed
    per-static-instruction standardized-token table
    (``(n_static, l_token) int32``): the Fig-5 standardization depends
    only on the static instruction, so per-clip tokenization collapses to
    one ``token_table[trace.pc[a:b]]`` gather.

``Trace``
    a *dynamic* columnar trace: ``pc`` (int32 static index), ``ea``
    (uint64 effective address, 0 for non-memory ops), ``taken`` (int8,
    -1 for non-branches) plus a ``(n_snaps, 40) uint64`` architectural
    snapshot matrix in ``CONTEXT_REGS`` order.

Register slots are unified across both files: integer registers (the 40
``CONTEXT_REGS``: R0-R31 then CR, LR, CTR, XER, FPSCR, VSCR, CIA, NIA)
occupy slots 0..39 — so a snapshot is literally a copy of the integer
file — and F0-F31 occupy slots 40..71.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.isa.isa import CONTEXT_REGS, OPCODES, Instruction

# --------------------------------------------------------------------------- #
# Opcode + register-slot numbering
# --------------------------------------------------------------------------- #

OPCODE_LIST: Tuple[str, ...] = tuple(sorted(OPCODES))
OPCODE_CODE: Dict[str, int] = {op: i for i, op in enumerate(OPCODE_LIST)}

N_IREGS = len(CONTEXT_REGS)                    # 40: slots 0..39
N_FREGS = 32                                   # slots 40..71
N_SLOTS = N_IREGS + N_FREGS

IREG_SLOT: Dict[str, int] = {r: i for i, r in enumerate(CONTEXT_REGS)}
FREG_SLOT: Dict[str, int] = {f"F{i}": N_IREGS + i for i in range(32)}
REG_SLOT: Dict[str, int] = {**IREG_SLOT, **FREG_SLOT}
SLOT_NAME: Tuple[str, ...] = tuple(CONTEXT_REGS) + tuple(
    f"F{i}" for i in range(32))

CR_SLOT = IREG_SLOT["CR"]
LR_SLOT = IREG_SLOT["LR"]
CTR_SLOT = IREG_SLOT["CTR"]
CIA_SLOT = IREG_SLOT["CIA"]
NIA_SLOT = IREG_SLOT["NIA"]

MAX_DSTS = 2
MAX_SRCS = 3

# per-opcode-code property tables (index with CompiledProgram.opcode)
OP_IS_LOAD = np.array([OPCODES[o].is_load for o in OPCODE_LIST], bool)
OP_IS_STORE = np.array([OPCODES[o].is_store for o in OPCODE_LIST], bool)
OP_IS_MEM = OP_IS_LOAD | OP_IS_STORE


class CompileError(ValueError):
    """Program shape the SoA encoding cannot represent (e.g. more than
    ``MAX_DSTS`` destinations); callers fall back to the object path."""


@dataclasses.dataclass(eq=False)                # ndarray fields: no __eq__
class CompiledProgram:
    """Structure-of-arrays encoding of a static program.

    All register columns hold unified slots (see module docstring) with
    -1 for "absent"; ``has_imm``/``has_target`` disambiguate legitimate
    zero immediates and branch targets from absent ones.
    """

    insts: Tuple[Instruction, ...]             # originals (adapters/tests)
    opcode: np.ndarray                         # (n,) int32 OPCODE_LIST code
    dsts: np.ndarray                           # (n, MAX_DSTS) int32 slots
    srcs: np.ndarray                           # (n, MAX_SRCS) int32 slots
    imm: np.ndarray                            # (n,) int64
    has_imm: np.ndarray                        # (n,) bool
    mem_base: np.ndarray                       # (n,) int32 slot or -1
    mem_offset: np.ndarray                     # (n,) int64
    target: np.ndarray                         # (n,) int32
    has_target: np.ndarray                     # (n,) bool
    _token_tables: Dict[int, Tuple[object, np.ndarray]] = \
        dataclasses.field(default_factory=dict, repr=False, compare=False)
    _token_keys: Dict[int, Tuple[object, Tuple[bytes, ...]]] = \
        dataclasses.field(default_factory=dict, repr=False, compare=False)
    _handlers: Optional[list] = \
        dataclasses.field(default=None, repr=False, compare=False)
    # per-static operand/property tables memoized by isa/timing
    _timing_tables: Optional[tuple] = \
        dataclasses.field(default=None, repr=False, compare=False)

    @property
    def n_static(self) -> int:
        return self.opcode.shape[0]

    def __len__(self) -> int:
        return self.n_static

    # ---------------------------- round-trip ---------------------------- #

    def instruction(self, i: int) -> Instruction:
        """Decode static instruction ``i`` back to the object form."""
        return Instruction(
            op=OPCODE_LIST[int(self.opcode[i])],
            dsts=tuple(SLOT_NAME[s] for s in self.dsts[i] if s >= 0),
            srcs=tuple(SLOT_NAME[s] for s in self.srcs[i] if s >= 0),
            imm=int(self.imm[i]) if self.has_imm[i] else None,
            mem_base=(SLOT_NAME[int(self.mem_base[i])]
                      if self.mem_base[i] >= 0 else None),
            mem_offset=int(self.mem_offset[i]),
            target=int(self.target[i]) if self.has_target[i] else None)

    def decode(self) -> List[Instruction]:
        return [self.instruction(i) for i in range(self.n_static)]

    # --------------------------- token table ---------------------------- #

    def token_table(self, vocab, l_token: int) -> np.ndarray:
        """``(n_static, l_token) int32`` standardized-token rows (Fig 5).

        Standardization reads only static fields, so the table is built
        once per (vocab, l_token) and per-clip tokenization becomes a
        gather ``table[trace.pc[a:b]]``.
        """
        # keyed by l_token with the vocab held by reference: identity is
        # checked (not id(), which could be reused after a gc) and the
        # cached vocab stays alive as long as its table does
        cached = self._token_tables.get(l_token)
        if cached is not None and cached[0] is vocab:
            return cached[1]
        from repro_torch.core.standardize import encode_instruction
        table = np.stack([encode_instruction(inst, vocab, l_token)
                          for inst in self.insts]) if self.insts else \
            np.zeros((0, l_token), np.int32)
        table.setflags(write=False)
        self._token_tables[l_token] = (vocab, table)
        return table

    def token_row_keys(self, vocab, l_token: int) -> Tuple[bytes, ...]:
        """Memoized content keys (``tobytes`` per ``token_table`` row) —
        what the static-instruction RT cache dedupes on.  Keyed like
        ``token_table`` (identity-checked vocab per l_token)."""
        cached = self._token_keys.get(l_token)
        if cached is not None and cached[0] is vocab:
            return cached[1]
        table = self.token_table(vocab, l_token)
        keys = tuple(r.tobytes() for r in np.ascontiguousarray(table))
        self._token_keys[l_token] = (vocab, keys)
        return keys


def compile_program(program: Sequence[Instruction]) -> CompiledProgram:
    """Build the SoA encoding; raises ``CompileError`` on shapes the
    columns cannot hold (callers then use the object interpreter)."""
    n = len(program)
    opcode = np.zeros(n, np.int32)
    dsts = np.full((n, MAX_DSTS), -1, np.int32)
    srcs = np.full((n, MAX_SRCS), -1, np.int32)
    imm = np.zeros(n, np.int64)
    has_imm = np.zeros(n, bool)
    mem_base = np.full(n, -1, np.int32)
    mem_offset = np.zeros(n, np.int64)
    target = np.full(n, -1, np.int32)
    has_target = np.zeros(n, bool)

    for i, inst in enumerate(program):
        code = OPCODE_CODE.get(inst.op)
        if code is None:
            raise CompileError(f"unknown opcode {inst.op!r}")
        if len(inst.dsts) > MAX_DSTS or len(inst.srcs) > MAX_SRCS:
            raise CompileError(
                f"operand overflow at pc {i}: {inst.text()}")
        try:
            for k, d in enumerate(inst.dsts):
                dsts[i, k] = REG_SLOT[d]
            for k, s in enumerate(inst.srcs):
                srcs[i, k] = REG_SLOT[s]
            if inst.mem_base is not None:
                mem_base[i] = REG_SLOT[inst.mem_base]
        except KeyError as e:                  # unknown register name
            raise CompileError(f"unknown register {e} at pc {i}") from e
        opcode[i] = code
        if inst.imm is not None:
            imm[i] = inst.imm
            has_imm[i] = True
        mem_offset[i] = inst.mem_offset
        if inst.target is not None:
            target[i] = inst.target
            has_target[i] = True

    return CompiledProgram(
        insts=tuple(program), opcode=opcode, dsts=dsts, srcs=srcs,
        imm=imm, has_imm=has_imm, mem_base=mem_base,
        mem_offset=mem_offset, target=target, has_target=has_target)


# --------------------------------------------------------------------------- #
# Columnar dynamic trace
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(eq=False)                # ndarray fields: no __eq__
class Trace:
    """Columnar dynamic trace (replaces ``List[TraceEntry]``).

    ``ea`` is 0 for non-memory instructions (whether an entry *has* an
    effective address is a static property: ``OP_IS_MEM[opcode[pc]]``);
    ``taken`` is -1 for non-branches, else 0/1.
    """

    program: CompiledProgram
    pc: np.ndarray                             # (n,) int32
    ea: np.ndarray                             # (n,) uint64
    taken: np.ndarray                          # (n,) int8
    snapshots: np.ndarray                      # (n_snaps, N_IREGS) uint64

    def __len__(self) -> int:
        return self.pc.shape[0]

    def entries(self) -> list:
        """Thin object adapter: the equivalent ``List[TraceEntry]``."""
        from repro_torch.isa.funcsim import TraceEntry
        insts = self.program.insts
        is_mem = OP_IS_MEM[self.program.opcode]
        pcs = self.pc.tolist()
        eas = self.ea.tolist()
        takens = self.taken.tolist()
        return [TraceEntry(pc=pc, inst=insts[pc],
                           ea=eas[i] if is_mem[pc] else None,
                           taken=None if takens[i] < 0 else bool(takens[i]))
                for i, pc in enumerate(pcs)]

    def snapshot_dicts(self) -> List[Dict[str, int]]:
        """Thin object adapter: snapshots as {reg_name: value} dicts."""
        return [{r: int(v) for r, v in zip(CONTEXT_REGS, row)}
                for row in self.snapshots.tolist()]
