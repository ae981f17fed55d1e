"""Synthetic benchmark suite (the SPEC 2017 stand-in, paper Table II).

SPEC 2017 binaries are unavailable offline, so the framework carries 24
generated Power-ISA programs named and tagged after Table II.  Each program
is a composition of behaviour motifs matched to its CTRL / COMP / MEM tags:

    COMP  floating-point fmadd chains, integer mul/div kernels
    MEM   streaming loads/stores (stride > cache line), pointer chasing
          (serial D-cache misses), blocked gather/scatter
    CTRL  data-dependent branch ladders (mispredict pressure), call/return
          chains, short irregular loops

The per-benchmark RNG (seeded by the benchmark name) varies loop lengths,
chain depths, strides, and register assignments, so the 24 programs exercise
distinct code and distinct microarchitectural bottlenecks — which is what
the 6-set train/test generalization protocol (Fig 11) needs.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.isa.compiled import CompiledProgram, compile_program
from repro_torch.isa.funcsim import CompiledState, MachineState
from repro_torch.isa.isa import Instruction

I = Instruction

# Table II: name -> (ckp_num, tags, set_no)
TABLE_II: Dict[str, Tuple[int, str, int]] = {
    "500.perlbench": (7, "CTRL", 1),
    "502.gcc": (1, "CTRL", 2),
    "503.bwaves": (24, "COMP+MEM", 1),
    "505.mcf": (32, "COMP+MEM", 2),
    "507.cactuBSSN": (20, "COMP+MEM", 3),
    "508.namd": (70, "COMP+MEM", 4),
    "510.parest": (78, "COMP+MEM", 5),
    "511.povray": (16, "COMP+MEM", 6),
    "519.lbm": (16, "COMP+MEM", 1),
    "520.omnetpp": (26, "CTRL", 3),
    "521.wrf": (71, "COMP+MEM", 2),
    "523.xalancbmk": (5, "CTRL+MEM", 4),
    "525.x264": (13, "COMP", 3),
    "526.blender": (13, "COMP+MEM", 4),
    "527.cam4": (86, "COMP+MEM", 5),
    "531.deepsjeng": (4, "CTRL", 5),
    "538.imagick": (4, "COMP+MEM", 6),
    "541.leela": (11, "CTRL+MEM", 1),
    "544.nab": (17, "COMP+MEM", 2),
    "548.exchange2": (40, "CTRL+MEM", 6),
    "549.fotonik3d": (15, "COMP+MEM", 3),
    "554.roms": (43, "COMP+MEM", 4),
    "557.xz": (8, "COMP+MEM", 5),
    "999.specrand": (3, "COMP+MEM", 6),
}

SET_NUMBERS = (1, 2, 3, 4, 5, 6)


@dataclasses.dataclass
class Benchmark:
    name: str
    tags: str
    set_no: int
    ckp_num: int
    program: List[Instruction]
    setup: Callable[[MachineState], None]
    _compiled: Optional[CompiledProgram] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def tag_list(self) -> Tuple[str, ...]:
        return tuple(self.tags.split("+"))

    def compiled(self) -> CompiledProgram:
        """Columnar SoA form of ``program``, compiled once per benchmark."""
        if self._compiled is None:
            self._compiled = compile_program(self.program)
        return self._compiled


# --------------------------------------------------------------------------- #
# Motif generators.  Each returns a list of instructions with branch targets
# RELATIVE to its own start; ``_emit`` rebases them into the program.
# --------------------------------------------------------------------------- #

def _loop(body: List[Instruction], iters_reg_val: int,
          scratch: str = "R9") -> List[Instruction]:
    """mtctr <n>; body; bdnz -> len(head) (loop start).

    Body-internal relative targets shift by len(head) so they stay correct
    after the head is prepended.
    """
    head = [I("addi", dsts=(scratch,), imm=iters_reg_val),
            I("mtctr", srcs=(scratch,))]
    shifted = [dataclasses.replace(i, target=i.target + len(head))
               if i.target is not None else i for i in body]
    loop = shifted + [I("bdnz", target=len(head))]
    return head + loop


def fp_chain(rng: np.random.RandomState, depth: int, base_reg: str,
             mem_ratio: float) -> List[Instruction]:
    """fmadd dependency chain, optionally fed from / drained to memory."""
    body: List[Instruction] = []
    fr = [f"F{i}" for i in rng.choice(16, size=6, replace=False)]
    if rng.rand() < mem_ratio:
        body.append(I("lfd", dsts=(fr[0],), mem_base=base_reg,
                      mem_offset=int(rng.randint(0, 16)) * 8))
    for d in range(depth):
        a, b, c = fr[d % 3], fr[(d + 1) % 3], fr[3 + d % 3]
        op = rng.choice(["fmadd", "fmul", "fadd", "fsub"])
        if op == "fmadd":
            body.append(I("fmadd", dsts=(a,), srcs=(a, b, c)))
        else:
            body.append(I(op, dsts=(a,), srcs=(a, b)))
    if rng.rand() < mem_ratio:
        body.append(I("stfd", srcs=(fr[0],), mem_base=base_reg,
                      mem_offset=int(rng.randint(0, 16)) * 8))
        body.append(I("addi", dsts=(base_reg,), srcs=(base_reg,), imm=64))
    return body


def int_kernel(rng: np.random.RandomState, n: int,
               div_ratio: float) -> List[Instruction]:
    body: List[Instruction] = []
    gr = [f"R{i}" for i in rng.choice(range(16, 28), size=6, replace=False)]
    for k in range(n):
        a, b = gr[k % 4], gr[(k + 1) % 4]
        r = rng.rand()
        if r < div_ratio:
            body.append(I("divd", dsts=(a,), srcs=(a, gr[4])))
        elif r < div_ratio + 0.25:
            body.append(I("mulld", dsts=(a,), srcs=(a, b)))
        else:
            op = rng.choice(["add", "xor", "and", "or", "subf"])
            body.append(I(op, dsts=(a,), srcs=(a, b)))
    body.append(I("addi", dsts=(gr[4],), srcs=(gr[4],), imm=3))
    return body


def stream_kernel(rng: np.random.RandomState, ptr: str, stride: int,
                  store: bool) -> List[Instruction]:
    """Strided load(+store) sweep; stride > 64 B defeats the line cache."""
    v = f"R{int(rng.randint(16, 28))}"
    body = [I("ld", dsts=(v,), mem_base=ptr, mem_offset=0),
            I("add", dsts=(v,), srcs=(v, v))]
    if store:
        body.append(I("std", srcs=(v,), mem_base=ptr, mem_offset=8))
    body.append(I("addi", dsts=(ptr,), srcs=(ptr,), imm=stride))
    return body


def chase_kernel(ptr: str) -> List[Instruction]:
    """Pointer chase: each load's address depends on the previous load."""
    return [I("ld", dsts=(ptr,), mem_base=ptr, mem_offset=0)]


def branch_ladder(rng: np.random.RandomState, ptr: str,
                  n_rungs: int) -> List[Instruction]:
    """Data-dependent compare+branch rungs over a random-valued array.

    Each rung: load, compare against a threshold, conditionally skip a
    couple of ALU ops.  Random data -> ~50% taken -> mispredict pressure.
    """
    body: List[Instruction] = []
    v = f"R{int(rng.randint(16, 24))}"
    t = f"R{int(rng.randint(24, 28))}"
    for _ in range(n_rungs):
        body.append(I("ld", dsts=(v,), mem_base=ptr, mem_offset=0))
        body.append(I("cmpi", srcs=(v,), imm=int(rng.randint(10, 120))))
        skip = [I("add", dsts=(t,), srcs=(t, v)),
                I("xor", dsts=(v,), srcs=(v, t))]
        # bc cond=0 (branch if lt) over the skip block
        body.append(I("bc", imm=0, target=None))
        patch_at = len(body) - 1
        body.extend(skip)
        body[patch_at] = I("bc", imm=0, target=len(body))
        body.append(I("addi", dsts=(ptr,), srcs=(ptr,), imm=8))
    return body


def call_block(rng: np.random.RandomState,
               fn_bodies: int) -> List[Instruction]:
    """bl/blr call chain: emit N tiny leaf functions + a caller sequence.

    Layout: [caller: bl f0; bl f1; ...; b end] [f0 ... blr] [f1 ... blr] end.
    """
    callers: List[Instruction] = []
    fns: List[List[Instruction]] = []
    for _ in range(fn_bodies):
        g = f"R{int(rng.randint(16, 28))}"
        fn = [I("addi", dsts=(g,), srcs=(g,), imm=int(rng.randint(1, 9))),
              I("mulld", dsts=(g,), srcs=(g, g)),
              I("blr")]
        fns.append(fn)
    n_callers = fn_bodies + 1                       # bl xN + trailing b
    out: List[Instruction] = []
    fn_starts = []
    off = n_callers
    for fn in fns:
        fn_starts.append(off)
        off += len(fn)
    for k in range(fn_bodies):
        out.append(I("bl", target=fn_starts[k]))
    out.append(I("b", target=off))                  # jump past the bodies
    for fn in fns:
        out.extend(fn)
    return out


# --------------------------------------------------------------------------- #
# Program assembly
# --------------------------------------------------------------------------- #

def _emit(program: List[Instruction], block: List[Instruction]) -> None:
    base = len(program)
    for inst in block:
        if inst.target is not None:
            inst = dataclasses.replace(inst, target=inst.target + base)
        program.append(inst)


def build_benchmark(name: str) -> Benchmark:
    ckp, tags, set_no = TABLE_II[name]
    seed = zlib.crc32(name.encode()) & 0xFFFFFFFF
    rng = np.random.RandomState(seed)
    tagset = set(tags.split("+"))

    program: List[Instruction] = []
    # pointer registers with well-separated heaps
    p_stream, p_chase, p_data = "R11", "R12", "R13"
    heap_stream, heap_chase, heap_data = 0x10000, 0x400000, 0x800000
    prologue = [
        I("addi", dsts=(p_stream,), imm=heap_stream),
        I("addi", dsts=(p_chase,), imm=heap_chase),
        I("addi", dsts=(p_data,), imm=heap_data),
        I("addi", dsts=("R28",), imm=int(rng.randint(3, 60))),
    ]
    _emit(program, prologue)
    outer_start = len(program)

    n_motifs = int(rng.randint(3, 6))
    for _ in range(n_motifs):
        choices = []
        if "COMP" in tagset:
            choices += ["fp", "int"] * 2
        if "MEM" in tagset:
            choices += ["stream", "chase"] * 2
        if "CTRL" in tagset:
            choices += ["branch", "call"] * 2
        kind = rng.choice(choices)
        iters = int(rng.randint(24, 120))
        if kind == "fp":
            body = fp_chain(rng, depth=int(rng.randint(3, 9)),
                            base_reg=p_stream,
                            mem_ratio=0.7 if "MEM" in tagset else 0.15)
            block = _loop(body, iters)
        elif kind == "int":
            body = int_kernel(rng, n=int(rng.randint(4, 10)),
                              div_ratio=float(rng.uniform(0.0, 0.15)))
            block = _loop(body, iters)
        elif kind == "stream":
            stride = int(rng.choice([8, 64, 72, 136, 264]))
            body = stream_kernel(rng, p_stream, stride,
                                 store=bool(rng.rand() < 0.5))
            block = _loop(body, iters)
        elif kind == "chase":
            block = _loop(chase_kernel(p_chase) * int(rng.randint(1, 4)),
                          iters)
        elif kind == "branch":
            body = branch_ladder(rng, p_data, n_rungs=int(rng.randint(2, 5)))
            block = _loop(body, iters)
        else:  # call
            block = _loop(call_block(rng, fn_bodies=int(rng.randint(2, 4))),
                          max(8, iters // 4))
        _emit(program, block)
        # re-anchor the pointers so repeated outer iterations stay in-heap
        _emit(program, [
            I("addi", dsts=(p_stream,), imm=heap_stream +
              int(rng.randint(0, 64)) * 8),
            I("addi", dsts=(p_data,), imm=heap_data),
        ])
    program.append(I("b", target=outer_start))     # absolute, no rebase

    chase_slots = 4096
    data_slots = 4096
    perm = rng.permutation(chase_slots)

    def setup(st: MachineState, _perm=perm, _rng_seed=seed) -> None:
        r = np.random.RandomState(_rng_seed ^ 0x5EED)
        st.regs[p_chase] = heap_chase
        # pointer-chase cycle: mem[heap + 8*i] -> heap + 8*perm[i]
        for i in range(chase_slots):
            ea = heap_chase + 8 * i
            st.mem[ea >> 3] = heap_chase + 8 * int(_perm[i])
        # random data for the branch ladders
        for i in range(data_slots):
            ea = heap_data + 8 * i
            st.mem[ea >> 3] = int(r.randint(0, 128))

    return Benchmark(name=name, tags=tags, set_no=set_no, ckp_num=ckp,
                     program=program, setup=setup)


# --------------------------------------------------------------------------- #
# Multi-threaded variants (the multicore subsystem's per-core programs)
# --------------------------------------------------------------------------- #
#
# Each core runs the SAME program structure over a shared data memory;
# only the heap-base immediates differ per core.  Standardization
# collapses immediates to <CONST> (Fig 5a), so every core's token table
# is bitwise identical and the static-instruction RT cache is shared
# perfectly across cores.  Two sharing regimes:
#
#   sharded   stream / chase kernels over per-core disjoint slices of the
#             shared heaps — a core's trace is invariant under core count
#             and scheduling order (no conflicts by construction),
#   shared    a read-modify-write counter kernel on ONE address all cores
#             hammer — the classic contention/lost-update workload whose
#             loaded values depend on the deterministic interleave.

MT_HEAP_STREAM = 0x10000
MT_HEAP_CHASE = 0x400000
MT_SHARD_SLOTS = 2048            # 8-byte slots per core in each sharded heap
MT_COUNTER_EA = 0xC00000         # the one shared contention counter

MT_KINDS = ("stream", "chase", "counter", "mix")


def shared_counter_kernel(ptr: str, scratch: str) -> List[Instruction]:
    """Non-atomic read-modify-write on one shared address: every core
    runs ld/addi/std against ``MT_COUNTER_EA`` — cross-core conflict
    visibility (and lost updates) by design."""
    return [I("ld", dsts=(scratch,), mem_base=ptr, mem_offset=0),
            I("addi", dsts=(scratch,), srcs=(scratch,), imm=1),
            I("std", srcs=(scratch,), mem_base=ptr, mem_offset=0)]


def _mt_stream_base(core_id: int) -> int:
    return MT_HEAP_STREAM + core_id * MT_SHARD_SLOTS * 8


def _mt_chase_base(core_id: int) -> int:
    return MT_HEAP_CHASE + core_id * MT_SHARD_SLOTS * 8


def build_core_program(kind: str, core_id: int,
                       seed: int) -> List[Instruction]:
    """One core's program for a multi-threaded variant.

    The RNG is seeded by ``seed`` only (not the core id), so all cores
    share one program shape; ``core_id`` enters solely through the
    heap-base immediates that shard the stream/chase heaps.
    """
    if kind not in MT_KINDS:
        raise ValueError(f"unknown multicore kind {kind!r} "
                         f"(one of {MT_KINDS})")
    rng = np.random.RandomState(seed)
    program: List[Instruction] = []
    p_stream, p_chase, p_ctr = "R11", "R12", "R13"
    _emit(program, [
        I("addi", dsts=(p_stream,), imm=_mt_stream_base(core_id)),
        I("addi", dsts=(p_chase,), imm=_mt_chase_base(core_id)),
        I("addi", dsts=(p_ctr,), imm=MT_COUNTER_EA),
    ])
    outer_start = len(program)

    def stream_block():
        # stride * iters stays inside the core's MT_SHARD_SLOTS*8 shard,
        # so streams never cross into a neighbour core's slice
        stride = int(rng.choice([8, 64, 72]))
        iters = int(rng.randint(32, 96))
        body = stream_kernel(rng, p_stream, stride,
                             store=bool(rng.rand() < 0.5))
        return _loop(body, iters)

    def chase_block():
        return _loop(chase_kernel(p_chase) * int(rng.randint(1, 4)),
                     int(rng.randint(32, 96)))

    def counter_block():
        body = shared_counter_kernel(p_ctr, "R20")
        body += int_kernel(rng, n=int(rng.randint(3, 7)), div_ratio=0.0)
        return _loop(body, int(rng.randint(32, 96)))

    blocks = {"stream": [stream_block, stream_block],
              "chase": [chase_block, chase_block],
              "counter": [counter_block, counter_block],
              "mix": [stream_block, chase_block, counter_block]}[kind]
    for make in blocks:
        _emit(program, make())
        # re-anchor the sharded pointers so repeated outer iterations
        # stay inside this core's slice
        _emit(program, [
            I("addi", dsts=(p_stream,), imm=_mt_stream_base(core_id)),
            I("addi", dsts=(p_chase,), imm=_mt_chase_base(core_id)),
        ])
    program.append(I("b", target=outer_start))     # absolute, no rebase
    return program


def mt_setup_memory(mem: Dict[int, int], n_cores: int, seed: int) -> None:
    """Initialize the SHARED data memory for an n-core run: one private
    pointer-chase cycle per core (inside its shard) plus the zeroed
    shared counter.  Core i's region depends only on ``core_id``, never
    on ``n_cores`` — the sharded-trace invariance the tests pin down."""
    for core in range(n_cores):
        base = _mt_chase_base(core)
        perm = np.random.RandomState(
            (seed ^ 0x5EED) + core).permutation(MT_SHARD_SLOTS)
        for i in range(MT_SHARD_SLOTS):
            mem[(base + 8 * i) >> 3] = base + 8 * int(perm[i])
    mem[MT_COUNTER_EA >> 3] = 0


def all_benchmarks() -> List[Benchmark]:
    return [build_benchmark(n) for n in TABLE_II]


def benchmarks_in_set(set_no: int) -> List[Benchmark]:
    return [build_benchmark(n) for n, (_, _, s) in TABLE_II.items()
            if s == set_no]


def fresh_state(bench: Benchmark) -> MachineState:
    st = MachineState.fresh()
    bench.setup(st)
    return st


def fresh_compiled_state(bench: Benchmark) -> CompiledState:
    """Columnar initial state (setup still writes the object form)."""
    return CompiledState.from_machine(fresh_state(bench))
