"""Multi-core trace simulation subsystem (front-end half).

The paper motivates CAPSim by the cost of simulating modern multi-core
CPUs, yet the base repro is single-core everywhere.  This module adds the
missing workload axis while reusing the whole existing stack *per core*:

``MulticoreBenchmark``
    N per-core programs (``progen.build_core_program`` multi-threaded
    variants: sharded stream/chase kernels plus a shared-counter
    contention kernel) over ONE shared data memory.  Every core's program
    is structurally identical — only heap-base immediates differ — so the
    compiled token tables (and therefore the static-instruction RT cache)
    are shared across cores for free.

``run_multicore``
    drives ``funcsim.run_compiled`` per core in a deterministic
    round-robin quantum schedule over the shared memory: core ``order[0]``
    commits up to ``quantum`` instructions, then ``order[1]``, ... until
    every core has retired ``max_instructions_per_core`` (or exited).
    Stores from core i's quantum are architecturally visible to every
    later quantum — the interleaved commit order the timing oracle
    (``timing.simulate_multicore``) replays.  Emits one columnar ``Trace``
    per core plus the ``(core, n)`` chunk schedule.

At N=1 the quantum scheduler degenerates to consecutive resumed
``run_compiled`` calls on one state, so the emitted trace (pc/ea/taken
columns AND snapshot rows) is bitwise identical to a single
``run_compiled`` call — the anchor for the subsystem's bitwise gates.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from capsim_bench.frontend import funcsim, progen
from capsim_bench.frontend.compiled import N_IREGS, NIA_SLOT, CompiledProgram, Trace, \
    compile_program
from capsim_bench.frontend.funcsim import CompiledState, MachineState
from capsim_bench.frontend.isa import Instruction

DEFAULT_QUANTUM = 64

MULTICORE_KINDS = progen.MT_KINDS
MULTICORE_NAMES = tuple(f"mt.{k}" for k in MULTICORE_KINDS)


@dataclasses.dataclass
class MulticoreBenchmark:
    """N per-core programs over a shared data memory."""

    name: str                              # e.g. "mt.mix"
    kind: str                              # progen.MT_KINDS member
    n_cores: int
    ckp_num: int
    seed: int
    programs: List[List[Instruction]]      # one per core
    _compiled: Optional[List[CompiledProgram]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def compiled(self) -> List[CompiledProgram]:
        """Per-core columnar SoA programs, compiled once."""
        if self._compiled is None:
            self._compiled = [compile_program(p) for p in self.programs]
        return self._compiled

    def fresh_states(self) -> List[CompiledState]:
        """Per-core architectural states sharing ONE memory dict,
        initialized by ``progen.mt_setup_memory``."""
        mem: Dict[int, int] = {}
        progen.mt_setup_memory(mem, self.n_cores, self.seed)
        return [CompiledState(iregs=[0] * N_IREGS, fregs=[0.0] * 32,
                              mem=mem) for _ in range(self.n_cores)]


def build_multicore_benchmark(name: str, n_cores: int,
                              ckp_num: int = 4) -> MulticoreBenchmark:
    """``name`` is "mt.<kind>" (or a bare kind) with kind one of
    ``progen.MT_KINDS``."""
    kind = name.split(".", 1)[1] if name.startswith("mt.") else name
    if n_cores < 1:
        raise ValueError(f"n_cores must be >= 1, got {n_cores}")
    seed = zlib.crc32(f"mt.{kind}".encode()) & 0xFFFFFFFF
    programs = [progen.build_core_program(kind, core, seed)
                for core in range(n_cores)]
    return MulticoreBenchmark(name=f"mt.{kind}", kind=kind,
                              n_cores=n_cores, ckp_num=ckp_num, seed=seed,
                              programs=programs)


def all_multicore_benchmarks(n_cores: int) -> List[MulticoreBenchmark]:
    return [build_multicore_benchmark(n, n_cores) for n in MULTICORE_NAMES]


def single_core_benchmark(name: str, ckp_num: int = 4) -> progen.Benchmark:
    """An mt.* benchmark as a plain single-core ``progen.Benchmark``:
    core 0's program over the 1-core shared-memory setup.  This is the
    bridge to the single-core dataset pipeline — at N=1 the multicore
    builders must be bitwise identical to ``build_dataset`` over this."""
    mb = build_multicore_benchmark(name, 1, ckp_num=ckp_num)

    def setup(st: MachineState) -> None:
        progen.mt_setup_memory(st.mem, 1, mb.seed)

    return progen.Benchmark(name=mb.name, tags="mt", set_no=0,
                            ckp_num=ckp_num, program=mb.programs[0],
                            setup=setup)


def clone_states(states: Sequence[CompiledState]) -> List[CompiledState]:
    """Replay anchor for a multicore checkpoint: independent copies of
    the per-core register files sharing ONE copy of the shared memory
    (``CompiledState.clone`` would give each core a private memory and
    break cross-core store visibility on replay)."""
    mem = dict(states[0].mem)
    for st in states:
        assert st.mem is states[0].mem, \
            "multicore states must share one memory dict"
    return [CompiledState(iregs=list(st.iregs), fregs=list(st.fregs),
                          mem=mem) for st in states]


@dataclasses.dataclass
class MulticoreTrace:
    """Per-core columnar traces plus the deterministic commit interleave.

    ``schedule`` lists ``(core, n)`` chunks in global commit order: the
    first ``n`` uncommitted instructions of ``cores[core]`` committed as
    one quantum.  ``sum(n for core==c) == len(cores[c])``.

    ``peer_snapshots`` (``run_multicore(..., peer_snapshots=True)``) has
    one ``(n_snaps_c, n_cores, N_IREGS) uint64`` matrix per core: for
    each of core c's snapshot positions, EVERY core's integer file as of
    the enclosing quantum's start.  Within a quantum only the running
    core mutates, so peer rows are exact at any position inside it; the
    own-core row is the stale quantum-start state — consumers must take
    core c's precise row from ``cores[c].snapshots``.
    """

    cores: List[Trace]
    schedule: List[Tuple[int, int]]
    peer_snapshots: Optional[List[np.ndarray]] = None

    @property
    def n_cores(self) -> int:
        return len(self.cores)

    def __len__(self) -> int:
        return sum(len(t) for t in self.cores)


def _concat_traces(cprog: CompiledProgram, chunks: List[Trace]) -> Trace:
    if not chunks:
        return Trace(program=cprog,
                     pc=np.zeros(0, np.int32), ea=np.zeros(0, np.uint64),
                     taken=np.zeros(0, np.int8),
                     snapshots=np.zeros((0, N_IREGS), np.uint64))
    if len(chunks) == 1:
        return chunks[0]
    return Trace(
        program=cprog,
        pc=np.concatenate([t.pc for t in chunks]),
        ea=np.concatenate([t.ea for t in chunks]),
        taken=np.concatenate([t.taken for t in chunks]),
        snapshots=np.concatenate([t.snapshots for t in chunks]))


def run_multicore(cprogs: Sequence[CompiledProgram],
                  max_instructions_per_core: int,
                  states: Sequence[CompiledState],
                  snapshot_every: Optional[int] = None,
                  quantum: int = DEFAULT_QUANTUM,
                  core_order: Optional[Sequence[int]] = None,
                  snapshot_at: Optional[Sequence[Sequence[int]]] = None,
                  peer_snapshots: bool = False
                  ) -> MulticoreTrace:
    """Round-robin interleaved execution of N cores over shared memory.

    Each scheduling round visits the cores in ``core_order`` (default
    0..N-1); a visit resumes the core at its saved pc and retires up to
    ``quantum`` instructions through ``funcsim.run_compiled``.  All cores
    start at pc 0 (one ``run_multicore`` call is one interval, matching
    the single-core engine's restart-at-0 checkpoint semantics; state
    carries across calls through ``states``).

    ``snapshot_every`` snapshots core c's integer file before its OWN
    trace positions 0, k, 2k, ... — the same per-trace-position contract
    as ``run_compiled``, computed against the core-local instruction
    count so the emitted rows line up with the per-core clip slicing.
    ``snapshot_at`` instead takes one sorted position list PER CORE (the
    training replay pass: snapshots exactly at the surviving clip
    starts); the two are mutually exclusive.  ``peer_snapshots``
    additionally captures the whole machine's integer files at each
    snapshotting quantum's start (see ``MulticoreTrace``).
    """
    n_cores = len(cprogs)
    assert len(states) == n_cores, (len(states), n_cores)
    order = list(core_order) if core_order is not None \
        else list(range(n_cores))
    assert sorted(order) == list(range(n_cores)), \
        f"core_order must permute 0..{n_cores - 1}, got {order}"
    assert quantum >= 1, quantum
    assert not (snapshot_every and snapshot_at is not None), \
        "snapshot_every and snapshot_at are mutually exclusive"
    at_lists: Optional[List[List[int]]] = None
    at_ptr = [0] * n_cores
    if snapshot_at is not None:
        assert len(snapshot_at) == n_cores, (len(snapshot_at), n_cores)
        at_lists = [sorted(int(k) for k in pos) for pos in snapshot_at]
    chunks: List[List[Trace]] = [[] for _ in range(n_cores)]
    schedule: List[Tuple[int, int]] = []
    peers: Optional[List[List[np.ndarray]]] = \
        [[] for _ in range(n_cores)] if peer_snapshots else None
    done = [0] * n_cores                   # instructions retired per core
    pc = [0] * n_cores                     # resume pc per core
    active = [True] * n_cores
    budget = max_instructions_per_core
    while True:
        progressed = False
        for c in order:
            if not active[c] or done[c] >= budget:
                continue
            q = min(quantum, budget - done[c])
            at = None
            if snapshot_every:
                at = [k for k in range(q)
                      if (done[c] + k) % snapshot_every == 0]
            elif at_lists is not None:
                lo, p = done[c], at_ptr[c]
                mine = at_lists[c]
                at = []
                while p < len(mine) and mine[p] < lo + q:
                    assert mine[p] >= lo, \
                        f"snapshot_at position {mine[p]} for core {c} " \
                        "already passed (positions must be >= 0, sorted)"
                    at.append(mine[p] - lo)
                    p += 1
                at_ptr[c] = p
            mat = None
            if peers is not None and at:
                # other cores cannot commit inside this quantum, so one
                # quantum-start capture is exact for every peer row of
                # every snapshot position the quantum serves
                mat = np.array([st.iregs for st in states], np.uint64)
            tr, _ = funcsim.run_compiled(
                cprogs[c], q, states[c],
                snapshot_at=at or None, start_pc=pc[c])
            if mat is not None:
                # one peer matrix per snapshot row actually emitted (a
                # mid-quantum exit can serve fewer positions than asked)
                peers[c].extend([mat] * tr.snapshots.shape[0])
            k = len(tr)
            if k:
                chunks[c].append(tr)
                schedule.append((c, k))
                done[c] += k
                pc[c] = int(states[c].iregs[NIA_SLOT])
                progressed = True
            if k < q:                      # program exited mid-quantum
                active[c] = False
        if not progressed:
            break
    cores = [_concat_traces(cprogs[c], chunks[c]) for c in range(n_cores)]
    peer_out = None
    if peers is not None:
        peer_out = [
            np.stack(peers[c]) if peers[c]
            else np.zeros((0, n_cores, N_IREGS), np.uint64)
            for c in range(n_cores)]
        for c in range(n_cores):
            assert peer_out[c].shape[0] == cores[c].snapshots.shape[0], \
                (c, peer_out[c].shape, cores[c].snapshots.shape)
    return MulticoreTrace(cores=cores, schedule=schedule,
                          peer_snapshots=peer_out)
