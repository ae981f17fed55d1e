"""O3 superscalar timing oracle (the paper's gem5 O3 golden model stand-in).

Computes per-instruction commit cycles for a dynamic trace under an
out-of-order core model parameterized exactly by the paper's Table III
knobs (FetchWidth, IssueWidth, CommitWidth, ROBEntry) plus functional-unit
counts/latencies, I/D caches, and a 2-bit branch predictor.

The model is *greedy-scheduled* rather than cycle-stepped: each instruction's
fetch / issue / complete / commit cycles are derived in trace order from
resource-availability bookkeeping.  That captures the first-order O3
behaviour the predictor must learn — data-dependency chains, structural FU
hazards, ROB back-pressure, cache locality, branch mispredict flushes —
at ~10^5-10^6 instructions/second in pure Python, which is what makes the
dataset pipeline runnable offline (gem5 itself is unavailable).

Commit times feed Algorithm 1 (core/slicer.py): clip runtime is the delta
of commit cycles across the clip boundary, exactly as the paper defines it.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from capsim_bench.frontend import compiled as comp
from capsim_bench.frontend.funcsim import TraceEntry
from capsim_bench.frontend.isa import OPCODES


@dataclasses.dataclass(frozen=True)
class TimingParams:
    # Table III knobs
    fetch_width: int = 8
    issue_width: int = 8
    commit_width: int = 8
    rob_entries: int = 192
    # front end
    icache_lines: int = 128          # direct-mapped, 8 insts per line
    icache_line_insts: int = 8
    icache_miss_cycles: int = 8
    mispredict_penalty: int = 12
    decode_depth: int = 4            # fetch->dispatch pipeline depth
    # memory
    dcache_lines: int = 512          # direct-mapped, 64 B lines
    dcache_line_bytes: int = 64
    dcache_hit_cycles: int = 2
    dcache_miss_cycles: int = 40
    mshr_entries: int = 4            # outstanding misses (bounds MLP)
    # functional units: class -> number of units
    fu_counts: Tuple[Tuple[str, int], ...] = (
        ("int", 4), ("mul", 1), ("div", 1), ("fp", 2), ("fdiv", 1),
        ("lsu", 2), ("br", 1))
    # shared resources (``simulate_multicore`` only; all three model
    # CROSS-core interference exclusively, so at n_cores == 1 they are
    # structurally inert and the oracle stays bitwise equal to
    # ``simulate_columnar``)
    llc_lines: int = 2048            # shared direct-mapped last-level cache
    llc_extra_miss_cycles: int = 60  # extra L1-miss latency when another
                                     # core's fill evicted the LLC line
    bus_cycles_per_miss: int = 4     # shared-bus occupancy per L1 miss

    def replace(self, **kw) -> "TimingParams":
        return dataclasses.replace(self, **kw)


class _TwoBitPredictor:
    """Per-pc 2-bit saturating counters, initialized weakly taken."""

    __slots__ = ("table",)

    def __init__(self):
        self.table: Dict[int, int] = {}

    def predict_and_update(self, pc: int, taken: bool) -> bool:
        c = self.table.get(pc, 2)
        pred = c >= 2
        self.table[pc] = min(3, c + 1) if taken else max(0, c - 1)
        return pred == taken


class _DirectMappedCache:
    __slots__ = ("tags", "n")

    def __init__(self, n_lines: int):
        self.tags = [-1] * n_lines
        self.n = n_lines

    def access(self, line: int) -> bool:
        idx = line % self.n
        hit = self.tags[idx] == line
        self.tags[idx] = line
        return hit


def simulate(trace: Sequence[TraceEntry],
             params: TimingParams = TimingParams()) -> List[int]:
    """Returns the commit cycle of every instruction in ``trace``."""
    p = params
    n = len(trace)
    commit = [0] * n
    if n == 0:
        return commit

    icache = _DirectMappedCache(p.icache_lines)
    dcache = _DirectMappedCache(p.dcache_lines)
    bpred = _TwoBitPredictor()
    fu_free: Dict[str, List[int]] = {
        cls: [0] * cnt for cls, cnt in p.fu_counts}
    mshr: List[int] = [0] * p.mshr_entries
    reg_ready: Dict[str, int] = {}          # reg -> cycle its value is ready
    issue_used: Dict[int, int] = defaultdict(int)
    store_ready: Dict[int, int] = {}        # mem line -> store completion

    fetch_cycle = 0                          # cycle of the current fetch group
    fetch_in_group = 0
    fetch_barrier = 0                        # redirect/miss stall point
    commit_cycle = 0
    commit_in_group = 0

    for i, e in enumerate(trace):
        info = OPCODES[e.inst.op]

        # ---------------- fetch ----------------
        line = e.pc // p.icache_line_insts
        if not icache.access(line):
            fetch_barrier = max(fetch_barrier,
                                fetch_cycle + p.icache_miss_cycles)
        if fetch_cycle < fetch_barrier:
            fetch_cycle = fetch_barrier
            fetch_in_group = 0
        elif fetch_in_group >= p.fetch_width:
            fetch_cycle += 1
            fetch_in_group = 0
            if fetch_cycle < fetch_barrier:
                fetch_cycle = fetch_barrier
        f_cyc = fetch_cycle
        fetch_in_group += 1

        # ---------------- dispatch (ROB back-pressure) ----------------
        disp = f_cyc + p.decode_depth
        if i >= p.rob_entries:
            disp = max(disp, commit[i - p.rob_entries])

        # ---------------- operand readiness ----------------
        ready = disp
        for s in e.inst.srcs:
            ready = max(ready, reg_ready.get(s, 0))
        if e.inst.mem_base is not None:
            ready = max(ready, reg_ready.get(e.inst.mem_base, 0))
        if info.uses_ctr:
            ready = max(ready, reg_ready.get("CTR", 0))
        if e.inst.op == "bc":
            ready = max(ready, reg_ready.get("CR", 0))
        if e.inst.op == "blr":
            ready = max(ready, reg_ready.get("LR", 0))

        # ---------------- issue: FU + issue-bandwidth ----------------
        units = fu_free[info.fu]
        u = min(range(len(units)), key=units.__getitem__)
        issue = max(ready, units[u])
        while issue_used[issue] >= p.issue_width:
            issue += 1
        issue_used[issue] += 1

        # ---------------- execute ----------------
        lat = info.latency
        if info.is_load:
            mline = (e.ea or 0) // p.dcache_line_bytes
            hit = dcache.access(mline)
            lat = p.dcache_hit_cycles if hit else p.dcache_miss_cycles
            dep = store_ready.get(mline)
            if dep is not None:              # store-to-load forwarding point
                issue = max(issue, dep)
            if not hit:                      # MSHR slot bounds miss overlap
                m = min(range(len(mshr)), key=mshr.__getitem__)
                issue = max(issue, mshr[m])
                mshr[m] = issue + lat
        complete = issue + lat
        units[u] = issue + 1                 # pipelined FUs: 1-cycle occupancy
        if info.fu in ("div", "fdiv"):
            units[u] = complete              # unpipelined dividers

        # ---------------- writeback ----------------
        for d in e.inst.dsts:
            reg_ready[d] = complete
        if info.writes_cr:
            reg_ready["CR"] = complete
        if info.writes_lr:
            reg_ready["LR"] = complete
        if info.uses_ctr:
            reg_ready["CTR"] = complete
        if info.is_store:
            mline = (e.ea or 0) // p.dcache_line_bytes
            dcache.access(mline)
            store_ready[mline] = complete

        # ---------------- branch resolution ----------------
        if info.is_branch and e.taken is not None:
            correct = bpred.predict_and_update(e.pc, e.taken)
            if not correct:
                fetch_barrier = max(fetch_barrier,
                                    complete + p.mispredict_penalty)

        # ---------------- commit (in order) ----------------
        c = max(complete + 1, commit_cycle)
        if c > commit_cycle:
            commit_cycle = c
            commit_in_group = 0
        elif commit_in_group >= p.commit_width:
            commit_cycle += 1
            commit_in_group = 0
        commit_in_group += 1
        commit[i] = commit_cycle

    return commit


def total_cycles(trace: Sequence[TraceEntry],
                 params: TimingParams = TimingParams()) -> int:
    c = simulate(trace, params)
    return c[-1] if c else 0


# --------------------------------------------------------------------------- #
# Columnar path: same greedy model over ``repro.isa.compiled.Trace``
# --------------------------------------------------------------------------- #

FU_ORDER = ("int", "mul", "div", "fp", "fdiv", "lsu", "br")
_FU_INDEX = {cls: i for i, cls in enumerate(FU_ORDER)}


def _static_tables(cprog: comp.CompiledProgram):
    """Per-static-instruction operand/property tables for the columnar
    oracle: everything ``simulate`` reads off ``TraceEntry.inst`` is
    precomputed once per program instead of per dynamic instruction.

    ``read_slots[pc]`` folds explicit sources, the memory base, and the
    implicit CR/CTR/LR reads into one tuple of unified register slots;
    ``write_slots[pc]`` does the same for destinations and implicit
    writes — so the hot loop is pure list indexing.
    """
    if cprog._timing_tables is not None:
        return cprog._timing_tables
    fu_idx: List[int] = []
    latency: List[int] = []
    is_load: List[bool] = []
    is_store: List[bool] = []
    is_branch: List[bool] = []
    read_slots: List[Tuple[int, ...]] = []
    write_slots: List[Tuple[int, ...]] = []
    for i, inst in enumerate(cprog.insts):
        info = OPCODES[inst.op]
        fu_idx.append(_FU_INDEX[info.fu])
        latency.append(info.latency)
        is_load.append(info.is_load)
        is_store.append(info.is_store)
        is_branch.append(info.is_branch)
        reads = [int(x) for x in cprog.srcs[i] if x >= 0]
        if cprog.mem_base[i] >= 0:
            reads.append(int(cprog.mem_base[i]))
        if info.uses_ctr:
            reads.append(comp.CTR_SLOT)
        if inst.op == "bc":
            reads.append(comp.CR_SLOT)
        if inst.op == "blr":
            reads.append(comp.LR_SLOT)
        read_slots.append(tuple(reads))
        writes = [int(x) for x in cprog.dsts[i] if x >= 0]
        if info.writes_cr:
            writes.append(comp.CR_SLOT)
        if info.writes_lr:
            writes.append(comp.LR_SLOT)
        if info.uses_ctr:
            writes.append(comp.CTR_SLOT)
        write_slots.append(tuple(writes))
    tables = (fu_idx, latency, is_load, is_store, is_branch,
              read_slots, write_slots)
    cprog._timing_tables = tables
    return tables


def simulate_columnar(trace: comp.Trace,
                      params: TimingParams = TimingParams()) -> np.ndarray:
    """Commit cycle of every instruction in a columnar ``Trace``.

    Bitwise identical to ``simulate`` on the equivalent object trace:
    the same greedy bookkeeping, with per-static decode hoisted out of
    the loop and name-keyed dicts replaced by slot-indexed lists.
    """
    p = params
    n = len(trace)
    commit = [0] * n
    if n == 0:
        return np.zeros(0, np.int64)

    (fu_idx, latency_t, is_load_t, is_store_t, is_branch_t,
     read_slots, write_slots) = _static_tables(trace.program)
    pcs = trace.pc.tolist()
    eas = trace.ea.tolist()
    takens = trace.taken.tolist()

    fu_units: List[List[int]] = [[] for _ in FU_ORDER]
    for cls, cnt in p.fu_counts:
        fu_units[_FU_INDEX[cls]] = [0] * cnt
    itags = [-1] * p.icache_lines
    dtags = [-1] * p.dcache_lines
    n_ilines, n_dlines = p.icache_lines, p.dcache_lines
    bpred: Dict[int, int] = {}
    mshr: List[int] = [0] * p.mshr_entries
    reg_ready = [0] * comp.N_SLOTS
    issue_used: Dict[int, int] = defaultdict(int)
    store_ready: Dict[int, int] = {}

    fetch_cycle = 0
    fetch_in_group = 0
    fetch_barrier = 0
    commit_cycle = 0
    commit_in_group = 0

    for i in range(n):
        pc = pcs[i]

        # ---------------- fetch ----------------
        line = pc // p.icache_line_insts
        idx = line % n_ilines
        if itags[idx] != line:
            itags[idx] = line
            fetch_barrier = max(fetch_barrier,
                                fetch_cycle + p.icache_miss_cycles)
        else:
            itags[idx] = line
        if fetch_cycle < fetch_barrier:
            fetch_cycle = fetch_barrier
            fetch_in_group = 0
        elif fetch_in_group >= p.fetch_width:
            fetch_cycle += 1
            fetch_in_group = 0
            if fetch_cycle < fetch_barrier:
                fetch_cycle = fetch_barrier
        f_cyc = fetch_cycle
        fetch_in_group += 1

        # ---------------- dispatch (ROB back-pressure) ----------------
        disp = f_cyc + p.decode_depth
        if i >= p.rob_entries:
            disp = max(disp, commit[i - p.rob_entries])

        # ---------------- operand readiness ----------------
        ready = disp
        for s in read_slots[pc]:
            r = reg_ready[s]
            if r > ready:
                ready = r

        # ---------------- issue: FU + issue-bandwidth ----------------
        units = fu_units[fu_idx[pc]]
        u = min(range(len(units)), key=units.__getitem__)
        issue = max(ready, units[u])
        while issue_used[issue] >= p.issue_width:
            issue += 1
        issue_used[issue] += 1

        # ---------------- execute ----------------
        lat = latency_t[pc]
        if is_load_t[pc]:
            mline = eas[i] // p.dcache_line_bytes
            didx = mline % n_dlines
            hit = dtags[didx] == mline
            dtags[didx] = mline
            lat = p.dcache_hit_cycles if hit else p.dcache_miss_cycles
            dep = store_ready.get(mline)
            if dep is not None:              # store-to-load forwarding point
                issue = max(issue, dep)
            if not hit:                      # MSHR slot bounds miss overlap
                m = min(range(len(mshr)), key=mshr.__getitem__)
                issue = max(issue, mshr[m])
                mshr[m] = issue + lat
        complete = issue + lat
        units[u] = issue + 1                 # pipelined FUs: 1-cycle occupancy
        fu = fu_idx[pc]
        if fu == 2 or fu == 4:               # unpipelined div/fdiv
            units[u] = complete

        # ---------------- writeback ----------------
        for d in write_slots[pc]:
            reg_ready[d] = complete
        if is_store_t[pc]:
            mline = eas[i] // p.dcache_line_bytes
            dtags[mline % n_dlines] = mline
            store_ready[mline] = complete

        # ---------------- branch resolution ----------------
        if is_branch_t[pc] and takens[i] >= 0:
            c = bpred.get(pc, 2)
            pred = c >= 2
            taken = takens[i] == 1
            bpred[pc] = min(3, c + 1) if taken else max(0, c - 1)
            if pred != taken:
                fetch_barrier = max(fetch_barrier,
                                    complete + p.mispredict_penalty)

        # ---------------- commit (in order) ----------------
        c = complete + 1
        if c < commit_cycle:
            c = commit_cycle
        if c > commit_cycle:
            commit_cycle = c
            commit_in_group = 0
        elif commit_in_group >= p.commit_width:
            commit_cycle += 1
            commit_in_group = 0
        commit_in_group += 1
        commit[i] = commit_cycle

    return np.asarray(commit, np.int64)


def total_cycles_columnar(trace: comp.Trace,
                          params: TimingParams = TimingParams()) -> int:
    c = simulate_columnar(trace, params)
    return int(c[-1]) if len(c) else 0


# --------------------------------------------------------------------------- #
# Multicore oracle: per-core simulate_columnar state + shared LLC / bus
# --------------------------------------------------------------------------- #


class _CoreTimingState:
    """One core's complete ``simulate_columnar`` bookkeeping, stepped in
    interleaved chunks by ``simulate_multicore``.  Field-for-field the
    locals of ``simulate_columnar`` so the per-core model is the same
    greedy machine bit for bit."""

    __slots__ = ("tables", "pcs", "eas", "takens", "commit", "i",
                 "fu_units", "itags", "dtags", "bpred", "mshr",
                 "reg_ready", "issue_used", "store_ready",
                 "fetch_cycle", "fetch_in_group", "fetch_barrier",
                 "commit_cycle", "commit_in_group")

    def __init__(self, trace: comp.Trace, p: TimingParams):
        self.tables = _static_tables(trace.program)
        self.pcs = trace.pc.tolist()
        self.eas = trace.ea.tolist()
        self.takens = trace.taken.tolist()
        self.commit = [0] * len(trace)
        self.i = 0
        self.fu_units = [[] for _ in FU_ORDER]
        for cls, cnt in p.fu_counts:
            self.fu_units[_FU_INDEX[cls]] = [0] * cnt
        self.itags = [-1] * p.icache_lines
        self.dtags = [-1] * p.dcache_lines
        self.bpred: Dict[int, int] = {}
        self.mshr: List[int] = [0] * p.mshr_entries
        self.reg_ready = [0] * comp.N_SLOTS
        self.issue_used: Dict[int, int] = defaultdict(int)
        self.store_ready: Dict[int, int] = {}
        self.fetch_cycle = 0
        self.fetch_in_group = 0
        self.fetch_barrier = 0
        self.commit_cycle = 0
        self.commit_in_group = 0


def simulate_multicore(traces: Sequence[comp.Trace],
                       schedule: Sequence[Tuple[int, int]],
                       params: TimingParams = TimingParams()
                       ) -> List[np.ndarray]:
    """Commit cycle of every instruction of every core.

    ``traces``/``schedule`` come from ``multicore.run_multicore``: the
    oracle replays the same deterministic interleaved commit order, each
    core stepping its own private ``simulate_columnar`` machine (front
    end, ROB back-pressure, L1 caches, branch predictor, FUs, MSHRs)
    while L1 misses additionally contend on two SHARED structures:

      shared LLC   a direct-mapped tag array filled by every core's L1
                   misses; a miss whose LLC slot holds a line installed
                   by a DIFFERENT core pays ``llc_extra_miss_cycles``
                   (cross-core conflict eviction).  Cold misses and
                   same-core conflicts cost exactly the single-core
                   ``dcache_miss_cycles``.
      shared bus   each L1 miss occupies the memory bus for
                   ``bus_cycles_per_miss``; a miss issued while ANOTHER
                   core's transfer holds the bus waits for it (a core's
                   own misses already serialize through its MSHRs).

    Both penalties key on *another core*, so at N=1 neither can fire and
    the returned commit array is bitwise equal to ``simulate_columnar``
    on the same trace — the subsystem's oracle anchor, enforced by the
    CI multicore gate.
    """
    p = params
    cores = [_CoreTimingState(t, p) for t in traces]
    need = [0] * len(cores)
    for c, n in schedule:
        need[c] += n
    for c, st in enumerate(cores):
        assert need[c] <= len(st.commit), \
            f"schedule overruns core {c}'s trace " \
            f"({need[c]} > {len(st.commit)})"

    n_llc = p.llc_lines
    llc_tags = [-1] * n_llc
    llc_owner = [-1] * n_llc
    bus_free = 0
    bus_owner = -1

    for core_id, count in schedule:
        st = cores[core_id]
        (fu_idx, latency_t, is_load_t, is_store_t, is_branch_t,
         read_slots, write_slots) = st.tables
        pcs, eas, takens, commit = st.pcs, st.eas, st.takens, st.commit
        itags, dtags = st.itags, st.dtags
        n_ilines, n_dlines = p.icache_lines, p.dcache_lines
        reg_ready, issue_used = st.reg_ready, st.issue_used
        mshr, store_ready, bpred = st.mshr, st.store_ready, st.bpred

        for i in range(st.i, st.i + count):
            pc = pcs[i]

            # ---------------- fetch ----------------
            line = pc // p.icache_line_insts
            idx = line % n_ilines
            if itags[idx] != line:
                itags[idx] = line
                st.fetch_barrier = max(
                    st.fetch_barrier,
                    st.fetch_cycle + p.icache_miss_cycles)
            else:
                itags[idx] = line
            if st.fetch_cycle < st.fetch_barrier:
                st.fetch_cycle = st.fetch_barrier
                st.fetch_in_group = 0
            elif st.fetch_in_group >= p.fetch_width:
                st.fetch_cycle += 1
                st.fetch_in_group = 0
                if st.fetch_cycle < st.fetch_barrier:
                    st.fetch_cycle = st.fetch_barrier
            f_cyc = st.fetch_cycle
            st.fetch_in_group += 1

            # ---------------- dispatch (ROB back-pressure) ----------------
            disp = f_cyc + p.decode_depth
            if i >= p.rob_entries:
                disp = max(disp, commit[i - p.rob_entries])

            # ---------------- operand readiness ----------------
            ready = disp
            for s in read_slots[pc]:
                r = reg_ready[s]
                if r > ready:
                    ready = r

            # ---------------- issue: FU + issue-bandwidth ----------------
            units = st.fu_units[fu_idx[pc]]
            u = min(range(len(units)), key=units.__getitem__)
            issue = max(ready, units[u])
            while issue_used[issue] >= p.issue_width:
                issue += 1
            issue_used[issue] += 1

            # ---------------- execute ----------------
            lat = latency_t[pc]
            if is_load_t[pc]:
                mline = eas[i] // p.dcache_line_bytes
                didx = mline % n_dlines
                hit = dtags[didx] == mline
                dtags[didx] = mline
                lat = p.dcache_hit_cycles if hit else p.dcache_miss_cycles
                dep = store_ready.get(mline)
                if dep is not None:          # store-to-load forwarding point
                    issue = max(issue, dep)
                if not hit:
                    # shared LLC: only a line another core's fill evicted
                    # costs extra (cold/same-core misses == single-core)
                    lidx = mline % n_llc
                    if llc_tags[lidx] != mline:
                        if llc_tags[lidx] != -1 \
                                and llc_owner[lidx] != core_id:
                            lat += p.llc_extra_miss_cycles
                        llc_tags[lidx] = mline
                    llc_owner[lidx] = core_id
                    # shared bus: wait only on ANOTHER core's transfer
                    if bus_owner != core_id and bus_free > issue:
                        issue = bus_free
                    # MSHR slot bounds this core's own miss overlap
                    m = min(range(len(mshr)), key=mshr.__getitem__)
                    issue = max(issue, mshr[m])
                    mshr[m] = issue + lat
                    bus_owner = core_id
                    bus_free = issue + p.bus_cycles_per_miss
            complete = issue + lat
            units[u] = issue + 1             # pipelined FUs
            fu = fu_idx[pc]
            if fu == 2 or fu == 4:           # unpipelined div/fdiv
                units[u] = complete

            # ---------------- writeback ----------------
            for d in write_slots[pc]:
                reg_ready[d] = complete
            if is_store_t[pc]:
                mline = eas[i] // p.dcache_line_bytes
                dtags[mline % n_dlines] = mline
                store_ready[mline] = complete

            # ---------------- branch resolution ----------------
            if is_branch_t[pc] and takens[i] >= 0:
                c = bpred.get(pc, 2)
                pred = c >= 2
                taken = takens[i] == 1
                bpred[pc] = min(3, c + 1) if taken else max(0, c - 1)
                if pred != taken:
                    st.fetch_barrier = max(
                        st.fetch_barrier,
                        complete + p.mispredict_penalty)

            # ---------------- commit (in order) ----------------
            c = complete + 1
            if c < st.commit_cycle:
                c = st.commit_cycle
            if c > st.commit_cycle:
                st.commit_cycle = c
                st.commit_in_group = 0
            elif st.commit_in_group >= p.commit_width:
                st.commit_cycle += 1
                st.commit_in_group = 0
            st.commit_in_group += 1
            commit[i] = st.commit_cycle
        st.i += count

    for core_id, st in enumerate(cores):
        assert st.i == len(st.commit), \
            f"schedule left core {core_id} partially simulated"
    return [np.asarray(st.commit, np.int64) for st in cores]


def total_cycles_multicore(traces: Sequence[comp.Trace],
                           schedule: Sequence[Tuple[int, int]],
                           params: TimingParams = TimingParams()
                           ) -> List[int]:
    """Per-core total cycles (last commit cycle, 0 for an empty core)."""
    commits = simulate_multicore(traces, schedule, params)
    return [int(c[-1]) if len(c) else 0 for c in commits]
