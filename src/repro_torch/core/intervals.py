"""SimPoint-style interval selection (paper §II sampling background, Fig 2).

Programs are executed functionally in fixed-size intervals; each interval is
summarized by its Basic-Block Vector (how often each basic block is entered,
SimPoint's metric).  k-means over the normalized BBVs picks one
representative interval (checkpoint) per cluster with a weight equal to the
cluster's share — the classic SimPoint recipe, implemented in numpy so the
framework carries no external dependency.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.isa.funcsim import MachineState, run
from repro_torch.isa.isa import Instruction


def basic_block_leaders(program: Sequence[Instruction]) -> np.ndarray:
    """Boolean mask over pcs: True where a basic block starts."""
    leaders = np.zeros(len(program), bool)
    if len(program):
        leaders[0] = True
    for pc, inst in enumerate(program):
        if inst.info.is_branch:
            if pc + 1 < len(program):
                leaders[pc + 1] = True
            if inst.target is not None and 0 <= inst.target < len(program):
                leaders[inst.target] = True
    return leaders


@dataclasses.dataclass(frozen=True)
class IntervalInfo:
    index: int                 # interval number within the run
    start: int                 # dynamic instruction offset
    weight: float              # cluster share
    bbv: np.ndarray


def interval_bbvs(program: Sequence[Instruction], total_insts: int,
                  interval_size: int,
                  state: Optional[MachineState] = None
                  ) -> Tuple[np.ndarray, MachineState]:
    """Run functionally, counting basic-block entries per interval.

    Returns (bbvs (n_intervals, n_blocks) float32, final_state).
    """
    leaders = basic_block_leaders(program)
    block_id = np.cumsum(leaders) - 1                   # pc -> block index
    n_blocks = int(block_id[-1]) + 1 if len(program) else 0

    st = state or MachineState.fresh()
    bbvs: List[np.ndarray] = []
    remaining = total_insts
    while remaining > 0:
        n = min(interval_size, remaining)
        trace, _, st = run(program, n, state=st)
        if not trace:
            break
        vec = np.zeros(n_blocks, np.float32)
        for e in trace:
            if leaders[e.pc]:
                vec[block_id[e.pc]] += 1.0
        bbvs.append(vec)
        remaining -= len(trace)
        if len(trace) < n:                              # program exited
            break
    return (np.stack(bbvs) if bbvs else
            np.zeros((0, n_blocks), np.float32)), st


def _kmeans(x: np.ndarray, k: int, iters: int = 25,
            seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Plain Lloyd's k-means.  Returns (assignments, centroids)."""
    rng = np.random.RandomState(seed)
    n = x.shape[0]
    k = min(k, n)
    centroids = x[rng.choice(n, size=k, replace=False)].copy()
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = ((x[:, None, :] - centroids[None]) ** 2).sum(-1)
        new_assign = d.argmin(1)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for c in range(k):
            m = assign == c
            if m.any():
                centroids[c] = x[m].mean(0)
    return assign, centroids


def pick_intervals(program: Sequence[Instruction], total_insts: int,
                   interval_size: int, k: int,
                   seed: int = 0) -> List[IntervalInfo]:
    """SimPoint: representative interval per k-means cluster + weights."""
    bbvs, _ = interval_bbvs(program, total_insts, interval_size)
    n = bbvs.shape[0]
    if n == 0:
        return []
    norms = np.linalg.norm(bbvs, axis=1, keepdims=True)
    x = bbvs / np.maximum(norms, 1e-9)
    assign, centroids = _kmeans(x, k, seed=seed)
    out: List[IntervalInfo] = []
    for c in range(centroids.shape[0]):
        members = np.flatnonzero(assign == c)
        if members.size == 0:
            continue
        d = ((x[members] - centroids[c]) ** 2).sum(1)
        rep = int(members[d.argmin()])
        out.append(IntervalInfo(index=rep, start=rep * interval_size,
                                weight=members.size / n, bbv=bbvs[rep]))
    out.sort(key=lambda i: i.index)
    return out
