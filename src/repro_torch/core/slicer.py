"""Instruction sequence slicer (paper §IV-A, Algorithm 1).

Cuts a committed instruction trace into *code trace clips*.  A clip closes
once (a) it holds at least ``l_min`` instructions AND (b) the current
commit time differs from the previous instruction's commit time — so a
clip boundary never splits a group of instructions that committed in the
same cycle, which keeps the clip runtime well defined (the paper's two
principles).  The clip's ground-truth runtime is the difference between
the previous commit time and the clip's begin time.

At inference CAPSim has no commit times (the functional simulator is
atomic), so ``slice_fixed`` cuts every ``l_min`` instructions; the
commit-boundary rule exists to make *training* targets exact.

Columnar path: on a ``repro_torch.isa.compiled.Trace`` a clip is just a
``(start, end)`` view into the trace columns, so ``fixed_bounds`` and
``slice_trace_columnar`` return ``(k, 2)`` bound arrays (plus times)
instead of materialized ``Clip`` objects — ``slice_trace_columnar`` finds
commit-time boundaries with one ``np.diff`` and a greedy pass over the
(few) change points.  ``clips_from_columnar`` is the object adapter.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.isa.isa import Instruction


@dataclasses.dataclass
class Clip:
    insts: List[Instruction]
    time: float                 # runtime in cycles (0.0 when unknown)
    start: int                  # trace position of first instruction
    # content key for the sampler (None = not yet computed; a computed
    # key may legitimately be 0, so 0 must not double as the sentinel)
    _key: Optional[int] = None

    def __len__(self) -> int:
        return len(self.insts)

    @property
    def key(self) -> int:
        if self._key is None:
            self._key = hash(tuple(
                (i.op, i.dsts, i.srcs, i.imm is not None,
                 i.mem_base) for i in self.insts))
        return self._key


def slice_trace(insts: Sequence[Instruction],
                commit_times: Sequence[float],
                l_min: int) -> List[Clip]:
    """Algorithm 1.  ``commit_times[i]`` is instruction i's commit cycle."""
    assert len(insts) == len(commit_times)
    clips: List[Clip] = []
    if not insts:
        return clips
    b: List[Instruction] = []
    b_start = 0
    inst_prev = insts[0]
    block_length = 0
    time_prev = 0.0
    time_begin = 0.0
    for idx in range(len(insts)):
        inst_now = insts[idx]
        time_now = float(commit_times[idx])
        b.append(inst_prev)
        block_length += 1
        if block_length >= l_min and time_now != time_prev:
            clips.append(Clip(insts=b, time=time_prev - time_begin,
                              start=b_start))
            time_begin = time_prev
            b = []
            b_start = idx
            block_length = 0
        inst_prev = inst_now
        time_prev = time_now
    return clips


def slice_fixed(insts: Sequence[Instruction], l_min: int) -> List[Clip]:
    """Fixed-length slicing for inference (no commit times available)."""
    clips = []
    for off in range(0, len(insts) - l_min + 1, l_min):
        clips.append(Clip(insts=list(insts[off: off + l_min]), time=0.0,
                          start=off))
    rem = len(insts) % l_min
    if rem:
        off = len(insts) - rem
        clips.append(Clip(insts=list(insts[off:]), time=0.0, start=off))
    return clips


def clip_boundaries(clips: Sequence[Clip]) -> List[int]:
    return [c.start for c in clips]


def total_time(clips: Sequence[Clip]) -> float:
    return sum(c.time for c in clips)


# --------------------------------------------------------------------------- #
# Columnar slicing: clips as (start, end) bounds into trace columns
# --------------------------------------------------------------------------- #

def fixed_bounds(n: int, l_min: int) -> np.ndarray:
    """``slice_fixed`` bounds: ``(k, 2) int64`` rows of (start, end).

    Same clip partition as ``slice_fixed`` over an ``n``-entry trace:
    full ``l_min`` windows plus one remainder clip.
    """
    starts = np.arange(0, max(n - l_min + 1, 0), l_min, dtype=np.int64)
    ends = starts + l_min
    rem = n % l_min
    if rem:
        starts = np.append(starts, n - rem)
        ends = np.append(ends, n)
    return np.stack([starts, ends], axis=1)


def _slice_commit_column(commit_times: np.ndarray, l_min: int,
                         include_tail: bool
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Shared Algorithm-1 core over one commit-cycle column.

    With ``include_tail`` the residue after the final Algorithm-1 close
    (the block that never reaches ``l_min`` *and* a commit change point)
    becomes one extra closing clip, so the bounds partition the whole
    trace and the clip times telescope to ``commit[-1]`` exactly — the
    multicore training-target mode.  Without it, the residue is dropped,
    matching ``slice_trace`` / the paper's Algorithm 1 verbatim.
    """
    c = np.asarray(commit_times, np.float64)
    n = c.shape[0]
    if n == 0:
        return np.zeros((0, 2), np.int64), np.zeros(0, np.float64)
    changes = np.flatnonzero(np.diff(c) != 0.0) + 1
    if c[0] != 0.0:                            # time_prev starts at 0.0
        changes = np.concatenate([[0], changes])
    closes: List[int] = []
    last = -1
    for idx in changes.tolist():
        if idx - last >= l_min:                # block_length == idx - last
            closes.append(idx)
            last = idx
    if include_tail and last < n:
        closes.append(n)                       # residue clip, < l_min ok
    k = len(closes)
    if k == 0:
        return np.zeros((0, 2), np.int64), np.zeros(0, np.float64)
    ends = np.asarray(closes, np.int64)
    starts = np.concatenate([[0], ends[:-1]])
    # clip j runtime telescopes between the commit times just before the
    # closes; time_begin is 0.0 before the first close
    prev_commit = np.where(ends >= 1, c[np.maximum(ends - 1, 0)], 0.0)
    times = np.diff(np.concatenate([[0.0], prev_commit]))
    return np.stack([starts, ends], axis=1), times


def slice_trace_columnar(commit_times: np.ndarray, l_min: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Columnar Algorithm 1 over a commit-cycle column.

    Returns ``(bounds, times)``: ``bounds[j] = (start, end)`` indexes the
    trace columns and ``times[j]`` is the clip runtime.  Equivalent to
    ``slice_trace`` with one quirk inherited from it: Algorithm 1 seeds
    the block with I[0], so clip 0 additionally carries a duplicated
    leading instruction (``clips_from_columnar`` reproduces it; bounds
    alone describe clips 1..k-1 exactly).

    A clip closes at trace position ``idx`` when the block holds at
    least ``l_min`` instructions and ``commit[idx] != commit[idx-1]`` —
    i.e. at a commit-time *change point*, found here with ``np.diff``;
    the greedy selection walks only the change points, not the trace.
    """
    return _slice_commit_column(commit_times, l_min, include_tail=False)


def slice_multicore_columnar(commits: Sequence[np.ndarray], l_min: int,
                             include_tail: bool = False
                             ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-core Algorithm-1 slicing over multicore commit columns.

    ``commits`` is ``timing.simulate_multicore``'s output: one commit-
    cycle column per core, in the shared-resource interleave.  Each core
    slices independently — clip boundaries are core-local commit events,
    so a clip's runtime is that core's commit-cycle delta *including* any
    LLC/bus stalls other cores inflicted on it — which is exactly the
    contention signal the multicore training targets must price.

    Returns one ``(bounds, times)`` pair per core (``slice_trace_columnar``
    semantics, duplicated-lead quirk included).  ``include_tail`` closes
    the sub-``l_min`` residue block after each core's final Algorithm-1
    boundary as one extra clip, making the bounds cover the core's whole
    trace and ``times`` sum to the core's total cycles (``commit[-1]``);
    the default drops the residue, bitwise matching the single-core
    training slicer — the ``N=1 == build_dataset`` anchor.
    """
    return [_slice_commit_column(c, l_min, include_tail) for c in commits]


def clip_lengths(bounds: np.ndarray) -> np.ndarray:
    """Instruction count per columnar clip (clip 0 carries the
    duplicated leading instruction — see ``slice_trace_columnar``)."""
    lens = bounds[:, 1] - bounds[:, 0]
    if len(lens):
        lens = lens.copy()
        lens[0] += 1
    return lens


def clips_from_columnar(insts: Sequence[Instruction], bounds: np.ndarray,
                        times: Optional[np.ndarray] = None) -> List[Clip]:
    """Object adapter: materialize ``Clip``s from columnar bounds
    (matches ``slice_trace`` bit for bit, duplicated lead included)."""
    out: List[Clip] = []
    for j in range(bounds.shape[0]):
        s, e = int(bounds[j, 0]), int(bounds[j, 1])
        body = list(insts[s:e])
        if j == 0:
            body = [insts[0]] + body
        out.append(Clip(insts=body,
                        time=float(times[j]) if times is not None else 0.0,
                        start=s))
    return out
