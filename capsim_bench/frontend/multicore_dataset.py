"""Multicore clip-dataset pipeline (the training half of the multicore
subsystem; port of ``repro/data/multicore_dataset.py``, a copy with its
imports retargeted).

The multicore engine prices contention at inference; this module makes
the predictor *train* on the contention it is asked to price.  Per mt.*
benchmark and checkpoint:

  1. ``multicore.run_multicore`` traces the interval — N per-core
     columnar traces over one shared memory, plus the deterministic
     commit interleave,
  2. ``timing.simulate_multicore`` assigns per-core commit cycles under
     the shared LLC / bus — so a clip's ground-truth runtime *includes*
     the stalls other cores inflicted on it,
  3. ``slicer.slice_multicore_columnar`` runs Algorithm 1 independently
     over each core's commit column (training-side commit-boundary
     slicing; inference keeps ``fixed_bounds``),
  4. the occurrence sampler thins each (benchmark, core) clip set on the
     same standardized-token content keys as the single-core build,
  5. a deterministic replay (``run_multicore`` with per-core
     ``snapshot_at``) snapshots each core's architectural state before
     every surviving clip — and, with ``peer_channels``, the *other*
     cores' states at the enclosing quantum start,
  6. the shared tokenize/pack pipeline (``standardize`` /
     ``dataset.pack_interval_clips``) emits the fixed-shape tensors.

Context layouts (widths all derive from ``context.context_len``):

  n_cores == 1            CONTEXT_LEN — the build degenerates to the
                          single-core pipeline bit for bit (the N=1
                          anchor: identical to ``build_dataset`` over
                          ``multicore.single_core_benchmark``),
  peer_channels == False  MULTICORE_CONTEXT_LEN — the engine's core-tagged
                          inference layout,
  peer_channels == True   n_cores * MULTICORE_CONTEXT_LEN — one
                          ``<CORE>``-tagged register block per core,
                          self first, so the block encoder can attend
                          across cores and learn interference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from capsim_bench.frontend import context as ctx_mod
from capsim_bench.frontend import slicer as slicer_mod
from capsim_bench.frontend import standardize as std_mod
from capsim_bench.frontend.dataset import (BuildConfig, BuildStats,
                                      ClipDataset, empty_dataset,
                                      pack_interval_clips,
                                      sample_interval_clips)
from capsim_bench.frontend import multicore, timing


@dataclasses.dataclass(frozen=True)
class MulticoreBuildConfig(BuildConfig):
    n_cores: int = 2
    quantum: int = multicore.DEFAULT_QUANTUM
    peer_channels: bool = False
    # close the sub-l_min residue after each core's final Algorithm-1
    # boundary as one extra clip (clip times then sum to the oracle's
    # per-core totals); off by default to stay bitwise with the
    # single-core slicer at N=1
    include_tail: bool = False

    @property
    def context_len(self) -> int:
        return ctx_mod.context_len(self.n_cores, self.peer_channels)


def _interval_core_context(mtrace: multicore.MulticoreTrace, core: int,
                           bcfg: MulticoreBuildConfig,
                           vocab: std_mod.Vocab) -> np.ndarray:
    """Step-5 context for one (checkpoint, core) replay: plain
    single-core rows at N=1, core-tagged rows otherwise, peer blocks
    appended when mixing is on."""
    snaps = mtrace.cores[core].snapshots
    if bcfg.n_cores == 1:
        return ctx_mod.context_tokens_from_matrix(snaps, vocab)
    if not bcfg.peer_channels:
        return ctx_mod.context_tokens_from_matrix(snaps, vocab,
                                                  core_id=core)
    return ctx_mod.peer_context_tokens(
        snaps, mtrace.peer_snapshots[core], core, vocab)


def build_multicore_bench_clips(mb: multicore.MulticoreBenchmark,
                                bcfg: MulticoreBuildConfig,
                                vocab: std_mod.Vocab,
                                stats: Optional[BuildStats] = None
                                ) -> ClipDataset:
    """Steps 1-6 for one multicore benchmark: (benchmark, core) clip
    shards whose ground-truth times are per-core commit-cycle deltas
    from the shared-resource oracle."""
    stats = stats if stats is not None else BuildStats()
    assert mb.n_cores == bcfg.n_cores, (mb.n_cores, bcfg.n_cores)
    cprogs = mb.compiled()
    tables = [cp.token_table(vocab, bcfg.l_token) for cp in cprogs]
    states = mb.fresh_states()
    t0 = time.time()
    multicore.run_multicore(cprogs, bcfg.warmup, states,
                            quantum=bcfg.quantum)
    stats.interpret_seconds += time.time() - t0

    parts: List[Tuple[np.ndarray, ...]] = []
    names: List[str] = []
    n_ckp = min(mb.ckp_num, bcfg.max_checkpoints)
    for _ in range(n_ckp):
        st_ckp = multicore.clone_states(states)         # replay anchor
        t0 = time.time()
        mtrace = multicore.run_multicore(cprogs, bcfg.interval_size,
                                         states, quantum=bcfg.quantum)
        stats.interpret_seconds += time.time() - t0
        if len(mtrace) == 0:
            break
        stats.n_instructions += len(mtrace)
        t0 = time.time()
        commits = timing.simulate_multicore(mtrace.cores, mtrace.schedule,
                                            bcfg.timing_params)
        stats.oracle_seconds += time.time() - t0
        t0 = time.time()
        sliced = slicer_mod.slice_multicore_columnar(
            commits, bcfg.l_min, include_tail=bcfg.include_tail)
        stats.slice_seconds += time.time() - t0

        rows_pc: List[Optional[np.ndarray]] = [None] * mb.n_cores
        keeps: List[List[int]] = [[] for _ in range(mb.n_cores)]
        starts: List[List[int]] = [[] for _ in range(mb.n_cores)]
        for c, (bounds, _) in enumerate(sliced):
            if not len(bounds):
                continue
            stats.n_sliced += len(bounds)
            rows_pc[c] = tables[c][mtrace.cores[c].pc]
            keeps[c] = sample_interval_clips(rows_pc[c], bounds, bcfg,
                                             stats)
            starts[c] = bounds[keeps[c], 0].tolist() if keeps[c] else []
        if not any(keeps):
            continue
        t0 = time.time()
        replay = multicore.run_multicore(
            cprogs, bcfg.interval_size, st_ckp, quantum=bcfg.quantum,
            snapshot_at=starts,
            peer_snapshots=bcfg.peer_channels and mb.n_cores > 1)
        stats.replay_seconds += time.time() - t0
        for c in range(mb.n_cores):
            if not keeps[c]:
                continue
            bounds, times = sliced[c]
            snaps = replay.cores[c].snapshots
            assert snaps.shape[0] == len(keeps[c]), \
                (c, snaps.shape, len(keeps[c]))
            t0 = time.time()
            ctx = _interval_core_context(replay, c, bcfg, vocab)
            stats.context_seconds += time.time() - t0
            parts.append(pack_interval_clips(rows_pc[c], bounds, times,
                                             keeps[c], ctx, bcfg, stats))
            names.extend([_shard_name(mb, c)] * len(keeps[c]))

    if not parts:
        return empty_dataset(bcfg, bcfg.context_len)
    return ClipDataset(np.concatenate([p[0] for p in parts]),
                       np.concatenate([p[1] for p in parts]),
                       np.concatenate([p[2] for p in parts]),
                       np.concatenate([p[3] for p in parts]), names)


def _shard_name(mb: multicore.MulticoreBenchmark, core: int) -> str:
    """(benchmark, core) provenance; at N=1 the bare benchmark name, so
    the N=1 build is identical to ``build_dataset`` in names too."""
    return mb.name if mb.n_cores == 1 else f"{mb.name}#c{core}"


def build_multicore_dataset(bench_names: Sequence[str],
                            bcfg: MulticoreBuildConfig,
                            vocab: Optional[std_mod.Vocab] = None,
                            verbose: bool = False,
                            stats: Optional[BuildStats] = None
                            ) -> ClipDataset:
    """The multicore mirror of ``build_dataset``: one ``ClipDataset`` of
    (benchmark, core) shards over the mt.* suite."""
    vocab = vocab or std_mod.build_vocab()
    parts = []
    for name in bench_names:
        t0 = time.time()
        mb = multicore.build_multicore_benchmark(name, bcfg.n_cores)
        part = build_multicore_bench_clips(mb, bcfg, vocab, stats=stats)
        parts.append(part)
        if verbose:
            print(f"  {name} x{bcfg.n_cores}: {len(part)} clips "
                  f"({time.time()-t0:.1f}s)")
    ds = ClipDataset.concat(parts)
    assert ds.context_len == bcfg.context_len or len(ds) == 0, \
        (ds.context_len, bcfg.context_len)
    return ds.validate()
