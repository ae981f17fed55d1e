"""Clip dataset pipeline (paper Fig 2): benchmarks -> intervals -> timed
traces -> sliced clips -> sampled + tokenized tensors.

Per benchmark checkpoint (interval):
  1. functional warm-up, then trace the interval (columnar funcsim over
     the benchmark's ``CompiledProgram``),
  2. O3 oracle assigns commit cycles (columnar ``isa/timing``) — the
     golden runtimes,
  3. Algorithm 1 slices the trace into (start, end) clip bounds
     (``slicer.slice_trace_columnar``: one np.diff + a greedy pass),
  4. the occurrence sampler thins the clip set (core/sampler) — clip
     content keys are the bytes of gathered standardized-token rows,
  5. a replay pass snapshots the architectural context at each surviving
     clip's start (the CPU state *before* the clip, §V-B) into a uint64
     snapshot matrix,
  6. a token-table gather + vectorized byte decomposition produce the
     fixed-shape int32 tensors — no per-instruction Python.

The arrays are plain numpy: each data-parallel host builds/loads its own
shard (clips are i.i.d., so sharding is a pure range split — see
``shard_range``), and ``batches`` yields ready-to-jit dict batches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from capsim_bench.frontend import context as ctx_mod
from capsim_bench.frontend import sampler as sampler_mod
from capsim_bench.frontend import slicer as slicer_mod
from capsim_bench.frontend import standardize as std_mod
from capsim_bench.frontend import funcsim, progen, timing


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    interval_size: int = 20_000       # paper: 5M; scaled for offline CPU
    warmup: int = 2_000               # paper: 1M
    max_checkpoints: int = 4          # cap Table II counts for wall time
    l_min: int = 100                  # paper §IV-B
    l_clip: int = 128                 # pad target (l_min..~l_min+width)
    l_token: int = 16
    threshold: int = 200              # sampler occurrence threshold
    coef: float = 0.02                # sampler coefficient
    sample: bool = True
    timing_params: timing.TimingParams = timing.TimingParams()


@dataclasses.dataclass
class BuildStats:
    """Per-stage wall-time breakdown across a dataset build — the
    dataset-build analogue of the engine's ``FrontendStats``, reported by
    ``bench_speed --dataset-build`` so build throughput joins the perf
    trajectory."""

    interpret_seconds: float = 0.0    # functional warmup + interval traces
    oracle_seconds: float = 0.0       # commit-cycle ground truth
    slice_seconds: float = 0.0        # Algorithm-1 bounds
    sample_seconds: float = 0.0       # content keys + occurrence sampler
    replay_seconds: float = 0.0       # snapshot replay pass
    tokenize_seconds: float = 0.0     # token-row gather + clip packing
    context_seconds: float = 0.0      # snapshot byte decomposition
    n_instructions: int = 0
    n_sliced: int = 0                 # clips before sampling
    n_clips: int = 0                  # clips kept in the dataset

    @property
    def build_seconds(self) -> float:
        return (self.interpret_seconds + self.oracle_seconds
                + self.slice_seconds + self.sample_seconds
                + self.replay_seconds + self.tokenize_seconds
                + self.context_seconds)

    def as_dict(self) -> Dict[str, float]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)} | {
                    "build_seconds": self.build_seconds}


@dataclasses.dataclass
class ClipDataset:
    clip_tokens: np.ndarray           # (N, l_clip, l_token) int32
    # (N, M) int32 — M is ctx_mod.context_len(n_cores, peer_channels):
    # CONTEXT_LEN single-core, MULTICORE_CONTEXT_LEN core-tagged,
    # n_cores such blocks with peer channels mixed in
    context_tokens: np.ndarray
    clip_mask: np.ndarray             # (N, l_clip) float32
    time: np.ndarray                  # (N,) float32
    bench_names: List[str]            # provenance per clip

    def __len__(self) -> int:
        return self.clip_tokens.shape[0]

    @property
    def context_len(self) -> int:
        return self.context_tokens.shape[1]

    def validate(self) -> "ClipDataset":
        """Dataset-build boundary check: consistent clip counts and a
        recognized context layout (no stale hard-coded widths)."""
        n = len(self)
        assert self.context_tokens.shape[0] == n, self.context_tokens.shape
        assert self.clip_mask.shape[0] == n, self.clip_mask.shape
        assert self.time.shape[0] == n, self.time.shape
        assert len(self.bench_names) == n, (len(self.bench_names), n)
        ctx_mod.validate_context_width(self.context_len, "ClipDataset")
        return self

    def select(self, idx: np.ndarray) -> "ClipDataset":
        return ClipDataset(self.clip_tokens[idx], self.context_tokens[idx],
                           self.clip_mask[idx], self.time[idx],
                           [self.bench_names[i] for i in idx])

    @staticmethod
    def concat(parts: Sequence["ClipDataset"]) -> "ClipDataset":
        return ClipDataset(
            np.concatenate([p.clip_tokens for p in parts]),
            np.concatenate([p.context_tokens for p in parts]),
            np.concatenate([p.clip_mask for p in parts]),
            np.concatenate([p.time for p in parts]),
            sum((p.bench_names for p in parts), []))

    def save(self, path) -> None:
        np.savez_compressed(
            path, clip_tokens=self.clip_tokens,
            context_tokens=self.context_tokens, clip_mask=self.clip_mask,
            time=self.time, bench_names=np.array(self.bench_names))

    @staticmethod
    def load(path) -> "ClipDataset":
        z = np.load(path, allow_pickle=False)
        return ClipDataset(z["clip_tokens"], z["context_tokens"],
                           z["clip_mask"], z["time"],
                           [str(s) for s in z["bench_names"]])


def empty_dataset(bcfg: BuildConfig,
                  context_len: Optional[int] = None) -> ClipDataset:
    """Zero-clip dataset with the build's tensor shapes (the degenerate
    part both builders emit for a clip-less benchmark)."""
    m = ctx_mod.CONTEXT_LEN if context_len is None else context_len
    return ClipDataset(
        np.zeros((0, bcfg.l_clip, bcfg.l_token), np.int32),
        np.zeros((0, m), np.int32),
        np.zeros((0, bcfg.l_clip), np.float32),
        np.zeros((0,), np.float32), [])


def sample_interval_clips(rows: np.ndarray, bounds: np.ndarray,
                          bcfg: BuildConfig,
                          stats: BuildStats) -> List[int]:
    """Step 4 (shared by the single- and multicore builds): occurrence-
    sample one interval's Algorithm-1 clips on their standardized-token
    content keys; ``bcfg.sample=False`` keeps everything."""
    t0 = time.time()
    if bcfg.sample:
        # content key = the clip's standardized-token bytes: exactly
        # what Fig-5 standardization preserves of the instructions
        keys = std_mod.bounded_clip_keys(rows, bounds)
        keep, _ = sampler_mod.sample_indices(keys, bcfg.threshold,
                                             bcfg.coef)
    else:
        keep = list(range(len(bounds)))
    stats.sample_seconds += time.time() - t0
    return keep


def pack_interval_clips(rows: np.ndarray, bounds: np.ndarray,
                        times: np.ndarray, keep: Sequence[int],
                        ctx: np.ndarray, bcfg: BuildConfig,
                        stats: BuildStats
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Step 6 (shared): tokenize the kept clips of one interval into the
    fixed-shape dataset tensors; ``ctx`` is the already-built context
    matrix for the same kept clips (step 5)."""
    assert ctx.shape[0] == len(keep), (ctx.shape, len(keep))
    t0 = time.time()
    toks, mask = std_mod.encode_bounded_clips(rows, bounds, keep,
                                              bcfg.l_clip)
    t = np.asarray([float(times[j]) for j in keep], np.float32)
    stats.tokenize_seconds += time.time() - t0
    stats.n_clips += len(keep)
    return toks, ctx, mask, t


def build_bench_clips(bench: progen.Benchmark, bcfg: BuildConfig,
                      vocab: std_mod.Vocab,
                      stats: Optional[BuildStats] = None) -> ClipDataset:
    """Steps 1-6 for one benchmark, entirely on the columnar IR."""
    stats = stats if stats is not None else BuildStats()
    cprog = bench.compiled()
    token_table = cprog.token_table(vocab, bcfg.l_token)
    st = progen.fresh_compiled_state(bench)
    t0 = time.time()
    _, st = funcsim.run_compiled(cprog, bcfg.warmup, st)
    stats.interpret_seconds += time.time() - t0

    parts: List[Tuple[np.ndarray, ...]] = []
    n_ckp = min(bench.ckp_num, bcfg.max_checkpoints)
    for _ in range(n_ckp):
        st_ckp = st.clone()                             # replay anchor
        t0 = time.time()
        trace, st = funcsim.run_compiled(cprog, bcfg.interval_size, st)
        stats.interpret_seconds += time.time() - t0
        if not len(trace):
            break
        stats.n_instructions += len(trace)
        t0 = time.time()
        commits = timing.simulate_columnar(trace, bcfg.timing_params)
        stats.oracle_seconds += time.time() - t0
        t0 = time.time()
        bounds, times = slicer_mod.slice_trace_columnar(commits, bcfg.l_min)
        stats.slice_seconds += time.time() - t0
        if not len(bounds):
            continue
        stats.n_sliced += len(bounds)
        rows = token_table[trace.pc]
        keep = sample_interval_clips(rows, bounds, bcfg, stats)
        if not keep:
            continue
        starts = bounds[keep, 0].tolist()
        t0 = time.time()
        replay, _ = funcsim.run_compiled(cprog, bcfg.interval_size, st_ckp,
                                         snapshot_at=starts)
        stats.replay_seconds += time.time() - t0
        snaps = replay.snapshots
        assert snaps.shape[0] == len(keep), (snaps.shape, len(keep))
        t0 = time.time()
        ctx = ctx_mod.context_tokens_from_matrix(snaps, vocab)
        stats.context_seconds += time.time() - t0
        parts.append(pack_interval_clips(rows, bounds, times, keep, ctx,
                                         bcfg, stats))

    if not parts:
        return empty_dataset(bcfg)
    n = sum(p[0].shape[0] for p in parts)
    return ClipDataset(np.concatenate([p[0] for p in parts]),
                       np.concatenate([p[1] for p in parts]),
                       np.concatenate([p[2] for p in parts]),
                       np.concatenate([p[3] for p in parts]),
                       [bench.name] * n)


def build_dataset(bench_names: Sequence[str], bcfg: BuildConfig,
                  vocab: Optional[std_mod.Vocab] = None,
                  verbose: bool = False,
                  stats: Optional[BuildStats] = None) -> ClipDataset:
    vocab = vocab or std_mod.build_vocab()
    parts = []
    for name in bench_names:
        t0 = time.time()
        part = build_bench_clips(progen.build_benchmark(name), bcfg, vocab,
                                 stats=stats)
        parts.append(part)
        if verbose:
            print(f"  {name}: {len(part)} clips ({time.time()-t0:.1f}s)")
    return ClipDataset.concat(parts).validate()


def build_set_datasets(bcfg: BuildConfig,
                       vocab: Optional[std_mod.Vocab] = None,
                       verbose: bool = False) -> Dict[int, ClipDataset]:
    """The six Table-II benchmark sets (Fig 11 train/test protocol)."""
    vocab = vocab or std_mod.build_vocab()
    out = {}
    for s in progen.SET_NUMBERS:
        names = [b.name for b in progen.benchmarks_in_set(s)]
        out[s] = build_dataset(names, bcfg, vocab, verbose=verbose)
    return out


def split_dataset(ds: ClipDataset, fractions=(0.8, 0.1, 0.1),
                  seed: int = 0) -> Tuple[ClipDataset, ...]:
    """Random 80/10/10 split (paper §VI-B method 1)."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(ds))
    out = []
    lo = 0
    for i, f in enumerate(fractions):
        hi = len(ds) if i == len(fractions) - 1 else lo + int(f * len(ds))
        out.append(ds.select(idx[lo:hi]))
        lo = hi
    return tuple(out)


def indexed_clips(ds: ClipDataset) -> Tuple[np.ndarray, np.ndarray]:
    """Dedupe a dataset's instruction rows for RT-cache-style serving:
    returns ``(row_table (n_unique, l_token) int32, rt_idx (N, l_clip)
    int32)`` with ``row_table[rt_idx]`` bitwise equal to
    ``ds.clip_tokens``.

    Traces are loopy, so n_unique is orders of magnitude below N x l_clip
    — this is both a storage compression and the bridge to cache-aware
    evaluation: ``RTCache.ensure_rows(row_table)`` maps local row ids to
    global ones, after which every eval batch is an ``rt_idx`` gather
    through ``predictor.forward_cached``.  When the dataset has any
    masked (all-<PAD>) slot the all-zero row occupies local row 0
    (``dedupe_token_rows``), matching the cache's pad slot.
    """
    n, l_clip, l_token = ds.clip_tokens.shape
    uniq, inv = std_mod.dedupe_token_rows(
        ds.clip_tokens.reshape(n * l_clip, l_token))
    return uniq, inv.reshape(n, l_clip)


def shard_range(n: int, host: int, n_hosts: int) -> Tuple[int, int]:
    """Contiguous per-host shard bounds (clips are i.i.d.)."""
    per = n // n_hosts
    lo = host * per
    hi = n if host == n_hosts - 1 else lo + per
    return lo, hi


def batches(ds: ClipDataset, batch_size: int, seed: int = 0,
            shuffle: bool = True, epochs: int = 1,
            include_time: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Yields dict batches; short final batches are dropped (fixed shapes
    keep XLA from recompiling)."""
    n = len(ds)
    rng = np.random.RandomState(seed)
    for _ in range(epochs):
        order = rng.permutation(n) if shuffle else np.arange(n)
        for lo in range(0, n - batch_size + 1, batch_size):
            idx = order[lo: lo + batch_size]
            b = {"clip_tokens": ds.clip_tokens[idx],
                 "context_tokens": ds.context_tokens[idx],
                 "clip_mask": ds.clip_mask[idx]}
            if include_time:
                b["time"] = ds.time[idx]
            yield b
