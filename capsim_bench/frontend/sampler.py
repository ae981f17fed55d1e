"""Code trace clip sampler (paper §IV-B, Fig 3, Fig 8).

Intervals are dominated by a few clip *contents* repeated thousands of times
(loop bodies) plus a long tail of rare unique clips (Fig 8).  The sampler:

  1. groups clips by content key and sorts groups by occurrence count,
  2. splits at ``threshold`` (paper: 200):
       frequent groups  -> sample *within* each group: keep
                           ``max(1, round(count * coef))`` occurrences so the
                           category distribution is preserved while the
                           occurrence numbers drop (paper's "lowering the
                           occurrence number ... preserving category
                           distribution"),
       rare groups      -> sample *across* groups: keep every occurrence of a
                           periodic ``coef`` fraction of the groups (paper's
                           "reduction of categories represented ... instead
                           of adjusting their occurrence number"),
  3. coefficient 0.02 turns the paper's 300 h training corpus into ~10 h.

``stratified_sample`` below is the *inference-time* sampler for the
analytical-ML fusion path (ROADMAP item 4): given per-clip stratum
labels (quantile bins of the analytical cycle estimate,
``analytical.stratify``), it picks a small representative subset per
stratum — deterministic under a seed, every non-empty stratum covered
with at least ``min_per_stratum`` clips — so only that subset runs
through the attention predictor.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np

from capsim_bench.frontend.slicer import Clip


@dataclasses.dataclass(frozen=True)
class SampleStats:
    n_in: int
    n_out: int
    n_groups: int
    n_frequent_groups: int
    n_rare_groups: int
    n_rare_groups_kept: int

    @property
    def reduction(self) -> float:
        return self.n_out / max(self.n_in, 1)


def group_by_content(clips: Sequence[Clip]) -> Dict[int, List[int]]:
    """content key -> indices into ``clips`` (order of appearance)."""
    groups: Dict[int, List[int]] = defaultdict(list)
    for i, c in enumerate(clips):
        groups[c.key].append(i)
    return groups


def occurrence_histogram(clips: Sequence[Clip]) -> List[int]:
    """Occurrence count per unique content, descending (Fig 8b)."""
    return sorted((len(v) for v in group_by_content(clips).values()),
                  reverse=True)


def select_from_groups(groups: Dict[Hashable, List[int]], n_in: int,
                       threshold: int, coef: float
                       ) -> Tuple[List[int], SampleStats]:
    """Core selection over content groups (key -> occurrence indices in
    order of appearance); returns kept indices, sorted ascending.
    Shared by the object (``sample_clips``) and columnar
    (``sample_indices``) paths."""
    # deterministic order: by count desc, then first appearance
    ordered = sorted(groups.items(), key=lambda kv: (-len(kv[1]), kv[1][0]))

    keep: List[int] = []
    n_freq = n_rare = n_rare_kept = 0
    rare_period = max(1, round(1.0 / coef))
    rare_rank = 0
    for key, idxs in ordered:
        count = len(idxs)
        if count > threshold:
            n_freq += 1
            n_keep = max(1, round(count * coef))
            stride = count / n_keep
            keep.extend(idxs[int(j * stride)] for j in range(n_keep))
        else:
            n_rare += 1
            if rare_rank % rare_period == 0:       # periodic across groups
                n_rare_kept += 1
                keep.extend(idxs)
            rare_rank += 1

    keep.sort()
    stats = SampleStats(n_in=n_in, n_out=len(keep),
                        n_groups=len(ordered), n_frequent_groups=n_freq,
                        n_rare_groups=n_rare, n_rare_groups_kept=n_rare_kept)
    return keep, stats


def sample_clips(clips: Sequence[Clip], threshold: int = 200,
                 coef: float = 0.02) -> Tuple[List[Clip], SampleStats]:
    keep, stats = select_from_groups(group_by_content(clips), len(clips),
                                     threshold, coef)
    return [clips[i] for i in keep], stats


def sample_indices(keys: Sequence[Hashable], threshold: int = 200,
                   coef: float = 0.02) -> Tuple[List[int], SampleStats]:
    """Columnar path: clips are identified by precomputed content keys
    (e.g. the bytes of their gathered standardized-token rows) instead of
    materialized ``Clip`` objects.  Returns kept clip indices."""
    groups: Dict[Hashable, List[int]] = defaultdict(list)
    for i, k in enumerate(keys):
        groups[k].append(i)
    return select_from_groups(groups, len(keys), threshold, coef)


# --------------------------------------------------------------------------- #
# Stratified inference-time sampler (analytical-ML fusion path)
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class StratifiedStats:
    n_in: int
    n_out: int
    n_strata: int                     # non-empty strata
    per_stratum: Tuple[Tuple[int, int, int], ...]   # (label, size, kept)

    @property
    def reduction(self) -> float:
        return self.n_out / max(self.n_in, 1)


def stratified_sample(strata: np.ndarray, fraction: float,
                      min_per_stratum: int = 1, seed: int = 0,
                      key: int = 0
                      ) -> Tuple[np.ndarray, StratifiedStats]:
    """Pick ``max(min_per_stratum, ceil(fraction * size))`` clips per
    non-empty stratum, without replacement, deterministically.

    ``strata`` is the (n,) per-clip label array; the draw is seeded by
    ``(seed, key)`` so distinct jobs (benchmarks, cores) sample
    independently but reproducibly.  Strata iterate in sorted label
    order and each stratum's picks come back sorted, so the result is
    invariant to how labels were numbered.  Returns (sorted indices,
    stats); ``fraction=1.0`` returns every index — the bitwise-identity
    contract the fusion path's ``fraction=1.0`` mode relies on.
    """
    strata = np.asarray(strata)
    n = strata.shape[0]
    rng = np.random.default_rng(
        np.asarray([abs(int(seed)), abs(int(key))], np.uint64))
    keep: List[np.ndarray] = []
    per: List[Tuple[int, int, int]] = []
    for label in np.unique(strata):
        idxs = np.flatnonzero(strata == label)
        size = idxs.shape[0]
        k = min(size, max(min_per_stratum,
                          math.ceil(fraction * size)))
        # rng.choice without replacement, sorted: deterministic and
        # independent of the stratum's internal ordering
        take = np.sort(rng.choice(size, size=k, replace=False))
        keep.append(idxs[take])
        per.append((int(label), size, k))
    indices = (np.sort(np.concatenate(keep)) if keep
               else np.zeros(0, np.int64)).astype(np.int64)
    stats = StratifiedStats(n_in=n, n_out=int(indices.shape[0]),
                            n_strata=len(per), per_stratum=tuple(per))
    return indices, stats
