"""Analytical-ML fusion: per-clip analytical features + residual fit.

Concorde-style fusion (PAPERS.md): a cheap compositional *analytical*
model captures most of each clip's cycle count from first principles —
ILP dependency chains, functional-unit structural bounds, cache-line
footprints, memory-level parallelism, branch behaviour — and a small ML
correction closes the gap.  Here the attention predictor plays the
"expensive model" role: only a stratified *sample* of clips runs through
it (``core/sampler.stratified_sample``); a ridge fit from analytical
features to the sampled model predictions extrapolates the rest, with a
per-stratum mean-residual correction and a stratified bootstrap
confidence interval over the total — PAI-style projection of a full
benchmark from partial simulation, with honest error bars.

Feature vocabulary mirrors ``launch/roofline.py``: each clip gets a
compute term (dependency-chain critical path, FU occupancy bound), a
memory term (unique D-cache lines x miss latency, MSHR-bounded miss
waves), and the roofline max of the two as the clip's analytical cycle
estimate — the stratification key.  All statics come straight from the
timing oracle's own tables (``timing._static_tables``), so the features
and the O3 oracle describe the same machine.

Two feature front-ends feed the same estimator:

  ``clip_features``       trace engine — the columnar ``Trace`` is in
                          hand, so features are exact per the greedy
                          model's vocabulary.  Windows follow the
                          ``slice_fixed`` partition exactly
                          (``l_min`` windows + remainder), so feature
                          row i describes predicted clip i.
  ``token_clip_features`` serving engine — requests carry only
                          tokenized clips, so features degrade to
                          token-level occupancy/diversity proxies.
                          Coarser, but the same stratify/fit/CI
                          machinery applies and every request still
                          resolves to exactly one typed result.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.isa import compiled as comp
from repro_torch.isa import timing

# clip_features column order (the serving token features use their own)
FEATURE_NAMES = (
    "n_insts",          # window length (commit-width floor: n / commit_width)
    "lat_sum",          # total static latency (serial work upper bound)
    "dep_chain",        # latency-weighted dependency critical path (ILP bound)
    "fu_bound",         # max FU-class structural occupancy bound
    "n_loads",
    "n_stores",
    "uniq_dlines",      # unique D-cache lines touched (miss-rate proxy)
    "uniq_ilines",      # unique I-cache lines touched (front-end proxy)
    "n_branches",
    "n_taken",
    "miss_waves",       # MSHR-serialized miss waves (MLP bound proxy)
    "analytical_cycles",  # roofline max of compute/memory/width terms
)
N_FEATURES = len(FEATURE_NAMES)


def clip_features(trace: comp.Trace, l_min: int,
                  params: Optional[timing.TimingParams] = None
                  ) -> np.ndarray:
    """(n_clips, N_FEATURES) float64 analytical features per clip window.

    Windows are the ``slice_fixed`` partition over the trace
    (``k_full = n // l_min`` full windows plus one remainder), exactly
    the clips ``encode_fixed_clips`` / ``fixed_clip_indices`` produce —
    feature row i always describes predicted clip i.  Dependency state
    resets at every window boundary, so each row is a pure function of
    its own window's (pc, ea, taken) rows: features are invariant to
    clip order by construction.
    """
    p = params if params is not None else timing.TimingParams()
    (fu_idx, latency, is_load, is_store, is_branch,
     read_slots, write_slots) = timing._static_tables(trace.program)
    fu_count = [1] * len(timing.FU_ORDER)
    for cls, cnt in p.fu_counts:
        fu_count[timing._FU_INDEX[cls]] = max(cnt, 1)

    pcs = trace.pc.tolist()
    eas = trace.ea.tolist()
    takens = trace.taken.tolist()
    n = len(pcs)
    if n == 0:
        return np.zeros((0, N_FEATURES), np.float64)
    k_full, rem = n // l_min, n % l_min
    n_clips = k_full + (1 if rem else 0)
    out = np.zeros((n_clips, N_FEATURES), np.float64)

    for c in range(n_clips):
        start = c * l_min if c < k_full else n - rem
        end = start + l_min if c < k_full else n
        lat_sum = 0
        depth = {}                       # reg slot -> chain depth (cycles)
        crit = 0
        fu_occ = [0] * len(fu_count)
        n_ld = n_st = n_br = n_tk = 0
        dlines = set()
        ilines = set()
        for i in range(start, end):
            pc = pcs[i]
            lat = latency[pc]
            if is_load[pc]:
                lat = p.dcache_hit_cycles    # hit-latency chain; misses
                n_ld += 1                    # are modeled by the memory
                dlines.add(eas[i] // p.dcache_line_bytes)   # term below
            elif is_store[pc]:
                n_st += 1
                dlines.add(eas[i] // p.dcache_line_bytes)
            if is_branch[pc]:
                n_br += 1
                if takens[i] == 1:
                    n_tk += 1
            lat_sum += lat
            ilines.add(pc // p.icache_line_insts)
            d = 0
            for s in read_slots[pc]:
                ds = depth.get(s, 0)
                if ds > d:
                    d = ds
            d += lat
            for s in write_slots[pc]:
                depth[s] = d
            if d > crit:
                crit = d
            fu = fu_idx[pc]
            # unpipelined dividers occupy their unit for the full
            # latency; everything else has 1-cycle occupancy
            fu_occ[fu] += lat if fu in (2, 4) else 1
        fu_bound = max(occ / fu_count[k] for k, occ in enumerate(fu_occ))
        n_insts = end - start
        uniq_d = len(dlines)
        # memory term: every distinct line is a potential miss; misses
        # overlap up to mshr_entries deep (MLP), hits pipeline freely
        miss_waves = -(-uniq_d // max(p.mshr_entries, 1))
        mem_term = (miss_waves * p.dcache_miss_cycles
                    + (n_ld + n_st - uniq_d) * p.dcache_hit_cycles
                    / max(p.mshr_entries, 1))
        width_term = n_insts / max(p.commit_width, 1)
        analytical = max(crit, fu_bound, mem_term, width_term)
        out[c] = (n_insts, lat_sum, crit, fu_bound, n_ld, n_st,
                  uniq_d, len(ilines), n_br, n_tk, miss_waves,
                  analytical)
    return out


def token_clip_features(clip_tokens: np.ndarray,
                        clip_mask: np.ndarray) -> np.ndarray:
    """(n, 6) float64 token-derived features for serving requests.

    The serving path never sees the columnar trace — requests arrive
    pre-tokenized — so features degrade to occupancy and diversity
    proxies over the (n, l_clip, l_token) token tensor (or the
    (n, l_clip) RT-index matrix): clip length, distinct static
    instructions, token-level entropy proxies.  Same estimator
    downstream, coarser strata.
    """
    tok = np.asarray(clip_tokens)
    mask = np.asarray(clip_mask, np.float64)
    n = tok.shape[0]
    if n == 0:
        return np.zeros((0, 6), np.float64)
    if tok.ndim == 2:                       # rt_idx rows: lift to 3-D
        tok = tok[:, :, None]
    n_valid = mask.sum(axis=1)
    out = np.zeros((n, 6), np.float64)
    for i in range(n):
        valid = mask[i] > 0
        rows = tok[i][valid]
        if rows.shape[0] == 0:
            continue
        uniq_rows = len({r.tobytes() for r in rows})
        vals, counts = np.unique(rows, return_counts=True)
        p_tok = counts / counts.sum()
        ent = float(-(p_tok * np.log(p_tok)).sum())
        out[i] = (n_valid[i], uniq_rows, len(vals), ent,
                  float(rows.mean()), n_valid[i] / max(uniq_rows, 1))
    return out


# --------------------------------------------------------------------------- #
# Stratification + the fused estimator
# --------------------------------------------------------------------------- #

def stratify(features: np.ndarray, n_strata: int,
             key_column: int = N_FEATURES - 1) -> np.ndarray:
    """(n,) int32 stratum label per clip: quantile bins of the
    analytical-cycles column (order statistics, so labels are invariant
    to clip order and deterministic).  Ties or low diversity collapse
    bins — empty strata are fine, the sampler skips them."""
    f = np.asarray(features, np.float64)
    n = f.shape[0]
    if n == 0:
        return np.zeros(0, np.int32)
    key = f[:, key_column] if f.ndim == 2 else f
    if n_strata <= 1:
        return np.zeros(n, np.int32)
    qs = np.quantile(key, np.arange(1, n_strata) / n_strata)
    return np.searchsorted(qs, key, side="left").astype(np.int32)


@dataclasses.dataclass(frozen=True)
class PredictionReport:
    """Typed result of one fused (subsampled) prediction.

    ``total_cycles`` is the stratified estimate; ``cycles_ci`` the 95%
    bootstrap interval around it (degenerate at the point when nothing
    was extrapolated or ``bootstrap_resamples == 0``);
    ``clip_provenance`` marks each clip True if its time came from the
    attention model, False if from the analytical-residual fit.
    """

    total_cycles: float
    cycles_ci: Tuple[float, float]
    clips_predicted: int
    clips_extrapolated: int
    clip_provenance: np.ndarray = dataclasses.field(compare=False,
                                                    repr=False,
                                                    default=None)
    times: np.ndarray = dataclasses.field(compare=False, repr=False,
                                          default=None)

    @property
    def n_clips(self) -> int:
        return self.clips_predicted + self.clips_extrapolated

    @property
    def ci_width(self) -> float:
        return self.cycles_ci[1] - self.cycles_ci[0]


def _ridge_fit(X: np.ndarray, y: np.ndarray, lam: float = 1e-3):
    """Standardized ridge regression; returns a predict closure.

    Features standardize to the sample's moments (constant columns
    drop to zero weight), the target centers, and the intercept stays
    unregularized — so a constant target extrapolates exactly."""
    mu = X.mean(axis=0)
    sd = X.std(axis=0)
    sd = np.where(sd > 0, sd, 1.0)
    Xs = (X - mu) / sd
    ym = y.mean()
    k = X.shape[1]
    A = Xs.T @ Xs + lam * np.eye(k)
    w = np.linalg.solve(A, Xs.T @ (y - ym))

    def predict(Z: np.ndarray) -> np.ndarray:
        return ym + ((Z - mu) / sd) @ w
    return predict


def _extrapolate(features, strata, sampled, sampled_preds):
    """Ridge fit + per-stratum mean-residual correction.

    Returns (n,) float64 times for EVERY clip: sampled positions carry
    their model predictions verbatim, the rest the corrected fit."""
    y = np.asarray(sampled_preds, np.float64)
    fit = _ridge_fit(features[sampled], y)
    times = np.empty(features.shape[0], np.float64)
    times[sampled] = y
    rest = np.ones(features.shape[0], bool)
    rest[sampled] = False
    if rest.any():
        est = fit(features[rest])
        # per-stratum residual correction: the ridge is global, the
        # bias it leaves is local — shift each stratum's extrapolations
        # by that stratum's mean sampled residual
        resid = y - fit(features[sampled])
        s_sample = strata[sampled]
        rest_idx = np.flatnonzero(rest)
        for s in np.unique(strata[rest_idx]):
            in_s = s_sample == s
            if in_s.any():
                est[strata[rest_idx] == s] += resid[in_s].mean()
        # clip runtimes are positive; a wild extrapolation must not go
        # below the cheapest observed clip
        est = np.maximum(est, max(y.min(), 0.0))
        times[rest] = est
    return times


def fuse_predictions(features: np.ndarray, strata: np.ndarray,
                     sampled: np.ndarray, sampled_preds: np.ndarray,
                     bootstrap_resamples: int = 200, seed: int = 0,
                     key: int = 0) -> PredictionReport:
    """The fused estimator: model predictions for the sampled clips,
    ridge+residual extrapolation for the rest, stratified bootstrap CI.

    ``sampled`` holds sorted clip indices; ``sampled_preds`` their model
    predictions in that order.  When every clip was sampled the total
    is exactly ``float(sampled_preds.sum())`` — the bitwise contract
    behind ``fraction=1.0`` — and the CI degenerates to the point.

    The bootstrap resamples the *sample* within each stratum (with
    replacement, sizes preserved), refits, and recomputes the whole
    estimator — so the interval reflects both within-stratum sampling
    variance and fit uncertainty.  95% percentile interval, seeded by
    ``(seed, key)`` so every (benchmark, core) job draws independently
    but deterministically.
    """
    features = np.asarray(features, np.float64)
    strata = np.asarray(strata)
    sampled = np.asarray(sampled, np.int64)
    preds_raw = np.asarray(sampled_preds)
    preds = preds_raw.astype(np.float64)
    n = features.shape[0]
    provenance = np.zeros(n, bool)
    provenance[sampled] = True
    n_extra = n - sampled.shape[0]

    if n_extra == 0:
        # sum in the predictor's own dtype: the unsampled engine does
        # float(float32_rows.sum()), and fraction=1.0 must match it bit
        # for bit
        total = float(preds_raw.sum())
        return PredictionReport(
            total_cycles=total, cycles_ci=(total, total),
            clips_predicted=int(sampled.shape[0]), clips_extrapolated=0,
            clip_provenance=provenance,
            times=preds.astype(np.float64))

    times = _extrapolate(features, strata, sampled, preds)
    total = float(preds.sum()) + float(times[~provenance].sum())

    lo = hi = total
    if bootstrap_resamples > 0:
        rng = np.random.default_rng(
            np.asarray([abs(int(seed)), abs(int(key))], np.uint64))
        s_sample = strata[sampled]
        groups = [np.flatnonzero(s_sample == s)
                  for s in np.unique(s_sample)]
        totals = np.empty(bootstrap_resamples, np.float64)
        for b in range(bootstrap_resamples):
            take = np.sort(np.concatenate(
                [g[rng.integers(0, g.shape[0], g.shape[0])]
                 for g in groups]))
            t_b = _extrapolate(features, strata, sampled[take],
                               preds[take])
            totals[b] = (float(preds[take].sum())
                         + float(t_b[~provenance].sum()))
        lo, hi = np.percentile(totals, [2.5, 97.5])
        lo, hi = float(min(lo, total)), float(max(hi, total))

    return PredictionReport(
        total_cycles=total, cycles_ci=(lo, hi),
        clips_predicted=int(sampled.shape[0]),
        clips_extrapolated=int(n_extra),
        clip_provenance=provenance, times=times)
