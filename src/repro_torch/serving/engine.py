"""Clip-parallel predictor serving engine (port of
``repro/serving/engine.py``).

A *request* is one benchmark interval: the functional trace's clips
(tokenized) whose predicted runtimes must be summed.  The engine packs
clips from many concurrent requests into fixed-shape device batches,
runs the predictor, and scatters the per-clip times back to their
requests, so throughput is set by total clip count, not by request
boundaries.

The batch backend is ``repro_torch.core.engine.BatchedPredictor``
(size-bucketed remainder padding, asynchronous CUDA dispatch) over the
static-instruction RT cache (``core/rt_cache.py``, on by default): request
token rows are deduped against a content-addressed table that persists
across flushes, so a steady request stream pays the instruction encoder
only for never-before-seen static rows.  The engine holds one backend for
its whole lifetime, so under ``fused_serving`` the serving plan is rebuilt
only when the table grows.  ``config.sampling`` switches flushes to the
analytical-ML fusion path with token-derived features.  A non-empty
``config.mesh_shape`` shards every flush's device batches and the RT
cache's encode passes over the data mesh (``launch/mesh.py``), equal to
the unsharded engine.

The production front-end that puts a queue, deadlines and graceful
degradation on top is ``repro_torch.serving.service.SimulationService``;
its flushes and the engine's run one body, ``flush_requests``.
Like every entry point of the port, the engine runs on the card unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import analytical
from repro_torch.core import context as ctx_mod
from repro_torch.core import sampler as sampler_mod
from repro_torch.core.engine import (BatchedPredictor, PredictStack,
                                     config_faults)
from repro_torch.core.engine_config import EngineConfig
from repro_torch.core.rt_cache import RTCacheStats
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import Observability


@dataclasses.dataclass
class Request:
    request_id: int
    clip_tokens: np.ndarray           # (n, l_clip, l_token) int32
    # (n, M) int32: M is one of the context.context_len layouts
    # (single-core / core-tagged / peer-channel)
    context_tokens: np.ndarray
    clip_mask: np.ndarray             # (n, l_clip) float32


@dataclasses.dataclass
class Result:
    request_id: int
    total_cycles: float
    n_clips: int
    seconds: float
    # --- PredictionReport fields (config.sampling flushes only) ---
    cycles_ci: Optional[Tuple[float, float]] = None
    clips_predicted: Optional[int] = None     # None -> every clip (full path)
    clips_extrapolated: int = 0

    def __post_init__(self):
        if self.clips_predicted is None:
            self.clips_predicted = self.n_clips


def validate_request(req: Request, config: EngineConfig,
                     expect: Optional[tuple] = None) -> None:
    """Full submission-boundary payload check: ndims, dtypes, and
    internal shape consistency of every array (not just the context
    width).  ``expect=(l_clip, l_token)`` additionally pins the clip
    shape: the ``SimulationService`` pins it to its config, and the raw
    engine to the flush's first request (one flush's clips concatenate
    into shared device batches).  Raises ``ValueError`` naming the
    request and the offending field, so a malformed payload never
    surfaces as a shape error inside a later concatenate or kernel."""
    who = f"Request {req.request_id}"
    tok, ctx, mask = req.clip_tokens, req.context_tokens, req.clip_mask
    if tok.ndim != 3:
        raise ValueError(f"{who}: clip_tokens must be "
                         f"(n, l_clip, l_token), got shape {tok.shape}")
    n = tok.shape[0]
    if expect is not None and tok.shape[1:] != tuple(expect):
        raise ValueError(
            f"{who}: clip_tokens shape {tok.shape} does not match the "
            f"engine's (n, l_clip={expect[0]}, l_token={expect[1]})")
    if not np.issubdtype(tok.dtype, np.integer):
        raise ValueError(f"{who}: clip_tokens dtype {tok.dtype} is not "
                         f"an integer token dtype (expected int32)")
    if ctx.ndim != 2 or ctx.shape[0] != n:
        raise ValueError(
            f"{who}: context_tokens must be (n={n}, M), "
            f"got shape {ctx.shape}")
    if not np.issubdtype(ctx.dtype, np.integer):
        raise ValueError(f"{who}: context_tokens dtype {ctx.dtype} is "
                         f"not an integer token dtype (expected int32)")
    ctx_mod.validate_context_width(ctx.shape[1], who)
    if mask.shape != (n, tok.shape[1]):
        raise ValueError(
            f"{who}: clip_mask shape {mask.shape} does not match "
            f"clip_tokens' (n={n}, l_clip={tok.shape[1]})")
    if not np.issubdtype(mask.dtype, np.floating):
        raise ValueError(f"{who}: clip_mask dtype {mask.dtype} is not a "
                         f"float mask dtype (expected float32)")


def flush_requests(backend: BatchedPredictor, reqs: Sequence[Request],
                   bootstrap_resamples: Optional[int] = None) -> list:
    """One flush of ``reqs`` through ``backend``, the body of
    ``PredictorEngine.flush`` and of ``SimulationService``'s flushes: the
    pool's context width unpinned (flushes are independent: each may
    carry a different, internally consistent, context layout), each
    request added whole, the backend drained.  Returns each request's
    per-clip times.

    Under ``backend.config.sampling`` (the analytical-ML fusion path) a
    request adds only its stratified sample: strata over token-derived
    features (``analytical.token_clip_features``: serving never sees the
    columnar trace), keyed on clip occupancy (column 0, the work-amount
    proxy: token features have no analytical-cycles column), the draw
    keyed by ``request_id`` so that a retried request samples alike.
    Each request then gets its ``fuse_predictions`` report instead, with
    ``bootstrap_resamples`` resamples (None: the sampling config's)."""
    backend.reset_context_width()
    scfg = backend.config.sampling
    if scfg is None:
        for r in reqs:
            backend.add(r.clip_tokens, r.context_tokens, r.clip_mask)
        times = backend.drain()               # exactly this flush's clips
        return np.split(times, np.cumsum(
            [r.clip_tokens.shape[0] for r in reqs])[:-1])
    plans = []
    for r in reqs:
        feats = analytical.token_clip_features(r.clip_tokens, r.clip_mask)
        strata = analytical.stratify(feats, scfg.strata, key_column=0)
        sampled, _ = sampler_mod.stratified_sample(
            strata, scfg.fraction, scfg.min_clips_per_stratum, scfg.seed,
            key=r.request_id)
        if sampled.shape[0]:
            backend.add(r.clip_tokens[sampled], r.context_tokens[sampled],
                        r.clip_mask[sampled])
        plans.append((feats, strata, sampled))
    preds = backend.drain()                   # exactly the sampled clips
    if bootstrap_resamples is None:
        bootstrap_resamples = scfg.bootstrap_resamples
    reports = []
    off = 0
    for r, (feats, strata, sampled) in zip(reqs, plans):
        k = int(sampled.shape[0])
        reports.append(analytical.fuse_predictions(
            feats, strata, sampled, preds[off:off + k],
            bootstrap_resamples=bootstrap_resamples, seed=scfg.seed,
            key=r.request_id))
        off += k
    return reports


class PredictorEngine:
    """Synchronous submit/flush serving engine.  Batching, precision and
    the RT cache travel in one ``EngineConfig``; ``config.sampling``
    switches flushes to the analytical-ML fusion path (only a stratified
    sample of each request's clips runs through the predictor, the rest
    extrapolate from token-derived features, and each ``Result`` carries
    a bootstrap CI); ``config.faults`` builds a fault injector the RT
    cache consults at the store's load and persist and the backend at
    dispatch and retire; ``config.mesh_shape`` shards the backend and
    the RT cache over one data mesh (``make_data_mesh(n, device)``)."""

    def __init__(self, params, cfg, config: Optional[EngineConfig] = None,
                 *, device: DeviceLike = "cuda"):
        config = config or EngineConfig()
        self.device = resolve_device(device)
        self.config = config
        self.obs = Observability.from_config(config.observability)
        self.instance = self.obs.metrics.next_instance("pengine")
        # params are pinned for the engine's lifetime, so the RT table
        # survives across flushes: only unseen static rows ever encode;
        # with rt_store_dir it also survives process restarts
        self._stack = PredictStack(params, cfg, config, device=self.device,
                                   obs=self.obs,
                                   faults=config_faults(config))
        self.mesh = self._stack.mesh
        self._pending: List[Request] = []

    @classmethod
    def from_config(cls, params, cfg, config: Optional[EngineConfig] = None,
                    *, device: DeviceLike = "cuda") -> "PredictorEngine":
        """Canonical constructor (mirrors ``SimulationEngine``)."""
        return cls(params, cfg, config, device=device)

    @property
    def rt_stats(self) -> Optional[RTCacheStats]:
        cache = self._stack.cache
        return cache.stats if cache is not None else None

    def submit(self, req: Request) -> None:
        """Queue one request, validating the full payload contract at
        the submission boundary.  The flush's first request pins its
        clip shape."""
        expect = (self._pending[0].clip_tokens.shape[1:]
                  if self._pending else None)
        validate_request(req, self.config, expect)
        self._pending.append(req)

    def backend(self) -> BatchedPredictor:
        """The engine-lifetime batch backend (built lazily on the first
        flush, then reused with its RT table and serving plan)."""
        return self._stack.backend()

    def flush(self) -> List[Result]:
        """Run every pending clip through the predictor; one device batch
        may span many requests.  Under ``config.sampling`` each result
        carries its request's fused total and bootstrap CI."""
        if not self._pending:
            return []
        reqs = self._pending
        self._pending = []
        sampled = self.config.sampling is not None
        args = {"requests": len(reqs)}
        if sampled:
            args["sampled"] = True
        with self.obs.span("serving.flush", instance=self.instance,
                           args=args) as sp:
            preds = flush_requests(self.backend(), reqs)
            if self._stack.cache is not None:
                self._stack.cache.persist()   # no-op without a store_dir
        if not sampled:
            n = sum(t.shape[0] for t in preds)
            return [Result(request_id=r.request_id,
                           total_cycles=float(t.sum()), n_clips=t.shape[0],
                           seconds=sp.seconds * (t.shape[0] / max(n, 1)))
                    for r, t in zip(reqs, preds)]
        n = sum(rep.clips_predicted for rep in preds)
        return [Result(request_id=r.request_id,
                       total_cycles=rep.total_cycles,
                       n_clips=int(r.clip_tokens.shape[0]),
                       seconds=sp.seconds * (rep.clips_predicted
                                             / max(n, 1)),
                       cycles_ci=rep.cycles_ci,
                       clips_predicted=rep.clips_predicted,
                       clips_extrapolated=rep.clips_extrapolated)
                for r, rep in zip(reqs, preds)]
