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
analytical-ML fusion path with token-derived features.

The production front-end that puts a queue, deadlines and graceful
degradation on top is ``repro_torch.serving.service.SimulationService``.
Like every entry point of the port, the engine runs on the card unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import analytical
from repro_torch.core import context as ctx_mod
from repro_torch.core import predictor as pred_mod
from repro_torch.core import sampler as sampler_mod
from repro_torch.core.engine import (BatchedPredictor, params_to_device,
                                     reject_unported)
from repro_torch.core.engine_config import EngineConfig
from repro_torch.core.rt_cache import RTCache, RTCacheStats
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


class PredictorEngine:
    """Synchronous submit/flush serving engine.  Batching, precision and
    the RT cache travel in one ``EngineConfig``; ``config.sampling``
    switches flushes to the analytical-ML fusion path (only a stratified
    sample of each request's clips runs through the predictor, the rest
    extrapolate from token-derived features, and each ``Result`` carries
    a bootstrap CI); ``config.faults`` builds a fault injector the
    backend consults at dispatch and retire."""

    def __init__(self, params, cfg, config: Optional[EngineConfig] = None,
                 *, device: DeviceLike = "cuda"):
        config = config or EngineConfig()
        reject_unported(config, "PredictorEngine")
        self.device = resolve_device(device)
        self.config = config
        self.obs = Observability.from_config(config.observability)
        self.instance = self.obs.metrics.next_instance("pengine")
        params = params_to_device(params, self.device)
        if config.precision == "int8":
            from repro_torch.core import quant
            params = quant.quantize_dequant_params(params)
        self.params = params
        self.cfg = pred_mod.inference_config(cfg, config.precision)
        # params are pinned for the engine's lifetime, so the RT table
        # survives across flushes: only unseen static rows ever encode;
        # with rt_store_dir it also survives process restarts
        if config.rt_cache:
            from repro_torch.core.standardize import build_vocab
            self._cache = RTCache(params, self.cfg, config.l_token,
                                  device=self.device,
                                  store_dir=config.rt_store_dir,
                                  store_extra=build_vocab().signature(),
                                  obs=self.obs)
        else:
            self._cache = None
        self._faults = None
        if config.faults:
            from repro_torch.serving.faults import FaultInjector
            self._faults = FaultInjector.from_config(config)
        self._pending: List[Request] = []
        self._backend: Optional[BatchedPredictor] = None

    @classmethod
    def from_config(cls, params, cfg, config: Optional[EngineConfig] = None,
                    *, device: DeviceLike = "cuda") -> "PredictorEngine":
        """Canonical constructor (mirrors ``SimulationEngine``)."""
        return cls(params, cfg, config, device=device)

    @property
    def rt_stats(self) -> Optional[RTCacheStats]:
        return self._cache.stats if self._cache is not None else None

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
        if self._backend is None:
            self._backend = BatchedPredictor(self.params, self.cfg,
                                             config=self.config,
                                             rt_cache=self._cache,
                                             fault_injector=self._faults,
                                             obs=self.obs,
                                             device=self.device)
        return self._backend

    def flush(self) -> List[Result]:
        """Run every pending clip through the predictor; one device batch
        may span many requests."""
        if not self._pending:
            return []
        reqs = self._pending
        self._pending = []
        if self.config.sampling is not None:
            return self._flush_sampled(reqs)
        with self.obs.span("serving.flush", instance=self.instance,
                           args={"requests": len(reqs)}) as sp:
            backend = self.backend()
            # flushes are independent: each may carry a different (but
            # internally consistent) context layout
            backend.reset_context_width()
            for r in reqs:
                backend.add(r.clip_tokens, r.context_tokens, r.clip_mask)
            times = backend.drain()           # exactly this flush's clips
            if self._cache is not None:
                self._cache.persist()         # no-op without a store_dir
        n = times.shape[0]
        seconds = sp.seconds

        results = []
        off = 0
        for r in reqs:
            k = r.clip_tokens.shape[0]
            results.append(Result(
                request_id=r.request_id,
                total_cycles=float(times[off:off + k].sum()),
                n_clips=k,
                seconds=seconds * (k / max(n, 1))))
            off += k
        return results

    def _flush_sampled(self, reqs: List[Request]) -> List[Result]:
        """Fusion path of ``flush()``: per request, stratify on
        token-derived features (``analytical.token_clip_features``:
        serving never sees the columnar trace), predict only the
        stratified sample, extrapolate the rest, and attach the
        bootstrap CI.  The draw is keyed by ``request_id``, so a retried
        request samples identically."""
        scfg = self.config.sampling
        plans = []
        with self.obs.span("serving.flush", instance=self.instance,
                           args={"requests": len(reqs),
                                 "sampled": True}) as sp:
            backend = self.backend()
            backend.reset_context_width()
            for r in reqs:
                feats = analytical.token_clip_features(r.clip_tokens,
                                                       r.clip_mask)
                # token features have no analytical-cycles column; clip
                # occupancy (column 0) is the work-amount proxy
                strata = analytical.stratify(feats, scfg.strata,
                                             key_column=0)
                sampled, _ = sampler_mod.stratified_sample(
                    strata, scfg.fraction, scfg.min_clips_per_stratum,
                    scfg.seed, key=r.request_id)
                if sampled.shape[0]:
                    backend.add(r.clip_tokens[sampled],
                                r.context_tokens[sampled],
                                r.clip_mask[sampled])
                plans.append((feats, strata, sampled))
            preds = backend.drain()           # exactly the sampled clips
            if self._cache is not None:
                self._cache.persist()         # no-op without a store_dir
        n = preds.shape[0]
        seconds = sp.seconds

        results = []
        off = 0
        for r, (feats, strata, sampled) in zip(reqs, plans):
            k = int(sampled.shape[0])
            rep = analytical.fuse_predictions(
                feats, strata, sampled, preds[off:off + k],
                bootstrap_resamples=scfg.bootstrap_resamples,
                seed=scfg.seed, key=r.request_id)
            results.append(Result(
                request_id=r.request_id,
                total_cycles=rep.total_cycles,
                n_clips=int(r.clip_tokens.shape[0]),
                seconds=seconds * (k / max(n, 1)),
                cycles_ci=rep.cycles_ci,
                clips_predicted=rep.clips_predicted,
                clips_extrapolated=rep.clips_extrapolated))
            off += k
        return results
