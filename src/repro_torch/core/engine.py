"""Batched multi-benchmark simulation engine (port of
``repro/core/engine.py``: ``SimulationEngine.run`` and ``run_multicore``).

Benchmarks go through the host front-end (columnar functional simulator,
slicing, tokenization and context matrices, all numpy), their clips pool
into shared device batches, and per-clip predictions demux back into one
``SimResult`` per benchmark:

  1. the RT cache encodes each program's static token rows once
     (``RTCache.ensure_rows`` -> ``predictor.encode_instructions``);
  2. each clip batch ships (n, l_clip) RT-table indices and runs the block
     encoder + head (``forward_cached``), or with
     ``EngineConfig(fused_serving=True)`` the dedup-fused step over a
     serving plan (``serving_plan`` + ``forward_cached_fused``);
  3. the final partial batch pads to a size bucket with fully masked zero
     rows, and ``drain`` retires everything.

CUDA launches are asynchronous, which gives the reference's double buffer
for free: up to ``max_in_flight`` batches stay un-retired while the host
simulates the next benchmark, and a retire is the ``.cpu()`` of a batch's
output tensor.  The same spans and metric names as the reference feed the
stats views; the port adds a span for each phase of a dispatch
(``predict.batch``, ``predict.h2d``, ``predict.launch``).

``run_multicore`` feeds N interleaved per-core functional sims
(``isa/multicore.py``) through the same pooled predictor and RT cache:
each core's context rows carry its core-id channel (M = 369), and
per-(core, checkpoint) segments demux back to per-core ``SimResult``s.
With ``EngineConfig.rt_store_dir`` the RT cache loads its table from a
persistent store keyed on (params, config, vocab, framework and device)
and every run persists it after ``drain``.

``EngineConfig.sampling`` switches both runs to the analytical-ML fusion
path (``core/analytical.py``, ``core/sampler.py``): each job's clips
collect on the host with their analytical features, only a stratified
sample reaches the predictor, and the rest extrapolate with a bootstrap
CI.  At ``fraction=1.0`` every clip is fed in the unsampled path's order,
so the device batches are the same rows and ``predicted_cycles`` is
bitwise the unsampled run's: always single-core, and per core when every
core runs one checkpoint (with more, the unsampled path feeds and sums a
core's clips checkpoint by checkpoint, interleaved with the other cores).
``EngineConfig.faults`` builds one ``serving.faults.FaultInjector`` per
engine, consulted at dispatch, at retire, at the RT store's load and at
its persist.

A non-empty ``EngineConfig.mesh_shape`` (n shards, ``launch/mesh.py``)
splits every predict dispatch and every RT-cache encode pass over the
data mesh (``predictor.sharded_*``): buckets stay multiples of n, a pool
smaller than the mesh pads to a full set of shards with masked zero
rows, and the per-shard outputs come back in row order, equal to the
unsharded engine's.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import analytical
from repro_torch.core import context as ctx_mod
from repro_torch.core import predictor as pred_mod
from repro_torch.core import sampler as sampler_mod
from repro_torch.core import standardize as std_mod
from repro_torch.core.analytical import PredictionReport
from repro_torch.core.engine_config import EngineConfig
from repro_torch.core.rt_cache import RTCache, RTCacheStats
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.isa import funcsim, multicore, progen, timing
from repro_torch.launch.mesh import DataMesh, resolve_mesh
from repro_torch.obs import SPAN_SECONDS_TOTAL, Observability

def params_to_device(params, device: torch.device):
    if isinstance(params, dict):
        return {k: params_to_device(v, device) for k, v in params.items()}
    return params.to(device)


def config_faults(config: EngineConfig):
    """The fault injector ``config.faults`` asks for, None without
    faults."""
    if not config.faults:
        return None
    # deferred import: repro_torch.serving imports this module
    from repro_torch.serving.faults import FaultInjector
    return FaultInjector.from_config(config)


@dataclasses.dataclass
class SimResult:
    name: str
    n_intervals: int
    n_instructions: int
    n_clips: int
    predicted_cycles: float
    oracle_cycles: Optional[float]
    func_seconds: float               # functional sim + tokenize
    predict_seconds: float            # batched predictor inference (share)
    oracle_seconds: Optional[float]   # O3 oracle wall time
    # --- PredictionReport fields (analytical-ML fusion path) ---
    # Full-prediction runs: every clip is model-predicted and there is
    # no interval.  Under EngineConfig.sampling, predicted_cycles is the
    # stratified estimate, cycles_ci its 95% bootstrap interval, and
    # clip_provenance marks model (True) vs analytical-residual (False)
    # per clip.
    cycles_ci: Optional[Tuple[float, float]] = None
    clips_predicted: Optional[int] = None
    clips_extrapolated: int = 0
    clip_provenance: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.clips_predicted is None:
            self.clips_predicted = self.n_clips

    @property
    def capsim_seconds(self) -> float:
        return self.func_seconds + self.predict_seconds

    @property
    def speedup(self) -> Optional[float]:
        if self.oracle_seconds is None:
            return None
        return self.oracle_seconds / max(self.capsim_seconds, 1e-9)

    @property
    def rel_error(self) -> Optional[float]:
        if not self.oracle_cycles:
            return None
        return abs(self.predicted_cycles - self.oracle_cycles) \
            / self.oracle_cycles

    @property
    def prediction_report(self) -> PredictionReport:
        """The result's fused-prediction view as one typed object."""
        ci = (self.cycles_ci if self.cycles_ci is not None
              else (self.predicted_cycles, self.predicted_cycles))
        return PredictionReport(
            total_cycles=self.predicted_cycles, cycles_ci=ci,
            clips_predicted=self.clips_predicted,
            clips_extrapolated=self.clips_extrapolated,
            clip_provenance=self.clip_provenance)


def bucket_sizes(batch_size: int, align: int = 1) -> Tuple[int, ...]:
    """Descending pad targets for the final partial batch: the full batch
    plus halvings down to 8, keeping remainder padding < 2x.  ``align``
    (the mesh's shard count) keeps every bucket a multiple of the mesh
    size, and at least one row per shard, so a sharded dispatch never
    hands a shard an empty or ragged slice.  The floor is the least
    multiple of ``align`` >= 8; the reference takes ``max(8, align)``,
    which a mesh of 3, 5, 6 or 7 does not divide (its dispatch contract
    then refuses a drain of 8 rows or fewer)."""
    floor = -(-8 // align) * align
    sizes = [batch_size]
    b = batch_size
    while b > floor:
        b = max((b // 2 + align - 1) // align * align, floor)
        sizes.append(b)
    return tuple(sizes)


# stage span name per FrontendStats field
_FE_SPANS = {"interpret_seconds": "engine.interpret",
             "slice_seconds": "engine.slice",
             "tokenize_seconds": "engine.tokenize",
             "context_seconds": "engine.context",
             "analytical_seconds": "engine.analytical"}


class FrontendStats:
    """Host front-end breakdown across one ``SimulationEngine.run``: a
    live view over the obs registry that snapshots a baseline at
    construction, so each run reads per-run deltas."""

    def __init__(self, obs: Optional[Observability] = None,
                 instance: str = ""):
        self._obs = obs
        self._instance = instance
        self._base = {f: self._read(f) for f in
                      (*_FE_SPANS, "n_instructions", "n_clips")}

    def _read(self, field: str) -> float:
        if self._obs is None:
            return 0.0
        if field in _FE_SPANS:
            return self._obs.metrics.value(
                SPAN_SECONDS_TOTAL, span=_FE_SPANS[field],
                instance=self._instance)
        name = {"n_instructions": "capsim_frontend_instructions_total",
                "n_clips": "capsim_frontend_clips_total"}[field]
        return self._obs.metrics.value(name, instance=self._instance)

    def _delta(self, field: str) -> float:
        return self._read(field) - self._base[field]

    @property
    def interpret_seconds(self) -> float:
        return self._delta("interpret_seconds")

    @property
    def slice_seconds(self) -> float:
        return self._delta("slice_seconds")

    @property
    def tokenize_seconds(self) -> float:
        return self._delta("tokenize_seconds")

    @property
    def context_seconds(self) -> float:
        return self._delta("context_seconds")

    @property
    def analytical_seconds(self) -> float:
        return self._delta("analytical_seconds")

    @property
    def n_instructions(self) -> int:
        return int(self._delta("n_instructions"))

    @property
    def n_clips(self) -> int:
        return int(self._delta("n_clips"))

    @property
    def frontend_seconds(self) -> float:
        return (self.interpret_seconds + self.slice_seconds
                + self.tokenize_seconds + self.context_seconds
                + self.analytical_seconds)

    def as_dict(self) -> Dict[str, float]:
        return {"interpret_seconds": self.interpret_seconds,
                "slice_seconds": self.slice_seconds,
                "tokenize_seconds": self.tokenize_seconds,
                "context_seconds": self.context_seconds,
                "analytical_seconds": self.analytical_seconds,
                "frontend_seconds": self.frontend_seconds,
                "n_instructions": self.n_instructions,
                "n_clips": self.n_clips}


class PredictorStats:
    """Live view over one predictor instance's registry cells."""

    def __init__(self, obs: Optional[Observability] = None,
                 instance: str = ""):
        self._obs = obs
        self._instance = instance

    def _val(self, name: str, **labels) -> float:
        if self._obs is None:
            return 0.0
        return self._obs.metrics.value(name, instance=self._instance,
                                       **labels)

    @property
    def n_clips(self) -> int:              # real clips fed in
        return int(self._val("capsim_predictor_clips_total"))

    @property
    def n_predicted(self) -> int:          # real clips retired
        return int(self._val("capsim_predictor_predicted_total"))

    @property
    def n_pad(self) -> int:                # padding rows dispatched
        return int(self._val("capsim_predictor_pad_rows_total"))

    @property
    def batch_shapes(self) -> Dict[int, int]:
        if self._obs is None:
            return {}
        return {int(labels["shape"]): int(v)
                for labels, v in self._obs.metrics.collect(
                    "capsim_predictor_batches_total",
                    instance=self._instance)}

    @property
    def n_batches(self) -> int:
        return sum(self.batch_shapes.values())

    @property
    def dispatch_seconds(self) -> float:
        return self._val(SPAN_SECONDS_TOTAL, span="predict.dispatch")

    @property
    def drain_seconds(self) -> float:
        return self._val(SPAN_SECONDS_TOTAL, span="predict.drain")

    @property
    def predict_seconds(self) -> float:
        return self.dispatch_seconds + self.drain_seconds


def _pad_rows(arrays, rows: int):
    """Each array with zero rows appended up to ``rows``: an all-<PAD>
    token row / the RT cache's pad slot, with a zero mask that excludes
    the row entirely."""
    return tuple(np.concatenate(
        [a, np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)])
        for a in arrays)


class BatchedPredictor:
    """Size-bucketed async batcher over a global clip pool.

    ``add``/``add_indexed`` buffer clips and dispatch a device batch
    whenever ``batch_size`` accumulate; at most ``max_in_flight`` batches
    stay un-retired.  ``drain`` pads the remainder to the smallest size
    bucket with fully masked zero rows, retires everything, and returns
    per-clip predictions in submission order.

    With ``rt_cache`` set, batches carry RT-table indices and run
    ``forward_cached``; ``config.fused_serving`` dedupes each batch's
    context rows on the host and runs ``forward_cached_fused`` over a
    serving plan rebuilt whenever the cache's ``version`` changes.
    Without a cache, batches carry token tensors and run ``forward``.

    With a non-empty ``config.mesh_shape`` every dispatch splits its rows
    over the data mesh (``mesh``, or ``make_data_mesh(n, device)``):
    each shard runs on its device's copy of the parameters, the RT table
    and the plan, and a retire joins the shards' outputs in row order.

    ``fault_injector`` (built from ``config.faults`` when not given) is
    consulted before every dispatch (``slow_flush``, ``device_error``)
    and at every retire (``nan_output``), once per dispatch however many
    shards it has.  Every buffer is the instance's own: two backends
    share only the read-only parameters and the RT cache, whose rows
    never change once written.
    """

    def __init__(self, params, cfg, *, config: Optional[EngineConfig] = None,
                 rt_cache: Optional[RTCache] = None,
                 fault_injector=None,
                 obs: Optional[Observability] = None,
                 device: DeviceLike = "cuda",
                 mesh: Optional[DataMesh] = None):
        config = config or EngineConfig()
        self.device = resolve_device(device)
        self._mesh = resolve_mesh(config.n_shards, self.device, mesh)
        self.config = config
        self.obs = (obs if obs is not None
                    else Observability.from_config(config.observability))
        m = self.obs.metrics
        self.instance = m.next_instance("predictor")
        self._c_clips = m.counter(
            "capsim_predictor_clips_total", "Real clips fed in.",
            ("instance",)).labels(instance=self.instance)
        self._c_predicted = m.counter(
            "capsim_predictor_predicted_total",
            "Real clips with a retired prediction.",
            ("instance",)).labels(instance=self.instance)
        self._c_pad = m.counter(
            "capsim_predictor_pad_rows_total",
            "Padding rows dispatched.",
            ("instance",)).labels(instance=self.instance)
        self._fam_batches = m.counter(
            "capsim_predictor_batches_total",
            "Device batches dispatched, by padded batch shape.",
            ("instance", "shape"))
        self._g_in_flight = m.gauge(
            "capsim_predictor_in_flight",
            "Un-retired device batches (the double buffer).",
            ("instance",)).labels(instance=self.instance)
        self._faults = (fault_injector if fault_injector is not None
                        else config_faults(config))
        self.params = params
        self.cfg = pred_mod.inference_config(cfg, config.precision)
        self.batch_size = config.batch_size
        self.buckets = bucket_sizes(config.batch_size,
                                    max(config.n_shards, 1))
        self.max_in_flight = config.max_in_flight
        self.use_context = config.use_context
        self._cache = rt_cache
        self._fused = config.fused_serving
        self._plan = None              # serving_plan for _plan_version
        self._plan_r = None            # its per-shard copies on a mesh
        self._plan_version = -1
        # per-shard copies of the parameters (shards on one device share)
        self._params_r = (self._mesh.replicate(params)
                          if self._mesh is not None else None)
        if self._fused and rt_cache is None:
            raise ValueError(
                "fused_serving requires an RTCache (the fused step IS "
                "the RT-gather + block encoder)")
        if rt_cache is not None and (rt_cache.params is not params
                                     or rt_cache.cfg != self.cfg):
            raise ValueError("RT cache must be built with the same params "
                             "and resolved config as the predict step")
        self._tok: List[np.ndarray] = []      # token tensors OR rt_idx rows
        self._ctx: List[np.ndarray] = []
        self._mask: List[np.ndarray] = []
        self._ctx_width: Optional[int] = None  # pinned by the first add
        self._buffered = 0
        # one dispatch's outputs (one per shard) and its real rows
        self._pending: Deque[Tuple[List[torch.Tensor], int]] = deque()
        self._retired: List[np.ndarray] = []
        self._drained = 0           # clips returned by previous drains
        self.stats = PredictorStats(self.obs, self.instance)

    def add(self, tok: np.ndarray, ctx: np.ndarray,
            mask: np.ndarray) -> None:
        """tok (n, l_clip, l_token) int32; ctx (n, M) int32;
        mask (n, l_clip) float32."""
        if tok.shape[0] == 0:
            return
        if self._cache is not None:
            self.add_indexed(self._cache.index_clips(tok), ctx, mask)
            return
        self._buffer(tok, ctx, mask)

    def add_indexed(self, rt_idx: np.ndarray, ctx: np.ndarray,
                    mask: np.ndarray) -> None:
        """RT-cache fast path: rt_idx (n, l_clip) int32 rows into the
        cache table (masked slots on the pad row); ctx/mask as ``add``."""
        if self._cache is None:
            raise ValueError("add_indexed needs an RT cache")
        if rt_idx.shape[0] == 0:
            return
        self._cache.record_served(int(mask.sum()))
        self._buffer(rt_idx, ctx, mask)

    def _buffer(self, tok: np.ndarray, ctx: np.ndarray,
                mask: np.ndarray) -> None:
        # dispatch-boundary width check: the pool concatenates context
        # rows across many programs/cores, so a mixed or unknown layout
        # must fail here with the producer on the stack, before a kernel
        ctx_mod.validate_context_width(ctx.shape[1], "BatchedPredictor")
        if self._ctx_width is None:
            self._ctx_width = ctx.shape[1]
        elif ctx.shape[1] != self._ctx_width:
            raise ValueError(
                f"BatchedPredictor: context width {ctx.shape[1]} differs "
                f"from the pool's {self._ctx_width} — single-core, "
                "core-tagged, and peer-channel clips cannot share one "
                "batch pool")
        self._tok.append(tok)
        self._ctx.append(ctx)
        self._mask.append(mask)
        self._buffered += tok.shape[0]
        self._c_clips.inc(tok.shape[0])
        while self._buffered >= self.batch_size:
            self._dispatch(self.batch_size, self.batch_size)

    def _take(self, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pop exactly k rows off the buffer head."""
        out = []
        for buf in (self._tok, self._ctx, self._mask):
            have, taken = 0, []
            while have < k:
                chunk = buf.pop(0)
                need = k - have
                if chunk.shape[0] > need:
                    taken.append(chunk[:need])
                    buf.insert(0, chunk[need:])
                    have = k
                else:
                    taken.append(chunk)
                    have += chunk.shape[0]
            out.append(taken[0] if len(taken) == 1
                       else np.concatenate(taken))
        self._buffered -= k
        return tuple(out)

    def reset_context_width(self) -> None:
        """Unpin the pool's context-width check between independent
        flushes (the pool must be empty), so consecutive flushes may carry
        different (but internally consistent) context layouts."""
        if self._buffered:
            raise RuntimeError(
                "cannot reset context width with clips still buffered")
        self._ctx_width = None

    def _dispatch(self, n_real: int, shape: int) -> None:
        """Dispatch the buffer's next ``n_real`` rows as one batch of
        ``shape`` rows, the rest fully masked zero rows.  Phases:
        ``batch`` (the rows off the buffer, the padding, the host
        tensors), ``h2d`` (their copies to the device) and ``launch`` (the
        forward: the host's time to enqueue its kernels); on a mesh each
        shard copies its own rows inside ``launch``.  The dispatch's span
        includes any blocking retires forced by the in-flight cap."""
        with self.obs.span("predict.dispatch", instance=self.instance):
            with self.obs.span("predict.batch", instance=self.instance):
                tok, ctx, mask = self._take(n_real)
                if shape > n_real:
                    tok, ctx, mask = _pad_rows((tok, ctx, mask), shape)
                batch = self._host_batch(tok, ctx, mask)
            if self._faults is not None:
                # chaos layer: may stall (slow_flush) or raise
                # (device_error) where a real device failure would surface
                self._faults.on_dispatch()
            if self._mesh is not None:
                with self.obs.span("predict.launch", instance=self.instance):
                    outs = self._predict_sharded(batch)
            else:
                with self.obs.span("predict.h2d", instance=self.instance):
                    batch = {k: v.to(self.device) for k, v in batch.items()}
                with self.obs.span("predict.launch", instance=self.instance):
                    outs = [self._predict(batch)]
            self._pending.append((outs, n_real))
            self._fam_batches.labels(instance=self.instance,
                                     shape=shape).inc()
            self._c_pad.inc(shape - n_real)
            while len(self._pending) > self.max_in_flight:
                self._retire()
            self._g_in_flight.set(len(self._pending))

    def _host_batch(self, tok, ctx, mask) -> dict:
        """One dispatch's rows as host tensors.  The fused step's context
        is deduped on the host over the whole batch (on a mesh, before
        the split: every shard sees the batch's U), and attends over each
        row's unique tokens with multiplicity weights."""
        if self._fused:
            uniq, counts = std_mod.dedupe_context_tokens(ctx)
            batch = {"rt_idx": tok, "ctx_uniq": uniq, "ctx_count": counts}
        else:
            key = "rt_idx" if self._cache is not None else "clip_tokens"
            batch = {key: tok, "context_tokens": ctx}
        batch["clip_mask"] = mask
        return {k: torch.as_tensor(v) for k, v in batch.items()}

    def _predict(self, batch) -> torch.Tensor:
        if self._fused:
            return pred_mod.forward_cached_fused(
                self.params, self._serving_plan(), batch, self.cfg)
        if self._cache is not None:
            return pred_mod.forward_cached(self.params, self._cache.table,
                                           batch, self.cfg, self.use_context)
        return pred_mod.forward(self.params, batch, self.cfg,
                                self.use_context)

    def _predict_sharded(self, batch) -> List[torch.Tensor]:
        """The batch's rows split over the mesh; each shard copies its
        rows from the host to its device.  ``bucket_sizes`` keeps every
        bucket a multiple of the mesh size, and a pool smaller than the
        mesh was padded to a full set of shards (``_shard_map`` raises on
        a ragged split)."""
        mesh = self._mesh
        if self._fused:
            return pred_mod.sharded_forward_cached_fused(
                self._params_r, self._serving_plan(sharded=True), batch,
                self.cfg, mesh)
        if self._cache is not None:
            tables = tuple(self._cache.table_on(d) for d in mesh.devices)
            return pred_mod.sharded_forward_cached(
                self._params_r, tables, batch, self.cfg, self.use_context,
                mesh)
        return pred_mod.sharded_predict_step(self._params_r, batch, self.cfg,
                                             self.use_context, mesh)

    def _serving_plan(self, sharded: bool = False):
        """Cross K/V plan for the cache table's current contents (with
        ``sharded``, its per-shard copies).  The table is written in
        place, so its identity never changes: the plan keys on the cache's
        write counter instead."""
        if self._plan is None or self._plan_version != self._cache.version:
            self._plan = pred_mod.serving_plan(self.params,
                                               self._cache.table, self.cfg)
            self._plan_r = (self._mesh.replicate(self._plan)
                            if self._mesh is not None else None)
            self._plan_version = self._cache.version
        return self._plan_r if sharded else self._plan

    def _retire(self) -> None:
        with self.obs.span("predict.retire", instance=self.instance):
            outs, n_real = self._pending.popleft()
            if len(outs) == 1:
                out = outs[0][:n_real].cpu().numpy()          # blocks
            else:                     # the shards' outputs in row order
                out = np.concatenate([o.cpu().numpy()
                                      for o in outs])[:n_real]
            if self._faults is not None:
                # nan_output chaos: the retired batch comes back
                # non-finite; the service's guard must catch it
                out = self._faults.corrupt_output(out)
            self._retired.append(out)
            self._c_predicted.inc(n_real)

    def drain(self) -> np.ndarray:
        """Flush the remainder, retire all outstanding batches, and
        return (n_clips,) float32 predictions in submission order."""
        with self.obs.span("predict.drain", instance=self.instance):
            return self._drain_inner()

    def _drain_inner(self) -> np.ndarray:
        if self._buffered:
            # the remainder pads to the smallest bucket that holds it.  On
            # a mesh the bucket floor is max(8, n_shards): a pool smaller
            # than the mesh pads to a full set of shards, and the
            # [:n_real] in _retire drops the pads
            n = self._buffered
            self._dispatch(n, min((b for b in self.buckets if b >= n),
                                  default=self.batch_size))
        while self._pending:
            self._retire()
        self._g_in_flight.set(0)
        preds = (np.concatenate(self._retired) if self._retired
                 else np.zeros(0, np.float32))
        if preds.shape[0] != self.stats.n_predicted - self._drained:
            raise RuntimeError("demux must return exactly the real "
                               "(non-pad) clips")
        self._drained = self.stats.n_predicted
        self._retired = []
        return preds


class PredictStack:
    """What one front end predicts with: ``SimulationEngine``,
    ``PredictorEngine`` and each rung of ``SimulationService``, its
    auditor included, hold one.  What a precision means is decided here
    alone: ``params`` is the tree on ``device``, fake-quantized per
    channel when ``config.precision == "int8"`` (cache, serving plan and
    predict step all see that tree); ``cfg`` is ``inference_config(cfg,
    config.precision)`` (None keeps ``cfg``'s dtype); ``cache`` the RT
    cache, or None without ``config.rt_cache``, on the stack's mesh and
    consulting ``faults``, its store keyed with ``store_extra`` (default:
    the vocabulary's signature).  ``backend`` is a ``BatchedPredictor``
    built on first use; ``new_predictor`` builds a fresh one.

    ``shared``, one dict a caller passes to several stacks, holds one
    device tree, one quantized tree and one RT cache per (tree, resolved
    numerics): the service's ``fused`` and ``rt`` rungs share a cache.
    Each stack keeps its own backend and config."""

    def __init__(self, params, cfg, config: EngineConfig, *,
                 device: DeviceLike, obs: Observability,
                 mesh: Optional[DataMesh] = None, faults=None,
                 store_extra: Optional[str] = None,
                 shared: Optional[dict] = None):
        shared = {} if shared is None else shared
        self.config = config
        self.device = resolve_device(device)
        self.mesh = resolve_mesh(config.n_shards, self.device, mesh)
        self.obs = obs
        self.faults = faults
        if "device" not in shared:
            shared["device"] = params_to_device(params, self.device)
        self.params = shared["device"]
        if config.precision == "int8":
            if "int8" not in shared:
                from repro_torch.core import quant
                shared["int8"] = quant.quantize_dequant_params(self.params)
            self.params = shared["int8"]
        self.cfg = pred_mod.inference_config(cfg, config.precision)
        self.cache: Optional[RTCache] = None
        if config.rt_cache:
            # params are pinned for the cache's lifetime, so the table
            # never goes stale: new programs only append unseen rows.
            # With rt_store_dir it loads (or later persists) the table
            # under a (params, cfg, l_token, store_extra, device) key
            key = (id(self.params), self.cfg)
            if key not in shared:
                if store_extra is None:
                    store_extra = std_mod.build_vocab().signature()
                shared[key] = RTCache(
                    self.params, self.cfg, config.l_token,
                    device=self.device, n_shards=config.n_shards,
                    mesh=self.mesh, store_dir=config.rt_store_dir,
                    store_extra=store_extra, fault_injector=faults,
                    obs=obs)
            self.cache = shared[key]
        self._backend: Optional[BatchedPredictor] = None

    def new_predictor(self) -> BatchedPredictor:
        return BatchedPredictor(self.params, self.cfg, config=self.config,
                                rt_cache=self.cache,
                                fault_injector=self.faults, obs=self.obs,
                                device=self.device, mesh=self.mesh)

    def backend(self) -> BatchedPredictor:
        """The stack's lasting backend, built on first use and then
        reused with its serving plan."""
        if self._backend is None:
            self._backend = self.new_predictor()
        return self._backend

    def invalidate_backend(self) -> None:
        """Drop the backend after a mid-flush fault or watchdog abort:
        its buffered and in-flight state is lost; the (append-only) RT
        cache is not, and survives."""
        self._backend = None


@dataclasses.dataclass
class _Job:
    bench: object                     # Benchmark or (multicore) core label
    offset: int = 0                   # first clip index in the global pool
    n_clips: int = 0
    n_intervals: int = 0
    n_instructions: int = 0
    oracle_cycles: float = 0.0
    oracle_seconds: float = 0.0
    func_seconds: float = 0.0
    # multicore demux: (bench, core) clips land in per-checkpoint
    # segments interleaved across cores, so predictions accumulate
    # segment-by-segment instead of as one contiguous pool slice
    predicted_cycles: float = 0.0
    name: str = ""


@dataclasses.dataclass
class MulticoreSimResult:
    """One multicore benchmark's demuxed (benchmark, core) results.

    ``predicted_cycles`` / ``oracle_cycles`` are the across-core sums
    (total core-cycles of the N-core run); the per-core breakdown is in
    ``cores`` (entries named ``<bench>#c<k>``).
    """

    name: str
    n_cores: int
    cores: List[SimResult]

    @property
    def predicted_cycles(self) -> float:
        return sum(r.predicted_cycles for r in self.cores)

    @property
    def oracle_cycles(self) -> Optional[float]:
        if any(r.oracle_cycles is None for r in self.cores):
            return None
        return sum(r.oracle_cycles for r in self.cores)

    @property
    def n_clips(self) -> int:
        return sum(r.n_clips for r in self.cores)

    @property
    def n_instructions(self) -> int:
        return sum(r.n_instructions for r in self.cores)

    # --- PredictionReport aggregates (analytical-ML fusion path) ---

    @property
    def cycles_ci(self) -> Optional[Tuple[float, float]]:
        """Across-core CI: summed per-core bounds (conservative: the
        per-core draws are independent, so the true interval is
        narrower).  None unless every core ran the fusion path."""
        if any(r.cycles_ci is None for r in self.cores):
            return None
        return (sum(r.cycles_ci[0] for r in self.cores),
                sum(r.cycles_ci[1] for r in self.cores))

    @property
    def clips_predicted(self) -> int:
        return sum(r.clips_predicted for r in self.cores)

    @property
    def clips_extrapolated(self) -> int:
        return sum(r.clips_extrapolated for r in self.cores)


class SimulationEngine:
    """Queue of benchmarks -> functional sims -> one shared clip pool ->
    bucketed device inference -> demultiplexed ``SimResult``s.

    Every knob arrives through one ``EngineConfig``; ``device`` (default
    ``"cuda"``) is where the parameters, the RT table and every batch
    live.  Without a card the caller must pass ``device="cpu"``, which
    runs the kernels' plain versions.  A non-empty ``config.mesh_shape``
    shards every predict dispatch and every RT-cache encode pass over the
    data mesh (``mesh``, or ``make_data_mesh(n, device)``: n cards on
    ``cuda``, n shards on the CPU), equal to the unsharded engine.
    ``config.sampling`` switches runs to the analytical-ML fusion path
    (``sampling=None`` keeps the full path bitwise).
    """

    def __init__(self, params, cfg, vocab: std_mod.Vocab,
                 config: Optional[EngineConfig] = None, *,
                 timing_params: Optional[timing.TimingParams] = None,
                 device: DeviceLike = "cuda",
                 mesh: Optional[DataMesh] = None):
        config = config or EngineConfig()
        self.device = resolve_device(device)
        self.config = config
        self.obs = Observability.from_config(config.observability)
        self.instance = self.obs.metrics.next_instance("engine")
        self._c_instructions = self.obs.metrics.counter(
            "capsim_frontend_instructions_total",
            "Instructions functionally simulated.",
            ("instance",)).labels(instance=self.instance)
        self._c_fe_clips = self.obs.metrics.counter(
            "capsim_frontend_clips_total",
            "Clips sliced/tokenized by the front-end.",
            ("instance",)).labels(instance=self.instance)
        # one fault injector per engine (None without config.faults): the
        # cache and every per-run BatchedPredictor share its RNG stream,
        # so a chaos run's injection schedule is one deterministic
        # sequence across the whole stack.  One cache per engine, on the
        # engine's mesh (encode passes shard too), its store keyed by
        # the vocabulary
        self._stack = PredictStack(params, cfg, config, device=self.device,
                                   obs=self.obs, mesh=mesh,
                                   faults=config_faults(config),
                                   store_extra=vocab.signature())
        self.mesh = self._stack.mesh
        self.vocab = vocab
        self.interval_size = config.interval_size
        self.warmup = config.warmup
        self.max_checkpoints = config.max_checkpoints
        self.l_min = config.l_min
        self.l_clip = config.l_clip
        self.l_token = config.l_token
        self.with_oracle = config.with_oracle
        self.timing_params = (timing_params if timing_params is not None
                              else timing.TimingParams())
        self._queue: List[progen.Benchmark] = []
        self.last_stats: Optional[PredictorStats] = None
        self.last_rt_stats = None
        self.frontend_stats = FrontendStats(self.obs, self.instance)

    @classmethod
    def from_config(cls, params, cfg, vocab: std_mod.Vocab,
                    config: Optional[EngineConfig] = None, *,
                    timing_params: Optional[timing.TimingParams] = None,
                    device: DeviceLike = "cuda",
                    mesh: Optional[DataMesh] = None) -> "SimulationEngine":
        """Canonical constructor: every public entry point routes here."""
        return cls(params, cfg, vocab, config, timing_params=timing_params,
                   device=device, mesh=mesh)

    def submit(self, bench: progen.Benchmark) -> None:
        self._queue.append(bench)

    def submit_names(self, names: Sequence[str]) -> None:
        for name in names:
            self.submit(progen.build_benchmark(name))

    def _feed_trace(self, trace, token_table, static_ids,
                    pred: BatchedPredictor, job: _Job,
                    core_id: Optional[int] = None,
                    sink: Optional[list] = None) -> int:
        """Tokenize + context one interval trace and enqueue its clips,
        the shared interval body of the single-core and multicore paths
        (``core_id=None`` keeps the single-core context layout bit for
        bit).  Returns the clip count enqueued.

        With ``sink`` (the fusion path) nothing reaches the predictor
        yet: the clip arrays land in the sink with their analytical
        feature rows, and the caller feeds only the stratified sample
        once the job's trace is complete."""
        n = len(trace)
        job.n_intervals += 1
        job.n_instructions += n
        self._c_instructions.inc(n)

        with self.obs.span("engine.tokenize", instance=self.instance):
            if static_ids is not None:
                tok, mask = std_mod.fixed_clip_indices(
                    static_ids, trace.pc, self.l_min, self.l_clip)
            else:
                tok, mask = std_mod.encode_fixed_clips(
                    token_table, trace.pc, self.l_min, self.l_clip)
            n_clips = tok.shape[0]             # slice_fixed partition

        with self.obs.span("engine.context", instance=self.instance):
            ctx_all = ctx_mod.context_tokens_from_matrix(
                trace.snapshots, self.vocab, core_id=core_id)
            rows = np.minimum(np.arange(n_clips), len(ctx_all) - 1)
            ctx = ctx_all[rows]

        job.n_clips += n_clips
        self._c_fe_clips.inc(n_clips)
        if sink is not None:
            with self.obs.span("engine.analytical",
                               instance=self.instance):
                feats = analytical.clip_features(trace, self.l_min,
                                                 self.timing_params)
            if feats.shape[0] != n_clips:
                raise RuntimeError("analytical windows must mirror the "
                                   "clip partition")
            sink.append((tok, ctx, mask, feats))
        elif static_ids is not None:
            pred.add_indexed(tok, ctx, mask)
        else:
            pred.add(tok, ctx, mask)
        return n_clips

    def _feed_sample(self, pred: BatchedPredictor, sink: list,
                     job_key: int):
        """Stratify one job's collected clips, select the sample, and
        feed only those rows to the predictor, in clip order (the device
        works on this job's sample while the next job's functional sim
        runs).  Returns the job's fusion plan ``(features, strata,
        sampled)`` for ``fuse_predictions`` after the drain."""
        scfg = self.config.sampling
        if sink:
            tok, ctx, mask, feats = (np.concatenate([s[i] for s in sink])
                                     for i in range(4))
        else:
            feats = np.zeros((0, analytical.N_FEATURES), np.float64)
        strata = analytical.stratify(feats, scfg.strata)
        sampled, _ = sampler_mod.stratified_sample(
            strata, scfg.fraction, scfg.min_clips_per_stratum,
            scfg.seed, key=job_key)
        if sampled.shape[0]:
            if self._stack.cache is not None:
                pred.add_indexed(tok[sampled], ctx[sampled], mask[sampled])
            else:
                pred.add(tok[sampled], ctx[sampled], mask[sampled])
        return feats, strata, sampled

    def _fuse(self, feats, strata, sampled, preds, key: int
              ) -> PredictionReport:
        scfg = self.config.sampling
        return analytical.fuse_predictions(
            feats, strata, sampled, preds,
            bootstrap_resamples=scfg.bootstrap_resamples, seed=scfg.seed,
            key=key)

    def _functional(self, bench: progen.Benchmark, pred: BatchedPredictor,
                    job: _Job, sink: Optional[list] = None) -> None:
        """Columnar functional sim + slice + tokenize one benchmark,
        feeding clips straight into the (asynchronously consuming)
        predictor; with ``sink`` the clips collect there instead (fusion
        path)."""
        cprog = bench.compiled()
        token_table = cprog.token_table(self.vocab, self.l_token)
        static_ids = None
        if self._stack.cache is not None:
            # one instruction-encoder pass over n_static rows serves every
            # dynamic clip of this benchmark (and dedupes across programs)
            static_ids = self._stack.cache.ensure_rows(
                token_table,
                keys=cprog.token_row_keys(self.vocab, self.l_token))
        st = progen.fresh_compiled_state(bench)
        with self.obs.span("engine.interpret", instance=self.instance):
            _, st = funcsim.run_compiled(cprog, self.warmup, st)
        n_ckp = min(bench.ckp_num, self.max_checkpoints)
        for _ in range(n_ckp):
            with self.obs.span("engine.interpret",
                               instance=self.instance):
                trace, st = funcsim.run_compiled(
                    cprog, self.interval_size, st,
                    snapshot_every=self.l_min)
            if not len(trace):
                break
            self._feed_trace(trace, token_table, static_ids, pred, job,
                             sink=sink)
            if self.with_oracle:
                with self.obs.span("engine.oracle",
                                   instance=self.instance) as osp:
                    job.oracle_cycles += timing.total_cycles_columnar(
                        trace, self.timing_params)
                job.oracle_seconds += osp.seconds

    def run(self, benches: Optional[Sequence[progen.Benchmark]] = None
            ) -> List[SimResult]:
        """Drain the queue (plus ``benches``) and return one ``SimResult``
        per benchmark, in submission order.

        Under ``config.sampling`` (the fusion path) each benchmark's clips
        collect with their analytical features until its trace is
        complete, only its stratified sample is fed (``_feed_sample``),
        and after the drain ``fuse_predictions`` extrapolates the rest
        with a bootstrap CI.  At ``fraction=1.0`` every clip is fed in
        the unsampled order and the total is the same ``float(sum())``
        over the same rows, so it is bitwise the unsampled run's."""
        jobs = [_Job(b, name=b.name) for b in self._queue]
        self._queue = []
        if benches is not None:
            jobs.extend(_Job(b, name=b.name) for b in benches)
        sampling = self.config.sampling is not None
        self.frontend_stats = FrontendStats(self.obs, self.instance)
        pred = self._stack.new_predictor()
        rt_stats = (self._stack.cache.stats if self._stack.cache is not None
                    else RTCacheStats())
        plans = []                    # (features, strata, sampled) per job
        offset = 0
        for j, job in enumerate(jobs):
            sink = [] if sampling else None
            d0 = pred.stats.dispatch_seconds
            b0 = rt_stats.build_seconds
            with self.obs.span("engine.job", instance=self.instance,
                               args={"bench": job.name}) as jsp:
                self._functional(job.bench, pred, job, sink=sink)
                if sampling:
                    plans.append(self._feed_sample(pred, sink, j))
            # dispatch (and any blocking retire) and the RT-cache build
            # overlap the functional window; subtract both so device
            # predict time isn't counted twice
            job.func_seconds = (jsp.seconds - job.oracle_seconds
                                - (pred.stats.dispatch_seconds - d0)
                                - (rt_stats.build_seconds - b0))
            job.offset = offset
            offset += int(plans[j][2].shape[0]) if sampling else job.n_clips
        preds = self._drain(pred, rt_stats, offset)

        results = []
        for j, job in enumerate(jobs):
            if sampling:
                feats, strata, sampled = plans[j]
                n_fed = int(sampled.shape[0])
                rep = self._fuse(feats, strata, sampled,
                                 preds[job.offset:job.offset + n_fed], j)
            else:
                n_fed, rep = job.n_clips, None
                job.predicted_cycles = float(
                    preds[job.offset:job.offset + n_fed].sum())
            results.append(self._result(job, pred, n_fed / max(offset, 1),
                                        rep))
        return results

    def _drain(self, pred: BatchedPredictor, rt_stats, n_fed: int
               ) -> np.ndarray:
        """Retire every batch, persist the RT store, keep the run's stats,
        and check that exactly the ``n_fed`` clips came back."""
        preds = pred.drain()
        if self._stack.cache is not None:
            self._stack.cache.persist()    # no-op without a store_dir
        self.last_stats = pred.stats
        self.last_rt_stats = (rt_stats.freeze()
                              if self._stack.cache is not None else None)
        if not preds.shape[0] == n_fed == pred.stats.n_predicted:
            raise RuntimeError("clip accounting mismatch between the fed "
                               "clips and the predictions")
        return preds

    def _result(self, job: _Job, pred: BatchedPredictor, share: float,
                rep: Optional[PredictionReport] = None) -> SimResult:
        """One job's ``SimResult``: ``share`` of the run's predict time,
        and the fusion report's fields when the job ran sampled."""
        fused = {}
        if rep is not None:
            job.predicted_cycles = rep.total_cycles
            fused = dict(cycles_ci=rep.cycles_ci,
                         clips_predicted=rep.clips_predicted,
                         clips_extrapolated=rep.clips_extrapolated,
                         clip_provenance=rep.clip_provenance)
        return SimResult(
            name=job.name,
            n_intervals=job.n_intervals,
            n_instructions=job.n_instructions,
            n_clips=job.n_clips,
            predicted_cycles=job.predicted_cycles,
            oracle_cycles=job.oracle_cycles if self.with_oracle else None,
            func_seconds=job.func_seconds,
            predict_seconds=pred.stats.predict_seconds * share,
            oracle_seconds=job.oracle_seconds if self.with_oracle else None,
            **fused)

    def simulate(self, bench: progen.Benchmark) -> SimResult:
        """Single-benchmark convenience path (``capsim_simulate``)."""
        return self.run([bench])[0]

    # ------------------------------ multicore ------------------------------ #

    def run_multicore(self,
                      mbenches: Sequence[multicore.MulticoreBenchmark], *,
                      quantum: Optional[int] = None
                      ) -> List[MulticoreSimResult]:
        """Multicore path: interleaved per-core functional sims ->
        (benchmark, core) clip shards through the same pooled
        ``BatchedPredictor`` + shared ``RTCache`` -> demuxed per-core
        ``SimResult``s summed into per-benchmark cycles.

        Clips arrive in per-(core, checkpoint) segments interleaved
        across cores, so demux walks the recorded segment list; per-core
        predicted cycles accumulate one ``float(segment.sum())`` per
        checkpoint, the accumulation order of a per-core sequential loop.
        Each core's context matrices carry its ``core_id`` channel
        (``context_tokens_from_matrix(..., core_id=c)``); the oracle is
        ``timing.total_cycles_multicore`` over the recorded commit
        interleave.

        Under ``config.sampling`` each core's clips (all checkpoints)
        collect in a per-core sink, the per-core stratified samples feed
        the pool in core order once the benchmark's trace is complete,
        and each (benchmark, core) job fuses on its own; the job key
        counts the flattened jobs, so every core draws independently but
        reproducibly.
        """
        if self.config.peer_channels:
            raise NotImplementedError(
                "peer_channels serving is reserved, in the reference too: "
                "the peer-context training channels are not wired into "
                "the trace engine's context layout yet")
        if quantum is None:
            quantum = (self.config.quantum
                       if self.config.quantum is not None
                       else multicore.DEFAULT_QUANTUM)
        sampling = self.config.sampling is not None
        self.frontend_stats = FrontendStats(self.obs, self.instance)
        pred = self._stack.new_predictor()
        rt_stats = (self._stack.cache.stats if self._stack.cache is not None
                    else RTCacheStats())
        all_jobs: List[List[_Job]] = []
        segments: List[Tuple[_Job, int]] = []   # unsampled demux
        plans = []                 # sampled: (job, features, strata, sampled)
        offset = 0
        for mb in mbenches:
            cprogs = mb.compiled()
            token_tables = [cp.token_table(self.vocab, self.l_token)
                            for cp in cprogs]
            static_ids = None
            if self._stack.cache is not None:
                # all cores of one program share identical token tables
                # (immediates collapse to <CONST>), so rows dedupe to one
                # RT-table entry set across the whole benchmark
                static_ids = [
                    self._stack.cache.ensure_rows(
                        tt, keys=cp.token_row_keys(self.vocab,
                                                   self.l_token))
                    for cp, tt in zip(cprogs, token_tables)]
            jobs = [_Job(bench=mb, name=f"{mb.name}#c{c}")
                    for c in range(mb.n_cores)]
            all_jobs.append(jobs)
            sinks = [[] if sampling else None for _ in range(mb.n_cores)]
            states = mb.fresh_states()
            d0 = pred.stats.dispatch_seconds
            b0 = rt_stats.build_seconds
            oracle_s = 0.0
            with self.obs.span("engine.job", instance=self.instance,
                               args={"bench": mb.name}) as jsp:
                if self.warmup:
                    with self.obs.span("engine.interpret",
                                       instance=self.instance):
                        multicore.run_multicore(cprogs, self.warmup,
                                                states, quantum=quantum)
                n_ckp = min(mb.ckp_num, self.max_checkpoints)
                for _ in range(n_ckp):
                    with self.obs.span("engine.interpret",
                                       instance=self.instance):
                        mtrace = multicore.run_multicore(
                            cprogs, self.interval_size, states,
                            snapshot_every=self.l_min, quantum=quantum)
                    if len(mtrace) == 0:
                        break
                    for c, trace in enumerate(mtrace.cores):
                        if not len(trace):
                            continue
                        n_clips = self._feed_trace(
                            trace, token_tables[c],
                            static_ids[c] if static_ids is not None
                            else None,
                            pred, jobs[c], core_id=c, sink=sinks[c])
                        if not sampling:
                            segments.append((jobs[c], n_clips))
                    if self.with_oracle:
                        with self.obs.span("engine.oracle",
                                           instance=self.instance) as osp:
                            totals = timing.total_cycles_multicore(
                                mtrace.cores, mtrace.schedule,
                                self.timing_params)
                        dt = osp.seconds
                        oracle_s += dt
                        for c, cyc in enumerate(totals):
                            jobs[c].oracle_cycles += cyc
                            jobs[c].oracle_seconds += dt / mb.n_cores
                if sampling:
                    for c, job in enumerate(jobs):
                        plan = self._feed_sample(pred, sinks[c], len(plans))
                        job.offset = offset
                        offset += int(plan[2].shape[0])
                        plans.append((job, *plan))
            mb_seconds = (jsp.seconds - oracle_s
                          - (pred.stats.dispatch_seconds - d0)
                          - (rt_stats.build_seconds - b0))
            mb_clips = max(sum(j.n_clips for j in jobs), 1)
            for job in jobs:
                job.func_seconds = mb_seconds * (job.n_clips / mb_clips)

        reports = {}               # id(job) -> (PredictionReport, n fed)
        if sampling:
            preds = self._drain(pred, rt_stats, offset)
            for k, (job, feats, strata, sampled) in enumerate(plans):
                n = int(sampled.shape[0])
                reports[id(job)] = (self._fuse(
                    feats, strata, sampled,
                    preds[job.offset:job.offset + n], k), n)
        else:
            offset = sum(n for _, n in segments)
            preds = self._drain(pred, rt_stats, offset)
            off = 0
            for job, n in segments:
                job.predicted_cycles += float(preds[off:off + n].sum())
                off += n

        results = []
        for mb, jobs in zip(mbenches, all_jobs):
            cores = []
            for job in jobs:
                rep, n_fed = reports.get(id(job), (None, job.n_clips))
                cores.append(self._result(job, pred,
                                          n_fed / max(offset, 1), rep))
            results.append(MulticoreSimResult(
                name=mb.name, n_cores=mb.n_cores, cores=cores))
        return results
