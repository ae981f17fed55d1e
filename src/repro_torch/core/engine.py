"""Batched multi-benchmark simulation engine (port of
``repro/core/engine.py``, the single-core ``SimulationEngine.run`` path).

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
stats views.

``EngineConfig`` fields whose subsystems are not ported yet (device mesh,
multicore, sampling, fault injection, the persistent RT store) raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import context as ctx_mod
from repro_torch.core import predictor as pred_mod
from repro_torch.core import standardize as std_mod
from repro_torch.core.engine_config import EngineConfig
from repro_torch.core.rt_cache import RTCache, RTCacheStats
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.isa import funcsim, progen, timing
from repro_torch.obs import SPAN_SECONDS_TOTAL, Observability

# EngineConfig fields outside this port's slice -> the ROADMAP item that
# ports them (the check is "field differs from its default")
_UNPORTED = {
    "rt_store_dir": "port queue item 2, RT store",
    "multicore": "port queue item 3, run_multicore + isa/multicore.py",
    "sampling": "port queue item 4, sampling",
    "faults": "port queue item 5, serving + fault injection",
    "mesh_shape": "port queue item 6, mesh / multi-GPU",
}


def reject_unported(config: EngineConfig, where: str) -> None:
    default = EngineConfig()
    for field, item in _UNPORTED.items():
        if getattr(config, field) != getattr(default, field):
            raise NotImplementedError(
                f"{where}: EngineConfig.{field} is not ported to "
                f"repro_torch yet (ROADMAP {item})")


def params_to_device(params, device: torch.device):
    if isinstance(params, dict):
        return {k: params_to_device(v, device) for k, v in params.items()}
    return params.to(device)


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


def bucket_sizes(batch_size: int) -> Tuple[int, ...]:
    """Descending pad targets for the final partial batch: the full batch
    plus halvings down to 8, keeping remainder padding < 2x."""
    sizes = [batch_size]
    b = batch_size
    while b > 8:
        b = max(b // 2, 8)
        sizes.append(b)
    return tuple(sizes)


# stage span name per FrontendStats field
_FE_SPANS = {"interpret_seconds": "engine.interpret",
             "tokenize_seconds": "engine.tokenize",
             "context_seconds": "engine.context"}


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
    def tokenize_seconds(self) -> float:
        return self._delta("tokenize_seconds")

    @property
    def context_seconds(self) -> float:
        return self._delta("context_seconds")

    @property
    def n_instructions(self) -> int:
        return int(self._delta("n_instructions"))

    @property
    def n_clips(self) -> int:
        return int(self._delta("n_clips"))

    @property
    def frontend_seconds(self) -> float:
        return (self.interpret_seconds + self.tokenize_seconds
                + self.context_seconds)


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
    """

    def __init__(self, params, cfg, *, config: Optional[EngineConfig] = None,
                 rt_cache: Optional[RTCache] = None,
                 obs: Optional[Observability] = None,
                 device: DeviceLike = "cuda"):
        config = config or EngineConfig()
        reject_unported(config, "BatchedPredictor")
        self.device = resolve_device(device)
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
        self._h_occupancy = m.histogram(
            "capsim_predictor_bucket_occupancy",
            "Real-row share of each dispatched bucket.",
            ("instance",),
            buckets=(0.25, 0.5, 0.75, 0.9, 0.99, 1.0)).labels(
                instance=self.instance)
        self.params = params
        self.cfg = pred_mod.inference_config(cfg, config.precision)
        self.batch_size = config.batch_size
        self.buckets = bucket_sizes(config.batch_size)
        self.max_in_flight = config.max_in_flight
        self.use_context = config.use_context
        self._cache = rt_cache
        self._fused = config.fused_serving
        self._plan = None              # serving_plan for _plan_version
        self._plan_version = -1
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
        self._pending: Deque[Tuple[torch.Tensor, int]] = deque()
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
        ctx_mod.validate_context_width(ctx.shape[1], "BatchedPredictor")
        if self._ctx_width is None:
            self._ctx_width = ctx.shape[1]
        elif ctx.shape[1] != self._ctx_width:
            raise ValueError(
                f"BatchedPredictor: context width {ctx.shape[1]} differs "
                f"from the pool's {self._ctx_width}")
        self._tok.append(tok)
        self._ctx.append(ctx)
        self._mask.append(mask)
        self._buffered += tok.shape[0]
        self._c_clips.inc(tok.shape[0])
        while self._buffered >= self.batch_size:
            tok_b, ctx_b, mask_b = self._take(self.batch_size)
            self._dispatch(tok_b, ctx_b, mask_b, self.batch_size)

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

    def _dispatch(self, tok, ctx, mask, n_real: int) -> None:
        # the span includes any blocking retires forced by the in-flight cap
        with self.obs.span("predict.dispatch", instance=self.instance):
            self._dispatch_inner(tok, ctx, mask, n_real)

    def _dispatch_inner(self, tok, ctx, mask, n_real: int) -> None:
        dev = self.device
        clip_mask = torch.as_tensor(mask, device=dev)
        if self._fused:
            # host-side context dedup: the fused step attends over each
            # row's unique tokens with multiplicity weights
            uniq, counts = std_mod.dedupe_context_tokens(ctx)
            batch = {"rt_idx": torch.as_tensor(tok, device=dev),
                     "ctx_uniq": torch.as_tensor(uniq, device=dev),
                     "ctx_count": torch.as_tensor(counts, device=dev),
                     "clip_mask": clip_mask}
            out = pred_mod.forward_cached_fused(
                self.params, self._serving_plan(), batch, self.cfg)
        elif self._cache is not None:
            batch = {"rt_idx": torch.as_tensor(tok, device=dev),
                     "context_tokens": torch.as_tensor(ctx, device=dev),
                     "clip_mask": clip_mask}
            out = pred_mod.forward_cached(self.params, self._cache.table,
                                          batch, self.cfg, self.use_context)
        else:
            batch = {"clip_tokens": torch.as_tensor(tok, device=dev),
                     "context_tokens": torch.as_tensor(ctx, device=dev),
                     "clip_mask": clip_mask}
            out = pred_mod.forward(self.params, batch, self.cfg,
                                   self.use_context)
        self._pending.append((out, n_real))
        shape = tok.shape[0]
        self._fam_batches.labels(instance=self.instance, shape=shape).inc()
        self._c_pad.inc(shape - n_real)
        self._h_occupancy.observe(n_real / shape)
        while len(self._pending) > self.max_in_flight:
            self._retire()
        self._g_in_flight.set(len(self._pending))

    def _serving_plan(self):
        """Cross K/V plan for the cache table's current contents.  The
        table is written in place, so its identity never changes: the plan
        keys on the cache's write counter instead."""
        if self._plan is None or self._plan_version != self._cache.version:
            self._plan = pred_mod.serving_plan(self.params,
                                               self._cache.table, self.cfg)
            self._plan_version = self._cache.version
        return self._plan

    def _retire(self) -> None:
        with self.obs.span("predict.retire", instance=self.instance):
            out, n_real = self._pending.popleft()
            self._retired.append(out[:n_real].cpu().numpy())  # blocks
            self._c_predicted.inc(n_real)

    def drain(self) -> np.ndarray:
        """Flush the remainder, retire all outstanding batches, and
        return (n_clips,) float32 predictions in submission order."""
        with self.obs.span("predict.drain", instance=self.instance):
            return self._drain_inner()

    def _drain_inner(self) -> np.ndarray:
        if self._buffered:
            n = self._buffered
            tok, ctx, mask = self._take(n)
            bucket = min((b for b in self.buckets if b >= n),
                         default=self.batch_size)
            pad = bucket - n
            if pad:
                # zero rows: an all-<PAD> token row / the cache's pad slot,
                # with a zero mask that excludes the row entirely
                tok = np.concatenate(
                    [tok, np.zeros((pad,) + tok.shape[1:], tok.dtype)])
                ctx = np.concatenate(
                    [ctx, np.zeros((pad,) + ctx.shape[1:], ctx.dtype)])
                mask = np.concatenate(
                    [mask, np.zeros((pad,) + mask.shape[1:], mask.dtype)])
            self._dispatch(tok, ctx, mask, n)
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


@dataclasses.dataclass
class _Job:
    bench: progen.Benchmark
    offset: int = 0                   # first clip index in the global pool
    n_clips: int = 0
    n_intervals: int = 0
    n_instructions: int = 0
    oracle_cycles: float = 0.0
    oracle_seconds: float = 0.0
    func_seconds: float = 0.0


class SimulationEngine:
    """Queue of benchmarks -> functional sims -> one shared clip pool ->
    bucketed device inference -> demultiplexed ``SimResult``s.

    Every knob arrives through one ``EngineConfig``; ``device`` (default
    ``"cuda"``) is where the parameters, the RT table and every batch
    live.  Without a card the caller must pass ``device="cpu"``, which
    runs the kernels' plain versions.
    """

    def __init__(self, params, cfg, vocab: std_mod.Vocab,
                 config: Optional[EngineConfig] = None, *,
                 timing_params: Optional[timing.TimingParams] = None,
                 device: DeviceLike = "cuda"):
        config = config or EngineConfig()
        reject_unported(config, "SimulationEngine")
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
        params = params_to_device(params, self.device)
        if config.precision == "int8":
            # per-channel weight fake-quantization at engine build: the
            # cache, plan and predict step all see the same quantized tree
            from repro_torch.core import quant
            params = quant.quantize_dequant_params(params)
        self.params = params
        self.cfg = pred_mod.inference_config(cfg, config.precision)
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
        # one cache per engine: params are pinned at construction, so the
        # table never goes stale; new programs just append unseen rows
        self._rt_cache = (RTCache(self.params, self.cfg, config.l_token,
                                  device=self.device, obs=self.obs)
                          if config.rt_cache else None)
        self._queue: List[progen.Benchmark] = []
        self.last_stats: Optional[PredictorStats] = None
        self.last_rt_stats = None
        self.frontend_stats = FrontendStats(self.obs, self.instance)

    @classmethod
    def from_config(cls, params, cfg, vocab: std_mod.Vocab,
                    config: Optional[EngineConfig] = None, *,
                    timing_params: Optional[timing.TimingParams] = None,
                    device: DeviceLike = "cuda") -> "SimulationEngine":
        """Canonical constructor: every public entry point routes here."""
        return cls(params, cfg, vocab, config, timing_params=timing_params,
                   device=device)

    def submit(self, bench: progen.Benchmark) -> None:
        self._queue.append(bench)

    def submit_names(self, names: Sequence[str]) -> None:
        for name in names:
            self.submit(progen.build_benchmark(name))

    def _feed_trace(self, trace, token_table, static_ids,
                    pred: BatchedPredictor, job: _Job) -> int:
        """Tokenize + context one interval trace and enqueue its clips.
        Returns the clip count enqueued."""
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
            ctx_all = ctx_mod.context_tokens_from_matrix(trace.snapshots,
                                                         self.vocab)
            rows = np.minimum(np.arange(n_clips), len(ctx_all) - 1)
            ctx = ctx_all[rows]

        job.n_clips += n_clips
        self._c_fe_clips.inc(n_clips)
        if static_ids is not None:
            pred.add_indexed(tok, ctx, mask)
        else:
            pred.add(tok, ctx, mask)
        return n_clips

    def _functional(self, bench: progen.Benchmark, pred: BatchedPredictor,
                    job: _Job) -> None:
        """Columnar functional sim + slice + tokenize one benchmark,
        feeding clips straight into the (asynchronously consuming)
        predictor."""
        cprog = bench.compiled()
        token_table = cprog.token_table(self.vocab, self.l_token)
        static_ids = None
        if self._rt_cache is not None:
            # one instruction-encoder pass over n_static rows serves every
            # dynamic clip of this benchmark (and dedupes across programs)
            static_ids = self._rt_cache.ensure_rows(
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
            self._feed_trace(trace, token_table, static_ids, pred, job)
            if self.with_oracle:
                with self.obs.span("engine.oracle",
                                   instance=self.instance) as osp:
                    job.oracle_cycles += timing.total_cycles_columnar(
                        trace, self.timing_params)
                job.oracle_seconds += osp.seconds

    def run(self, benches: Optional[Sequence[progen.Benchmark]] = None
            ) -> List[SimResult]:
        """Drain the queue (plus ``benches``) and return one ``SimResult``
        per benchmark, in submission order."""
        jobs = [_Job(b) for b in self._queue]
        self._queue = []
        if benches is not None:
            jobs.extend(_Job(b) for b in benches)
        self.frontend_stats = FrontendStats(self.obs, self.instance)
        pred = BatchedPredictor(self.params, self.cfg, config=self.config,
                                rt_cache=self._rt_cache, obs=self.obs,
                                device=self.device)
        rt_stats = (self._rt_cache.stats if self._rt_cache is not None
                    else RTCacheStats())
        offset = 0
        for job in jobs:
            job.offset = offset
            d0 = pred.stats.dispatch_seconds
            b0 = rt_stats.build_seconds
            with self.obs.span("engine.job", instance=self.instance,
                               args={"bench": job.bench.name}) as jsp:
                self._functional(job.bench, pred, job)
            # dispatch (and any blocking retire) and the RT-cache build
            # overlap the functional window; subtract both so device
            # predict time isn't counted twice
            job.func_seconds = (jsp.seconds - job.oracle_seconds
                                - (pred.stats.dispatch_seconds - d0)
                                - (rt_stats.build_seconds - b0))
            offset = job.offset + job.n_clips
        preds = pred.drain()
        self.last_stats = pred.stats
        self.last_rt_stats = (rt_stats.freeze()
                              if self._rt_cache is not None else None)
        if not preds.shape[0] == offset == pred.stats.n_predicted:
            raise RuntimeError("clip accounting mismatch between pool and "
                               "predictions")

        results = []
        total_clips = max(offset, 1)
        for job in jobs:
            mine = preds[job.offset:job.offset + job.n_clips]
            results.append(SimResult(
                name=job.bench.name,
                n_intervals=job.n_intervals,
                n_instructions=job.n_instructions,
                n_clips=job.n_clips,
                predicted_cycles=float(mine.sum()),
                oracle_cycles=job.oracle_cycles if self.with_oracle
                else None,
                func_seconds=job.func_seconds,
                predict_seconds=pred.stats.predict_seconds
                * job.n_clips / total_clips,
                oracle_seconds=job.oracle_seconds if self.with_oracle
                else None))
        return results

    def simulate(self, bench: progen.Benchmark) -> SimResult:
        """Single-benchmark convenience path (``capsim_simulate``)."""
        return self.run([bench])[0]
