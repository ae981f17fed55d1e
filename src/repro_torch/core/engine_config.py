"""EngineConfig: the one construction surface for the inference engines.

Every serving entry point — ``SimulationEngine`` / ``BatchedPredictor``
(core), ``PredictorEngine`` (serving), ``capsim_simulate`` /
``capsim_simulate_multicore`` (wrappers), and ``launch/serve.py`` — used
to re-declare the same knob set as loose keyword arguments, so adding an
axis (precision, RT cache, multicore N, and now the device mesh) meant
threading one more kwarg through five signatures.  ``EngineConfig``
collapses them into a single frozen dataclass: sharding is a config
*axis*, not another kwarg.

Field groups:

  mesh          ``mesh_shape`` — data-parallel device mesh for predict
                AND RT-cache encode dispatch.  ``()`` (default) is the
                unsharded single-device path; ``(n,)`` (or any shape
                whose product is n) shards clip batches n ways via
                ``shard_map`` over a 1-D "data" mesh — bitwise equal to
                unsharded because clips are row-independent.
  numerics      ``precision`` (None keeps cfg.dtype; the ladder is
                "fp32" bitwise -> "bf16" ≤1% rel err -> "int8"
                per-channel weight quant, fp32 compute, ≤1% rel err),
                ``rt_cache``, ``use_context``, ``fused_serving`` (the
                dedup-fused block-encoder serving step; requires
                rt_cache + use_context, tolerance-gated ≤1e-3 vs the
                unfused path), ``rt_store_dir`` (persistent
                content-addressed RT-cache store; None = in-memory
                only).  Precision is validated HERE at construction,
                not at first dispatch inside ``inference_config``.
  batching      ``batch_size`` (must divide by the mesh size so no
                shard is ever empty), ``max_in_flight``.
  trace scale   ``interval_size``, ``warmup``, ``max_checkpoints``,
                ``l_min``, ``l_clip``, ``l_token``, ``with_oracle``.
  multicore     ``multicore`` (N cores; 0 = single-core suite),
                ``quantum`` (None = scheduler default),
                ``peer_channels`` (peer-context serving — reserved,
                ROADMAP item 8).
  faults        ``faults`` — chaos-engineering fault-injection spec, a
                tuple of ``(kind, rate)`` pairs (``FAULT_KINDS`` below)
                consumed by ``repro.serving.faults.FaultInjector`` and
                honored by the REAL engine stack (``BatchedPredictor``
                dispatch/retire, ``RTCache`` store load/persist), so
                chaos tests and ``bench_serving.py`` exercise the same
                code paths production traffic does.  ``()`` (default)
                injects nothing and costs nothing.  ``fault_seed``
                makes every injection schedule deterministic.
  sampling      ``sampling`` — opt-in analytical-ML fusion mode: a
                nested ``SamplingConfig`` (or an equivalent mapping; a
                JSON round trip hands one back).  Only a stratified
                sample of each benchmark's clips runs through the
                attention predictor; the rest are extrapolated from a
                ridge fit over per-clip analytical features
                (``repro.core.analytical``) with a bootstrap confidence
                interval over the stratified estimate.  ``None``
                (default) preserves the exact full-prediction path
                bitwise.
  observability ``observability`` — a nested ``ObservabilityConfig``
                (or mapping) enabling span tracing and the degradation
                flight recorder (``repro.obs``).  The metrics registry
                is always on; ``None`` (default) just means no trace
                ring and no postmortem files.

The config is JSON round-trippable (``to_json``/``from_json``) so one
``--engine-config`` flag can drive every bench pass and CI leg.  The
pre-PR-6 loose keyword signatures are fully retired: any extra keyword
on an entry point raises ``TypeError`` (``reject_legacy_kwargs``)
pointing at the ``EngineConfig`` field to use instead.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Optional, Tuple

PRECISIONS = (None, "fp32", "bf16", "int8")

# Injectable fault kinds (see repro/serving/faults.py for what each does
# and README's failure-mode table for the expected recovery):
#   device_error     predict dispatch raises (transient device failure)
#   nan_output       a dispatched batch's predictions come back non-finite
#   slow_flush       a dispatch stalls (stuck device / runaway compile)
#   corrupt_rt_read  a persistent RT-store read returns corrupt data
#   crash_persist    the process "dies" mid RTCache.persist (before the
#                    atomic publish, so the previous store must survive)
FAULT_KINDS = ("device_error", "nan_output", "slow_flush",
               "corrupt_rt_read", "crash_persist")


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Stratified clip-subsampling knobs for the analytical-ML fusion
    path (``EngineConfig.sampling``).

    ``fraction``: target share of each stratum's clips that run through
    the attention predictor (``1.0`` samples everything and is bitwise
    the unsampled engine).  ``strata``: number of quantile bins of the
    analytical cycle estimate per benchmark.  ``min_clips_per_stratum``
    floors every non-empty stratum's sample so rare-but-expensive
    strata are never extrapolated blind.  ``bootstrap_resamples``:
    within-stratum bootstrap replicates behind the 95% ``cycles_ci``
    (``0`` degenerates the CI to a point).  ``seed`` drives every
    selection and resample deterministically.
    """

    fraction: float = 0.1
    strata: int = 4
    seed: int = 0
    min_clips_per_stratum: int = 2
    bootstrap_resamples: int = 200

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(
                f"sampling fraction must be in (0, 1], "
                f"got {self.fraction}")
        if self.strata < 1:
            raise ValueError(f"strata must be >= 1, got {self.strata}")
        if self.min_clips_per_stratum < 1:
            raise ValueError(
                f"min_clips_per_stratum must be >= 1, "
                f"got {self.min_clips_per_stratum}")
        if self.bootstrap_resamples < 0:
            raise ValueError(
                f"bootstrap_resamples must be >= 0, "
                f"got {self.bootstrap_resamples}")

    def replace(self, **kw) -> "SamplingConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "SamplingConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - fields
        if unknown:
            raise ValueError(
                f"unknown SamplingConfig fields {sorted(unknown)} "
                f"(known: {sorted(fields)})")
        return cls(**dict(data))


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """Observability knobs (``EngineConfig.observability``).

    The metrics registry is always on — it replaced the ad-hoc Stats
    accumulators, so it costs what they cost.  ``trace`` opts into the
    span tracer (a private ``repro.obs.Tracer`` ring of ``trace_ring``
    spans, Chrome-trace exportable); disabled tracing allocates nothing
    on the span path.  ``flight_dir`` opts into the degradation flight
    recorder: the last ``flight_events`` structured events and
    ``flight_spans`` trace spans are frozen into an atomic postmortem
    JSON under that directory whenever the service demotes a tier, the
    watchdog abandons a flush, or a persist fault fires.
    """

    trace: bool = False
    trace_ring: int = 4096
    flight_dir: Optional[str] = None
    flight_spans: int = 256
    flight_events: int = 512

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.trace_ring < 1:
            raise ValueError(
                f"trace_ring must be >= 1, got {self.trace_ring}")
        if self.flight_spans < 0:
            raise ValueError(
                f"flight_spans must be >= 0, got {self.flight_spans}")
        if self.flight_events < 1:
            raise ValueError(
                f"flight_events must be >= 1, got {self.flight_events}")
        if self.flight_dir is not None and not isinstance(
                self.flight_dir, str):
            raise ValueError(
                f"flight_dir must be a path string or None, "
                f"got {self.flight_dir!r}")

    def replace(self, **kw) -> "ObservabilityConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "ObservabilityConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - fields
        if unknown:
            raise ValueError(
                f"unknown ObservabilityConfig fields {sorted(unknown)} "
                f"(known: {sorted(fields)})")
        return cls(**dict(data))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # --- mesh ---
    mesh_shape: Tuple[int, ...] = ()
    # --- numerics / caching ---
    precision: Optional[str] = None
    rt_cache: bool = True
    use_context: bool = True
    fused_serving: bool = False
    rt_store_dir: Optional[str] = None
    # --- batching ---
    batch_size: int = 256
    max_in_flight: int = 2
    # --- trace scale ---
    interval_size: int = 20_000
    warmup: int = 2_000
    max_checkpoints: int = 4
    l_min: int = 100
    l_clip: int = 128
    l_token: int = 16
    with_oracle: bool = True
    # --- multicore ---
    multicore: int = 0
    quantum: Optional[int] = None
    peer_channels: bool = False
    # --- fault injection (chaos) ---
    faults: Tuple[Tuple[str, float], ...] = ()
    fault_seed: int = 0
    # --- analytical-ML fusion (None = full prediction, bitwise) ---
    sampling: Optional[SamplingConfig] = None
    # --- observability (None = metrics only: no tracing, no flight) ---
    observability: Optional[ObservabilityConfig] = None

    def __post_init__(self):
        # normalize mesh_shape so (config equality == behavior equality)
        # survives JSON round trips (lists) and scalar convenience input
        shape = self.mesh_shape
        if isinstance(shape, int):
            shape = (shape,)
        object.__setattr__(self, "mesh_shape", tuple(int(s) for s in shape))
        # normalize faults the same way: JSON lists / dicts of
        # {kind: rate} all collapse to one sorted tuple-of-pairs form
        faults = self.faults
        if isinstance(faults, Mapping):
            faults = faults.items()
        object.__setattr__(
            self, "faults",
            tuple(sorted((str(k), float(r)) for k, r in faults)))
        # normalize sampling: a JSON round trip hands back a mapping
        if isinstance(self.sampling, Mapping):
            object.__setattr__(self, "sampling",
                               SamplingConfig.from_dict(self.sampling))
        if isinstance(self.observability, Mapping):
            object.__setattr__(
                self, "observability",
                ObservabilityConfig.from_dict(self.observability))
        self.validate()

    @property
    def n_shards(self) -> int:
        """Data-parallel shard count: 0 = no mesh (unsharded path); a
        1-device mesh (``(1,)``) still dispatches through shard_map."""
        if not self.mesh_shape:
            return 0
        n = 1
        for s in self.mesh_shape:
            n *= s
        return n

    def validate(self) -> None:
        if any(s < 1 for s in self.mesh_shape):
            raise ValueError(
                f"mesh_shape must be positive, got {self.mesh_shape}")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, "
                f"got {self.precision!r}")
        if self.fused_serving and not (self.rt_cache and self.use_context):
            raise ValueError(
                "fused_serving requires rt_cache=True and "
                "use_context=True (the fused step is the RT-gather + "
                "context block encoder)")
        if self.rt_store_dir is not None and not isinstance(
                self.rt_store_dir, str):
            raise ValueError(
                f"rt_store_dir must be a path string or None, "
                f"got {self.rt_store_dir!r}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, "
                             f"got {self.batch_size}")
        n = self.n_shards
        if n and self.batch_size % n:
            raise ValueError(
                f"batch_size {self.batch_size} must divide by the mesh "
                f"size {n} so no device ever receives an empty shard")
        if self.multicore < 0:
            raise ValueError(f"multicore must be >= 0, "
                             f"got {self.multicore}")
        if self.peer_channels and self.multicore < 1:
            raise ValueError("peer_channels requires multicore >= 1")
        if self.quantum is not None and self.quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {self.quantum}")
        seen = set()
        for kind, rate in self.faults:
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} "
                    f"(known: {list(FAULT_KINDS)})")
            if kind in seen:
                raise ValueError(f"duplicate fault kind {kind!r}")
            seen.add(kind)
            if not 0.0 <= rate <= 1.0:
                raise ValueError(
                    f"fault rate for {kind!r} must be in [0, 1], "
                    f"got {rate}")
        if self.sampling is not None and not isinstance(self.sampling,
                                                        SamplingConfig):
            raise ValueError(
                f"sampling must be a SamplingConfig (or a mapping of "
                f"its fields) or None, got {self.sampling!r}")
        if self.observability is not None and not isinstance(
                self.observability, ObservabilityConfig):
            raise ValueError(
                f"observability must be an ObservabilityConfig (or a "
                f"mapping of its fields) or None, "
                f"got {self.observability!r}")

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------ JSON ------------------------------ #

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)          # nests sampling as a dict
        d["mesh_shape"] = list(self.mesh_shape)
        d["faults"] = [[k, r] for k, r in self.faults]
        return d

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "EngineConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - fields
        if unknown:
            raise ValueError(
                f"unknown EngineConfig fields {sorted(unknown)} "
                f"(known: {sorted(fields)})")
        return cls(**dict(data))

    @classmethod
    def from_json(cls, text: str) -> "EngineConfig":
        return cls.from_dict(json.loads(text))


# config field names — used only to phrase the retirement TypeError
_CONFIG_FIELDS = frozenset(f.name for f in dataclasses.fields(EngineConfig))


def reject_legacy_kwargs(kwargs: Dict[str, Any], where: str) -> None:
    """The PR-6 deprecated loose-kwarg shims are retired.

    Every entry point now accepts knobs exclusively through
    ``config=EngineConfig(...)``; any leftover keyword raises
    ``TypeError``.  Keywords that name real config fields get a message
    pointing at the exact ``EngineConfig(...)`` construction to use."""
    if not kwargs:
        return
    names = sorted(kwargs)
    known = sorted(set(kwargs) & _CONFIG_FIELDS)
    if known:
        fields = ", ".join(f"{k}=..." for k in known)
        raise TypeError(
            f"{where}() no longer accepts {names} as keyword arguments "
            f"(the deprecated shims were removed) — construct an "
            f"EngineConfig and pass config=EngineConfig({fields})")
    raise TypeError(
        f"{where}() got unexpected keyword arguments {names}")
