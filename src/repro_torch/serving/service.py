"""Fault-tolerant continuous-batching simulation service (port of
``repro/serving/service.py``).

``PredictorEngine`` is a synchronous flush front-end: callers block, a
stuck flush hangs everyone, and a misbehaving fast path (fused / int8 /
RT store) returns whatever it returns.  ``SimulationService`` is the
production front: the contract is that **every admitted request ends in
a typed result** — a success, a degraded-tier success, or a clean,
immediate rejection — never a hang, and never an ungated wrong answer.

Structure:

  admission     a bounded queue with SLA-aware shedding: a full queue or
                a predicted wait beyond the request's deadline resolves
                the ticket *immediately* with ``overloaded`` instead of
                blocking the batch (``deadline_exceeded`` covers
                requests that expire while queued).
  continuous    one worker drains the queue into device batches with no
  batching      drain barrier between requests: a flush window tops up
                from the queue until ``sla.max_flush_clips`` (many
                requests share one device batch; one request may span
                several), and the backend's async dispatch keeps the
                device busy while the next request is packed.
  watchdog      every flush runs on a watchdog thread bounded by
                ``sla.watchdog_s``; a stuck flush (the ``slow_flush``
                chaos fault, a runaway compile, a wedged device) is
                abandoned, its tier's backend rebuilt, and the batch
                retried a tier down.
  degradation   a ``DegradationController`` walks the serving-tier
                ladder fused+int8 -> fused -> RT warm -> monolithic
                (the Concorde shape: cheap path backed by an accurate
                one).  On the card every rung runs the port's kernels:
                flash attention in the RT build, the block encoder of
                the ``rt`` rung and every encoder of the ``monolithic``
                one, weighted attention in the fused rungs.  Every
                flush is NaN/Inf-guarded; periodic spot checks re-run a
                few clips through the trusted monolithic reference and
                demote when the tier's rel-err gate (the same
                tolerances CI enforces) is exceeded.  Demotions
                back off exponentially: re-promotion needs a healthy
                streak that doubles with every repeated demotion, so a
                flapping fast path settles low instead of oscillating.
  chaos         ``EngineConfig.faults`` builds a ``FaultInjector``
                honored by the *real* engine stack (dispatch, retire,
                RT-store read, persist): the tests and
                ``chip_smoke.py`` drive exactly the code production
                traffic runs.

Threads.  The worker and every watchdogged flush run under
``torch.inference_mode()`` (grad mode is per thread, so the caller's
setting does not reach them), and ``start`` builds the attention kernels
before the first flush, so the watchdog bounds run time, not ``nvcc``.
An abandoned flush thread cannot be killed (a launched CUDA kernel is not
interruptible); it finishes against its *old* backend object and is
dropped.  PyTorch tensors are mutable, so the argument is not the
reference's (immutable arrays) but this: a backend's buffers, pending
outputs and serving plan are its own, and ``invalidate_backend`` hands the
retry a new one; the parameters are only read; and the RT cache, which a
straggler on the ``fused`` rung shares with the ``rt`` rung, writes each
row once, under its lock, above every row id it has handed out, so a
straggler only gathers rows below the count it saw, which nothing writes
again (``core/rt_cache.py``).  A late straggler can therefore never
corrupt a retry's results.

Clocks.  Arrivals, deadlines and every interval (``ServiceResult``'s
``queue_seconds``/``service_seconds``, the flush histogram, the queue
wait) are on the monotonic ``time.perf_counter()``: a step of the wall
clock moves none of them.  The worker's spans (``service.wait``,
``service.collect``, ``service.flush``, ``service.resolve``) and the
predictor's (``predict.*``) are registry series and, while a
``torch.profiler`` records, ranges of its trace.

Like every entry point of the port, the service runs on the card unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import PredictStack
from repro_torch.core.engine_config import EngineConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import resolve_mesh
from repro_torch.obs import Observability
from repro_torch.serving.engine import (Request, flush_requests,
                                        validate_request)
from repro_torch.serving.faults import FaultInjector

# service-level metric names (see README's Observability section).
# Every family carries an ``instance`` label (svc0, svc1, ...) so two
# services in one process — or an abandoned watchdog thread outliving a
# rebuilt one — never write into each other's series.
TIER_EVENTS_TOTAL = "capsim_service_tier_events_total"
TIER_TRANSITIONS_TOTAL = "capsim_service_tier_transitions_total"
ADMISSION_TOTAL = "capsim_service_admission_total"
QUEUE_DEPTH = "capsim_service_queue_depth"
QUEUED_CLIPS = "capsim_service_queued_clips"
FLUSH_SECONDS = "capsim_service_flush_seconds"
QUEUE_WAIT_SECONDS = "capsim_service_queue_wait_seconds"
ABANDONED_THREADS = "capsim_service_abandoned_flush_threads"
ABANDONED_THREADS_TOTAL = "capsim_service_abandoned_flush_threads_total"

# typed result statuses: the full closed set a caller can observe
STATUS_OK = "ok"                          # served at the top tier
STATUS_DEGRADED = "degraded"              # served at a demoted tier
STATUS_OVERLOADED = "overloaded"          # shed at admission (clean)
STATUS_DEADLINE = "deadline_exceeded"     # expired before service
STATUS_FAILED = "failed"                  # every tier faulted (typed)
STATUS_CANCELLED = "cancelled"            # service stopped w/o drain
STATUSES = (STATUS_OK, STATUS_DEGRADED, STATUS_OVERLOADED,
            STATUS_DEADLINE, STATUS_FAILED, STATUS_CANCELLED)

# the degradation ladder, fastest first.  Tolerances are the existing
# CI gates for each rung measured against the monolithic auditor (at the
# config's own dtype):
# fused is ≤1e-3 vs unfused, int8 is width-dependent (~0.6% at the
# paper's d_model=128, gated 1% full scale / 5% quick), RT is bitwise
# (any drift at all means the table is corrupt).
TIER_LADDER = ("fused_int8", "fused", "rt", "monolithic")
DEFAULT_TIER_TOLERANCES = {"fused_int8": 0.05, "fused": 1e-3,
                           "rt": 1e-6, "monolithic": float("inf")}


class FlushTimeout(RuntimeError):
    """A watchdogged flush exceeded ``sla.watchdog_s``."""


@dataclasses.dataclass
class ServiceSLA:
    """The service-level knobs (see README's serving section).

    ``queue_limit``/``default_deadline_s`` drive admission;
    ``watchdog_s`` bounds any single flush; ``max_flush_clips`` caps a
    continuous-batching window; ``check_every``/``check_clips`` set the
    rel-err spot-check cadence and sample; ``promote_after`` is the
    base healthy streak a demoted service needs before re-promoting
    (doubles per repeated demotion up to ``backoff_max``).
    """

    queue_limit: int = 256
    default_deadline_s: float = 30.0
    watchdog_s: float = 10.0
    max_flush_clips: int = 1024
    check_every: int = 8
    check_clips: int = 4
    promote_after: int = 3
    backoff_max: int = 64
    tier_tolerances: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_TIER_TOLERANCES))


@dataclasses.dataclass
class ServiceResult:
    """The one typed terminal state of every submitted request."""

    request_id: int
    status: str                          # one of STATUSES
    total_cycles: Optional[float]        # None unless ok/degraded
    tier: Optional[str]                  # serving tier that produced it
    n_clips: int
    queue_seconds: float = 0.0
    service_seconds: float = 0.0
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status in (STATUS_OK, STATUS_DEGRADED)

    @property
    def latency_seconds(self) -> float:
        return self.queue_seconds + self.service_seconds


class ServiceTicket:
    """Future-like handle returned by ``submit``.  ``result()`` blocks
    until the request reaches its typed terminal state."""

    def __init__(self, request_id: int, n_clips: int):
        self.request_id = request_id
        self.n_clips = n_clips
        self._event = threading.Event()
        self._result: Optional[ServiceResult] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ServiceResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not resolved in {timeout}s")
        assert self._result is not None
        return self._result

    def _resolve(self, result: ServiceResult) -> None:
        self._result = result
        self._event.set()


@dataclasses.dataclass
class _QueuedRequest:
    req: Request
    ticket: ServiceTicket
    arrival: float                       # time.perf_counter() at submit
    deadline: float                      # arrival + the deadline's seconds


class TierStats:
    """Live per-tier counters, as a view over the metrics registry
    (``capsim_service_tier_events_total{instance,tier,event}``).  The
    attribute surface of the retired accumulator dataclass is kept:
    ``ts.nan_trips`` etc. read the registry; writers call ``inc``."""

    # event label values == the legacy dataclass field names
    EVENTS = ("flushes", "clips", "demotions", "promotions", "nan_trips",
              "relerr_trips", "fault_trips", "watchdog_trips",
              "persist_failures")

    def __init__(self, name: str, obs: Observability, instance: str):
        self.name = name
        self._obs = obs
        self._instance = instance
        fam = obs.metrics.counter(
            TIER_EVENTS_TOTAL,
            "Per-tier serving events (flushes, clips, guard trips, ...).",
            ("instance", "tier", "event"))
        self._handles = {e: fam.labels(instance=instance, tier=name,
                                       event=e) for e in self.EVENTS}

    def inc(self, event: str, n: int = 1) -> None:
        self._handles[event].inc(n)

    def _val(self, event: str) -> int:
        return int(self._obs.metrics.value(
            TIER_EVENTS_TOTAL, instance=self._instance, tier=self.name,
            event=event))

    def __getattr__(self, item: str) -> int:
        if item in TierStats.EVENTS:
            return self._val(item)
        raise AttributeError(item)

    def as_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {"name": self.name}
        d.update({e: self._val(e) for e in self.EVENTS})
        return d


@dataclasses.dataclass(frozen=True)
class ServiceSnapshot:
    """One immutable, JSON-stable view of the whole service: admission
    ledger, degradation state, per-tier counters, chaos activity, and
    the abandoned-watchdog-thread ledger.  ``stats()`` is a thin compat
    wrapper returning ``snapshot().to_dict()``; the key set is frozen —
    benches, the flight recorder, and the CI chaos leg all parse it."""

    submitted: int
    statuses: Dict[str, int]
    current_tier: str
    backoff: int
    healthy_streak: int
    queued: int
    queued_clips: int
    clips_per_s_ewma: Optional[float]
    n_flushes: int
    tiers: Dict[str, Dict[str, object]]
    faults_fired: Dict[str, int]
    abandoned_flush_threads: int         # still alive right now
    abandoned_flush_threads_total: int   # ever abandoned (monotone)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "ServiceSnapshot":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ServiceSnapshot fields "
                             f"{sorted(unknown)}")
        return cls(**d)  # type: ignore[arg-type]


class DegradationController:
    """Tier pointer + exponential-backoff re-promotion policy.

    Healthy flushes build a streak; once it reaches the current backoff
    the service promotes one tier.  Any guard trip demotes one tier,
    zeroes the streak, and doubles the backoff (capped) — so a tier
    that keeps failing gets retried less and less often.  The backoff
    resets to base only after the service is back at the top tier and
    has stayed healthy for one more full streak.
    """

    def __init__(self, n_tiers: int, sla: ServiceSLA):
        self.n_tiers = n_tiers
        self.sla = sla
        self.idx = 0
        self.healthy_streak = 0
        self.backoff = sla.promote_after
        self._recovered = True

    def on_healthy(self) -> Optional[int]:
        """Record a healthy flush; returns the new tier index when this
        triggers a promotion, else None."""
        self.healthy_streak += 1
        if self.idx > 0 and self.healthy_streak >= self.backoff:
            self.idx -= 1
            self.healthy_streak = 0
            self._recovered = False
            return self.idx
        if (self.idx == 0 and not self._recovered
                and self.healthy_streak >= self.sla.promote_after):
            # fully re-promoted and stable: forgive the backoff
            self.backoff = self.sla.promote_after
            self._recovered = True
        return None

    def on_trip(self) -> Optional[int]:
        """Record a guard trip; returns the new (demoted) tier index,
        or None when already at the ladder floor."""
        self.healthy_streak = 0
        self.backoff = min(self.backoff * 2, self.sla.backoff_max)
        self._recovered = False
        if self.idx + 1 < self.n_tiers:
            self.idx += 1
            return self.idx
        return None


def build_ladder(config: EngineConfig) -> List[Tuple[str, EngineConfig]]:
    """The degradation ladder as (name, EngineConfig) rungs, fastest
    first, honoring the base config's structural axes (a config without
    an RT cache or context has no fused rungs to degrade through)."""
    ladder: List[Tuple[str, EngineConfig]] = []
    if config.rt_cache and config.use_context:
        ladder.append(("fused_int8", config.replace(
            fused_serving=True, precision="int8")))
        ladder.append(("fused", config.replace(
            fused_serving=True, precision=None)))
    if config.rt_cache:
        ladder.append(("rt", config.replace(
            fused_serving=False, precision=None)))
    ladder.append(("monolithic", config.replace(
        fused_serving=False, precision=None, rt_cache=False,
        rt_store_dir=None)))
    return ladder


class SimulationService:
    """The continuous-batching, fault-tolerant serving front-end.

    Usage::

        sla = ServiceSLA(queue_limit=64, default_deadline_s=5.0)
        with SimulationService(params, cfg, config, sla=sla) as svc:
            ticket = svc.submit(request, deadline_s=2.0)
            result = ticket.result()        # always a typed result

    The service manages precision/fusion itself via the degradation
    ladder — the base config's ``precision``/``fused_serving`` fields
    are overridden per rung; batching, scale, mesh, store and fault
    fields pass through.  Each rung, and the auditor that spot-checks
    them, holds a ``PredictStack``; the stacks share one parameter tree,
    one quantized tree and one RT cache per (tree, numerics), so the
    ``fused`` and ``rt`` rungs share a cache.  Every rung and its RT cache
    shard over one data mesh (``make_data_mesh(n, device)``).  The
    auditor is the ``monolithic`` rung at the config's own dtype (not
    necessarily f32), unsharded, without the service's injector.
    """

    def __init__(self, params, cfg, config: Optional[EngineConfig] = None,
                 *, sla: Optional[ServiceSLA] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 start_tier: int = 0, device: DeviceLike = "cuda"):
        self.config = config or EngineConfig()
        self.device = resolve_device(device)
        self.mesh = resolve_mesh(self.config.n_shards, self.device)
        self.sla = sla or ServiceSLA()
        self.obs = Observability.from_config(self.config.observability)
        m = self.obs.metrics
        self.instance = m.next_instance("svc")
        self._injector = fault_injector
        if self._injector is None and self.config.faults:
            # slow_flush must out-sleep the watchdog, or the chaos fault
            # would model a *slow* flush rather than a *stuck* one
            self._injector = FaultInjector.from_config(
                self.config, slow_seconds=self.sla.watchdog_s * 3)

        ladder = build_ladder(self.config)
        shared: Dict[object, object] = {}
        # one stack a rung, named by its tier_stats entry
        self._tiers = [PredictStack(params, cfg, tcfg, device=self.device,
                                    obs=self.obs, mesh=self.mesh,
                                    faults=self._injector, shared=shared)
                       for _, tcfg in ladder]
        # the trusted auditor: the monolithic rung at the config's own
        # dtype, unsharded, without the service's injector, so that its
        # checks draw nothing from the rungs' fault schedule.  Under a
        # chaos config its backend builds a private injector from the
        # config, as every BatchedPredictor given none does; a fault
        # there makes the spot check return None, not demote
        self._reference = PredictStack(
            params, cfg, ladder[-1][1].replace(mesh_shape=()),
            device=self.device, obs=self.obs, shared=shared)

        if not 0 <= start_tier < len(self._tiers):
            raise ValueError(f"start_tier {start_tier} outside the "
                             f"{len(self._tiers)}-rung ladder")
        self._ctrl = DegradationController(len(self._tiers), self.sla)
        self._ctrl.idx = start_tier
        self.tier_stats = [TierStats(name, self.obs, self.instance)
                           for name, _ in ladder]
        self._status_counts: Dict[str, int] = {s: 0 for s in STATUSES}
        self._n_submitted = 0
        self._n_flushes = 0

        self._fam_transitions = m.counter(
            TIER_TRANSITIONS_TOTAL,
            "Degradation-ladder transitions by edge and reason.",
            ("instance", "from_tier", "to_tier", "reason"))
        self._fam_admission = m.counter(
            ADMISSION_TOTAL, "Admission decisions (admitted vs shed).",
            ("instance", "decision"))
        self._g_queue_depth = m.gauge(
            QUEUE_DEPTH, "Requests waiting in the admission queue.",
            ("instance",)).labels(instance=self.instance)
        self._g_queued_clips = m.gauge(
            QUEUED_CLIPS, "Clips waiting in the admission queue.",
            ("instance",)).labels(instance=self.instance)
        self._h_flush = m.histogram(
            FLUSH_SECONDS, "Watchdogged flush latency by serving tier.",
            ("instance", "tier"))
        self._h_queue_wait = m.histogram(
            QUEUE_WAIT_SECONDS,
            "A served request's wait from admission to its flush's start.",
            ("instance",)).labels(instance=self.instance)
        self._g_abandoned = m.gauge(
            ABANDONED_THREADS,
            "Abandoned watchdog flush threads still alive.",
            ("instance",)).labels(instance=self.instance)
        self._c_abandoned = m.counter(
            ABANDONED_THREADS_TOTAL,
            "Watchdog flush threads ever abandoned.",
            ("instance",)).labels(instance=self.instance)
        self._abandoned: List[threading.Thread] = []

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: Deque[_QueuedRequest] = deque()
        self._queued_clips = 0
        self._rate: Optional[float] = None        # EWMA clips/sec
        self._running = False
        self._draining = False
        self._worker: Optional[threading.Thread] = None

    # ------------------------------ lifecycle ------------------------------ #

    def start(self) -> "SimulationService":
        if self.device.type == "cuda":
            # a first-use nvcc build inside a watchdogged flush would
            # trip a short watchdog: build the attention kernels now
            from repro_torch.kernels import build
            build.build(("flash_attention", "weighted_attention"))
        with self._lock:
            if self._running:
                return self
            self._running = True
            self._draining = False
        self._worker = threading.Thread(target=self._serve_loop,
                                        name="sim-service", daemon=True)
        self._worker.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop the worker.  ``drain=True`` serves everything already
        queued first; ``drain=False`` resolves queued requests with the
        typed ``cancelled`` status immediately."""
        with self._cond:
            if not self._running:
                return
            self._running = False
            self._draining = drain
            if not drain:
                now = time.perf_counter()
                while self._queue:
                    qr = self._queue.popleft()
                    self._queued_clips -= qr.ticket.n_clips
                    self._finish(qr, ServiceResult(
                        request_id=qr.req.request_id,
                        status=STATUS_CANCELLED, total_cycles=None,
                        tier=None, n_clips=qr.ticket.n_clips,
                        queue_seconds=now - qr.arrival,
                        error="service stopped without drain"))
                self._update_queue_gauges()
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)
            self._worker = None

    def __enter__(self) -> "SimulationService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    @property
    def injector(self) -> Optional[FaultInjector]:
        """The chaos injector the whole service stack consults (None on
        a fault-free config) — benches toggle it between phases."""
        return self._injector

    def prewarm(self, req: Request) -> None:
        """Run every rung (and the reference) once over one small request
        before taking traffic, so the kernels are built and loaded, the
        RT rows encoded and the cuBLAS handles made, and the watchdog
        budget bounds *runtime*, not a first flush.  Injection is
        suspended for the warmup — chaos belongs to the traffic phases."""
        validate_request(req, self.config,
                         (self.config.l_clip, self.config.l_token))
        prev = (self._injector.set_enabled(False)
                if self._injector is not None else None)
        try:
            with torch.inference_mode():
                for tier in self._tiers + [self._reference]:
                    backend = tier.backend()
                    backend.reset_context_width()
                    backend.add(req.clip_tokens, req.context_tokens,
                                req.clip_mask)
                    backend.drain()
        finally:
            if prev is not None:
                self._injector.set_enabled(prev)

    # ------------------------------ admission ------------------------------ #

    def submit(self, req: Request,
               deadline_s: Optional[float] = None) -> ServiceTicket:
        """Admit (or immediately shed) one request.  Always returns a
        ticket; a shed request's ticket is already resolved with the
        typed ``overloaded`` result — callers never block to learn they
        were rejected."""
        validate_request(req, self.config,
                         (self.config.l_clip, self.config.l_token))
        n_clips = req.clip_tokens.shape[0]
        ticket = ServiceTicket(req.request_id, n_clips)
        deadline = (deadline_s if deadline_s is not None
                    else self.sla.default_deadline_s)
        now = time.perf_counter()
        with self._cond:
            self._n_submitted += 1
            if not self._running:
                self._admission("not_running")
                self._resolve_ticket(ticket, ServiceResult(
                    request_id=req.request_id, status=STATUS_OVERLOADED,
                    total_cycles=None, tier=None, n_clips=n_clips,
                    error="service is not running"))
                return ticket
            if len(self._queue) >= self.sla.queue_limit:
                self._admission("queue_full")
                self._resolve_ticket(ticket, ServiceResult(
                    request_id=req.request_id, status=STATUS_OVERLOADED,
                    total_cycles=None, tier=None, n_clips=n_clips,
                    error=f"queue full "
                          f"({self.sla.queue_limit} requests)"))
                return ticket
            # SLA-aware shed: if the backlog alone predicts we blow the
            # deadline, reject NOW instead of letting the request expire
            # in queue (an open-loop client learns immediately)
            if self._rate:
                est_wait = self._queued_clips / self._rate
                if est_wait > deadline:
                    self._admission("predicted_wait")
                    self._resolve_ticket(ticket, ServiceResult(
                        request_id=req.request_id,
                        status=STATUS_OVERLOADED, total_cycles=None,
                        tier=None, n_clips=n_clips,
                        error=f"predicted wait {est_wait:.2f}s exceeds "
                              f"deadline {deadline:.2f}s"))
                    return ticket
            self._admission("admitted")
            self._queue.append(_QueuedRequest(
                req=req, ticket=ticket, arrival=now,
                deadline=now + deadline))
            self._queued_clips += n_clips
            self._update_queue_gauges()
            self._cond.notify()
        return ticket

    def _admission(self, decision: str) -> None:
        self._fam_admission.labels(instance=self.instance,
                                   decision=decision).inc()

    def _update_queue_gauges(self) -> None:
        """Mirror the queue state into the registry (lock held)."""
        self._g_queue_depth.set(len(self._queue))
        self._g_queued_clips.set(self._queued_clips)

    def _resolve_ticket(self, ticket: ServiceTicket,
                        result: ServiceResult) -> None:
        self._status_counts[result.status] += 1
        ticket._resolve(result)

    def _finish(self, qr: _QueuedRequest, result: ServiceResult) -> None:
        self._resolve_ticket(qr.ticket, result)

    # ------------------------------ serving ------------------------------ #

    @property
    def current_tier(self) -> str:
        return self.tier_stats[self._ctrl.idx].name

    def _serve_loop(self) -> None:
        with torch.inference_mode():
            self._serve_forever()

    def _serve_forever(self) -> None:
        """The worker: wait on an empty queue (span ``service.wait``, one
        a wake-up of at most 50 ms, so a window's reading of the span
        counts at most 50 ms of waiting from before it), pop a window
        (``service.collect``), serve it (``_serve_batch``)."""
        while True:
            with self._cond:
                while not self._queue:
                    if not self._running:
                        return
                    with self.obs.span("service.wait",
                                       instance=self.instance):
                        self._cond.wait(0.05)
                if not self._running and not self._draining:
                    return
                with self.obs.span("service.collect",
                                   instance=self.instance):
                    batch = self._collect_window()
            if batch:
                self._serve_batch(batch)

    def _collect_window(self) -> List[_QueuedRequest]:
        """Pop one continuous-batching window off the queue (lock held):
        everything queued, up to ``max_flush_clips``.  Requests already
        past their deadline resolve here — typed, without burning a
        flush on work nobody is waiting for."""
        now = time.perf_counter()
        window: List[_QueuedRequest] = []
        clips = 0
        while self._queue and clips < self.sla.max_flush_clips:
            qr = self._queue.popleft()
            self._queued_clips -= qr.ticket.n_clips
            if now > qr.deadline:
                self._finish(qr, ServiceResult(
                    request_id=qr.req.request_id, status=STATUS_DEADLINE,
                    total_cycles=None, tier=None,
                    n_clips=qr.ticket.n_clips,
                    queue_seconds=now - qr.arrival,
                    error="deadline expired while queued"))
                continue
            window.append(qr)
            clips += qr.ticket.n_clips
        self._update_queue_gauges()
        return window

    def _serve_batch(self, batch: List[_QueuedRequest]) -> None:
        """Serve one window, walking down the tier ladder on faults.
        Every request in the window ends resolved, whatever happens.
        Each request's wait from admission to now is observed once in
        ``capsim_service_queue_wait_seconds``; spans ``service.flush``
        (each watchdogged flush, its thread's start and join included)
        and ``service.resolve`` (the healthy flush's results scattered
        to the tickets, the rate and the ladder updated)."""
        t_start = time.perf_counter()
        for qr in batch:
            self._h_queue_wait.observe(t_start - qr.arrival)
        attempts = 0
        max_attempts = len(self._tiers) + 2
        last_error = "unknown"
        while batch and attempts < max_attempts:
            attempts += 1
            # deadlines may expire between (watchdogged) attempts
            now = time.perf_counter()
            still: List[_QueuedRequest] = []
            for qr in batch:
                if now > qr.deadline:
                    self._finish(qr, ServiceResult(
                        request_id=qr.req.request_id,
                        status=STATUS_DEADLINE, total_cycles=None,
                        tier=None, n_clips=qr.ticket.n_clips,
                        queue_seconds=qr.deadline - qr.arrival,
                        service_seconds=now - qr.deadline,
                        error="deadline expired during degraded retry"))
                    continue
                still.append(qr)
            batch = still
            if not batch:
                return

            idx = self._ctrl.idx
            tier = self._tiers[idx]
            ts = self.tier_stats[idx]
            try:
                with self.obs.span("service.flush", instance=self.instance):
                    times, flush_s = self._flush_watchdogged(idx, batch)
            except FlushTimeout:
                ts.inc("watchdog_trips")
                tier.invalidate_backend()
                last_error = (f"watchdog abort after "
                              f"{self.sla.watchdog_s:.2f}s at {ts.name}")
                self._demote(idx, "watchdog", last_error)
                continue
            except Exception as exc:          # noqa: BLE001 — typed fail
                ts.inc("fault_trips")
                tier.invalidate_backend()
                last_error = f"{type(exc).__name__}: {exc} at {ts.name}"
                self._demote(idx, "fault", last_error)
                continue

            if not np.isfinite(times).all():
                ts.inc("nan_trips")
                last_error = f"non-finite predictions at {ts.name}"
                self._demote(idx, "nan", last_error)
                continue

            self._n_flushes += 1
            if (ts.name != "monolithic"
                    and self.sla.check_every > 0
                    and self._n_flushes % self.sla.check_every == 0):
                err = self._spot_check(tier, batch)
                tol = self.sla.tier_tolerances.get(
                    ts.name, float("inf"))
                if err is not None and err > tol:
                    ts.inc("relerr_trips")
                    last_error = (f"spot-check rel err {err:.2e} > "
                                  f"{tol:.2e} gate at {ts.name}")
                    self._demote(idx, "relerr", last_error)
                    continue

            # healthy flush: resolve, update throughput, maybe promote
            with self.obs.span("service.resolve", instance=self.instance):
                ts.inc("flushes")
                ts.inc("clips", int(times.shape[0]))
                if flush_s > 1e-6:
                    rate = times.shape[0] / flush_s
                    self._rate = (rate if self._rate is None
                                  else 0.5 * self._rate + 0.5 * rate)
                status = STATUS_OK if idx == 0 else STATUS_DEGRADED
                done_t = time.perf_counter()
                off = 0
                for qr in batch:
                    k = qr.ticket.n_clips
                    self._finish(qr, ServiceResult(
                        request_id=qr.req.request_id, status=status,
                        total_cycles=float(times[off:off + k].sum()),
                        tier=ts.name, n_clips=k,
                        queue_seconds=t_start - qr.arrival,
                        service_seconds=done_t - t_start))
                    off += k
                promoted = self._ctrl.on_healthy()
                if promoted is not None:
                    self.tier_stats[promoted].inc("promotions")
                    self._transition(ts.name,
                                     self.tier_stats[promoted].name,
                                     "promotion")
            return

        # ladder exhausted (or attempt cap): typed failure, never a hang
        now = time.perf_counter()
        for qr in batch:
            self._finish(qr, ServiceResult(
                request_id=qr.req.request_id, status=STATUS_FAILED,
                total_cycles=None, tier=None, n_clips=qr.ticket.n_clips,
                queue_seconds=t_start - qr.arrival,
                service_seconds=now - t_start,
                error=f"all serving tiers failed ({last_error})"))

    def _transition(self, from_tier: str, to_tier: str,
                    reason: str) -> None:
        """One ladder move: counter + flight/trace event, same ledger
        the CI chaos leg cross-checks against the bench JSON."""
        self._fam_transitions.labels(
            instance=self.instance, from_tier=from_tier,
            to_tier=to_tier, reason=reason).inc()
        self.obs.event("tier_transition", from_tier=from_tier,
                       to_tier=to_tier, reason=reason)

    def _demote(self, from_idx: int, reason: str,
                detail: str = "") -> None:
        self.tier_stats[from_idx].inc("demotions")
        new_idx = self._ctrl.on_trip()
        from_name = self.tier_stats[from_idx].name
        if new_idx is not None:
            self._transition(from_name, self.tier_stats[new_idx].name,
                             reason)
        else:
            # ladder floor: a trip with nowhere to go is still an event
            self.obs.event("tier_trip_floor", tier=from_name,
                           reason=reason)
        # postmortem AFTER the transition event so the flight ring
        # captures it; the snapshot is the post-demotion state
        state = self.snapshot().to_dict()
        if detail:
            state["detail"] = detail
        self.obs.postmortem(f"demote_{reason}", state=state)

    def _flush_watchdogged(self, idx: int,
                           batch: Sequence[_QueuedRequest]
                           ) -> Tuple[np.ndarray, float]:
        """Run one flush on rung ``idx`` on a watchdog thread.  Returns
        (times, flush seconds); raises ``FlushTimeout`` after
        ``sla.watchdog_s`` (the stuck thread is abandoned — see the
        module docstring)."""
        tier, name = self._tiers[idx], self.tier_stats[idx].name
        box: Dict[str, object] = {}
        done = threading.Event()
        t0 = time.perf_counter()

        def _run():
            try:
                with torch.inference_mode():
                    box["times"] = self._flush(tier, batch)
            except BaseException as exc:      # noqa: BLE001 — re-raised
                box["exc"] = exc
            finally:
                done.set()

        th = threading.Thread(target=_run, name=f"flush-{name}",
                              daemon=True)
        th.start()
        if not done.wait(self.sla.watchdog_s):
            self._abandoned.append(th)
            self._c_abandoned.inc()
            self._prune_abandoned()
            raise FlushTimeout(name)
        if "exc" in box:
            raise box["exc"]                  # type: ignore[misc]
        flush_s = time.perf_counter() - t0
        self._h_flush.labels(instance=self.instance,
                             tier=name).observe(flush_s)
        if tier.cache is not None:
            # persist failures must not discard a finished flush: the
            # previous store generation is intact (atomic publish), so
            # this is a counter, not a demotion
            try:
                tier.cache.persist()
            except Exception:                 # noqa: BLE001
                self.tier_stats[idx].inc("persist_failures")
        return box["times"], flush_s          # type: ignore[return-value]

    def _flush(self, tier: PredictStack,
               batch: Sequence[_QueuedRequest]) -> np.ndarray:
        """One flush of ``batch`` on ``tier``'s backend: per-clip times.
        Under ``config.sampling`` they are each request's fused per-clip
        times, extrapolated where not sampled, so the vector is full
        length and the NaN guard and per-request scatter in
        ``_serve_batch`` (and hence the typed-result contract) hold
        alike.  The bootstrap is skipped: ``ServiceResult`` carries
        totals, not intervals; ``PredictorEngine`` with sampling gives
        CIs."""
        preds = flush_requests(tier.backend(), [qr.req for qr in batch],
                               bootstrap_resamples=0)
        if tier.config.sampling is not None:
            preds = [np.asarray(rep.times, np.float64) for rep in preds]
        return np.concatenate(preds)

    def _spot_check(self, tier: PredictStack,
                    batch: Sequence[_QueuedRequest]) -> Optional[float]:
        """Re-run a small sample of the window's clips through the
        trusted auditor (the monolithic rung) and return the max rel err
        (None when the reference itself fails — a reference fault must
        not demote the tier under test)."""
        k = self.sla.check_clips
        qr = batch[0]
        tok = qr.req.clip_tokens[:k]
        ctx = qr.req.context_tokens[:k]
        mask = qr.req.clip_mask[:k]
        if tok.shape[0] == 0:
            return None
        try:
            ref = self._reference.backend()
            ref.reset_context_width()
            ref.add(tok, ctx, mask)
            ref_times = ref.drain()
            tier_backend = tier.backend()
            tier_backend.reset_context_width()
            tier_backend.add(tok, ctx, mask)
            got = tier_backend.drain()
        except Exception:                     # noqa: BLE001
            self._reference.invalidate_backend()
            tier.invalidate_backend()
            return None
        if not np.isfinite(got).all():
            return float("inf")
        return float(np.max(np.abs(got - ref_times)
                            / np.maximum(np.abs(ref_times), 1.0)))

    # ------------------------------ stats ------------------------------ #

    def _prune_abandoned(self) -> None:
        """Drop finished stragglers; mirror the alive count into the
        gauge.  A straggler that finally finishes was writing into its
        OLD backend's per-instance metric series — never this one's."""
        self._abandoned = [t for t in self._abandoned if t.is_alive()]
        self._g_abandoned.set(len(self._abandoned))

    def join_abandoned(self, timeout: Optional[float] = None) -> int:
        """Wait up to ``timeout`` seconds for the abandoned flush threads
        to finish; returns how many are still running.  Call it before
        the process exits: a thread killed inside a torch call at
        interpreter shutdown aborts the process."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with self._lock:
            threads = list(self._abandoned)
        for th in threads:
            th.join(None if deadline is None
                    else max(deadline - time.perf_counter(), 0.0))
        with self._lock:
            self._prune_abandoned()
            return len(self._abandoned)

    def snapshot(self) -> ServiceSnapshot:
        """One consistent, frozen, JSON-stable view of the service."""
        with self._lock:
            self._prune_abandoned()
            return ServiceSnapshot(
                submitted=self._n_submitted,
                statuses=dict(self._status_counts),
                current_tier=self.current_tier,
                backoff=self._ctrl.backoff,
                healthy_streak=self._ctrl.healthy_streak,
                queued=len(self._queue),
                queued_clips=self._queued_clips,
                clips_per_s_ewma=self._rate,
                n_flushes=self._n_flushes,
                tiers={s.name: s.as_dict() for s in self.tier_stats},
                faults_fired=(self._injector.stats()
                              if self._injector is not None else {}),
                abandoned_flush_threads=len(self._abandoned),
                abandoned_flush_threads_total=int(self.obs.metrics.value(
                    ABANDONED_THREADS_TOTAL, instance=self.instance)),
            )

    def stats(self) -> Dict[str, object]:
        """Compat wrapper: ``snapshot().to_dict()`` (same keys as the
        pre-observability dict, plus the new snapshot fields)."""
        return self.snapshot().to_dict()
