"""Unified observability: span tracing, metrics, flight recorder.

:class:`Observability` is the bundle components hold.  Its
:meth:`~Observability.span` primitive always times (the registry is the
system of record — the Stats view classes read it back), and feeds the
tracer ring only when tracing is enabled, so one ``with obs.span(...)``
stanza replaces both the old ad-hoc ``time.time()`` accounting and the
bench-only ``perf_counter`` breakdowns.

Construction::

    obs = Observability.from_config(config.observability)  # None -> defaults
    with obs.span("engine.tokenize", instance=self._inst) as sp:
        ...
    elapsed = sp.seconds          # same clock the registry recorded

``from_config(None)`` shares the process-global registry and the
disabled global tracer; ``ObservabilityConfig(trace=True)`` gets a
private enabled :class:`Tracer` the owner can dump with
``obs.tracer.dump(path)``.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from .flight import POSTMORTEM_SCHEMA_VERSION, FlightRecorder
from .metrics import (COUNTER, DEFAULT_TIME_BUCKETS, GAUGE, HISTOGRAM,
                      REGISTRY, MetricsRegistry, exp_buckets)
from .trace import NULL_SPAN, TRACER, SpanRecord, Tracer

__all__ = [
    "COUNTER", "GAUGE", "HISTOGRAM", "DEFAULT_TIME_BUCKETS", "REGISTRY",
    "TRACER", "NULL_SPAN", "POSTMORTEM_SCHEMA_VERSION", "MetricsRegistry",
    "Tracer", "SpanRecord", "FlightRecorder", "Observability",
    "exp_buckets", "SPAN_SECONDS_TOTAL", "SPAN_SECONDS_HIST",
]

SPAN_SECONDS_TOTAL = "capsim_span_seconds_total"
SPAN_SECONDS_HIST = "capsim_span_seconds"


class _ObsSpan:
    """Times one span; writes the registry always, the tracer if on."""

    __slots__ = ("_obs", "_name", "_instance", "_args", "_start", "seconds")

    def __init__(self, obs: "Observability", name: str, instance: str,
                 args: Optional[Dict[str, object]]):
        self._obs = obs
        self._name = name
        self._instance = instance
        self._args = args
        self.seconds = 0.0

    def __enter__(self):
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur_ns = time.perf_counter_ns() - self._start
        self.seconds = dur_ns * 1e-9
        self._obs._record_span(self._name, self._instance, self._start,
                               dur_ns, self._args)
        return False


class Observability:
    """Bundle of tracer + metrics registry + optional flight recorder."""

    def __init__(self, *, metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 flight: Optional[FlightRecorder] = None):
        self.metrics = REGISTRY if metrics is None else metrics
        self.tracer = TRACER if tracer is None else tracer
        self.flight = flight
        self._span_total = self.metrics.counter(
            SPAN_SECONDS_TOTAL, "Cumulative seconds per span.",
            ("span", "instance"))
        self._span_hist = self.metrics.histogram(
            SPAN_SECONDS_HIST, "Span latency distribution.",
            ("span", "instance"))
        self._handles: Dict[Tuple[str, str], tuple] = {}

    @classmethod
    def from_config(cls, config=None) -> "Observability":
        """Build from an ``ObservabilityConfig`` (or None -> defaults)."""
        if config is None:
            return cls()
        tracer = (Tracer(ring_size=config.trace_ring, enabled=True)
                  if config.trace else None)
        flight = (FlightRecorder(config.flight_dir,
                                 max_spans=config.flight_spans,
                                 max_events=config.flight_events)
                  if config.flight_dir is not None else None)
        return cls(tracer=tracer, flight=flight)

    # -- span primitive -----------------------------------------------------
    def span(self, name: str, instance: str = "",
             args: Optional[Dict[str, object]] = None) -> _ObsSpan:
        return _ObsSpan(self, name, instance, args)

    def _record_span(self, name: str, instance: str, start_ns: int,
                     dur_ns: int, args: Optional[Dict[str, object]]) -> None:
        key = (name, instance)
        handles = self._handles.get(key)
        if handles is None:
            handles = (self._span_total.labels(span=name, instance=instance),
                       self._span_hist.labels(span=name, instance=instance))
            self._handles[key] = handles
        secs = dur_ns * 1e-9
        handles[0].inc(secs)
        handles[1].observe(secs)
        if self.tracer.enabled:
            targs = dict(args) if args else {}
            if instance:
                targs["instance"] = instance
            self.tracer.record(name, start_ns, dur_ns, args=targs or None)

    # -- events -------------------------------------------------------------
    def event(self, kind: str, **data: object) -> None:
        """Record a structured event to flight ring + trace (if on)."""
        if self.flight is not None:
            self.flight.record(kind, **data)
        if self.tracer.enabled:
            self.tracer.instant(kind, args=dict(data) or None)

    def postmortem(self, reason: str,
                   state: Optional[dict] = None) -> Optional[str]:
        """Dump a postmortem if a flight recorder is configured."""
        if self.flight is None:
            return None
        return self.flight.postmortem(reason, state=state,
                                      tracer=(self.tracer
                                              if self.tracer.enabled
                                              else None),
                                      metrics=self.metrics)
