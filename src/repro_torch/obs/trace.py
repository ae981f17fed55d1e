"""Low-overhead span tracer with Chrome-trace-event / Perfetto export.

Spans are stamped on the clock ``torch.profiler``'s (Kineto's) events
use, nanoseconds since the Unix epoch (:func:`epoch_ns`), track nesting
depth via thread-local span stacks, and land in a bounded ring buffer
(``deque(maxlen=ring_size)``) so a long-running service never grows
without bound.  When the tracer is disabled, :meth:`Tracer.span`
returns the shared :data:`NULL_SPAN` singleton — no allocation, no
clock read — which is what keeps always-present instrumentation out of
the hot path's profile.

``export_chrome()`` emits the Chrome trace-event JSON format (complete
``"ph": "X"`` events, timestamps in microseconds since the epoch); open
the file at https://ui.perfetto.dev to get a zoomable per-thread
timeline, beside a ``torch.profiler`` export of the same process on one
time axis.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# The monotonic counter placed on the epoch by one offset read at import:
# a span's duration never moves with a step of the wall clock, and its
# start lies where Kineto, which stamps its events in Unix-epoch
# nanoseconds, puts the same instant (unless the wall clock has stepped
# since import).
_EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def epoch_ns() -> int:
    """Now, in nanoseconds since the Unix epoch, on a monotonic clock."""
    return time.perf_counter_ns() + _EPOCH_OFFSET_NS


class _NullSpan:
    """Shared no-op span for the disabled path (identity-stable)."""

    __slots__ = ()
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class SpanRecord:
    """One finished span (or instant event when ``dur_ns`` is None)."""

    __slots__ = ("name", "cat", "start_ns", "dur_ns", "tid", "depth", "args")

    def __init__(self, name: str, cat: str, start_ns: int,
                 dur_ns: Optional[int], tid: int, depth: int,
                 args: Optional[Dict[str, object]]):
        self.name = name
        self.cat = cat
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.depth = depth
        self.args = args


class _LiveSpan:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_start", "seconds")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, object]]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self.seconds = 0.0

    def __enter__(self):
        self._tracer._stack().append(self)
        self._start = epoch_ns()
        return self

    def __exit__(self, *exc):
        end = epoch_ns()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        dur = end - self._start
        self.seconds = dur * 1e-9
        self._tracer._append(SpanRecord(
            self._name, self._cat, self._start, dur,
            threading.get_ident(), len(stack), self._args))
        return False


class Tracer:
    """Span tracer writing into a bounded ring buffer."""

    def __init__(self, ring_size: int = 4096, enabled: bool = False):
        self.enabled = bool(enabled)
        self._ring: deque = deque(maxlen=int(ring_size))
        self._lock = threading.Lock()
        self._tls = threading.local()

    # -- internals ----------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _append(self, rec: SpanRecord) -> None:
        with self._lock:
            self._ring.append(rec)

    # -- recording ----------------------------------------------------------
    def span(self, name: str, cat: str = "span",
             args: Optional[Dict[str, object]] = None):
        """Context manager timing one span; NULL_SPAN when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _LiveSpan(self, name, cat, args)

    def record(self, name: str, start_ns: int, dur_ns: int,
               cat: str = "span",
               args: Optional[Dict[str, object]] = None) -> None:
        """Append an already-timed span (the Observability fast path)."""
        if not self.enabled:
            return
        self._append(SpanRecord(name, cat, start_ns, dur_ns,
                                threading.get_ident(),
                                len(self._stack()), args))

    def instant(self, name: str, cat: str = "event",
                args: Optional[Dict[str, object]] = None) -> None:
        """Record a zero-duration instant event (tier trips, faults)."""
        if not self.enabled:
            return
        self._append(SpanRecord(name, cat, epoch_ns(), None,
                                threading.get_ident(),
                                len(self._stack()), args))

    # -- control / export ---------------------------------------------------
    def set_enabled(self, enabled: bool) -> bool:
        prev, self.enabled = self.enabled, bool(enabled)
        return prev

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._ring)

    def export_chrome(self) -> dict:
        """Chrome trace-event JSON (open at ui.perfetto.dev)."""
        events = []
        for rec in self.spans():
            ev = {"name": rec.name, "cat": rec.cat,
                  "ts": rec.start_ns / 1e3,
                  "pid": 0, "tid": rec.tid}
            if rec.dur_ns is None:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = rec.dur_ns / 1e3
            args = dict(rec.args) if rec.args else {}
            args["depth"] = rec.depth
            ev["args"] = args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.export_chrome(), f)
        return path


#: Process-global default tracer (disabled until someone enables it).
TRACER = Tracer()
