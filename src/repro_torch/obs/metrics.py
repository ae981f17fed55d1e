"""Thread-safe metrics registry: counters, gauges, log-scale histograms.

One process-global :data:`REGISTRY` backs every entry point (engine,
serving, benchmarks, launch) so a single ``/metrics`` scrape sees the
whole picture; tests construct private :class:`MetricsRegistry`
instances for isolation.  The design is Prometheus-flavored:

* a metric *family* has a name, a kind (counter / gauge / histogram), a
  help string, and a fixed tuple of label names;
* ``family.labels(**labels)`` resolves one labeled *cell* and returns a
  bound handle (``inc`` / ``set`` / ``observe``) that owning objects
  cache on their hot paths — after the first resolve, a write is one
  lock acquire and one float add;
* components that may coexist (several predictors, rebuilt service
  backends, abandoned watchdog flush threads) isolate their series via
  :meth:`MetricsRegistry.next_instance` labels, which is what lets the
  Stats view classes stay exact under concurrency.

Everything here is stdlib-only and safe to import from any layer.
"""
from __future__ import annotations

import bisect
import itertools
import math
import threading
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


def exp_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """Log-scale histogram bucket upper bounds (``+Inf`` is implicit)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("exp_buckets needs start>0, factor>1, count>=1")
    out, v = [], float(start)
    for _ in range(count):
        out.append(v)
        v *= factor
    return tuple(out)


# 10 us .. ~84 s in factor-2 steps: spans a single tokenize interval up
# to a full-scale device predict.
DEFAULT_TIME_BUCKETS = exp_buckets(1e-5, 2.0, 24)


def _fmt(v: float) -> str:
    """Prometheus text-format number: integral floats render as ints."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:  # NaN
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _escape_help(v: str) -> str:
    # HELP text escapes only backslash and newline (format 0.0.4).
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class _HistCell:
    __slots__ = ("counts", "sum", "n")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # last slot = +Inf overflow
        self.sum = 0.0
        self.n = 0


class CounterHandle:
    __slots__ = ("_lock", "_cell")

    def __init__(self, lock: threading.Lock, cell: List[float]):
        self._lock = lock
        self._cell = cell

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._cell[0] += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._cell[0]


class GaugeHandle:
    __slots__ = ("_lock", "_cell")

    def __init__(self, lock: threading.Lock, cell: List[float]):
        self._lock = lock
        self._cell = cell

    def set(self, v: float) -> None:
        with self._lock:
            self._cell[0] = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._cell[0] += v

    def dec(self, v: float = 1.0) -> None:
        with self._lock:
            self._cell[0] -= v

    @property
    def value(self) -> float:
        with self._lock:
            return self._cell[0]


class HistogramHandle:
    __slots__ = ("_lock", "_cell", "_bounds")

    def __init__(self, lock: threading.Lock, cell: _HistCell,
                 bounds: Tuple[float, ...]):
        self._lock = lock
        self._cell = cell
        self._bounds = bounds

    def observe(self, v: float) -> None:
        idx = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._cell.counts[idx] += 1
            self._cell.sum += v
            self._cell.n += 1


class CounterGroup:
    """Counter cells of one registry that are always written together:
    ``inc`` adds to each under one acquire of the registry's lock."""

    __slots__ = ("_lock", "_cells")

    def __init__(self, *handles: CounterHandle):
        if any(h._lock is not handles[0]._lock for h in handles):
            raise ValueError("a counter group's cells share one registry")
        self._lock = handles[0]._lock
        self._cells = tuple(h._cell for h in handles)

    def inc(self, *values: float) -> None:
        """Add ``values[i]`` to the i-th cell (none may be negative)."""
        if min(values) < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            for cell, v in zip(self._cells, values):
                cell[0] += v


class Family:
    """One named metric family; cells are resolved by label values."""

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help: str, labelnames: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self.buckets = buckets
        self._lock = registry._lock
        self._cells: Dict[Tuple[str, ...], object] = {}
        self._handles: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Mapping[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def labels(self, **labels: object):
        key = self._key(labels)
        with self._lock:
            handle = self._handles.get(key)
            if handle is None:
                if self.kind == HISTOGRAM:
                    cell = _HistCell(len(self.buckets))
                    handle = HistogramHandle(self._lock, cell, self.buckets)
                else:
                    cell = [0.0]
                    cls = (CounterHandle if self.kind == COUNTER
                           else GaugeHandle)
                    handle = cls(self._lock, cell)
                self._cells[key] = cell
                self._handles[key] = handle
            return handle


class MetricsRegistry:
    """Thread-safe registry of metric families with text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}
        self._instance_seq = itertools.count()
        self._before_read: List[Callable[[], None]] = []

    # -- family registration ------------------------------------------------
    def _family(self, name: str, kind: str, help: str,
                labelnames: Sequence[str],
                buckets: Optional[Sequence[float]] = None) -> Family:
        labelnames = tuple(labelnames)
        bt = tuple(buckets) if buckets is not None else None
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"kind/labelnames")
                return fam
            fam = Family(self, name, kind, help, labelnames, bt)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Family:
        return self._family(name, COUNTER, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Family:
        return self._family(name, GAUGE, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS) -> Family:
        return self._family(name, HISTOGRAM, help, labelnames, buckets)

    def next_instance(self, prefix: str) -> str:
        """A process-unique instance label, e.g. ``predictor3``."""
        return f"{prefix}{next(self._instance_seq)}"

    def before_read(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` at the start of every read (``value``, ``collect``,
        ``snapshot``, ``render_prometheus``), outside the lock: a writer
        that keeps its adds on a device folds them in there."""
        with self._lock:
            if fn not in self._before_read:
                self._before_read.append(fn)

    def _settle(self) -> None:
        for fn in list(self._before_read):
            fn()

    # -- reads --------------------------------------------------------------
    def value(self, name: str, **labels: object) -> float:
        """Current value of one cell; 0.0 if the cell never existed.

        Counters/gauges return their value; histograms their ``sum``.
        """
        self._settle()
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return 0.0
            key = tuple(str(labels.get(k, "")) for k in fam.labelnames)
            cell = fam._cells.get(key)
            if cell is None:
                return 0.0
            return cell.sum if fam.kind == HISTOGRAM else cell[0]

    def collect(self, name: str, **match: object
                ) -> List[Tuple[Dict[str, str], object]]:
        """All cells of a family whose labels match ``match`` (subset).

        Returns ``[(labels_dict, value), ...]``; histogram values are
        ``(sum, count)`` tuples.
        """
        out: List[Tuple[Dict[str, str], object]] = []
        smatch = {k: str(v) for k, v in match.items()}
        self._settle()
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return out
            for key, cell in fam._cells.items():
                labels = dict(zip(fam.labelnames, key))
                if any(labels.get(k) != v for k, v in smatch.items()):
                    continue
                if fam.kind == HISTOGRAM:
                    out.append((labels, (cell.sum, cell.n)))
                else:
                    out.append((labels, cell[0]))
        return out

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able dump of every family (for bench artifacts)."""
        snap: Dict[str, dict] = {}
        self._settle()
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                values = []
                for key in sorted(fam._cells):
                    cell = fam._cells[key]
                    labels = dict(zip(fam.labelnames, key))
                    if fam.kind == HISTOGRAM:
                        cum, buckets = 0, []
                        for le, c in zip(fam.buckets, cell.counts):
                            cum += c
                            buckets.append([le, cum])
                        buckets.append(["+Inf", cum + cell.counts[-1]])
                        values.append({"labels": labels, "sum": cell.sum,
                                       "count": cell.n, "buckets": buckets})
                    else:
                        values.append({"labels": labels, "value": cell[0]})
                snap[name] = {"kind": fam.kind, "help": fam.help,
                              "values": values}
        return snap

    # -- exposition ---------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        self._settle()
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                lines.append(f"# HELP {name} {_escape_help(fam.help)}")
                lines.append(f"# TYPE {name} {fam.kind}")
                for key in sorted(fam._cells):
                    cell = fam._cells[key]
                    base = ",".join(
                        f'{k}="{_escape(v)}"'
                        for k, v in zip(fam.labelnames, key))
                    if fam.kind == HISTOGRAM:
                        cum = 0
                        for le, c in zip(fam.buckets, cell.counts):
                            cum += c
                            sep = "," if base else ""
                            lines.append(
                                f'{name}_bucket{{{base}{sep}le='
                                f'"{_fmt(le)}"}} {cum}')
                        cum += cell.counts[-1]
                        sep = "," if base else ""
                        lines.append(
                            f'{name}_bucket{{{base}{sep}le="+Inf"}} {cum}')
                        suffix = f"{{{base}}}" if base else ""
                        lines.append(f"{name}_sum{suffix} {_fmt(cell.sum)}")
                        lines.append(f"{name}_count{suffix} {cell.n}")
                    else:
                        suffix = f"{{{base}}}" if base else ""
                        lines.append(f"{name}{suffix} {_fmt(cell[0])}")
        return "\n".join(lines) + "\n"


#: Process-global default registry; ``/metrics`` serves this one.
REGISTRY = MetricsRegistry()
