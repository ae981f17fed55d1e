"""The traced run's device trace, reduced to what the readers need.

``Profile`` wraps ``torch.profiler`` over the measured window and, at its
end, reduces the raw Kineto events (read without building the profiler's
Python event tree) to a ``Trace``: every device operation's name, start,
end and correlation id, each kernel launch's host time by correlation
id, and the host ranges (``record_function``) by name.  Busy time is the
union of the device operations' intervals.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, int, int, int]]      # (name, start, end, corr) ns
    launches: Dict[int, int]                  # corr -> host launch ns
    ranges: Dict[str, List[Tuple[int, int]]]  # host range name -> spans
    window_s: float                           # the traced window

    def busy_s(self) -> float:
        """Seconds in which any operation ran on the device."""
        total, cur_s, cur_e = 0, None, None
        for _, s, e, _ in sorted(self.ops, key=lambda o: o[1]):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-9

    def kernels_in_range(self, name: str) -> List[Tuple[str, int, int, int]]:
        """Device operations launched by the host inside a range of that
        name (whichever thread launched them)."""
        spans = sorted(self.ranges.get(name, []))
        if not spans:
            return []
        starts = [s for s, _ in spans]
        out = []
        for op in self.ops:
            t = self.launches.get(op[3])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(op)
        return out

    def gaps(self) -> List[Tuple[int, int, str]]:
        """Idle intervals between device operations: (start, end, name of
        the operation that ended the gap)."""
        out, cur_e = [], None
        for name, s, e, _ in sorted(self.ops, key=lambda o: o[1]):
            if cur_e is not None and s > cur_e:
                out.append((cur_e, s, name))
            cur_e = e if cur_e is None else max(cur_e, e)
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time by
        what came next and by the host range it fell in."""
        by_op: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.ops:
            by_op[name[:120]] += (e - s) * 1e-9
        by_gap: Dict[str, float] = defaultdict(float)
        spans = sorted((s, e, n) for n, v in self.ranges.items()
                       for s, e in v)
        starts = [a for a, _, _ in spans]
        for s, e, nxt in self.gaps():
            i = bisect.bisect_right(starts, s) - 1
            host = spans[i][2] if i >= 0 and s < spans[i][1] else "no range"
            by_gap[f"{host}; then {nxt[:80]}"] += (e - s) * 1e-9
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v] for n, v in top],
                "idle_gaps": [[n, v] for n, v in gaps]}


def reduce_events(events, window_s: float) -> Trace:
    """Kineto's events as a ``Trace``.  Device events are the operations,
    less the device copies of the host's ranges; a host event named for
    a CUDA runtime or driver call (``cuda*``, ``cu*``) is a launch, keyed
    by the correlation id its device operation carries; a host user
    annotation is a range."""
    ops, launches, ranges = [], {}, defaultdict(list)
    for e in events:
        s = e.start_ns()
        on_device = str(e.device_type()).endswith("CUDA")
        if e.is_user_annotation():
            if not on_device:
                ranges[e.name()].append((s, s + e.duration_ns()))
        elif on_device:
            ops.append((e.name(), s, s + e.duration_ns(), e.correlation_id()))
        elif e.name().startswith("cu"):
            launches[e.correlation_id()] = s
    return Trace(ops, launches, dict(ranges), window_s)


class Profile:
    """``with Profile(on, host_ranges) as p: ...`` traces the block when
    ``on``; ``p.trace`` is the reduced trace afterwards (None when off).
    ``host_ranges`` records the host's operations too, which the
    ``record_function`` ranges need; without it only the device and the
    launches are traced."""

    def __init__(self, on: bool, host_ranges: bool):
        self.on = on
        self.host_ranges = host_ranges
        self.trace: Optional[Trace] = None
        self._prof = None

    def __enter__(self):
        if self.on:
            import time

            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CUDA]
            if self.host_ranges:
                acts.append(ProfilerActivity.CPU)
            self._prof = profile(activities=acts)
            torch.cuda.synchronize()
            self._prof.__enter__()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            import time

            import torch
            torch.cuda.synchronize()
            window = time.perf_counter() - self._t0
            self._prof.__exit__(*exc)
            self.trace = reduce_events(
                self._prof.profiler.kineto_results.events(), window)
            self._prof = None
        return False
