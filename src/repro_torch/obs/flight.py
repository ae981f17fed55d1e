"""Degradation flight recorder: bounded event ring + postmortem dumps.

The recorder keeps the last N structured events (tier transitions,
watchdog trips, fault injections, admission sheds) in memory at
near-zero cost.  When something goes wrong — the degradation controller
demotes a tier, the watchdog abandons a flush, a fault fires on a
persist — :meth:`FlightRecorder.postmortem` freezes the event ring, the
tail of the span trace, a metrics snapshot, and the caller's state dict
into one JSON file, written atomically (tmp + rename) so a crash
mid-dump never leaves a torn postmortem.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional

POSTMORTEM_SCHEMA_VERSION = 1

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


class FlightRecorder:
    """Records recent events; dumps postmortems on degradation."""

    def __init__(self, out_dir: Optional[str] = None, *,
                 max_spans: int = 256, max_events: int = 512):
        self.out_dir = out_dir
        self.max_spans = int(max_spans)
        self._events: deque = deque(maxlen=int(max_events))
        self._lock = threading.Lock()
        self._seq = 0
        self.postmortems: List[str] = []
        self.last: Optional[dict] = None

    def record(self, kind: str, **data: object) -> None:
        """Append one structured event to the ring."""
        ev = {"wall_time": time.time(), "kind": kind}
        ev.update(data)
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def postmortem(self, reason: str, *, state: Optional[dict] = None,
                   tracer=None, metrics=None) -> Optional[str]:
        """Freeze events + span tail + metrics + state; write JSON.

        Returns the file path (None when no ``out_dir`` is configured;
        the dict is still kept on :attr:`last` either way).
        """
        with self._lock:
            self._seq += 1
            seq = self._seq
            events = list(self._events)
        spans = []
        if tracer is not None:
            for rec in tracer.spans()[-self.max_spans:]:
                spans.append({
                    "name": rec.name, "cat": rec.cat,
                    "start_ns": rec.start_ns, "dur_ns": rec.dur_ns,
                    "tid": rec.tid, "depth": rec.depth,
                    "args": rec.args})
        post: Dict[str, object] = {
            "schema_version": POSTMORTEM_SCHEMA_VERSION,
            "reason": reason,
            "wall_time": time.time(),
            "seq": seq,
            "state": state,
            "events": events,
            "spans": spans,
            "metrics": metrics.snapshot() if metrics is not None else None,
        }
        self.last = post
        if self.out_dir is None:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        slug = _SAFE.sub("_", reason)[:64] or "unknown"
        path = os.path.join(self.out_dir,
                            f"postmortem_{seq:04d}_{slug}.json")
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(post, f, indent=1)
        os.replace(tmp, path)
        self.postmortems.append(path)
        return path
