"""First-class fault injection for the serving stack (chaos layer; port
of ``repro/serving/faults.py``).

Production claims about graceful degradation are untestable unless the
faults that trigger them are *injectable on the real code paths*: a mock
engine exercises the mock, not the watchdog.  ``FaultInjector`` is the
one chaos surface the whole stack consults —

  ``BatchedPredictor._dispatch``   ``device_error`` (raises
                                   ``FaultInjected``) and ``slow_flush``
                                   (stalls the dispatch long enough to
                                   trip the service watchdog),
  ``BatchedPredictor._retire``     ``nan_output`` (the batch's retired
                                   predictions come back non-finite, the
                                   exact signature of a bad kernel or a
                                   corrupted table row),
  ``RTCache._load_store``          ``corrupt_rt_read`` (a key-matching
                                   store read yields corrupt data; the
                                   cache must warn + cold-encode),
  ``RTCache.persist``              ``crash_persist`` (the process "dies"
                                   after writing array files but BEFORE
                                   the atomic publish; the previous
                                   store generation must stay loadable).

The spec travels in ``EngineConfig.faults`` (``(kind, rate)`` pairs,
kinds in ``engine_config.FAULT_KINDS``) + ``fault_seed``, so one JSON
config drives a chaos run end to end, and every engine entry point
builds its injector with ``FaultInjector.from_config``.  Draws are
deterministic in (seed, call order); rates can be flipped at runtime
(``set_enabled`` / ``set_rates``) so a bench can run a healthy phase, a
fault phase, and a recovery phase against one live service.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.core.engine_config import FAULT_KINDS, EngineConfig
from repro_torch.obs.metrics import REGISTRY

FaultSpec = Union[Mapping[str, float], Iterable[Tuple[str, float]]]

# fleet-wide fault ledger: every fired injection also lands in the
# process metrics registry so /metrics shows chaos activity live
FAULTS_INJECTED_TOTAL = "capsim_faults_injected_total"


class FaultInjected(RuntimeError):
    """An injected fault fired.  ``kind`` names which one."""

    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        super().__init__(f"injected fault: {kind}"
                         + (f" ({detail})" if detail else ""))


class FaultInjector:
    """Deterministic, rate-based fault source.

    ``maybe(kind)`` returns True when the fault fires this draw;
    ``maybe_raise(kind)`` raises ``FaultInjected`` instead.  Draws come
    from one ``np.random.Generator`` seeded at construction, so a given
    (seed, call sequence) replays bit for bit — chaos tests are as
    reproducible as the bitwise-equality ones.  Thread-safe: the serving
    worker, the watchdogged flush thread, and the RT-cache loader may
    all consult one injector concurrently.
    """

    def __init__(self, faults: FaultSpec = (), seed: int = 0, *,
                 slow_seconds: float = 0.25):
        rates = dict(faults.items() if isinstance(faults, Mapping)
                     else faults)
        unknown = set(rates) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds {sorted(unknown)} "
                             f"(known: {list(FAULT_KINDS)})")
        self._rates: Dict[str, float] = {k: float(rates.get(k, 0.0))
                                         for k in FAULT_KINDS}
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._enabled = True
        self.slow_seconds = slow_seconds
        # per-kind fire counters: the bench/service stats report exactly
        # how many of each fault the run actually saw
        self.fired: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        fam = REGISTRY.counter(
            FAULTS_INJECTED_TOTAL,
            "Injected chaos faults that actually fired, by kind.",
            ("kind",))
        self._metric = {k: fam.labels(kind=k) for k in FAULT_KINDS}

    @classmethod
    def from_config(cls, config: EngineConfig, *,
                    slow_seconds: float = 0.25
                    ) -> Optional["FaultInjector"]:
        """Build the injector an engine should honor — None when the
        config injects nothing, so the healthy path stays hook-free."""
        if not config.faults:
            return None
        return cls(config.faults, config.fault_seed,
                   slow_seconds=slow_seconds)

    # ------------------------------ control ------------------------------ #

    def set_enabled(self, enabled: bool) -> bool:
        """Master switch: a disabled injector never fires (the bench's
        healthy / faulted / recovery phases toggle this).  Returns the
        previous setting so callers can restore it."""
        with self._lock:
            prev = self._enabled
            self._enabled = enabled
            return prev

    def set_rates(self, faults: FaultSpec) -> None:
        with self._lock:
            for k, r in (faults.items() if isinstance(faults, Mapping)
                         else faults):
                if k not in self._rates:
                    raise ValueError(f"unknown fault kind {k!r}")
                self._rates[k] = float(r)

    def rate(self, kind: str) -> float:
        return self._rates[kind]

    # ------------------------------ draws ------------------------------ #

    def maybe(self, kind: str) -> bool:
        """One deterministic draw against ``kind``'s rate."""
        with self._lock:
            rate = self._rates[kind] if self._enabled else 0.0
            if rate <= 0.0:
                return False
            fired = bool(self._rng.random() < rate)
            if fired:
                self.fired[kind] += 1
                self._metric[kind].inc()
            return fired

    def maybe_raise(self, kind: str, detail: str = "") -> None:
        if self.maybe(kind):
            raise FaultInjected(kind, detail)

    # --------------------------- stack hooks --------------------------- #

    def on_dispatch(self) -> None:
        """Consulted by ``BatchedPredictor._dispatch`` before every
        device batch: may stall (slow_flush) and/or raise
        (device_error)."""
        if self.maybe("slow_flush"):
            time.sleep(self.slow_seconds)
        self.maybe_raise("device_error", "predict dispatch failed")

    def corrupt_output(self, out: np.ndarray) -> np.ndarray:
        """Consulted by ``BatchedPredictor._retire``: on a nan_output
        draw the retired batch comes back non-finite — the service-level
        NaN guard must catch it before any result reaches a caller."""
        if out.size and self.maybe("nan_output"):
            out = np.array(out, copy=True)
            out[0] = np.nan
        return out

    def crash_hook(self):
        """``pre_publish`` hook for ``ckpt.save``: fires crash_persist
        right before the atomic rename, the worst-case crash point."""
        def _hook():
            self.maybe_raise(
                "crash_persist",
                "simulated process death before atomic publish")
        return _hook

    def stats(self) -> Dict[str, int]:
        return {k: v for k, v in self.fired.items() if v}
