"""The work of kernel calls that did not launch: the meta route.

A kernel wrapper given ``meta`` tensors (shapes without storage, as the
dry-run runs a step, ``launch/dryrun.py``) computes nothing: it returns
an empty output of the shape the kernel writes and reports the FLOPs and
HBM bytes its launch would take (each ops module's ``*_cost``: the
formulas of ``chip_smoke.py``'s bounds) to every open ``KernelCosts``,
whichever thread calls it (the autograd engine may run a backward's
recompute on its own).  A meta tensor holds no data, so the route hides
neither a device nor a kernel: a number it reports is a count from
shapes, never a time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict


@dataclasses.dataclass
class KernelCosts:
    """FLOPs, HBM bytes and calls a kernel's meta route reported, by
    kernel name."""
    flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops[name] = self.flops.get(name, 0.0) + flops
        self.bytes[name] = self.bytes.get(name, 0.0) + nbytes
        self.calls[name] = self.calls.get(name, 0) + 1

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())


_OPEN: list = []
_LOCK = threading.Lock()


@contextlib.contextmanager
def count_kernels():
    """A ``KernelCosts`` that every meta-route call adds to while the
    context is open."""
    costs = KernelCosts()
    with _LOCK:
        _OPEN.append(costs)
    try:
        yield costs
    finally:
        with _LOCK:
            _OPEN.remove(costs)


def report(name: str, flops: float, nbytes: float) -> None:
    """A meta-route call of kernel ``name``: add its work to every open
    ``KernelCosts``."""
    with _LOCK:
        for costs in _OPEN:
            costs.add(name, flops, nbytes)
