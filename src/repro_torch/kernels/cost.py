"""The work of kernel calls: counted from shapes, on the card and on meta.

On the card, each launch of a wrapper adds its FLOPs and HBM bytes
(the ops module's ``*_cost``) to the registry (``launched``):
``capsim_kernel_flops_total{kernel, dtype, bound}`` and
``capsim_kernel_bytes_total{kernel, dtype, bound}``, where ``bound`` is
the side of ``launch/roofline.py``'s ridge (the dtype's peak FLOP/s over
``HBM_BW``) the launch falls on: ``ops`` or ``bytes``.  A reader then
has the launches' least time exactly, as the ``ops`` FLOPs at the peak
plus the ``bytes`` bytes at the memory's rate.  The launches themselves
are counted on the wrapper (``build.count_launch``); an SSD call's four
kernels count as one.

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
from typing import Dict, Tuple

import torch

from repro_torch.launch import roofline
from repro_torch.obs import REGISTRY
from repro_torch.obs.metrics import CounterGroup

FLOPS_TOTAL = "capsim_kernel_flops_total"
BYTES_TOTAL = "capsim_kernel_bytes_total"
PEAK_FLOPS = {torch.bfloat16: roofline.PEAK_FLOPS_BF16,
              torch.float32: roofline.PEAK_FLOPS_F32}


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


def bound(flops: float, nbytes: float, dtype: torch.dtype) -> str:
    """``ops`` where a launch's FLOPs at the dtype's peak take at least
    as long as its bytes at ``HBM_BW``, else ``bytes``."""
    return ("ops" if flops * roofline.HBM_BW >= nbytes * PEAK_FLOPS[dtype]
            else "bytes")


_GROUPS: Dict[Tuple[str, torch.dtype, str], CounterGroup] = {}


def launched(name: str, dtype: torch.dtype, flops: float,
             nbytes: float) -> None:
    """A launch of kernel ``name`` on the card: its FLOPs and its bytes
    added to the registry's ``capsim_kernel_*`` cells of its dtype and
    bound, under one acquire of the registry's lock."""
    side = bound(flops, nbytes, dtype)
    group = _GROUPS.get((name, dtype, side))
    if group is None:
        dt = str(dtype).removeprefix("torch.")
        group = CounterGroup(
            REGISTRY.counter(FLOPS_TOTAL, "FLOPs of the launches, by the "
                             "side of the roofline's ridge they fall on.",
                             ("kernel", "dtype", "bound")).labels(
                kernel=name, dtype=dt, bound=side),
            REGISTRY.counter(BYTES_TOTAL, "HBM bytes of the launches, by "
                             "the side of the roofline's ridge they fall "
                             "on.", ("kernel", "dtype", "bound")).labels(
                kernel=name, dtype=dt, bound=side))
        group = _GROUPS.setdefault((name, dtype, side), group)
    group.inc(flops, nbytes)
