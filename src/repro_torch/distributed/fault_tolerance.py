"""Fault tolerance for long training runs: crash-restart and straggler
detection (port of ``repro/distributed/fault_tolerance.py``).

  - ``ResilientTrainer`` wraps any (state, batch) -> (state, metrics)
    step with periodic async checkpointing (``checkpoint/ckpt.py``),
    drain on preemption (SIGTERM or SIGINT saves a final checkpoint
    before the loop ends) and restore on restart: a replacement process
    resumes from the newest complete checkpoint.
  - ``StragglerMonitor`` tracks per-host step wall times; a host whose
    EWMA exceeds ``threshold`` x the median is flagged, and ``rebalance``
    gives per-host data-shard weights inversely proportional to step
    time.
  - ``timed_step`` returns a step's wall seconds, the CUDA device
    synchronized at its end.
  - ``rescale_state`` implements elastic scaling: checkpoints are
    mesh-agnostic host arrays, so resuming on another device count
    places each leaf by its sharding on the new mesh: replicated leaves
    whole, sharded leaves cut to the rank's block.  The data-parallel
    trainer splits each global batch by ``shard_range``, so a run
    checkpointed at 2 ranks resumes at 1 or 4 with the same batches.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import (mark, split_dims,
                                              take_dims_block)
from repro_torch.training.optimizer import tree_leaves, tree_map


# --------------------------------------------------------------------------- #
# Crash-restart training loop
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class ResilientTrainer:
    step_fn: Callable                     # (state, batch) -> (state, metrics)
    ckpt: CheckpointManager
    save_every: int = 100
    log_every: int = 25
    log_fn: Callable[[int, Dict], None] = lambda step, m: None

    _preempted: bool = dataclasses.field(default=False, init=False)
    _prev_handlers: Dict = dataclasses.field(default_factory=dict,
                                             init=False, repr=False)

    # both schedulers' preemption signals: a cluster manager sends
    # SIGTERM, an operator (or a tty) SIGINT; either way the right move
    # is a drain checkpoint, not an unclean death
    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def install_signal_handler(self) -> None:
        """Install drain-on-preemption handlers for SIGTERM and SIGINT.

        The previous handlers are chained, not clobbered: a launcher that
        registered its own SIGTERM hook still runs it.
        ``uninstall_signal_handler`` restores the handlers from before the
        install; ``run`` does so on exit, so a trainer's handlers never
        outlive its loop."""
        if self._prev_handlers:
            return                                  # already installed
        for sig in self._SIGNALS:
            prev = signal.getsignal(sig)

            def _handler(signum, frame, _prev=prev):
                self._preempted = True
                # chain custom hooks only: SIG_DFL/SIG_IGN are not
                # callable, and the default SIGINT handler would raise
                # KeyboardInterrupt, the unclean death this replaces
                if callable(_prev) and _prev is not \
                        signal.default_int_handler:
                    _prev(signum, frame)
            self._prev_handlers[sig] = prev
            signal.signal(sig, _handler)

    def uninstall_signal_handler(self) -> None:
        """Restore the handlers from before the install (no-op if never
        installed)."""
        while self._prev_handlers:
            sig, prev = self._prev_handlers.popitem()
            signal.signal(sig, prev)

    def run(self, state, batch_iter, *, start_step: int = 0,
            total_steps: int = 1000, state_like=None,
            device: DeviceLike = None):
        """Resumes from the latest checkpoint if one exists, restored on
        ``device`` (by default the device of the state's step)."""
        like = state_like if state_like is not None else state
        if device is None:
            device = state["step"].device
        restored, ck_step = self.ckpt.restore_latest(like, device=device)
        if restored is not None:
            state, start_step = restored, ck_step
        step = start_step
        installed_here = not self._prev_handlers
        if installed_here:
            self.install_signal_handler()
        try:
            for batch in batch_iter:
                if step >= total_steps or self._preempted:
                    break
                state, metrics = self.step_fn(state, batch)
                step += 1
                if step % self.log_every == 0:
                    self.log_fn(step, tree_map(float, metrics))
                if step % self.save_every == 0:
                    self.ckpt.save(state, step)
            # drain: final checkpoint on preemption or completion
            self.ckpt.save(state, step)
            self.ckpt.wait()
        finally:
            if installed_here:
                self.uninstall_signal_handler()
        return state, step


# --------------------------------------------------------------------------- #
# Elastic rescale
# --------------------------------------------------------------------------- #

def rescale_state(host_state, new_shardings):
    """Place a host state tree (numpy arrays or CPU tensors, a
    checkpoint's) onto a differently sized mesh: each leaf cut by its
    ``sharding.NamedSharding``'s spec, fitted to its shape, to this
    rank's block (whole where the spec replicates), moved to the mesh's
    device and marked with the axes that split it.  Every sharding is
    logical (rules), not by device index, so this is all an elastic
    scale-up or -down needs."""
    def place(a, s):
        t = a if isinstance(a, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(a))
        dims = split_dims(t.shape, s.spec, s.mesh)
        return mark(take_dims_block(t, dims, s.mesh).to(s.mesh.device)
                    .clone(), dims)
    return tree_map(place, host_state, new_shardings)


# --------------------------------------------------------------------------- #
# Straggler detection / mitigation
# --------------------------------------------------------------------------- #

class StragglerMonitor:
    """EWMA step-time tracking per host; flags and re-balances outliers."""

    def __init__(self, n_hosts: int, alpha: float = 0.2,
                 threshold: float = 1.5):
        self.n_hosts = n_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.ewma = np.zeros(n_hosts)
        self._seen = np.zeros(n_hosts, bool)

    def record(self, host: int, seconds: float) -> None:
        if not self._seen[host]:
            self.ewma[host] = seconds
            self._seen[host] = True
        else:
            self.ewma[host] = (self.alpha * seconds +
                               (1 - self.alpha) * self.ewma[host])

    def stragglers(self) -> List[int]:
        if not self._seen.any():
            return []
        med = float(np.median(self.ewma[self._seen]))
        return [h for h in range(self.n_hosts)
                if self._seen[h] and self.ewma[h] > self.threshold * med]

    def rebalance(self) -> np.ndarray:
        """Per-host data-shard weights inversely proportional to step time
        (normalized to sum to n_hosts): a 2x-slow host gets ~0.5x the
        clips."""
        if not self._seen.all():
            return np.ones(self.n_hosts)
        inv = 1.0 / np.maximum(self.ewma, 1e-9)
        return inv * (self.n_hosts / inv.sum())


def timed_step(step_fn):
    """Wraps a step to also return its wall seconds; the device of every
    CUDA metric is synchronized before the clock stops."""
    def wrapped(state, batch):
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        for m in tree_leaves(metrics):
            if m.is_cuda:
                torch.cuda.synchronize(m.device)
        return state, metrics, time.time() - t0
    return wrapped
