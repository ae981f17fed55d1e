"""End-to-end CAPSim simulation (paper Fig 1, right-hand path), port of
``repro/core/simulate.py``: ``capsim_simulate`` and
``capsim_simulate_multicore``.

Run the functional simulator, slice the trace into fixed-length clips,
snapshot contexts at clip starts, tokenize, predict every clip's runtime
in device batches, and sum.  ``capsim_simulate`` is the single-benchmark
wrapper over ``repro_torch.core.engine.SimulationEngine``, and
``capsim_simulate_multicore`` the one-benchmark wrapper over its
``run_multicore``; use the engine directly when simulating more than one
benchmark.  With ``config.sampling`` both return the engine's sampled
result: a stratified estimate with its 95% bootstrap CI and each clip's
provenance (``SimResult.prediction_report``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import standardize as std_mod
from repro_torch.core.engine import (MulticoreSimResult, SimResult,
                                     SimulationEngine)
from repro_torch.core.engine_config import EngineConfig
from repro_torch.device import DeviceLike
from repro_torch.isa import multicore as mc_mod
from repro_torch.isa import progen, timing

__all__ = ["EngineConfig", "MulticoreSimResult", "SimResult",
           "capsim_simulate", "capsim_simulate_multicore"]


def capsim_simulate(bench: progen.Benchmark, params, cfg,
                    vocab: std_mod.Vocab,
                    config: Optional[EngineConfig] = None, *,
                    timing_params: Optional[timing.TimingParams] = None,
                    device: DeviceLike = "cuda") -> SimResult:
    """One benchmark through ``SimulationEngine.from_config``."""
    engine = SimulationEngine.from_config(params, cfg, vocab, config,
                                          timing_params=timing_params,
                                          device=device)
    return engine.simulate(bench)


def capsim_simulate_multicore(mbench: mc_mod.MulticoreBenchmark, params,
                              cfg, vocab: std_mod.Vocab,
                              config: Optional[EngineConfig] = None, *,
                              timing_params:
                              Optional[timing.TimingParams] = None,
                              device: DeviceLike = "cuda"
                              ) -> MulticoreSimResult:
    """One multicore benchmark through ``SimulationEngine.run_multicore``:
    N interleaved per-core functional sims feeding one pooled predictor
    (shared RT cache, core-id context channel), demuxed per core and
    summed per benchmark.  The scheduler quantum travels as
    ``config.quantum`` (None = scheduler default)."""
    engine = SimulationEngine.from_config(params, cfg, vocab, config,
                                          timing_params=timing_params,
                                          device=device)
    return engine.run_multicore([mbench])[0]
