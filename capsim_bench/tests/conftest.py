"""Shared fixtures: cells cut to a size the CPU runs in seconds."""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# the model at widths a CPU test can hold; every other size as the cell's
SMALL = dict(d_model=32, num_heads=2, head_dim=16, d_ff=64)
SMALL_TRAFFIC = {
    "service_closed_loop": dict(programs=["503.bwaves", "505.mcf"],
                                interval=2000, warmup=200, checkpoints=2,
                                clients=2, warmup_s=0.2, check_requests=3),
    "train_loop": dict(programs=["503.bwaves", "505.mcf", "500.perlbench"],
                       interval=2000, warmup=200, checkpoints=1, batch=8,
                       warm_steps=1),
}


@pytest.fixture(scope="session")
def input_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("capsim_bench_inputs")


@pytest.fixture
def small_run(input_cache):
    """run(cell name, **traffic overrides) -> (result fields, record) of a
    cell with a few small inputs, at the SMALL widths unless
    ``full_width``, on the CPU, driven like a run on the card."""
    import torch

    from capsim_bench import harness
    from capsim_bench.run import run_cell

    def run(name, seconds=1.0, control=False, full_width=False, **traffic):
        cell = harness.load_cell(name)
        if not full_width:
            cell.config.update(SMALL)
        cell.traffic.update(SMALL_TRAFFIC[cell.kind])
        if cell.config["n_cores"] > 1:
            cell.traffic["programs"] = ["mt.stream", "mt.chase"]
        cell.traffic.update(traffic)
        torch.manual_seed(0)
        ctx = harness.RunContext(cell=cell, seed=2**31 + 9, seconds=seconds,
                                 trace=False, device=torch.device("cpu"),
                                 cache=input_cache,
                                 t_start=time.perf_counter(), control=control)
        return run_cell(ctx)
    return run
