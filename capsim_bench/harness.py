"""What every cell shares: the manifest, the device check, the result line.

A cell is found by its name alone.  ``BENCHMARK.json`` gives its
configuration, its traffic and which metrics it reports;
``workloads/<cell>.json`` gives the deployment and the limits of the
output check; ``configs/<config>.json`` the model's sizes;
``traffic/<traffic>.json`` the input mix and the ``kind`` of driver that
runs it (``drivers/<kind>.py``); ``metrics/<metric>.py`` one reader per
metric.  Adding a cell, a mix or a metric adds files and manifest
entries and edits none.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
REPO_ROOT = BENCH_DIR.parent

# top-level module names that may not be loaded in a run's process: the JAX
# package the port was made from, and JAX itself.  Compared whole, since the
# port's own name, ``repro_torch``, begins with ``repro``.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s workloads, with its files read."""
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, or, without the key, every cell that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def load_cell(name: str, manifest: Optional[Path] = None) -> Cell:
    """The cell ``name`` of the manifest, with its configuration, traffic
    and workload files; raises KeyError for a cell the manifest lacks."""
    bench = _read_json(manifest or REPO_ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=_read_json(REPO_ROOT / conf["file"]),
                traffic=_read_json(BENCH_DIR / "traffic"
                                   / f"{entry['traffic']}.json"),
                workload=_read_json(BENCH_DIR / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def load_module(path: Path):
    """A module from a file by path (metric readers and drivers have dots
    and dashes in their names)."""
    spec = importlib.util.spec_from_file_location(
        "capsim_bench_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return load_module(BENCH_DIR / "drivers" / f"{kind}.py")


def reader(metric: str) -> Callable:
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py").read


def read_metrics(metrics: List[dict], rec: dict, cell: Cell) -> dict:
    """Each metric's reader over the run's record; a reader that finds
    nothing returns None and the metric is left out of the line."""
    out = {}
    for m in metrics:
        v = reader(m["name"])(rec, cell)
        if v is None:
            print(f"metric {m['name']}: nothing to read", file=sys.stderr)
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN_MODULES})


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile of all values by the nearest-rank rule; an
    infinite value (a request that failed) counts as missing every
    limit."""
    if not values:
        return math.inf
    s = sorted(values)
    k = max(0, math.ceil(q / 100.0 * len(s)) - 1)
    return s[k]


def power_limit() -> Optional[str]:
    """The card's name and power limit by ``nvidia-smi``, where it runs."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def checks_text(checks: List[dict]) -> List[str]:
    return [f"check {c['name']}: {c['value']!r} limit {c['limit']!r}"
            for c in checks]


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in float32 products on or off for the block, restored after."""
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@dataclasses.dataclass
class RunContext:
    """What a driver is given: the cell, the run's arguments, the device,
    the input cache, and the process's start on the host clock."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    cache: Path
    t_start: float
    control: bool = False

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def device_info(self) -> dict:
        """The result line's ``device``: the cards used and the peak of the
        fullest (a CPU run, as the tests drive one, reports none)."""
        import torch
        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0}
        chips = self.cell.chips
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips))}


def cache_dir() -> Path:
    d = BENCH_DIR / ".cache"
    d.mkdir(exist_ok=True)
    return d


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict,
                device: dict, checks: List[dict],
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return json.dumps(out)
