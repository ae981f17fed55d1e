"""Multi-rank programs for the port's distributed tests: n processes on
the CPU, one a rank, joined by a gloo process group that meets at a
``file://`` store in the run's directory (no port, so parallel test
workers never collide).  Each program reads ``RANK``, ``WORLD_SIZE``,
``INIT`` (the store) and ``OUT`` (the directory) from its environment,
and writes what the test compares as npz files there; ``init()`` is the
prologue it runs first.  Also the npz bridge for parameter trees."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

SRC = str(Path(__file__).resolve().parent.parent / "src")

PROLOGUE = r"""
import os
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
OUT = os.environ["OUT"]
if WORLD > 1:
    dist.init_process_group("gloo", init_method=os.environ["INIT"],
                            rank=RANK, world_size=WORLD)


def load_tree(npz, prefix):
    tree = {}
    for key in npz.files:
        if key.startswith(prefix + "/"):
            node, parts = tree, key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = npz[key]
    return tree
"""


def spawn(program: str, n: int, out: Path, tag: str = "ranks"):
    """Start ``program`` (after ``PROLOGUE``) on ``n`` ranks; returns the
    processes, each with its log file under ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(rank), INIT=f"file://{out}/{tag}.store",
                   OUT=str(out), PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        log = open(out / f"{tag}.rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", PROLOGUE + program], env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def wait(procs, timeout: float = 300) -> None:
    """Wait for every process; a failure raises with the failed rank's
    log."""
    bad = []
    for i, (p, log) in enumerate(procs):
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = "timeout"
        log.close()
        if rc != 0:
            bad.append((i, rc, Path(log.name).read_text()[-4000:]))
    for _, (p, _log) in enumerate(procs):
        if p.poll() is None:
            p.kill()
    assert not bad, "\n".join(f"rank {i} rc {rc}:\n{text}"
                              for i, rc, text in bad)


def flat(tree, prefix: str) -> dict:
    """A tree of arrays as npz keys ``prefix/a/b``."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree, dtype=np.float32)
            if np.asarray(tree).dtype.kind == "f" else np.asarray(tree)}
