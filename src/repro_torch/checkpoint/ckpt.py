"""Atomic checkpoints: save/restore with a manifest (port of
``repro/checkpoint/ckpt.py``: ``save``, ``latest_step``, ``read_manifest``,
``restore`` and the training loop's ``CheckpointManager``).

Layout (one directory per step), the reference's:

    <dir>/step_000120/
        manifest.json       tree keys, shapes, dtypes, step, metadata
        arr_00000.npy ...   one file per leaf
    <dir>/LATEST            text file holding the newest complete step

Writes are atomic: arrays land in a writer-unique ``step_N.tmp*``
directory which is renamed only after the manifest is fsync'd, so a
killed writer never leaves a half-checkpoint that restore would pick up;
``LATEST`` is published the same way (temp file + fsync +
``os.replace``).  Concurrent writers racing one step are safe: tmp names
embed pid + a serial, and the publish rename retries through the
delete/rename window, so the last writer wins with no corrupt final dir.
``pre_publish`` runs right before the final rename, the worst-case crash
point (the serving layer's fault injector hooks in there).

A tree is nested dicts whose leaves are tensors or numpy arrays; its
flat keys join the dict keys with "/", as the reference's pytree paths
do.  numpy has no bfloat16, so a bfloat16 tensor is saved as its raw
16-bit pattern (int16) with ``"bfloat16"`` in the manifest, and restores
bit for bit.  ``restore`` returns tensors on the device the caller names.

``CheckpointManager`` saves asynchronously, one save in flight at a
time, and keeps the newest K steps: the state is copied to the host
before the writer thread starts, so training may go on with the
device's tensors.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_STEP_DIR = re.compile(r"step_(\d+)$")

# writer-unique tmp suffix serial: two saves in one process (or two
# engine threads sharing an RT store dir) never collide on a tmp path
_TMP_SERIAL = itertools.count()


def _completed_steps(ckpt_dir: Path):
    """Step numbers of *published* checkpoint dirs only."""
    out = []
    for d in ckpt_dir.iterdir():
        m = _STEP_DIR.fullmatch(d.name)
        if m and d.is_dir():
            out.append(int(m.group(1)))
    return sorted(out)


def _write_latest(ckpt_dir: Path, step: int, host: int) -> None:
    """Atomic LATEST publish: a crash can truncate the temp file, never
    the pointer itself."""
    tmp = ckpt_dir / f"LATEST.tmp{host}-{os.getpid()}-{next(_TMP_SERIAL)}"
    with open(tmp, "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, ckpt_dir / "LATEST")


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {"a/b": leaf}."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key, value in tree.items():
        out.update(_flatten(value, f"{prefix}/{key}" if prefix else
                            str(key)))
    return out


def _to_numpy(leaf) -> tuple:
    """(array to write, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(state, step: int, ckpt_dir: str, *, host: int = 0,
         n_hosts: int = 1, metadata: Optional[dict] = None,
         pre_publish: Optional[Callable[[], None]] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / (f"step_{step:08d}.tmp{host}"
                      f"-{os.getpid()}-{next(_TMP_SERIAL)}")
    tmp.mkdir(parents=True, exist_ok=True)

    try:
        entries = {}
        for i, (key, leaf) in enumerate(sorted(_flatten(state).items())):
            arr, dtype = _to_numpy(leaf)
            fname = f"arr_{i:05d}.h{host}.npy"
            np.save(tmp / fname, arr)
            entries[key] = {"file": fname, "shape": list(arr.shape),
                            "dtype": dtype}
        manifest = {"step": step, "host": host, "n_hosts": n_hosts,
                    "entries": entries, "metadata": metadata or {}}
        mpath = tmp / f"manifest.h{host}.json"
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())

        if pre_publish is not None:
            pre_publish()       # worst-case crash point

        # publish: replace any previous generation of this step; two
        # writers racing the same step can interleave rmtree/rename, so
        # retry through the window (last writer wins)
        for attempt in range(5):
            if final.exists():
                shutil.rmtree(final, ignore_errors=True)
            try:
                tmp.rename(final)                        # atomic publish
                break
            except OSError:
                if attempt == 4:
                    raise
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _write_latest(ckpt_dir, step, host)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    step = int(p.read_text().strip())
    if not (Path(ckpt_dir) / f"step_{step:08d}").exists():
        # LATEST points at a missing dir: fall back to the published ones
        steps = _completed_steps(Path(ckpt_dir))
        return steps[-1] if steps else None
    return step


def read_manifest(step: int, ckpt_dir: str, *, host: int = 0) -> dict:
    """A step's manifest (entries + metadata), without the array files."""
    final = Path(ckpt_dir) / f"step_{step:08d}"
    return json.loads((final / f"manifest.h{host}.json").read_text())


def restore(state_like, step: int, ckpt_dir: str, *, host: int = 0,
            device: DeviceLike = "cuda"):
    """Rebuild the tree from disk as tensors on ``device``.  ``state_like``
    gives the tree's keys (its leaves' values are not read); each leaf
    must have the shape and dtype its manifest entry records."""
    dev = resolve_device(device)
    final = Path(ckpt_dir) / f"step_{step:08d}"
    entries = read_manifest(step, ckpt_dir, host=host)["entries"]
    keys = _flatten(state_like)
    if sorted(keys) != sorted(entries):
        raise ValueError(f"checkpoint tree mismatch: "
                         f"{set(keys) ^ set(entries)}")
    leaves = {}
    for key in keys:
        entry = entries[key]
        arr = np.load(final / entry["file"])
        bf16 = entry["dtype"] == "bfloat16"
        if (list(arr.shape) != entry["shape"]
                or str(arr.dtype) != ("int16" if bf16 else entry["dtype"])):
            raise ValueError(f"{key}: stored {arr.dtype}{list(arr.shape)} "
                             f"!= manifest {entry['dtype']}{entry['shape']}")
        t = torch.from_numpy(arr)
        leaves[key] = (t.view(torch.bfloat16) if bf16 else t).to(dev)

    def build(tree, prefix=""):
        if not isinstance(tree, dict):
            return leaves[prefix]
        return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return build(state_like)


class CheckpointManager:
    """Async, keep-last-K checkpointing for the training loop.  ``wait``
    returns once the save in flight (if any) is on disk."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3,
                 writer: bool = True):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        # data-parallel ranks other than 0 restore but never write
        self.writer = writer
        self._thread: Optional[threading.Thread] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, state, step: int) -> None:
        if not self.writer:
            return
        self.wait()                                     # one in flight
        # on the host *now*, so training can go on with the device state
        host_state = _host_copy(state)

        def _do():
            save(host_state, step, str(self.dir))
            self._gc()

        self._thread = threading.Thread(target=_do, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        for s in _completed_steps(self.dir)[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def restore_latest(self, state_like, device: DeviceLike = "cuda"):
        """(state on ``device``, its step), or (None, None) without a
        checkpoint."""
        self.wait()
        step = latest_step(str(self.dir))
        if step is None:
            return None, None
        return restore(state_like, step, str(self.dir), device=device), step


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)
