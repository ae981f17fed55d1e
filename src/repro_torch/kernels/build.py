"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface, ``build/repro_torch/lib<name>.so`` under the
checkout, and is loaded with ``ctypes``.  Nothing is built while a module
is imported: ``load`` builds a stale library at first use, and ``build``
starts one ``nvcc`` per source, all at once, for callers that want every
kernel up front (``chip_smoke.py``).  A library is stale when it is
missing or older than any source under ``csrc/``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "weighted_attention", "ssd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(src.stat().st_mtime > built
               for src in CSRC.iterdir() if src.suffix in (".cu", ".cuh"))


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[str, float]]:
    """Compile every stale library among ``names``, one ``nvcc`` per
    source, all started together.  Returns each built library's compiler
    log (``-Xptxas -v``: registers, shared memory and spills per kernel)
    and its seconds of ``nvcc``; raises ``RuntimeError`` with the log if a
    build fails."""
    names = [n for n in names if _stale(n)]
    if not names:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if name not in SOURCES:
            raise ValueError(f"unknown kernel source {name!r}")
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp"
        log = BUILD_DIR / f"{name}.{os.getpid()}.log"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "w") as out:
            procs[name] = (tmp, log, subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT))
    done, failed = {}, []
    while len(done) < len(procs):
        for name, (tmp, log, proc) in procs.items():
            if name in done or proc.poll() is None:
                continue
            text = log.read_text()
            log.unlink()
            done[name] = (text, time.perf_counter() - t0)
            if proc.returncode != 0:
                failed.append(name)
                continue
            (BUILD_DIR / f"{name}.log").write_text(text)
            os.replace(tmp, library_path(name))  # atomic for concurrent users
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(done[n][0] for n in failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, built if stale."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.capsim_cuda_error_string.argtypes = [ctypes.c_int]
        lib.capsim_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned an error (``cudaGetLastError`` after the
    launch, or -1 for a configuration the library was not built for)."""
    if rc == -1:
        raise ValueError(f"{what}: dtype/shape not supported by the "
                         "kernel")
    if rc != 0:
        msg = lib.capsim_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")
