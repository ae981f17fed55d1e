"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface, ``build/repro_torch/lib<name>.so`` under the
checkout, and is loaded with ``ctypes``.  Nothing is built while a module
is imported: ``load`` builds a stale library at first use, and ``build``
starts one ``nvcc`` per source, all at once, for callers that want every
kernel up front (``chip_smoke.py``, ``SimulationService.start``).  A
library is stale when it is missing or older than any source under
``csrc/``.  Building and loading hold one process-wide lock: the serving
layer's flush threads may meet a stale library at once, and only the
first of them runs ``nvcc``.  The wrappers' launch helpers live here too:
the current stream's handle, the launch's return code, the launch count.
"""
from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Counter, Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "weighted_attention", "ssd", "embedding_grad")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()       # builds and loads, across threads
_COUNT_LOCK = threading.Lock()  # the wrappers' launch counts


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
    with _LOCK:
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, Tuple[str, float]]:
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
        with _LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                lib.capsim_cuda_error_string.argtypes = [ctypes.c_int]
                lib.capsim_cuda_error_string.restype = ctypes.c_char_p
                _LOADED[name] = lib
    return lib


def count_launch(wrapper, heads: Optional[int] = None) -> None:
    """Add one to a kernel wrapper's ``launches`` count and, where
    ``heads`` is given, to its ``heads[heads]`` (its launches by the head
    count of the call), under a lock: the serving layer launches kernels
    from several threads."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if heads is not None:
            wrapper.heads[heads] = wrapper.heads.get(heads, 0) + 1


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(device: torch.device) -> int:
    """The raw handle of the current CUDA stream on ``device``, for a
    launch (the private accessor where PyTorch has it: a Stream object
    costs microseconds a launch)."""
    if _RAW_STREAM is not None:
        index = device.index
        return _RAW_STREAM(index if index is not None
                           else torch.cuda.current_device())
    return torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned an error (``cudaGetLastError`` after the
    launch, or -1 for a configuration the library was not built for)."""
    if rc == -1:
        raise ValueError(f"{what}: dtype/shape not supported by the "
                         "kernel")
    if rc != 0:
        msg = lib.capsim_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def cuobjdump() -> Optional[str]:
    """The CUDA toolkit's ``cuobjdump``, or None where it is missing."""
    found = shutil.which("cuobjdump")
    if found is None and Path("/usr/local/cuda/bin/cuobjdump").exists():
        found = "/usr/local/cuda/bin/cuobjdump"
    return found


def sass_opcodes(path: Path) -> Dict[str, Counter[str]]:
    """Per kernel (mangled name) of a built library or cubin, the count of
    each SASS opcode (``cuobjdump -sass``; predicates and modifiers
    dropped, so ``@P0 HMMA.16816.F32.BF16`` counts as ``HMMA``)."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out: Dict[str, Counter[str]] = {}
    name = None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            out[name] = collections.Counter()
            continue
        inst = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*)", line)
        if name is not None and inst:
            out[name][inst.group(1)] += 1
    return out


def resource_usage(path: Path) -> Dict[str, Tuple[int, int]]:
    """Per kernel of a built library: (registers, static shared bytes)
    from ``cuobjdump -res-usage``."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found")
    res = subprocess.run([tool, "-res-usage", str(path)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    pattern = r"Function (\S+):\s+REG:(\d+)[^\n]*?SHARED:(\d+)"
    return {m.group(1): (int(m.group(2)), int(m.group(3)))
            for m in re.finditer(pattern, res)}
