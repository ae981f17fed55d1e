#!/usr/bin/env python3
"""SASS opcode histograms of the kernels in one CUDA source.

    python3 tools/sass_histogram.py SOURCE.cu [--include DIR] [--top 25]

Compiles SOURCE.cu for sm_90a with the port's nvcc flags into a cubin
under ``build/sass/`` and prints, for each kernel, its registers (from
``-Xptxas -v``) and its most frequent SASS opcodes (``cuobjdump -sass``),
then, for each pair of kernels that differ only in their element type
(``float`` / ``__nv_bfloat16`` in the mangled name), the opcodes whose
counts differ.  Needs the CUDA toolkit (the machine with the card).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", type=Path)
    ap.add_argument("--include", type=Path, action="append", default=[])
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    out_dir = ROOT / "build" / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    cubin = out_dir / (args.source.stem + ".cubin")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-fPIC")
             and f != "-Xcompiler"]
    cmd = [build._nvcc(), *flags, "-cubin", "-o", str(cubin),
           *(f"-I{d}" for d in args.include), str(args.source)]
    log = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if log.returncode != 0:
        print(log.stdout + log.stderr, file=sys.stderr)
        return 1
    print("\n".join(line for line in (log.stdout + log.stderr).splitlines()
                    if "registers" in line or "Compiling entry" in line))
    ops = build.sass_opcodes(cubin)
    for name, hist in sorted(ops.items()):
        total = sum(hist.values())
        top = ", ".join(f"{op} {n}" for op, n in hist.most_common(args.top))
        print(f"\n{name}: {total} instructions\n  {top}")
    names = sorted(ops)
    for a in names:
        if "13__nv_bfloat16" not in a:
            continue
        b = a.replace("13__nv_bfloat16", "f")
        if b not in ops:
            continue
        keys = sorted(set(ops[a]) | set(ops[b]),
                      key=lambda k: -abs(ops[a][k] - ops[b][k]))
        diff = ", ".join(f"{k} {ops[b][k]}->{ops[a][k]}" for k in keys
                         if ops[a][k] != ops[b][k])
        print(f"\nfloat -> bf16 {b} -> {a}: "
              f"{sum(ops[b].values())} -> {sum(ops[a].values())} "
              f"instructions\n  {diff}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
