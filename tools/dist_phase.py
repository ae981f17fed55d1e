#!/usr/bin/env python3
"""``chip_smoke.py``'s dist phase alone: the LM zoo's multi-device paths
on one card in about a minute, after building the kernels.

    python3 tools/dist_phase.py          # from the root of a checkout, one GPU

It builds every kernel from ``src/repro_torch/csrc``, prints the card's
name and power limit, and runs ``chip_smoke.check_dist`` with TF32 off,
as the whole script does: world size 1 over NCCL against the meshless
runs, the CAPSim data-parallel trainer (also on 2 gloo ranks on the
card), and n shards of each body in one process at full width.  It
exits non-zero when a check fails.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("dist_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    print(cs.nvidia_smi())
    t0 = time.perf_counter()
    n, rows, errs = cs.check_dist(torch, fa_ops)
    print(f"dist: {n} flash launches, {len(rows)} timing rows, max err "
          f"{errs}, {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
