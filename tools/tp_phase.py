#!/usr/bin/env python3
"""``chip_smoke.py``'s tp phase alone: GSPMD's weight layouts as
per-rank blocks (tensor parallelism over 'model', FSDP rows) on one card
in a few minutes, after building the kernels.

    python3 tools/tp_phase.py          # from the root of a checkout, one GPU

It builds every kernel from ``src/repro_torch/csrc``, prints the card's
name and power limit, and runs ``chip_smoke.check_tp`` with TF32 off, as
the whole script does: the meshless runs in this process, then two gloo
ranks sharing the card on a (1, 2) mesh (qwen3-4b, Mamba2-780m and
llama4-maverick's super-block at full width in bf16 through
``generate``, the f32 gates, training with 'model' = 2 and FSDP rows on
(2, 1)), then n tensor-parallel shards of the flash and SSD kernels and
of the attention and SSM layers in one process.  It exits non-zero when
a check fails.
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
        print("tp_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    print(cs.nvidia_smi())
    t0 = time.perf_counter()
    launches, rows, errs = cs.check_tp(torch, fa_ops, ssd_ops)
    print(f"tp: launches {launches}, {sum(map(len, rows.values()))} timing "
          f"rows, max err {errs}, {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
