#!/usr/bin/env python3
"""The flash backward kernels alone, f32 and bf16
(``csrc/flash_attention_bwd.cu``): ``chip_smoke.py``'s checks and
timings of them in about a minute, after building the kernels.

    python3 tools/flash_bwd_phase.py [--grads]   # from a checkout, one GPU

It builds every kernel from ``src/repro_torch/csrc``, prints the card's
name and power limit, each backward kernel's registers and spills from
the build log and its SASS (HMMA in bf16, none in f32), and runs
``chip_smoke.check_flash_backward`` with TF32 off: the kernels against
the plain equations and the plain recompute at the train cells' shapes
(the nemo3 cell's causal attention in bf16) and every head dim, the
same bits twice, then kernel, recompute, SDPA backward and bound ms.  ``--grads`` adds ``check_train_grads`` (the
Functions' gradients at the train step's shapes, forward bitwise the
no-grad launch).  It exits non-zero when a check fails.
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
        print("flash_bwd_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build {sorted(logs)} {time.perf_counter() - t0:.1f} s")
    print(cs.nvidia_smi())
    log = (build.BUILD_DIR / "flash_attention_bwd.log").read_text()
    for line in log.splitlines():
        if "fa_bwd" in line or "Used " in line or "spill" in line:
            print("ptxas " + line.strip())
    cs.sass_pipes(torch, build, fa_ops, ssd_ops)
    t0 = time.perf_counter()
    rows = cs.check_flash_backward(torch, fa_ops)
    print(f"flash_bwd: {len(rows)} shapes, {time.perf_counter() - t0:.1f} s")
    if "--grads" in sys.argv[1:]:
        cs.check_train_grads(torch, fa_ops, ssd_ops)
    return 0


if __name__ == "__main__":
    sys.exit(main())
