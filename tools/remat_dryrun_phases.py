#!/usr/bin/env python3
"""``chip_smoke.py``'s lstm, remat, dryrun and examples phases alone, on
one card in a few minutes, after building the kernels.

    python3 tools/remat_dryrun_phases.py    # from the root of a checkout, one GPU

It builds every kernel from ``src/repro_torch/csrc``, prints the card's
name and power limit, and runs, with TF32 off as the whole script does,
``chip_smoke.check_lstm`` (the LSTM baseline at the CAPSim full config
beside the predictor), ``check_remat`` (CAPSim at batch 32 and 256 and
qwen3-4b cut to 2 layers, one train step with remat off and on),
``check_dryrun`` (three production cells on meta, the roofline report,
the estimated peaks of the remat cells against the card's) and
``check_examples`` (``examples/*_torch.py``).  It exits non-zero when a
check fails.
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
        print("remat_dryrun_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_serving import ops as wa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    print(cs.nvidia_smi())
    for name, run in (
            ("lstm", lambda: cs.check_lstm(torch, fa_ops)),
            ("remat", lambda: cs.check_remat(torch, fa_ops, ssd_ops)),
            ("dryrun", lambda: cs.check_dryrun(torch, cells)),
            ("examples", lambda: cs.check_examples(torch, fa_ops, wa_ops,
                                                   ssd_ops))):
        t0 = time.perf_counter()
        out = run()
        if name == "remat":
            launches, cells = out
            print(f"remat launches {launches}")
        elif name == "examples":
            print(f"examples launches {out}")
        print(f"phase {name} {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
