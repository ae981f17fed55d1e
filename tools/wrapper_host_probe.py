#!/usr/bin/env python3
"""Host time per call of the attention wrappers at launch-bound shapes.

    python3 tools/wrapper_host_probe.py [--root DIR] [--load N]   # one GPU

At the serving shapes (weighted attention over U = 64 or 128 unique
tokens, the instruction encoder's 64 x 16 rows) a launch takes about 25
microseconds on the card, so ``chip_smoke.py``'s ``kernel_ms`` (CUDA
events around back-to-back calls, ``cuda_ms``) times the wrapper's host
work, not the kernel.  For each shape this prints, from the package under
``DIR/src`` (default: this checkout), the wrapper's host microseconds
per call (the host clock over calls issued without a synchronisation),
``cuda_ms`` as ``chip_smoke.py`` takes it, and the kernel's device time
(``device_ms``).  ``--load N`` keeps N processes spinning on the host's
cores while it measures, as a host shared with other work would.  To
compare two trees, run it on each in one call, in the order A, B, B, A.
The last line is one JSON object of the rows.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def host_us(torch, fn, calls: int = 400, rounds: int = 5) -> float:
    """Least mean host microseconds per call over ``rounds`` runs of
    ``calls`` calls issued without a synchronisation (few enough that
    the launch queue never fills)."""
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, 1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose src/repro_torch is measured")
    ap.add_argument("--load", type=int, default=0,
                    help="processes spinning on the host while measuring")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root / "src"))
    sys.path.insert(0, str(HERE))
    import torch
    if not torch.cuda.is_available():
        print("wrapper_host_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_serving import ops as wa_ops
    build.build()
    gen = torch.Generator().manual_seed(1)
    cases = []
    for (label, B, Sq, Skv, _, _, kind) in cs.WA_PATH:
        q, k, v = cs.make_qkv(torch, gen, B, Sq, Skv, 4, 32, torch.bfloat16)
        w = cs.make_aux(torch, gen, kind, B, Skv)
        cases.append((f"weighted {label}",
                      lambda q=q, k=k, v=v, w=w:
                      wa_ops.weighted_attention(q, k, v, w)))
    label, B, Sq, Skv, H, D, _, _, kind = cs.FA_PATH[0]
    q, k, v = cs.make_qkv(torch, gen, B, Sq, Skv, H, D, torch.bfloat16)
    m = cs.make_aux(torch, gen, kind, B, Skv)
    cases.append((f"flash {label}",
                  lambda: fa_ops.flash_attention(q, k, v, kv_mask=m)))
    spin = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(args.load)]
    rows = []
    try:
        time.sleep(1.0 if spin else 0.0)
        with torch.no_grad():
            for name, fn in cases:
                rows.append({"case": f"{name} bf16", "load": args.load,
                             "host_us": host_us(torch, fn),
                             "kernel_ms": cs.cuda_ms(torch, fn),
                             "device_ms": cs.device_ms(torch, fn)})
    finally:
        for p in spin:
            p.kill()
            p.wait()
    print(f"root {args.root}; {cs.nvidia_smi()}; load {args.load}")
    for r in rows:
        print(f"{r['case']:28s} host {r['host_us']:.2f} us/call  kernel_ms "
              f"{r['kernel_ms']:.4f}  device_ms {r['device_ms']:.4f}")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
