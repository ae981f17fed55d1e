#!/usr/bin/env python3
"""Time the SSD scan of several source trees on one card, in turns.

    python3 tools/ssd_time.py TREE [TREE ...]     # e.g. parent new new parent

Each TREE is the root of a checkout.  In a process of its own, it builds
that tree's ``csrc/ssd.cu`` (into the tree's ``build/``) and times
``ssd_scan`` at the Mamba2-780m prefill shape (Bt 4, S 4096, H 48, P 64,
N 128, chunk 256) in float32 and bfloat16 on the same seeded data: CUDA
events, the least of three means of 20 calls after 3 warm-up calls, and
the device time of each of its four kernels from ``torch.profiler``
(mean over 5 calls).  Give the trees in alternating order to see the
card's drift between them.  Needs the card and the CUDA toolkit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

_CHILD = r"""
import json, re, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.ssd import ops
Bt, S, H, P, N, q = 4, 4096, 48, 64, 128, 256
out = {}
for name in ("float32", "bfloat16"):
    g = torch.Generator().manual_seed(3)
    dt_ = getattr(torch, name)
    x = (torch.randn(Bt, S, H, P, generator=g) * 0.5).to("cuda", dt_)
    dt = (torch.randn(Bt, S, H, generator=g).abs() * 0.4 + 0.01).cuda()
    B = (torch.randn(Bt, S, N, generator=g) * 0.3).to("cuda", dt_)
    C = (torch.randn(Bt, S, N, generator=g) * 0.3).to("cuda", dt_)
    A = (-torch.randn(H, generator=g).abs() - 0.1).cuda()
    fn = lambda: ops.ssd_scan(x, dt, B, C, A, chunk=q)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(20):
            fn()
        e.record()
        torch.cuda.synchronize()
        best = min(best, s.elapsed_time(e) / 20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    parts = {re.sub(r"\(capsim_ssd::Args.*", "", k.key)
             .replace("void capsim_ssd::", ""): k.self_device_time_total / 5e3
             for k in prof.key_averages()
             if k.device_type == DeviceType.CUDA and "capsim" in k.key}
    out[name] = {"ms": best, "device_ms": parts}
print(json.dumps(out))
"""


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {smi}")
    for tree in trees:
        root = str(Path(tree).resolve())
        run = subprocess.run([sys.executable, "-c", _CHILD, root],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stderr, file=sys.stderr)
            return run.returncode
        res = json.loads(run.stdout.strip().splitlines()[-1])
        for name, r in res.items():
            parts = "; ".join(f"{k} {v:.4f}" for k, v in
                              r["device_ms"].items())
            print(f"{tree} {name:8s} kernel_ms={r['ms']:.4f} device ms per "
                  f"kernel: {parts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
