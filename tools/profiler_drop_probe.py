#!/usr/bin/env python3
"""Whether ``torch.profiler`` drops the first device records of a capture.

    python3 tools/profiler_drop_probe.py          # from the root of a checkout, one GPU

Late in a whole ``chip_smoke.py`` run, captures of a few launches of a
long kernel came back with none of them.  This probe reproduces that in
one process: causal flash attention at (4, 4096, 32, 128) f32, captured
as ``chip_smoke.py``'s ``_capture`` does (host and device activity, no
schedule), 5 launches after as many outside the capture.  Between rounds
it records ``--captures`` captures of ``--events`` small elementwise
kernels each.  Every round prints, for captures that first launch a pad
of 0, 4, 16, 64 and 256 one-element kernels, how many of the 5 flash
launches and of the pad's kernels each capture holds: a capture that
loses its first K device records, of whatever kernel, holds 5 flash
launches once the pad is longer than K.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402

PADS = (0, 4, 16, 64, 256)
CALLS = 5


def capture(fn, pad_tensor, pad: int):
    """(flash launches, other device records) in one capture."""
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            pad_tensor.add_(1.0)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    ours = sum(e.count for e in dev if "capsim" in e.key)
    return ours, sum(e.count for e in dev) - ours


def busy_capture(events: int) -> None:
    x = torch.zeros(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(events // 2):
            x = x * 1.0001 + 0.5
        torch.cuda.synchronize()
    prof.key_averages()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--captures", type=int, default=4,
                    help="busy captures between rounds")
    ap.add_argument("--events", type=int, default=40_000,
                    help="device records of each busy capture")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_drop_probe: needs a CUDA device", file=sys.stderr)
        return 1
    build.build(("flash_attention",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = [torch.randn(4, 4096, 32, 128, device="cuda", generator=gen)
               for _ in range(3)]

    def fn():
        return fa_ops.flash_attention(q, k, v, causal=True)
    pad_tensor = torch.zeros(1, device="cuda")
    for r in range(args.rounds + 1):
        if r:
            for _ in range(args.captures):
                busy_capture(args.events)
        held = {pad: capture(fn, pad_tensor, pad) for pad in PADS}
        print(f"profiler_drop_probe: after {r * args.captures} busy captures"
              f" of {args.events} device records: "
              + "; ".join(f"pad {pad}: flash {ours} of {CALLS}, pad "
                          f"{other} of {pad}"
                          for pad, (ours, other) in held.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
