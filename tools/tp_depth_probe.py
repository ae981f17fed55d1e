#!/usr/bin/env python3
"""Whether tensor parallelism parts from the meshless run at full depth
because of its arithmetic or because of bf16: Mamba2-780m (48 layers)
and qwen3-4b (36 layers) at full width, the prefill's last-row logits of
the meshless run against two gloo ranks sharing the card (mesh (1, 2),
``LOGICAL_RULES_DECODE``, as ``chip_smoke.py``'s tp phase runs them), in
f32 and in bf16, beside the meshless run's own bf16-vs-f32 gap.

    python3 tools/tp_depth_probe.py          # from the root of a checkout, one GPU

Each gap is max |a - b| / max |b| over the real vocabulary columns.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUNS = (("mamba2-780m", None), ("qwen3-4b", None))
DTYPES = ("float32", "bfloat16")
B, S = 1, 1024


def logits(torch, cs, mesh, rules):
    """{(arch, dtype): the prefill's last-row logits} of each run."""
    out = {}
    for arch, layers in RUNS:
        for dtype in DTYPES:
            cfg = cs.tp_cfg(arch, layers, None, dtype)
            g, _, _ = cs.tp_generate(torch, cfg, mesh, rules, B, S, 1)
            out[(arch, dtype)] = g.logits[:, 0].float().cpu()
            del g
            torch.cuda.empty_cache()
    return out


def rank_main(rank: int) -> int:
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.distributed.sharding import LOGICAL_RULES_DECODE
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=os.environ["INIT"],
                            rank=rank, world_size=2)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mesh = make_mesh((1, 2), ("data", "model"), "cuda:0")
        out = logits(torch, cs, mesh, LOGICAL_RULES_DECODE)
        if rank == 0:
            torch.save(out, os.environ["OUT"])
        return 0
    finally:
        dist.destroy_process_group()


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("tp_depth_probe: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        return rank_main(int(sys.argv[2]))
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    print(cs.nvidia_smi())
    t0 = time.perf_counter()
    ref = logits(torch, cs, None, None)
    torch.cuda.empty_cache()
    out = ROOT / "build" / "tp_depth.pt"
    store = ROOT / "build" / "tp_depth.store"
    for f in (out, store):
        f.unlink(missing_ok=True)
    env = {**os.environ, "INIT": f"file://{store}", "OUT": str(out)}
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r)],
                              env=env) for r in range(2)]
    rcs = [p.wait(timeout=900) for p in procs]
    if any(rcs):
        print(f"tp_depth_probe: ranks failed {rcs}", file=sys.stderr)
        return 1
    tp = torch.load(out)
    for arch, layers in RUNS:
        V = cs.tp_cfg(arch, layers, None).vocab_size
        gaps = {d: cs.live_rel(tp[(arch, d)], ref[(arch, d)], V)
                for d in DTYPES}
        own = cs.live_rel(ref[(arch, "bfloat16")], ref[(arch, "float32")], V)
        print(f"tp depth {arch} (full depth and width, B={B} x {S}, TP "
              f"over 2 gloo ranks on one card): last-row logits TP vs "
              f"meshless f32 {gaps['float32']:.3e}, bf16 "
              f"{gaps['bfloat16']:.3e}; the meshless run's bf16 vs f32 "
              f"{own:.3e}")
    print(f"tp depth probe {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
