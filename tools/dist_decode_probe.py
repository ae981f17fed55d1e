#!/usr/bin/env python3
"""Whether running under the zoo's mesh costs qwen3-4b's decode anything.

    python3 tools/dist_decode_probe.py          # from the root of a checkout, one GPU

``chip_smoke.py``'s dist phase times each ``generate`` run once, and its
host-bound decode drifts within a call.  This probe takes one prefill of
qwen3-4b at full width in bf16 (B=4 x 4096), then times ``--rounds``
pairs of ``--steps`` greedy decode steps from copies of the same caches:
one with no mesh, one under ``make_test_mesh()`` and
``LOGICAL_RULES_DECODE`` in a one-rank NCCL group, alternating which
goes first.  Each run's ms/step (host clock, synchronized), then each
side's median and quartiles, the share of pairs the mesh run was
slower, and whether the two sides' tokens agree.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("dist_decode_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed.sharding import (LOGICAL_RULES_DECODE,
                                                  use_mesh_and_rules)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import transformer as tfm

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip())
    store = ROOT / "build" / "dist_decode_probe.store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh("cuda")
        cfg = get_config("qwen3-4b")
        B, S = 4, 4096
        params = tfm.init_params(cfg, seed=0, device="cuda")
        batch = random_batch(cfg, ShapeConfig("p", S, B, "prefill"),
                             "prefill", seed=0, device="cuda")
        with torch.no_grad():
            logits, caches = tfm.prefill_step(params, batch, cfg)
            caches = tfm.place_caches(cfg, caches, S + args.steps)
            first = logits[:, -1].argmax(-1)
            del logits

            def clone(tree):
                return {k: clone(v) if isinstance(v, dict) else v.clone()
                        for k, v in tree.items()}

            def run(on_mesh: bool):
                c, tok, out = clone(caches), first, []
                ctx = use_mesh_and_rules(mesh if on_mesh else None,
                                         LOGICAL_RULES_DECODE if on_mesh
                                         else None)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with ctx:
                    for i in range(args.steps):
                        lg, c = tfm.decode_step(params,
                                                {"tokens": tok[:, None]},
                                                cfg, c, S + i)
                        tok = lg[:, -1].argmax(-1)
                        out.append(tok)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0) / args.steps
                return ms, torch.stack(out, 1)

            run(False)
            run(True)                                # warm-up, not kept
            times = {False: [], True: []}
            same, slower = True, 0
            for r in range(args.rounds):
                order = (False, True) if r % 2 == 0 else (True, False)
                pair = {}
                for side in order:
                    pair[side] = run(side)
                    times[side].append(pair[side][0])
                same &= bool(torch.equal(pair[False][1], pair[True][1]))
                slower += pair[True][0] > pair[False][0]
                print(f"round {r}: " + ", ".join(
                    f"{'mesh' if side else 'meshless'} "
                    f"{pair[side][0]:.3f}" for side in order) + " ms/step")
        for side in (False, True):
            q = statistics.quantiles(times[side], n=4)
            print(f"{'mesh' if side else 'meshless'}: median "
                  f"{statistics.median(times[side]):.3f} ms/step, quartiles "
                  f"{q[0]:.3f} / {q[2]:.3f}")
        print(f"the mesh run slower in {slower} of {args.rounds} pairs; "
              f"tokens equal in every pair: {same}")
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
