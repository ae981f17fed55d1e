"""Readings that set the output check's limits: the program's, and its
control's, over many seeds in one process.

    python3 capsim_bench/control.py --workload paper.train-b256 \\
        --seeds 11,12,13 --seconds 5

Each seed runs the cell's own path at its own size for a short window
(the program's readings are those of its timed path), then the output
check, then the control: the reference put in the program's place one
precision below the configuration's (serving: fp8 products against bf16;
training: TF32 against float32 with TF32 off), and, for training, the
planted fault of a batch of which half is left out.  One JSON line a
seed, to standard output and to ``--out``.  The benchmark's own runs do
not run it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from capsim_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("control readings need a CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    drive = harness.driver(cell.kind)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            ctx = harness.RunContext(
                cell=cell, seed=seed, seconds=args.seconds, trace=False,
                device=torch.device("cuda", 0), cache=harness.cache_dir(),
                t_start=time.perf_counter(), control=True)
            rec = drive.run(ctx)
            line = json.dumps({"workload": cell.name, "seed": seed,
                               "correct": rec["correct"],
                               "checks": rec["checks"],
                               "control": rec["control"],
                               "card": harness.power_limit()})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
