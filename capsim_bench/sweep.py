"""The closed-loop client sweep that sets a serve cell's client count.

    python3 capsim_bench/sweep.py --workload paper.serve-mono-c3 \\
        --clients 2,4,8,16,32 --seed 7 --seconds 10

For each client count, in one process, the cell's own run at that count
(service, warm-up, window, output check) for a short window: one JSON line
a run with its clips/s, p95 and whether it came out correct.  A count
given more than once is read by the median of its runs.  Then the
highest rate of the sweep, and the count whose rate lies nearest four
fifths of it, where the tails are still the service's and not a queue's:
the count a cell of this traffic runs at.  The benchmark's own runs do not
run it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from statistics import median  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from capsim_bench import harness  # noqa: E402

# the share of the sweep's highest rate that a cell's count is chosen at
LOAD_SHARE = 0.8


def choose(points):
    """(highest clips/s, the count whose clips/s lies nearest
    ``LOAD_SHARE`` of it) over (count, clips/s) points, each count read
    by the median of its points."""
    by = {}
    for n, r in points:
        by.setdefault(n, []).append(r)
    rate = {n: median(v) for n, v in by.items()}
    top = max(rate.values())
    return top, min(rate, key=lambda n: abs(rate[n] - LOAD_SHARE * top))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--clients", required=True,
                    help="comma-separated client counts")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 3
    base = harness.load_cell(args.workload)
    drive = harness.driver(base.kind)
    read = {m: harness.reader(m)
            for m in ("serve_clips_per_s", "serve_p95_ms",
                      "flush_clips.serve", "pad_share.serve")}
    points = []
    out = open(args.out, "a") if args.out else None
    try:
        for n in (int(s) for s in args.clients.split(",")):
            cell = copy.deepcopy(base)
            cell.traffic["clients"] = n
            ctx = harness.RunContext(
                cell=cell, seed=args.seed, seconds=args.seconds, trace=False,
                device=torch.device("cuda", 0), cache=harness.cache_dir(),
                t_start=time.perf_counter())
            rec = drive.run(ctx)
            row = {"workload": cell.name, "clients": n, "seed": args.seed,
                   "seconds": args.seconds, "correct": rec["correct"],
                   "attempted": rec["attempted"], "failed": rec["failed"],
                   **{k: f(rec, cell) for k, f in read.items()},
                   "card": harness.power_limit()}
            points.append((n, row["serve_clips_per_s"]))
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        top, n = choose(points)
        line = json.dumps({"highest_clips_per_s": top,
                           "load_share": LOAD_SHARE, "clients": n})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
