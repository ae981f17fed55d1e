"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 capsim_bench/run.py --workload paper.serve-mono-c3 \\
        --seed 7 --seconds 30 --trace 0

Runs on the machine it is started on, on its CUDA cards; without a card,
or with fewer than the cell asks for, it exits with code 3 and prints no
result.  The last line of standard output is one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a device trace of the window.  The numbers
the output check compared, each beside its limit, end standard error and
the result line.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from capsim_bench import harness  # noqa: E402


def run_cell(ctx: harness.RunContext):
    """The cell's driver over ``ctx``, then its metrics: (result fields,
    the record)."""
    rec = harness.driver(ctx.cell.kind).run(ctx)
    metrics = (ctx.cell.per_layer if ctx.trace else ctx.cell.end_to_end)
    out = {"correct": rec["correct"], "attempted": rec["attempted"],
           "failed": rec["failed"],
           "metrics": harness.read_metrics(metrics, rec, ctx.cell),
           "device": dict(rec["device"]), "checks": rec["checks"]}
    tr = rec.get("trace")
    if tr is not None:
        out["device"]["busy_s"] = tr.busy_s()
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    return out, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (the program under test)

    ctx = harness.RunContext(cell=cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace),
                             device=torch.device("cuda", 0),
                             cache=harness.cache_dir(), t_start=T_START)
    out, _ = run_cell(ctx)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    for line in harness.checks_text(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(out["correct"], out["attempted"],
                              out["failed"], out["metrics"], out["device"],
                              out["checks"], out.get("breakdown")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
