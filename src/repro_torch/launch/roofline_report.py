"""Roofline report: results/dryrun_torch/*.json -> per-cell terms +
markdown (port of ``repro/launch/roofline_report.py``).

    PYTHONPATH=src python -m repro_torch.launch.roofline_report [--mesh pod_16x16]

Per (arch x shape) cell of a dry-run mesh, one NVIDIA H100 SXM a rank:
    compute_s    = FLOPs_per_device / 989 TFLOP/s (bf16; 67 TFLOP/s for
                   a float32 cell)
    memory_s     = HBM bytes_per_device / 3.35 TB/s
    collective_s = wire_bytes_per_device / 450 GB/s (NVLink 4, one way)
    dominant     = argmax
    model_ratio  = MODEL_FLOPS (6*N_active*D or 2*N_active*D) / FLOPs
    mfu_bound    = ideal model-FLOPs time / dominant term  (what MFU the
                   step could reach if the dominant bottleneck perfectly
                   overlapped the others)

The port's record holds the whole step at full depth (``scanned``), so
FLOPs, bytes and wire bytes are read from it; the per-layer
extrapolation from 1 and 2 repeats (``extrapolated``), which the
reference must use because XLA counts a scanned body once, is the
cross-check printed with ``--json``.  HBM traffic is the reference's
estimate from the buffers: every argument read once, every output
written once, every temp byte written and read.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.launch import roofline as rf

RESULTS_DIR = Path("results/dryrun_torch")


def _mem_traffic(memory: dict) -> float:
    """HBM traffic estimate from the buffers: every argument read once,
    every output written once, every temp buffer written + read (>=1
    each).  Closer to real traffic than the unfused 'bytes accessed',
    which counts every op's operands."""
    a = memory.get("argument_bytes") or 0
    o = memory.get("output_bytes") or 0
    t = memory.get("temp_bytes") or 0
    return float(a + o + 2 * t)


def cell_terms(rec: dict) -> Optional[dict]:
    if "skipped" in rec:
        return None
    chips = rec["chips"]
    step = rec["scanned"]
    flops = step["cost"]["flops"] or 0.0
    bts_unfused = step["cost"]["bytes_accessed"] or 0.0
    wire = sum(v["wire_bytes"] for v in step["collectives"].values())
    traffic = _mem_traffic(step["memory"])
    cfg = get_config(rec["arch"])
    terms = rf.roofline_terms(flops, traffic, wire, cfg.dtype)
    terms["memory_unfused_s"] = bts_unfused / rf.HBM_BW if bts_unfused \
        else 0.0

    shape = cfg.shapes().get(rec["shape"])
    model_fl = rf.model_flops(cfg, shape, rec["kind"]) if shape else 0.0
    model_fl_dev = model_fl / chips
    terms["model_flops_ratio"] = (model_fl_dev / flops) if flops else 0.0
    peak = rf.PEAK_FLOPS_F32 if cfg.dtype == "float32" \
        else rf.PEAK_FLOPS_BF16
    ideal_s = model_fl_dev / peak
    bound = max(terms["compute_s"], terms["memory_s"],
                terms["collective_s"])
    terms["mfu_bound"] = ideal_s / bound if bound else 0.0
    terms["flops"] = flops
    terms["bytes"] = traffic
    terms["wire_bytes"] = wire
    terms["peak_bytes"] = (step["memory"]["argument_bytes"]
                           + step["memory"]["temp_bytes"])
    ext = rec.get("extrapolated")
    terms["extrapolated_flops_ratio"] = (ext["flops"] / flops
                                         if ext and flops else None)
    return terms


def load_cells(mesh: str, tag: str = "",
               results_dir: Path = RESULTS_DIR) -> dict:
    cells = {}
    suffix = f"__{mesh}__{tag}.json" if tag else f"__{mesh}.json"
    for f in sorted(Path(results_dir).glob(f"*{suffix}")):
        rec = json.loads(f.read_text())
        cells[(rec["arch"], rec["shape"])] = rec
    return cells


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def report(mesh: str, markdown: bool = True, tag: str = "",
           results_dir: Path = RESULTS_DIR) -> str:
    cells = load_cells(mesh, tag, results_dir)
    lines = []
    if markdown:
        lines.append(
            "| arch | shape | compute | memory | collective | dominant "
            "| model/step FLOPs | MFU bound | peak GiB |")
        lines.append("|---|---|---|---|---|---|---|---|---|")
    for (arch, shape), rec in sorted(cells.items()):
        if "skipped" in rec:
            lines.append(f"| {arch} | {shape} | — | — | — | skipped: "
                         f"{rec['skipped'][:48]} | — | — | — |")
            continue
        t = cell_terms(rec)
        lines.append(
            f"| {arch} | {shape} | {fmt_s(t['compute_s'])} | "
            f"{fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} | "
            f"{t['dominant'].replace('_s','')} | "
            f"{t['model_flops_ratio']:.2f} | {t['mfu_bound']*100:.0f}% | "
            f"{t['peak_bytes'] / 2**30:.2f} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod_16x16")
    ap.add_argument("--tag", default="", help="variant suffix, e.g. fsdp")
    ap.add_argument("--results", default=str(RESULTS_DIR))
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.json:
        cells = load_cells(args.mesh, args.tag, Path(args.results))
        out = {f"{a}__{s}": cell_terms(r)
               for (a, s), r in cells.items() if "skipped" not in r}
        print(json.dumps(out, indent=1))
    else:
        print(f"H100 SXM a rank: {rf.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s "
              f"bf16 ({rf.PEAK_FLOPS_F32 / 1e12:.0f} f32), "
              f"{rf.HBM_BW / 1e12:.2f} TB/s HBM, "
              f"{rf.NVLINK_BW / 1e9:.0f} GB/s NVLink a direction")
        print(report(args.mesh, tag=args.tag,
                     results_dir=Path(args.results)))


if __name__ == "__main__":
    main()
