"""Serving launcher: ``python -m repro_torch.launch.serve``.

Port of the ``--arch capsim`` engine path of ``repro/launch/serve.py``:
runs ``SimulationEngine`` over the first ``--n-benchmarks`` programs of
the synthetic suite (Table II) at the paper model's full width, with
seeded random parameters, and prints per-benchmark predictions, clip
throughput and the RT-cache build.  ``--device`` defaults to ``cuda``;
``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import time


def serve_capsim(args) -> None:
    from repro_torch.configs.capsim import config
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine import SimulationEngine
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.device import resolve_device
    from repro_torch.isa import progen

    device = resolve_device(args.device)
    engine_config = EngineConfig(
        interval_size=args.interval_size, warmup=0, max_checkpoints=1,
        l_min=100, batch_size=args.batch_size, with_oracle=False,
        rt_cache=not args.no_rt_cache, precision=args.precision,
        fused_serving=args.fused_serving)
    vocab = std_mod.build_vocab()
    cfg = config().replace(dtype="float32")
    params = predictor.init_params(cfg, seed=0, device=device)
    engine = SimulationEngine.from_config(params, cfg, vocab, engine_config,
                                          device=device)
    engine.submit_names(list(progen.TABLE_II)[: args.n_benchmarks])
    t0 = time.time()
    results = engine.run()
    wall = time.time() - t0
    stats = engine.last_stats
    for r in results:
        print(f"  {r.name:16s} clips={r.n_clips:5d} "
              f"predicted={r.predicted_cycles:12.0f} cycles")
    print(f"served {len(results)} benchmarks on {device} "
          f"({stats.n_clips} clips, {stats.n_batches} device batches, "
          f"{stats.n_pad} pad rows) in {wall:.1f}s "
          f"= {stats.n_clips / max(wall, 1e-9):.0f} clips/s")
    rt = engine.last_rt_stats
    if rt is not None:
        print(f"rt-cache: {rt.n_rows_encoded} static rows encoded in "
              f"{rt.build_seconds:.2f}s served {rt.n_rows_served} dynamic "
              f"rows ({rt.rows_avoided} instruction-encoder rows avoided)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--interval-size", type=int, default=10_000)
    ap.add_argument("--n-benchmarks", type=int, default=4)
    ap.add_argument("--no-rt-cache", action="store_true",
                    help="monolithic predict path (re-encode every "
                         "dynamic instruction row)")
    ap.add_argument("--precision", default=None,
                    choices=("fp32", "bf16", "int8"),
                    help="inference numerics; default keeps the config "
                         "dtype (fp32 here)")
    ap.add_argument("--fused-serving", action="store_true",
                    help="dedup-fused block-encoder serving step "
                         "(weighted attention over each clip's unique "
                         "context tokens + precomputed cross K/V)")
    serve_capsim(ap.parse_args())


if __name__ == "__main__":
    main()
