"""CAPSim vs the O3 oracle on whole benchmarks (paper Fig 1 / Fig 7) on the
PyTorch port (``examples/simulate_benchmark.py``'s steps through
``repro_torch``).

    PYTHONPATH=src python examples/simulate_benchmark_torch.py [--ckpt results/ckpt_capsim_torch] [--device cpu]

All requested benchmarks run through the batched multi-benchmark
``SimulationEngine``: each program's functional sim + tokenization feeds
a shared clip pool that the predictor consumes in size-bucketed device
batches.  For each benchmark: the functional+predictor wall time (CAPSim
path), the cycle-level oracle wall time, the speedup and the prediction
error.  With an untrained predictor the error column is meaningless:
pass --ckpt to use weights from examples/train_capsim_torch.py.  The
predictor runs on the card; ``--device cpu`` runs the kernels' plain
versions.  ``--mesh N`` shards inference over N cards (N shards on the
CPU with ``--device cpu``).
"""
import argparse

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import predictor
from repro_torch.core.engine import SimulationEngine
from repro_torch.core.engine_config import EngineConfig
from repro_torch.core.standardize import build_vocab
from repro_torch.device import resolve_device
from repro_torch.training.train_loop import TrainConfig, init_train_state


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--benchmarks", nargs="*",
                    default=["503.bwaves", "505.mcf", "548.exchange2"])
    ap.add_argument("--interval-size", type=int, default=20_000)
    ap.add_argument("--max-checkpoints", type=int, default=4)
    ap.add_argument("--no-rt-cache", action="store_true",
                    help="monolithic predict path")
    ap.add_argument("--precision", default=None, choices=("fp32", "bf16"))
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard inference over an N-device data mesh")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    vocab = build_vocab()
    cfg = get_config("capsim").replace(dtype="float32")
    params = predictor.init_params(cfg, seed=0, device=device)
    if args.ckpt:
        state_like = init_train_state(params, TrainConfig())
        restored, step = CheckpointManager(args.ckpt).restore_latest(
            state_like, device=device)
        if restored is not None:
            params = restored["params"]
            print(f"restored predictor from step {step}")

    config = EngineConfig(interval_size=args.interval_size,
                          max_checkpoints=args.max_checkpoints,
                          rt_cache=not args.no_rt_cache,
                          precision=args.precision,
                          mesh_shape=(args.mesh,) if args.mesh else ())
    engine = SimulationEngine.from_config(params, cfg, vocab, config,
                                          device=device)
    engine.submit_names(args.benchmarks)
    results = engine.run()

    print(f"{'benchmark':16s} {'insts':>8s} {'clips':>6s} {'oracle_s':>9s} "
          f"{'capsim_s':>9s} {'speedup':>8s} {'rel_err':>8s}   (on {device})")
    for r in results:
        print(f"{r.name:16s} {r.n_instructions:8d} {r.n_clips:6d} "
              f"{r.oracle_seconds:9.2f} {r.capsim_seconds:9.2f} "
              f"{r.speedup:7.2f}x {100*r.rel_error:7.1f}%")
    stats = engine.last_stats
    print(f"pool: {stats.n_clips} clips in {stats.n_batches} device "
          f"batches ({stats.n_pad} pad rows)")
    rt = engine.last_rt_stats
    if rt is not None:
        print(f"rt-cache: {rt.n_rows_encoded} static rows encoded "
              f"({rt.build_seconds:.2f}s) served {rt.n_rows_served} "
              f"dynamic rows — instruction encoder skipped for "
              f"{rt.rows_avoided}")
    return results


if __name__ == "__main__":
    main()
