"""Serving launcher: ``python -m repro_torch.launch.serve --arch capsim``.

Port of ``repro/launch/serve.py``.  ``--arch capsim`` (the default) runs
``SimulationEngine`` over the first ``--n-benchmarks`` programs of the
synthetic suite (Table II) at the paper model's full width, with seeded
random parameters, and prints per-benchmark predictions, clip throughput
and the RT-cache build.  ``--arch mamba2-780m`` runs the LM zoo's
prefill + greedy decode loop (``generate``) on the smoke config, as the
reference does.  ``--device`` defaults to ``cuda``; ``--device cpu`` runs
the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch


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


@dataclasses.dataclass
class Generation:
    """What ``generate`` returns.  tokens: (B, 1 + decode_steps) greedy
    ids, the prefill's then each decode step's; logits: (B, 1 +
    decode_steps, V_pad) the last position's logits at each step;
    prefill_seconds: prefill and its argmax; decode_seconds: all decode
    steps (host clock, synchronized on a card)."""
    tokens: torch.Tensor
    logits: torch.Tensor
    prefill_seconds: float
    decode_seconds: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(params: dict, cfg, batch: dict, decode_steps: int,
             device="cuda") -> Generation:
    """Prefill ``batch['tokens']`` (B, S), then ``decode_steps`` greedy
    decode steps against the prefill's caches (the reference's
    ``serve_lm`` loop).  An SSM cache does not grow with the sequence, so
    the prefill caches are the decode caches as they are."""
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tfm

    dev = resolve_device(device)
    tokens = batch["tokens"].to(dev)
    S = tokens.shape[1]
    t0 = time.perf_counter()
    logits, caches = tfm.prefill_step(params, {"tokens": tokens}, cfg)
    last = [logits[:, -1].clone()]       # frees the (B, S, V) logits
    del logits
    out = [last[-1].argmax(-1)]
    _sync(dev)
    t1 = time.perf_counter()
    for i in range(decode_steps):
        logits, caches = tfm.decode_step(
            params, {"tokens": out[-1][:, None]}, cfg, caches, S + i)
        last.append(logits[:, -1])
        out.append(last[-1].argmax(-1))
    _sync(dev)
    t2 = time.perf_counter()
    return Generation(torch.stack(out, 1), torch.stack(last, 1), t1 - t0,
                      t2 - t1)


def serve_lm(args) -> None:
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import transformer as tfm

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    B, S = 2, 64
    params = tfm.init_params(cfg, seed=0, device=device)
    batch = random_batch(cfg, ShapeConfig("p", S // 2, B, "prefill"),
                         "prefill", device=device)
    gen = generate(params, cfg, batch, args.decode_steps, device)
    print(f"{args.arch}: prefill {S // 2} tokens in "
          f"{gen.prefill_seconds:.3f}s + {args.decode_steps} decode steps "
          f"in {gen.decode_seconds:.3f}s on {device}; tokens "
          f"{gen.tokens.tolist()}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="capsim",
                    help="capsim (the engine) or mamba2-780m (LM prefill + "
                         "decode on the smoke config)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--interval-size", type=int, default=10_000)
    ap.add_argument("--n-benchmarks", type=int, default=4)
    ap.add_argument("--decode-steps", type=int, default=8)
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
    args = ap.parse_args()
    if args.arch == "capsim":
        serve_capsim(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
