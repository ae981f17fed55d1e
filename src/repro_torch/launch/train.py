"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``
(port of ``repro/launch/train.py``).

Two families share this entry point:
  - ``--arch capsim`` (default): build the clip dataset from the
    synthetic suite and train the attention predictor (paper §VI-B: SGD
    momentum 0.9, lr 1e-3, MAPE loss, batch 32), with checkpoint and
    restart through ``ResilientTrainer``; then the validation MAPE.
    ``--multicore N`` builds N-core mt.* shards with
    ``simulate_multicore`` commit deltas as ground truth and reports the
    held-out mt.* MAPE against that oracle (``--peer-channels`` mixes the
    other cores' register blocks into every context matrix).
  - any LM-zoo arch: train the LM (``--smoke``: its smoke config) on
    synthetic tokens with AdamW.

``--device`` defaults to ``cuda``, where the attention goes through the
flash kernel and Mamba2's scan through the SSD kernel, forward and
backward; ``--device cpu`` runs their plain versions.

One process a rank, as the reference runs one a host: the cluster
environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, as ``torchrun``
sets them, with its rendezvous address) gives the world.  At world size
1 the run is the reference's ``make_test_mesh()`` and one device, no
process group.  At world size n the process group is NCCL on
``cuda:LOCAL_RANK`` (gloo with ``--device cpu``) and the mesh (n, 1)
``("data", "model")``: the CAPSim predictor trains under
``LOGICAL_RULES_PREDICTOR``, a zoo model under ``LOGICAL_RULES_TRAIN``,
data-parallel (``training/train_loop.py``): every rank draws the same
global batches and takes its ``shard_range`` of each.  Under
``LOGICAL_RULES_TRAIN`` a zoo model's parameters are the rank's blocks
(``init_params(mesh=...)``: its FSDP rows over 'data', gathered at each
use); a checkpoint is gathered to whole leaves for rank 0, which writes
it and prints, and every rank restores its blocks.  The launcher keeps
this (n, 1) world; training with 'model' > 1 (tensor and expert
parallelism) runs through the library under a (data, model) mesh of
the caller's (``training/train_loop.py``).

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
        --smoke --steps 5 --batch-size 8 --n-benchmarks 3
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import ResilientTrainer
from repro_torch.distributed.sharding import (LOGICAL_RULES_PREDICTOR,
                                              LOGICAL_RULES_TRAIN,
                                              use_mesh_and_rules)
from repro_torch.launch.mesh import make_mesh, make_test_mesh
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step)


def _capsim_cfg(args, vocab):
    """The predictor config of a training run, in f32.  Smoke keeps the
    tiny model but must still embed the real vocabulary: ids above
    vocab_size would index past the embedding."""
    cfg = get_config("capsim").replace(dtype="float32")
    if args.smoke:
        cfg = get_smoke_config("capsim")
    return cfg.replace(vocab_size=max(cfg.vocab_size, vocab.size))


def _rank0() -> bool:
    return int(os.environ.get("RANK", "0")) == 0


def _say(*a, **kw) -> None:
    """print, on rank 0 only."""
    if _rank0():
        print(*a, **kw)


@contextlib.contextmanager
def cluster(device_arg: str):
    """The run's mesh from the cluster environment: ``make_test_mesh`` at
    world size 1; else a process group (NCCL, or gloo on the CPU) and an
    (n, 1) data mesh on this rank's device, torn down after."""
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = resolve_device(device_arg)
    if world == 1:
        yield make_test_mesh(device)
        return
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        yield make_mesh((world, 1), ("data", "model"), device)
    finally:
        dist.destroy_process_group()


def _on(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _fit_predictor(args, cfg, train_ds, device):
    """The MAPE training loop (paper §VI-B recipe); returns the trained
    state."""
    from repro_torch.core import predictor
    from repro_torch.data.dataset import batches

    tcfg = TrainConfig(optimizer="sgdm", base_lr=args.lr,
                       warmup_steps=min(20, args.steps // 10),
                       total_steps=args.steps)
    params = predictor.init_params(cfg, seed=args.seed, device=device)
    state = init_train_state(params, tcfg)
    step = make_train_step(lambda p, b: predictor.mape_loss(p, b, cfg), tcfg)

    trainer = ResilientTrainer(
        step_fn=lambda s, b: step(s, _on(b, device)),
        ckpt=CheckpointManager(args.ckpt_dir, keep=2, writer=_rank0()),
        save_every=args.save_every,
        log_fn=lambda i, m: _say(
            f"  step {i:5d} mape {m['loss']:.4f} lr {m['lr']:.2e}"))
    t0 = time.time()
    state, step_n = trainer.run(
        state, batches(train_ds, args.batch_size, epochs=10_000),
        total_steps=args.steps)
    _say(f"trained to step {step_n} in {time.time() - t0:.0f}s on {device}")
    return state


def _eval_mape(params, cfg, ds, batch_size, device):
    """MAPE of the trained predictor against the dataset's ground-truth
    clip times (overall, per benchmark).  For multicore builds the time
    column is the ``simulate_multicore`` per-core commit delta, so this
    is the eval-vs-oracle number."""
    from repro_torch.core import predictor

    errs, names = [], []
    n = len(ds)
    bs = max(1, min(batch_size, n))
    # plain range slicing, not dataset.batches(), which drops the short
    # final batch and would leave the last clips out of the eval
    for off in range(0, n, bs):
        sub = ds.select(np.arange(off, min(off + bs, n)))
        batch = _on({"clip_tokens": sub.clip_tokens,
                     "context_tokens": sub.context_tokens,
                     "clip_mask": sub.clip_mask}, device)
        with torch.no_grad():
            pred = predictor.predict_step(params, batch, cfg)
        fact = np.maximum(sub.time, 1.0)
        errs.extend(np.abs(pred.cpu().numpy() - fact) / fact)
        names.extend(sub.bench_names)
    if not errs:
        return float("nan"), {}
    errs = np.asarray(errs)
    names = np.asarray(names)
    per_bench = {n: float(errs[names == n].mean())
                 for n in sorted(set(names.tolist()))}
    return float(errs.mean()), per_bench


def train_capsim(args) -> dict:
    from repro_torch.core.standardize import build_vocab
    from repro_torch.data.dataset import (BuildConfig, build_dataset,
                                          split_dataset)
    from repro_torch.isa.progen import TABLE_II

    vocab = build_vocab()
    cfg = _capsim_cfg(args, vocab)
    bcfg = BuildConfig(interval_size=args.interval_size,
                       warmup=args.interval_size // 10,
                       max_checkpoints=args.max_checkpoints)
    names = list(TABLE_II)[: args.n_benchmarks]
    _say(f"building clip dataset from {len(names)} benchmarks ...")
    ds = build_dataset(names, bcfg, vocab, verbose=_rank0())
    train, val, _ = split_dataset(ds)
    _say(f"clips: train={len(train)} val={len(val)}")

    with cluster(args.device) as mesh, \
            use_mesh_and_rules(mesh, LOGICAL_RULES_PREDICTOR):
        state = _fit_predictor(args, cfg, train, mesh.device)
        mape, _ = _eval_mape(state["params"], cfg, val, args.batch_size,
                             mesh.device)
    if mape == mape:                                   # not NaN
        _say(f"validation MAPE: {mape:.4f} "
             f"(accuracy {100 * (1 - mape):.1f}%)")
    return state


def train_capsim_multicore(args) -> dict:
    """The multicore training path end to end: contention-aware dataset
    build (per-core Algorithm-1 slicing over the ``simulate_multicore``
    oracle) -> MAPE train -> held-out mt.* eval against the oracle's
    per-core commit deltas."""
    from repro_torch.core import context as ctx_mod
    from repro_torch.core.standardize import build_vocab
    from repro_torch.data.dataset import BuildStats, split_dataset
    from repro_torch.data.multicore_dataset import (MulticoreBuildConfig,
                                                    build_multicore_dataset)
    from repro_torch.isa.multicore import MULTICORE_NAMES

    vocab = build_vocab()
    cfg = _capsim_cfg(args, vocab)
    bcfg = MulticoreBuildConfig(
        interval_size=args.interval_size,
        warmup=args.interval_size // 10,
        max_checkpoints=args.max_checkpoints,
        n_cores=args.multicore,
        peer_channels=args.peer_channels)
    names = list(MULTICORE_NAMES)[: args.n_benchmarks]
    _say(f"building multicore clip dataset: {len(names)} benchmarks "
         f"x {bcfg.n_cores} cores (peer_channels={bcfg.peer_channels}, "
         f"context width {bcfg.context_len}) ...")
    stats = BuildStats()
    t0 = time.time()
    ds = build_multicore_dataset(names, bcfg, vocab, verbose=_rank0(),
                                 stats=stats)
    build_s = time.time() - t0
    assert ds.context_len == ctx_mod.context_len(
        bcfg.n_cores, bcfg.peer_channels)
    _say(f"built {len(ds)} clips in {build_s:.1f}s "
         f"({len(ds) / max(build_s, 1e-9):.0f} clips/s; interpret "
         f"{stats.interpret_seconds:.1f}s oracle "
         f"{stats.oracle_seconds:.1f}s replay "
         f"{stats.replay_seconds:.1f}s)")
    train, val, test = split_dataset(ds)
    _say(f"clips: train={len(train)} val={len(val)} "
         f"held-out={len(test)}")

    with cluster(args.device) as mesh, \
            use_mesh_and_rules(mesh, LOGICAL_RULES_PREDICTOR):
        state = _fit_predictor(args, cfg, train, mesh.device)
        val_mape, _ = _eval_mape(state["params"], cfg, val,
                                 args.batch_size, mesh.device)
        test_mape, per_bench = _eval_mape(state["params"], cfg, test,
                                          args.batch_size, mesh.device)
    _say(f"validation MAPE: {val_mape:.4f}")
    _say(f"mt.* held-out eval MAPE vs simulate_multicore oracle: "
         f"{test_mape:.4f} (accuracy {100 * (1 - test_mape):.1f}%, "
         f"{bcfg.n_cores} cores, peer_channels={bcfg.peer_channels})")
    for name, m in per_bench.items():
        _say(f"  {name}: MAPE {m:.4f}")
    return state


def train_lm(args) -> dict:
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import transformer as tfm

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("train", args.seq_len, args.batch_size, "train")
    tcfg = TrainConfig(optimizer="adamw", base_lr=args.lr,
                       warmup_steps=min(20, args.steps // 10),
                       total_steps=args.steps)
    with cluster(args.device) as mesh, \
            use_mesh_and_rules(mesh, LOGICAL_RULES_TRAIN):
        device = mesh.device
        params = tfm.init_params(cfg, seed=args.seed, device=device,
                                 mesh=mesh)
        n = sum(p.numel() for p in tree_leaves(params))
        _say(f"{args.arch}: {n / 1e6:.1f}M params on rank 0 (smoke="
             f"{args.smoke})")
        state = init_train_state(params, tcfg)
        step = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), tcfg)
        trainer = ResilientTrainer(
            step_fn=step, ckpt=CheckpointManager(args.ckpt_dir, keep=2,
                                                 writer=_rank0()),
            save_every=args.save_every,
            log_fn=lambda i, m: _say(
                f"  step {i:5d} loss {m['loss']:.4f} ce {m['ce']:.4f}"))

        def batch_iter():
            i = 0
            while True:
                yield random_batch(cfg, shape, "train", seed=i,
                                   device=device)
                i += 1

        state, step_n = trainer.run(state, batch_iter(),
                                    total_steps=args.steps)
    _say(f"trained to step {step_n} on {device}")
    return state


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="capsim")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain "
                         "versions run")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--interval-size", type=int, default=10_000)
    ap.add_argument("--max-checkpoints", type=int, default=2)
    ap.add_argument("--n-benchmarks", type=int, default=8)
    ap.add_argument("--multicore", type=int, default=0, metavar="N",
                    help="train on N-core mt.* shards (per-core "
                         "Algorithm-1 slicing over the "
                         "simulate_multicore oracle); 0 = single-core")
    ap.add_argument("--peer-channels", action="store_true",
                    help="append the other cores' <CORE>-tagged register "
                         "blocks to every clip's context matrix")
    return ap.parse_args(argv)


def main(argv=None):
    """Parse the flags and train; returns the trained state."""
    args = parse_args(argv)
    if args.arch != "capsim":
        return train_lm(args)
    if args.multicore:
        return train_capsim_multicore(args)
    return train_capsim(args)


if __name__ == "__main__":
    main()
