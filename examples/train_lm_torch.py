"""Train an assigned-architecture LM on synthetic tokens on the PyTorch
port (``examples/train_lm.py``'s steps through ``repro_torch``).

    PYTHONPATH=src python examples/train_lm_torch.py --arch olmo-1b --steps 30 [--device cpu]

Uses the smoke-scale config of the requested architecture (the full
configs are what the dry-run, ``python -m repro_torch.launch.dryrun``,
measures).  The shared runtime: logical-axis sharding rules, AdamW,
gradient clipping, checkpoint/restart, as the launcher
(``repro_torch/launch/train.py``).  Training runs on the card, attention
through the flash kernel and Mamba2's scan through the SSD kernel;
``--device cpu`` runs their plain versions.
"""
import argparse
import time

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import ResilientTrainer
from repro_torch.distributed.sharding import (LOGICAL_RULES_TRAIN,
                                              use_mesh_and_rules)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.specs import random_batch
from repro_torch.models import transformer as tfm
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="results/ckpt_lm_torch")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    shape = ShapeConfig("train", args.seq_len, args.batch_size, "train")
    tcfg = TrainConfig(optimizer="adamw", base_lr=3e-4,
                       warmup_steps=max(1, args.steps // 10),
                       total_steps=args.steps)

    losses = []
    with use_mesh_and_rules(make_test_mesh(device), LOGICAL_RULES_TRAIN):
        params = tfm.init_params(cfg, seed=0, device=device)
        n = sum(p.numel() for p in tree_leaves(params))
        print(f"{args.arch} (smoke): {n/1e6:.1f}M params, "
              f"batch {args.batch_size} x seq {args.seq_len} on {device}")
        state = init_train_state(params, tcfg)
        step = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), tcfg)

        def log(i, m):
            losses.append(float(m["loss"]))
            print(f"  step {i:4d} loss {float(m['loss']):.4f} "
                  f"ce {float(m['ce']):.4f} "
                  f"gnorm {float(m['grad_norm']):.2f}")
        trainer = ResilientTrainer(
            step_fn=step, ckpt=CheckpointManager(args.ckpt_dir, keep=2),
            save_every=max(10, args.steps // 2), log_every=5, log_fn=log)

        def batch_iter():
            i = 0
            while True:
                yield random_batch(cfg, shape, "train", seed=i,
                                   device=device)
                i += 1

        t0 = time.time()
        state, n_steps = trainer.run(state, batch_iter(),
                                     total_steps=args.steps)
        print(f"{n_steps} steps in {time.time()-t0:.0f}s "
              f"({(time.time()-t0)/max(n_steps,1):.2f} s/step)")
    return {"steps": n_steps, "losses": losses}


if __name__ == "__main__":
    main()
