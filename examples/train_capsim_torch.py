"""End to end on the PyTorch port: build the clip dataset, train
the CAPSim predictor, report validation MAPE, checkpoint/resume
(``examples/train_capsim.py``'s steps through ``repro_torch``).

    PYTHONPATH=src python examples/train_capsim_torch.py [--steps 200] [--fast] [--device cpu]

Paper recipe (§VI-B): SGD momentum 0.9, lr 1e-3, MAPE loss, 80/10/10
split.  ``--fast`` shrinks the model and data; the default is the
paper-exact E=128 / 4+4-layer model (activation rematerialization on,
as the config's default).  Training runs on the card, the attention's
forward through the flash kernel; ``--device cpu`` runs the kernels'
plain versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import predictor
from repro_torch.core.standardize import build_vocab
from repro_torch.data.dataset import (BuildConfig, batches, build_dataset,
                                      split_dataset)
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import ResilientTrainer
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step)


def _on(batch, device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def evaluate(params, cfg, ds, batch_size, device) -> float:
    errs = []
    n = len(ds)
    bs = max(1, min(batch_size, n))
    for off in range(0, n, bs):
        sub = ds.select(np.arange(off, min(off + bs, n)))
        b = _on({"clip_tokens": sub.clip_tokens,
                 "context_tokens": sub.context_tokens,
                 "clip_mask": sub.clip_mask}, device)
        with torch.no_grad():
            pred = predictor.predict_step(params, b, cfg).cpu().numpy()
        fact = np.maximum(sub.time, 1.0)
        errs.extend(np.abs(pred - fact) / fact)
    return float(np.mean(errs)) if errs else float("nan")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--fast", action="store_true",
                    help="reduced model + data (CI-sized)")
    ap.add_argument("--ckpt-dir", default="results/ckpt_capsim_torch")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    vocab = build_vocab()
    cfg = get_config("capsim").replace(dtype="float32")
    bcfg = BuildConfig(interval_size=10_000, warmup=1_000,
                       max_checkpoints=2, threshold=50, coef=0.1)
    bench_names = ["503.bwaves", "505.mcf", "525.x264", "541.leela",
                   "520.omnetpp", "508.namd"]
    if args.fast:
        cfg = cfg.replace(d_model=64, head_dim=16, d_ff=256)
        bcfg = BuildConfig(interval_size=5_000, warmup=500,
                           max_checkpoints=1, threshold=50, coef=0.1,
                           l_clip=64, l_min=50)
        bench_names = bench_names[:3]

    print("building clip dataset ...")
    ds = build_dataset(bench_names, bcfg, vocab, verbose=True)
    train, val, test = split_dataset(ds)
    print(f"clips: train={len(train)} val={len(val)} test={len(test)}")

    tcfg = TrainConfig(optimizer="sgdm", base_lr=1e-3, momentum=0.9,
                       warmup_steps=max(1, args.steps // 10),
                       total_steps=args.steps)
    params = predictor.init_params(cfg, seed=0, device=device)
    state = init_train_state(params, tcfg)
    step = make_train_step(lambda p, b: predictor.mape_loss(p, b, cfg),
                           tcfg)

    trainer = ResilientTrainer(
        step_fn=lambda s, b: step(s, _on(b, device)),
        ckpt=CheckpointManager(args.ckpt_dir, keep=2),
        save_every=max(50, args.steps // 4),
        log_fn=lambda i, m: print(
            f"  step {i:5d} mape {float(m['loss']):.4f} "
            f"lr {float(m['lr']):.2e}"))
    trainer.install_signal_handler()

    t0 = time.time()
    state, n = trainer.run(state, batches(train, args.batch_size,
                                          epochs=100_000),
                           total_steps=args.steps)
    print(f"trained {n} steps in {time.time()-t0:.0f}s on {device}")

    out = {"steps": n}
    for name, d in (("val", val), ("test", test)):
        mape = evaluate(state["params"], cfg, d, args.batch_size, device)
        out[name] = mape
        print(f"{name} MAPE {mape:.4f}  (accuracy {100*(1-mape):.1f}%)")
    return out


if __name__ == "__main__":
    main()
