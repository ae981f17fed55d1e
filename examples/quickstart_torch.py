"""Quickstart on the PyTorch port: the CAPSim pipeline end to end
(``examples/quickstart.py``'s steps through ``repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

1. generate a synthetic benchmark (SPEC-2017 stand-in),
2. trace it functionally, time it with the O3 oracle,
3. slice the timed trace into code clips (Algorithm 1), sample them,
4. tokenize (standardization + context matrix),
5. run the attention predictor on the clips and compare against the
   oracle.

The predictor runs on the card (its attention through the flash
kernel); ``--device cpu`` runs the kernels' plain versions.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import predictor
from repro_torch.core.context import context_token_ids
from repro_torch.core.sampler import sample_clips
from repro_torch.core.slicer import slice_trace
from repro_torch.core.standardize import build_vocab, encode_clip
from repro_torch.device import resolve_device
from repro_torch.isa import funcsim, progen, timing


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a benchmark from the suite (Table II)
    bench = progen.build_benchmark("503.bwaves")
    print(f"benchmark {bench.name}: tags={bench.tags}, "
          f"{len(bench.program)} static instructions")

    # 2. functional trace + O3 oracle commit times
    state = progen.fresh_state(bench)
    trace, snaps, _ = funcsim.run(bench.program, 20_000, state=state,
                                  snapshot_every=100)
    commits = timing.simulate(trace)
    print(f"traced {len(trace)} instructions -> {commits[-1]} cycles "
          f"(IPC {len(trace)/commits[-1]:.2f})")

    # 3. slice + sample
    clips = slice_trace([e.inst for e in trace], commits, l_min=100)
    sampled, stats = sample_clips(clips, threshold=50, coef=0.1)
    print(f"sliced {stats.n_in} clips ({stats.n_groups} unique contents) "
          f"-> sampled {stats.n_out}")

    # 4. tokenize
    vocab = build_vocab()
    cfg = get_config("capsim").replace(dtype="float32")
    batch = {"clip_tokens": [], "context_tokens": [], "clip_mask": []}
    for clip in sampled[:16]:
        toks, mask = encode_clip(clip.insts, vocab, 128, cfg.clip_tokens)
        batch["clip_tokens"].append(toks)
        batch["clip_mask"].append(mask)
        snap = snaps[min(clip.start // 100, len(snaps) - 1)]
        batch["context_tokens"].append(context_token_ids(snap, vocab))
    batch = {k: torch.from_numpy(np.stack(v)).to(device)
             for k, v in batch.items()}

    # 5. predict (untrained weights here; see train_capsim_torch.py)
    params = predictor.init_params(cfg, seed=0, device=device)
    with torch.no_grad():
        pred = predictor.predict_step(params, batch, cfg).cpu().numpy()
    fact = np.array([c.time for c in sampled[:16]])
    print(f"\n  clip  predicted  oracle   (on {device})")
    for i in range(min(8, len(pred))):
        print(f"  {i:4d} {float(pred[i]):9.1f} {fact[i]:7.1f}")
    print("\n(untrained predictor — run examples/train_capsim_torch.py to "
          "fit it)")
    return {"predicted": pred, "oracle": fact}


if __name__ == "__main__":
    main()
