"""The MAPE trainer: ``training/train_loop.make_train_step`` over
``predictor.mape_loss``, fed by ``data/dataset.batches`` over the 80%
training split of the mix's clips.

Set-up builds the one train state from the seed's weights and drives it
through its first steps by the same step and feed as the window; the
output check holds those first ``check_steps`` steps to the reference.
The window then steps the same state until it closes, and ends in a
synchronize: every clip of every step over the window's seconds.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from capsim_bench import compare, harness, inputs
from capsim_bench.drivers.service_closed_loop import arch_config
from capsim_bench.frontend import dataset as fe_dataset
from capsim_bench.reference import capsim as ref
from capsim_bench.trace import Profile


def _split(data: dict):
    """The builders' 80/10/10 split (frozen copy), training part."""
    n = data["time"].shape[0]
    ds = fe_dataset.ClipDataset(data["clip_tokens"].astype(np.int32),
                                data["context_tokens"].astype(np.int32),
                                data["clip_mask"].astype(np.float32),
                                data["time"].astype(np.float32), [""] * n)
    return fe_dataset.split_dataset(ds)[0]


def reference_batches(ds, batch: int, seed: int, count: int):
    """The first ``count`` batches of a shuffled feed: one permutation of
    the rows a pass, drawn from ``seed``, cut into whole batches."""
    rng = np.random.RandomState(seed)
    n = len(ds)
    out = []
    while len(out) < count:
        order = rng.permutation(n)
        for lo in range(0, n - batch + 1, batch):
            if len(out) < count:
                out.append(order[lo:lo + batch])
    return out


def schedule(t: dict) -> dict:
    return {k: t[k] for k in ("base_lr", "warmup_steps", "total_steps",
                              "grad_clip", "momentum")}


def run(ctx) -> dict:
    c, t, w = ctx.cell.config, ctx.cell.traffic, ctx.cell.workload
    from repro_torch.core import predictor
    from repro_torch.data import dataset as prog_dataset
    from repro_torch.training import train_loop

    dev = ctx.device
    train = _split(inputs.train_set(t, c, ctx.cache))
    if len(train) < t["batch"]:
        # the feed drops a short last batch: it would yield nothing
        raise ValueError(f"{len(train)} training clips, fewer than a batch "
                         f"of {t['batch']}")
    acfg = arch_config(c, c["train_dtype"])
    s = schedule(t)
    init = ref.make_params(c, ctx.seed, dev)
    params = ref.tree_map(lambda x: x.clone(), init)
    tcfg = train_loop.TrainConfig(
        optimizer="sgdm", base_lr=s["base_lr"],
        warmup_steps=s["warmup_steps"], total_steps=s["total_steps"],
        grad_clip=s["grad_clip"], momentum=s["momentum"])
    state = train_loop.init_train_state(params, tcfg)
    step = train_loop.make_train_step(
        lambda p, b: predictor.mape_loss(p, b, acfg), tcfg)
    feed_seed = ctx.seed % 2**32
    feed = prog_dataset.batches(train, t["batch"], seed=feed_seed,
                                epochs=10**9)

    def one(state):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(feed).items()}
        return step(state, b)

    n_check = t["check_steps"]
    losses, first_mu = [], None
    for i in range(n_check):
        state, m = one(state)
        losses.append(m["loss"])
        if i == 0:
            first_mu = state["opt"]["mu"]
    checked = state["params"]
    for _ in range(t["warm_steps"]):
        state, m = one(state)
    ctx.sync()

    setup_s = time.perf_counter() - ctx.t_start
    steps = 0
    with Profile(ctx.trace, host_ranges=True) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            state, m = one(state)
            steps += 1
        ctx.sync()
        window = time.perf_counter() - t0
    last_loss = float(m["loss"])
    peak = ctx.device_info()
    prog = {"losses": [float(x) for x in losses],
            "grad": compare.leaf_norms(ref.leaves(first_mu)),
            "change": compare.leaf_norms(
                (k, a - b) for (k, a), (_, b) in zip(ref.leaves(checked),
                                                     ref.leaves(init)))}
    del state, m, first_mu, checked, step, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rec = {"setup_s": setup_s, "window_s": window, "steps": steps,
           "batch": t["batch"], "attempted": steps,
           "failed": 0 if math.isfinite(last_loss) else 1,
           "trace": prof.trace, "device": peak}

    # the output check: the reference's own feed and steps from the init
    idx = reference_batches(train, t["batch"], feed_seed, n_check)
    bts = [{"clip_tokens": torch.from_numpy(train.clip_tokens[i]).to(dev),
            "context_tokens": torch.from_numpy(
                train.context_tokens[i]).to(dev),
            "clip_mask": torch.from_numpy(train.clip_mask[i]).to(dev),
            "time": torch.from_numpy(train.time[i]).to(dev)} for i in idx]

    def reference(tf32=False, rows=None):
        with harness.tf32(tf32):
            ls, g, p = ref.sgdm_steps(init, bts, c, s, rows=rows)
        return {"losses": ls, "grad": compare.leaf_norms(ref.leaves(g)),
                "change": compare.leaf_norms(
                    (k, a - b) for (k, a), (_, b) in zip(ref.leaves(p),
                                                         ref.leaves(init)))}
    want = reference()
    r = compare.train_readings(prog, want)
    lims = w["limits"]
    rec["checks"] = [{"name": k, "value": r[k], "limit": lims[k]}
                     for k in ("loss_gap", "grad_gap", "change_gap",
                               "change_worst_gap")]
    rec["correct"] = (rec["failed"] == 0
                      and all(ch["value"] <= ch["limit"]
                              for ch in rec["checks"]))
    if ctx.control:
        tf = compare.train_readings(reference(tf32=True), want)
        half = compare.train_readings(
            reference(rows=t["batch"] // 2), want)
        rec["control"] = {"program_f32": r, "reference_tf32": tf,
                          "fault_half_batch": half}
    return rec
