"""The LM trainer: ``training/train_loop.make_train_step`` over
``models/transformer.loss_fn`` with AdamW, as ``launch/train.py::
train_lm`` sets it up, on token ids drawn uniform over the vocabulary.

The configuration file gives the model under its published keys; this
driver builds the program's ``ArchConfig`` from them (``arch_config``).
Set-up draws the weights from the seed with the reference's
``make_params`` (the program's tree layout), feeds them to the program, and
drives the one train state through its first ``check_steps`` steps (the
output check's) and ``warm_steps`` more, by the same step and the same
feed as the window: each step a fresh (batch, seq_len + 1) draw of ids
from one generator on the card, seeded by ``--seed``, whose first
seq_len ids are the inputs and last seq_len the next-token labels.  The
window then steps the same state until it closes, and ends in a
synchronize: every sequence of every step over the window's seconds (a
"clip" of ``train_clips_per_s`` is one sequence).

The output check runs after the window, with the program's state freed.
The program records its expert choice in every MoE layer (``moe.
recorded_choices``) in the check's forwards: one at the initial weights
over the first check batch, and each check step's.  The reference
(``reference/nemotron_h.py``, float32, TF32 off) replays that choice
(``ref.Routes``) and takes AdamW steps from the same weights, drawn
again from the seed, on the same check batches.  A flipped choice moves
a token by a whole expert's share, so an unreplayed reference would
measure the flips near ties and not the rounding of the products; the
flips are read apart, as ``route_gap``: the share of the program's
(token, slot) pairs outside the reference's own top-k.  Then
``compare.train_readings`` holds the program's first steps to the
reference's: by the worst leaf the norms of the first clipped gradient
(AdamW's first moment after one step, 0.1 times it on both sides), and
by the median and the worst leaf the norms of the parameters' change.
``grad_diff_gap``: by the median leaf, the norm of the difference of the
first clipped gradients (the program's copied to the host after its
first step) over the reference's; its worst leaf is read as
``grad_diff_worst``.  ``logit_gap``: the program's logits at the
initial weights over the first check batch's last ``LOGIT_ROWS``
positions of each sequence, the path the loss takes, against the
reference's, as the norm of their difference over the reference's.
``CHECKS`` are held to the workload file's limits; the losses and
``grad_diff_worst`` are read and not held to a limit.  The control (``control.py``) puts the reference in the
program's place with its products' operands in float8 e4m3 (one
precision below the configuration's bfloat16), choosing for itself,
against the float32 reference replaying its choice; and the planted
fault of a batch of which half the sequences are left out, against the
reference that replays the program's choice.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from capsim_bench import compare, harness
from capsim_bench.drivers.service_closed_loop import (_counters,
                                                      counter_deltas)
from capsim_bench.reference import nemotron_h as ref
from capsim_bench.trace import Profile

# positions at the end of each sequence whose logits the check compares
LOGIT_ROWS = 256
CHECKS = ("logit_gap", "grad_gap", "change_gap", "change_worst_gap",
          "route_gap", "grad_diff_gap")


def arch_config(c: dict):
    """The program's config of the configuration file: every size from
    its published keys and the deployment's share of the experts."""
    from repro_torch.configs import ArchConfig
    dep = c["deployment"]
    if c["mlp_hidden_act"] != "relu2":
        raise ValueError(f"activation {c['mlp_hidden_act']!r}")
    return ArchConfig(
        name=c["name"], family="hybrid", num_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["moe_intermediate_size"], vocab_size=c["vocab_size"],
        num_experts=dep["router_outputs"],
        experts_per_token=c["num_experts_per_tok"],
        capacity_factor=c["capacity_factor"], router="sigmoid",
        routed_scaling=c["routed_scaling_factor"],
        shared_expert_d_ff=c["moe_shared_expert_intermediate_size"],
        experts_held=c["n_routed_experts"], expert_shard=dep["expert_shard"],
        ssm_state=c["ssm_state_size"], ssm_head_dim=c["mamba_head_dim"],
        ssm_num_heads=c["mamba_num_heads"], ssm_groups=c["n_groups"],
        ssm_conv_width=c["conv_kernel"], ssm_chunk=c["chunk_size"],
        ssm_conv_bias=c["use_conv_bias"],
        layer_pattern=c["hybrid_override_pattern"], rope=False,
        activation="squared_relu", norm_eps=c["layer_norm_epsilon"],
        tie_embeddings=c["tie_word_embeddings"], dtype=c["dtype"],
        param_dtype=c["param_dtype"], remat=c["remat"])


def reference_config(c: dict) -> dict:
    """The configuration file's keys with the deployment's, as the
    reference reads them."""
    dep = c["deployment"]
    return dict(c, router_outputs=dep["router_outputs"],
                expert_shard=dep["expert_shard"])


def host(mu: dict) -> dict:
    """{path: float32 copy on the host}."""
    return {k: v.detach().float().cpu() for k, v in mu.items()}


def schedule(t: dict) -> dict:
    return {k: t[k] for k in ("base_lr", "warmup_steps", "total_steps",
                              "grad_clip", "weight_decay")}


def _batch(ids: torch.Tensor) -> dict:
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:],
            "loss_mask": torch.ones(ids.shape[0], ids.shape[1] - 1,
                                    device=ids.device)}


def run(ctx) -> dict:
    c, t, w = ctx.cell.config, ctx.cell.traffic, ctx.cell.workload
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.training import train_loop

    dev = ctx.device
    cfg = arch_config(c)
    rc = reference_config(c)
    n_moe = ref.pattern(rc).count("E")
    s = schedule(t)
    B, S = t["batch"], t["seq_len"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)

    def draw():
        return torch.randint(0, c["vocab_size"], (B, S + 1), generator=gen,
                             device=dev)

    params = ref.make_params(rc, ctx.seed, dev)
    init = {k: v.clone() for k, v in ref.leaves(params)}
    tcfg = train_loop.TrainConfig(
        optimizer="adamw", base_lr=s["base_lr"],
        warmup_steps=s["warmup_steps"], total_steps=s["total_steps"],
        grad_clip=s["grad_clip"], weight_decay=s["weight_decay"])
    state = train_loop.init_train_state(params, tcfg)
    del params
    step = train_loop.make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg),
                                      tcfg)

    def choices(taps):
        # the forward's routings; a remat recompute repeats them after
        if len(taps) not in (n_moe, 2 * n_moe):
            raise RuntimeError(f"{len(taps)} routings, {n_moe} MoE layers")
        return [x.cpu() for x in taps[:n_moe]]

    checks = [draw() for _ in range(t["check_steps"])]
    with torch.no_grad(), moe.recorded_choices() as taps:
        logits = tfm.forward(state["params"], _batch(checks[0]), cfg,
                             "train")[0]
        prog_logits = logits[:, -LOGIT_ROWS:].float().cpu()
        logit_choice = choices(taps)
    del logits, taps
    losses, grad, step_choice = [], None, []
    for i in range(t["check_steps"]):
        with moe.recorded_choices() as taps:
            state, m = step(state, _batch(checks[i]))
        step_choice.append(choices(taps))
        del taps
        losses.append(m["loss"])
        if i == 0:
            grad = compare.leaf_norms(ref.leaves(state["opt"]["mu"]))
            prog_mu = host(dict(ref.leaves(state["opt"]["mu"])))
    change = compare.leaf_norms(
        (k, a.float() - init[k].float())
        for k, a in ref.leaves(state["params"]))
    del init
    for _ in range(t["warm_steps"]):
        state, m = step(state, _batch(draw()))
    ctx.sync()

    setup_s = time.perf_counter() - ctx.t_start
    before = _counters()
    steps = 0
    with Profile(ctx.trace, host_ranges=True) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            state, m = step(state, _batch(draw()))
            steps += 1
        ctx.sync()
        window = time.perf_counter() - t0
    deltas = counter_deltas(before, _counters())
    last_loss = float(m["loss"])
    peak = ctx.device_info()
    prog = {"losses": [float(x) for x in losses], "grad": grad,
            "change": change, "mu": prog_mu}
    del prog_mu
    del state, m, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rec = {"setup_s": setup_s, "window_s": window, "steps": steps,
           "batch": B, "attempted": steps,
           "failed": 0 if math.isfinite(last_loss) else 1,
           "counters": deltas, "trace": prof.trace, "device": peak}

    # the output check: the reference's AdamW steps from the same weights
    init = ref.make_params(rc, ctx.seed, dev)
    bts = [_batch(ids) for ids in checks]

    def reference(quant=None, rows=None, force=None, against=None,
                  candidate=False, keep=False):
        """AdamW steps; ``force``: a choice per step to replay (None: the
        reference chooses); ``against``: the candidate's first moment on
        the host, read against this run's (or, ``candidate``, this run's
        against it); ``keep``: keep the first moment on the host."""
        routes = [ref.Routes(f) for f in force or [None] * len(bts)]
        out = {}

        def first(mu):
            if against is not None:
                out.update(grad_diff(mu, against) if candidate
                           else grad_diff(against, mu))
            if keep:
                out["mu"] = host(mu)
        with harness.tf32(False):
            ls, g, after = ref.adamw_steps(init, bts, rc, s, quant=quant,
                                           rows=rows, remat=True,
                                           routes=routes, first_moment=first)
        moved = compare.leaf_norms(
            (k, a.float() - b.float())
            for (k, a), (_, b) in zip(ref.leaves(after), ref.leaves(init)))
        return dict(out, losses=ls, grad=g, change=moved, routes=routes)

    def grad_diff(got, want):
        gaps = {}
        for k in want:
            w = want[k].to(dev)
            if float(w.norm()) > 0:
                gaps[k] = float((got[k].to(dev) - w).norm() / w.norm())
        worst = max(gaps, key=gaps.get)
        return {"grad_diff_gap": statistics.median(gaps.values()),
                "grad_diff_worst": gaps[worst], "grad_diff_leaf": worst}

    def logits(quant=None, force=None):
        routes = ref.Routes(force)
        with torch.no_grad(), harness.tf32(False):
            out = ref.forward(init, bts[0]["tokens"], rc, quant,
                              routes=routes)[:, -LOGIT_ROWS:].contiguous()
        return out, routes

    def readings(got, got_logits, force_steps, force_logits, keep=False):
        """``got`` against the float32 reference replaying its choice."""
        want = reference(force=force_steps, against=got.pop("mu"), keep=keep)
        want_logits, lr = logits(force=force_logits)
        out = compare.train_readings(got, want)
        out.update({k: want[k] for k in ("grad_diff_gap", "grad_diff_worst",
                                         "grad_diff_leaf")})
        out["logit_gap"] = float((got_logits.to(dev) - want_logits).norm()
                                 / want_logits.norm())
        out["route_gap"] = ref.differ_share([lr] + want["routes"])
        return out, want
    r, want = readings(prog, prog_logits, step_choice, logit_choice,
                       keep=ctx.control)
    lims = w["limits"]
    rec["checks"] = [{"name": k, "value": r[k], "limit": lims[k]}
                     for k in CHECKS]
    rec["correct"] = (rec["failed"] == 0
                      and all(ch["value"] <= ch["limit"]
                              for ch in rec["checks"]))
    if ctx.control:
        got = reference(quant="fp8", keep=True)
        got_logits, lr = logits("fp8")
        fp8, _ = readings(got, got_logits,
                          [x.choices() for x in got["routes"]], lr.choices())
        got = reference(rows=B // 2, against=want.pop("mu"), candidate=True)
        half = compare.train_readings(got, want)
        half.update({k: got[k] for k in ("grad_diff_gap", "grad_diff_worst",
                                         "grad_diff_leaf")})
        rec["control"] = {"program_bf16": r, "reference_fp8": fp8,
                          "fault_half_batch": half}
    return rec
