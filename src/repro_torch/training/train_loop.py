"""Train-step factory: gradient accumulation, clipping, compression,
schedules (port of ``repro/training/train_loop.py``).

    state = {"params", "opt", "step", "err_fb"?}
    new_state, metrics = train_step(state, batch)

``loss_fn(params, batch) -> (scalar, aux dict)``.  The gradients come
from ``torch.autograd.grad`` over the parameter leaves; a step builds a
new state and leaves the old one as it is.  The parameters are plain
tensors (``requires_grad`` off): the step takes grad-enabled views of
them.  Microbatches run one after another, each gradient added to the
sum in ``accum_dtype``; the aux sums take whatever keys the loss returns.
The reference seeds its accumulation with the LM zoo's keys (``ce``,
``lb``, ``z``), so there a loss with other aux keys, such as
``mape_loss``'s ``mape``, fails with ``microbatches > 1``; where the
reference runs, the two agree.  ``metrics`` are 0-d tensors.

A step marks its parts for ``torch.profiler`` with ``record_function``
ranges: ``train/forward`` (the loss), ``train/backward`` (the gradients;
the autograd engine launches their kernels from its own thread, outside
this range) and ``train/update`` (clipping, compression, the schedule
and the optimizer).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.distributed.compression import (compress_decompress,
                                                 init_error_feedback)
from repro_torch.training.optimizer import (Optimizer, get_optimizer,
                                            tree_leaves, tree_map)
from repro_torch.training.schedule import constant, warmup_cosine


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "sgdm"          # paper §VI-B: SGD momentum 0.9
    base_lr: float = 1e-3
    warmup_steps: int = 0
    total_steps: int = 1000
    grad_clip: float = 1.0
    microbatches: int = 1
    compress_grads: bool = False
    momentum: float = 0.9
    weight_decay: float = 0.0
    accum_dtype: str = "float32"     # microbatch gradient accumulator
    opt_state_dtype: str = "float32"  # sgdm momentum dtype

    def make_optimizer(self) -> Optimizer:
        if self.optimizer == "sgdm":
            return get_optimizer("sgdm", momentum=self.momentum,
                                 weight_decay=self.weight_decay,
                                 state_dtype=self.opt_state_dtype)
        if self.optimizer == "adamw":
            return get_optimizer("adamw", weight_decay=self.weight_decay)
        return get_optimizer(self.optimizer)

    def make_schedule(self) -> Callable:
        if self.warmup_steps or self.total_steps:
            return warmup_cosine(self.base_lr, self.warmup_steps,
                                 self.total_steps)
        return constant(self.base_lr)


def init_train_state(params, tcfg: TrainConfig) -> dict:
    opt = tcfg.make_optimizer()
    dev = tree_leaves(params)[0].device
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if tcfg.compress_grads:
        state["err_fb"] = init_error_feedback(params)
    return state


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(l.float().square().sum()
                          for l in tree_leaves(tree)))


def _clip_by_global_norm(grads, max_norm):
    gn = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    # scaled in each gradient's own dtype, as the reference
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def value_and_grad(loss_fn: Callable, params, batch):
    """((loss, aux), grads): the loss and its aux detached, and one
    gradient per parameter leaf (zeros for a leaf the loss does not
    reach, as JAX gives)."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with record_function("train/forward"):
            loss, aux = loss_fn(live, batch)
        with record_function("train/backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(p): g for p, g in zip(leaves, grads)}
    grads = tree_map(lambda p: torch.zeros_like(p) if by_leaf[id(p)] is None
                     else by_leaf[id(p)], live)
    return (loss.detach(), tree_map(lambda a: a.detach(), aux)), grads


def _split(batch, n: int) -> list:
    """A batch as ``n`` microbatches along the leading axis."""
    def check(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"microbatches {n}")
        return x.chunk(n)
    parts = {k: check(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_train_step(loss_fn: Callable, tcfg: TrainConfig):
    """loss_fn(params, batch) -> (scalar, aux dict)."""
    opt = tcfg.make_optimizer()
    sched = tcfg.make_schedule()
    acc_dt = getattr(torch, tcfg.accum_dtype)

    def microbatched_grads(params, batch):
        if tcfg.microbatches <= 1:
            (loss, aux), grads = value_and_grad(loss_fn, params, batch)
            return loss, aux, grads
        n = tcfg.microbatches
        loss_sum = aux_sum = gsum = None
        for mbatch in _split(batch, n):
            (loss, aux), grads = value_and_grad(loss_fn, params, mbatch)
            if gsum is None:
                gsum = tree_map(lambda g: torch.zeros(
                    g.shape, dtype=acc_dt, device=g.device), grads)
                aux_sum = tree_map(torch.zeros_like, aux)
                loss_sum = torch.zeros_like(loss)
            gsum = tree_map(lambda a, g: a + g.to(acc_dt), gsum, grads)
            aux_sum = tree_map(lambda a, b: a + b, aux_sum, aux)
            loss_sum = loss_sum + loss
        inv = 1.0 / n
        return (loss_sum * inv, tree_map(lambda a: a * inv, aux_sum),
                tree_map(lambda g: g * inv, gsum))

    def train_step(state, batch):
        params = state["params"]
        loss, aux, grads = microbatched_grads(params, batch)
        new_state = dict(state)
        with record_function("train/update"):
            grads, gnorm = _clip_by_global_norm(grads, tcfg.grad_clip)
            if tcfg.compress_grads:
                grads, new_state["err_fb"] = compress_decompress(
                    grads, state["err_fb"])
            lr = sched(state["step"])
            with torch.no_grad():
                new_params, new_opt = opt.update(grads, state["opt"],
                                                 params, lr)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        new_state["step"] = state["step"] + 1
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, **aux}
        return new_state, metrics

    return train_step
