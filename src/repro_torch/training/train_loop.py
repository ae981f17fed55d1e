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

A step marks its parts with spans (``obs.span``: a registry series, and
a ``torch.profiler`` range while a profiler records): ``train/forward``
(the loss), ``train/backward`` (the gradients; the autograd engine
launches their kernels from its own thread, outside this range) and
``train/update`` (clipping, compression, the schedule and the
optimizer).

Under a mesh (``sharding.use_mesh_and_rules``), the step is given the
global batch on every rank and takes the rank's rows
(``data/dataset.shard_range`` of the leading axis) over the ``batch``
rule's mesh axes, the loss running under that ``Layout``; where those
axes do not divide the batch, the whole batch runs on every rank, as
``shard_logical`` drops the constraint.  A parameter is whole on the
rank or its block (``sharding.mark`` says which axes split it: GSPMD's
FSDP rows and tensor- and expert-parallel blocks, 'model' > 1 included).
Each rank's backward runs through the collectives' adjoints
(``distributed/collectives.py``), so it gives its share of the gradient
of the sum of the ranks' losses: each gradient is summed over the
ranks that hold the same block (the mesh axes that do not split the
leaf; an FSDP leaf's gather has already summed its rows' shares over
the axes that split it) and divided by the world size, which makes it
the gradient of the mean of the ranks' losses, equal on every holder.
That is done before clipping and compression, in the reference's
order; the global norm, the int8 scale and Adafactor's statistics
reduce over each leaf's blocks (``split_axes``), so every rank takes the
reference's step on its blocks.  The loss and aux are averaged over the
data-parallel ranks.  The new state keeps the old one's marks.  A world
of one rank runs the single-device step unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.compression import (compress_decompress,
                                                 init_error_feedback)
from repro_torch.distributed.sharding import (Layout, axis_rules, current_mesh,
                                              entry_axes, fit_spec,
                                              inherit_marks, split_axes,
                                              use_layout)
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
    """The state of ``params`` (marked blocks or whole leaves): optimizer
    and error-feedback leaves laid out as their parameters."""
    opt = tcfg.make_optimizer()
    dev = tree_leaves(params)[0].device
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if tcfg.compress_grads:
        state["err_fb"] = inherit_marks(init_error_feedback(params), params)
    return state


def abstract_train_state(param_abs, tcfg: TrainConfig) -> dict:
    """``init_train_state`` over ``meta`` parameters (the reference's
    ``abstract_train_state``): every leaf a meta tensor, a rank's
    blocks where the parameters are."""
    opt = tcfg.make_optimizer()
    state = {"params": param_abs, "opt": opt.abstract_state(param_abs),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    if tcfg.compress_grads:
        state["err_fb"] = inherit_marks(init_error_feedback(param_abs),
                                        param_abs)
    return state


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over the leaves in sorted order; a
    block (``sharding.mark``) has its sum added over the axes that split
    it, so it counts once, as a whole leaf does."""
    mesh = current_mesh()
    return torch.sqrt(sum(
        coll.all_reduce(l.float().square().sum(), mesh, split_axes(l))
        for l in tree_leaves(tree)))


def _clip_by_global_norm(grads, max_norm):
    """(the gradients scaled to a global norm of at most ``max_norm``,
    keeping their marks; the global norm)."""
    gn = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    # scaled in each gradient's own dtype, as the reference
    return inherit_marks(tree_map(lambda g: g * scale.to(g.dtype), grads),
                         grads), gn


def value_and_grad(loss_fn: Callable, params, batch):
    """((loss, aux), grads): the loss and its aux detached, and one
    gradient per parameter leaf (zeros for a leaf the loss does not
    reach, as JAX gives).  On a mesh of more than one rank the gathered
    parameters are saved as their blocks (``collectives.regather_saved``)."""
    mesh = current_mesh()
    regather = (coll.regather_saved() if mesh is not None
                and mesh.size(mesh.axis_names) > 1
                else contextlib.nullcontext())
    with torch.enable_grad(), regather:
        live = inherit_marks(
            tree_map(lambda p: p.detach().requires_grad_(True), params),
            params)
        leaves = tree_leaves(live)
        with obs.span("train/forward"):
            loss, aux = loss_fn(live, batch)
        with obs.span("train/backward"):
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


def data_axes(mesh, batch_size: int) -> tuple:
    """The mesh axes a global batch of ``batch_size`` rows splits over:
    the active ``batch`` rule's, fitted to the size (() when they do not
    divide it, or split nothing)."""
    if mesh is None:
        return ()
    axes = entry_axes(fit_spec(axis_rules(("batch",), mesh=mesh),
                               (batch_size,), mesh)[0])
    return axes if mesh.size(axes) > 1 else ()


def _batch_dim(key: str, x) -> int:
    """The batch axis of a batch entry: M-RoPE's (3, B, S) positions
    carry it second, every other entry first."""
    return 1 if key == "positions" and x.dim() == 3 else 0


def batch_size(batch: dict) -> int:
    k, v = next(iter(batch.items()))
    return v.shape[_batch_dim(k, v)]


def rank_rows(batch: dict, mesh, axes: tuple) -> dict:
    """The rank's rows of every array of a global batch: its
    ``shard_range`` of the batch axis over ``axes``."""
    from repro_torch.data.dataset import shard_range
    if not axes:
        return batch
    out = {}
    for k, v in batch.items():
        dim = _batch_dim(k, v)
        lo, hi = shard_range(v.shape[dim], mesh.index(axes),
                             mesh.size(axes))
        out[k] = v.narrow(dim, lo, hi - lo)
    return out


def make_grad_fn(loss_fn: Callable, tcfg: TrainConfig):
    """(params, global batch) -> (loss, aux, grads): the rank's rows,
    microbatched, then averaged over the data-parallel ranks (the module
    docstring); one device's without a mesh."""
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

    def grad_fn(params, batch):
        mesh = current_mesh()
        axes = data_axes(mesh, batch_size(batch))
        with use_layout(Layout(batch=axes)):
            loss, aux, grads = microbatched_grads(
                params, rank_rows(batch, mesh, axes))
        world = 1 if mesh is None else mesh.size(mesh.axis_names)
        if world > 1:
            grads = tree_map(lambda g, p: _holders_sum(g, p, mesh) / world,
                             grads, params)
        if axes:
            loss = coll.all_mean(loss, mesh, axes)
            aux = tree_map(lambda a: coll.all_mean(a, mesh, axes), aux)
        return loss, aux, grads

    return grad_fn


def _holders_sum(g: torch.Tensor, p: torch.Tensor, mesh) -> torch.Tensor:
    """Gradient ``g`` of parameter ``p`` summed over the ranks that hold
    the same block of ``p``: the mesh axes (of size > 1) that do not
    split it."""
    axes = tuple(a for a in mesh.axis_names
                 if mesh.size(a) > 1 and a not in split_axes(p))
    return coll.all_reduce(g, mesh, axes)


def make_train_step(loss_fn: Callable, tcfg: TrainConfig):
    """loss_fn(params, batch) -> (scalar, aux dict).  Under a mesh the
    step is data-parallel (the module docstring)."""
    opt = tcfg.make_optimizer()
    sched = tcfg.make_schedule()
    grad_fn = make_grad_fn(loss_fn, tcfg)

    def train_step(state, batch):
        params = state["params"]
        loss, aux, grads = grad_fn(params, batch)
        new_state = dict(state)
        with obs.span("train/update"):
            grads, gnorm = _clip_by_global_norm(
                inherit_marks(grads, params), tcfg.grad_clip)
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
        return inherit_marks(new_state, state), metrics

    return train_step
