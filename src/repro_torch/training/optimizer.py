"""Optimizers over nested dicts of tensors (port of
``repro/training/optimizer.py``).

Each optimizer is an (init, update) pair over a parameter tree:

    state = opt.init(params)
    new_params, new_state = opt.update(grads, state, params, lr)

SGD+momentum is the paper's trainer (§VI-B: momentum 0.9, lr 1e-3);
AdamW (b2 = 0.95, weight decay 0.1) for the LM zoo; Adafactor for
memory-constrained training.  Every update does its arithmetic in f32
and casts the new parameter back to the parameter's dtype, as the
reference does; ``lr`` is a 0-d f32 tensor (``training/schedule.py``) or
a float.  A state leaf keeps its parameter's ``sharding.mark``.  Updates
build new tensors and leave their inputs as they are.
``abstract_state`` is the reference's (the state's shapes for the
dry-run, ``launch/dryrun.py``): ``init`` over ``meta`` parameters.

``tree_map``, ``tree_leaves`` and ``tree_unzip`` walk nested dicts;
``tree_leaves`` gives them in sorted key order, the order
``jax.tree_util`` gives a dict's leaves, so a sum over them (the global
gradient norm) adds in the reference's order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed.sharding import inherit_marks, mark, split_of


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts that share one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unzip(tree, i: int):
    """The ``i``-th field of a tree whose leaves are tuples."""
    if isinstance(tree, dict):
        return {k: tree_unzip(v, i) for k, v in tree.items()}
    return tree[i]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Any]

    def abstract_state(self, param_abs):
        """The state of ``param_abs`` (``meta`` tensors, marked where
        they are a rank's blocks) as ``meta`` tensors: ``init`` over
        them, which allocates nothing."""
        if any(p.device.type != "meta" for p in tree_leaves(param_abs)):
            raise ValueError("abstract_state takes meta parameters")
        return self.init(param_abs)


# ----------------------------- SGD + momentum ------------------------------ #

def sgd_momentum(momentum: float = 0.9, weight_decay: float = 0.0,
                 state_dtype: str = "float32") -> Optimizer:
    dt = getattr(torch, state_dtype)
    # the reference's Python scalars meet the state as weak types: in the
    # state's dtype (0.9 is 0.8984375 in bfloat16)
    mom, wd = (float(torch.tensor(c, dtype=dt))
               for c in (momentum, weight_decay))

    def init(params):
        return {"mu": inherit_marks(tree_map(
            lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
            params), params)}

    def update(grads, state, params, lr):
        mu = tree_map(lambda m, g: mom * m + g.to(dt), state["mu"], grads)

        def step(p, m):
            upd = m
            if weight_decay:
                upd = upd + wd * p.to(dt)
            return (p.float() - lr * upd.float()).to(p.dtype)
        return tree_map(step, params, mu), {"mu": mu}

    return Optimizer("sgdm", init, update)


# --------------------------------- AdamW ----------------------------------- #

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:

    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        dev = tree_leaves(params)[0].device
        return {"mu": inherit_marks(tree_map(z, params), params),
                "nu": inherit_marks(tree_map(z, params), params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        c = state["count"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                      state["nu"], grads)
        bc1 = 1 - b1 ** c.float()
        bc2 = 1 - b2 ** c.float()

        def step(p, m, v):
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        return (tree_map(step, params, mu, nu),
                {"mu": mu, "nu": nu, "count": c})

    return Optimizer("adamw", init, update)


# ------------------------------- Adafactor --------------------------------- #

def _mean(x: torch.Tensor, dim: int, axes, keepdim: bool = False):
    """``x.mean(dim)`` where dimension ``dim`` of the whole tensor is split
    over mesh ``axes`` into equal blocks: the blocks' means averaged."""
    m = x.mean(dim=dim, keepdim=keepdim)
    if not axes:
        return m
    from repro_torch.distributed.collectives import all_mean
    from repro_torch.distributed.sharding import current_mesh
    return all_mean(m, current_mesh(), axes)


def adafactor(decay: float = 0.99, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moment for >=2D params (row/col statistics).  A
    parameter held as a block (``sharding.mark``) has its row and column
    means, their mean and the update RMS taken over the whole tensor
    (averaged over the axes that split the reduced dimensions), and its
    statistics are the blocks of the whole tensor's."""

    def init(params):
        def make(p):
            z = dict(dtype=torch.float32, device=p.device)
            dims = split_of(p)
            if p.dim() >= 2:
                return {"vr": mark(torch.zeros(p.shape[:-1], **z),
                                   dims[:-1]),
                        "vc": mark(torch.zeros(p.shape[:-2] + p.shape[-1:],
                                               **z), dims[:-2] + dims[-1:])}
            return {"v": mark(torch.zeros(p.shape, **z), dims)}
        dev = tree_leaves(params)[0].device
        return {"v": tree_map(make, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        c = state["count"] + 1

        def step(p, g, s):
            g = g.float()
            g2 = g.square() + eps
            dims = split_of(p)
            if p.dim() >= 2:
                vr = decay * s["vr"] + (1 - decay) * _mean(g2, -1, dims[-1])
                vc = decay * s["vc"] + (1 - decay) * _mean(g2, -2, dims[-2])
                denom = torch.clamp(_mean(vr, -1, dims[-2], keepdim=True),
                                    min=eps)
                vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
                upd = g * torch.rsqrt(vhat + eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = decay * s["v"] + (1 - decay) * g2
                upd = g * torch.rsqrt(v + eps)
                new_s = {"v": v}
            sq = upd.square().mean()
            axes = tuple(a for d in dims for a in d)
            if axes:
                from repro_torch.distributed.collectives import all_mean
                from repro_torch.distributed.sharding import current_mesh
                sq = all_mean(sq, current_mesh(), axes)
            rms = torch.sqrt(sq + 1e-12)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            return (p.float() - lr * upd).to(p.dtype), new_s

        # a parameter's state is a dict: map over the parameters only
        def walk(p, g, s):
            if isinstance(p, dict):
                return {k: walk(p[k], g[k], s[k]) for k in p}
            return step(p, g, s)
        out = walk(params, grads, state["v"])
        return tree_unzip(out, 0), {"v": tree_unzip(out, 1), "count": c}

    return Optimizer("adafactor", init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgdm":
        return sgd_momentum(**kw)
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(name)
