"""The collectives that join the LM zoo's shard bodies across ranks, over
``launch/mesh.py``'s ``Mesh`` groups (the reference's ``lax.all_gather``,
``psum``, ``pmax`` and ``pmean`` inside ``shard_map``).

Each takes the mesh and a tuple of axes; over axes of total size 1 (and
on a local mesh) it returns its input untouched, so a world of one rank
computes bit for bit what the meshless path computes.  Shards are
ordered by their row-major combined coordinate over the axes.

No gradient flows through them: the zoo's data-parallel trainer
(``training/train_loop.py``) averages whole gradients after the
backward, and every collective a trainable forward reaches there runs
on values whose gradient is the rank's own (``mean_local_grad``).
Gradients through the expert-parallel and sequence-parallel collectives
(training with 'model' > 1) are ROADMAP item 6c: a tensor that requires
a gradient raises here.
"""
from __future__ import annotations

import torch


def _group(x: torch.Tensor, mesh, axes):
    if mesh is None or mesh.size(axes) == 1:
        return None
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "gradients through the expert- and sequence-parallel "
            "collectives (training with 'model' > 1) are ROADMAP item 6c")
    return mesh.group(axes)


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The shards' ``x`` concatenated along ``dim`` in shard order (the
    reference's ``all_gather(..., tiled=True)``)."""
    import torch.distributed as dist
    group = _group(x, mesh, axes)
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(axes))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum"
               ) -> torch.Tensor:
    """A new tensor: ``x`` summed (``psum``) or maxed (``pmax``) over the
    shards of ``axes``."""
    import torch.distributed as dist
    group = _group(x, mesh, axes)
    if group is None:
        return x
    out = x.clone().contiguous()
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    return out


def all_mean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``pmean``: the sum over the shards divided by their count."""
    n = 1 if mesh is None else mesh.size(axes)
    return x if n == 1 else all_reduce(x, mesh, axes) / n


def mean_local_grad(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``pmean(x)`` in value, with the gradient of the rank's own ``x``:
    a data-parallel loss built on it, averaged over the ranks with its
    gradients, then has the gradient of the global loss."""
    if mesh is None or mesh.size(axes) == 1:
        return x
    return x + (all_mean(x.detach(), mesh, axes) - x.detach())


def take_block(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``: block ``mesh.index(axes)``
    of ``mesh.size(axes)`` equal blocks (the inverse of ``all_gather``)."""
    n = 1 if mesh is None else mesh.size(axes)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * size, size)
