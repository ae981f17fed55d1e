"""Gradient compression with error feedback (port of
``repro/distributed/compression.py``).

int8 per-tensor-scaled quantization:

    q = round(g / s),  s = max|g| / 127        (int8 wire format)
    e' = g - s*q                               (residual fed back next step)

The quantize->dequantize pair is applied to the gradients right before
the optimizer, so convergence is what a run that sends the int8 payload
would see.  ``torch.round`` rounds half to even, as ``jnp.round`` does,
so the codes are the reference's bit for bit.  A gradient held as a
block (marked by ``sharding.mark``) is scaled by the whole tensor's
``max|g|``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.training.optimizer import tree_map, tree_unzip


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize(g: torch.Tensor, axes, mesh):
    """(int8 codes, f32 scale) of one f32 tensor; where ``g`` is a block
    of a tensor split over mesh ``axes``, ``max|g|`` is the whole
    tensor's (a ``pmax`` over the blocks)."""
    from repro_torch.distributed.collectives import all_reduce
    scale = torch.clamp(all_reduce(g.abs().max(), mesh, axes, "max")
                        / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads, error_fb) -> Tuple[Any, Any]:
    """Returns (effective_grads, new_error_fb); a marked gradient's
    scale is its whole tensor's."""
    from repro_torch.distributed.sharding import current_mesh, split_axes
    mesh = current_mesh()

    def one(g, e):
        x = g.float() + e
        q, scale = quantize(x, split_axes(g), mesh)
        deq = q.float() * scale
        return deq, x - deq

    out = tree_map(one, grads, error_fb)
    return tree_unzip(out, 0), tree_unzip(out, 1)
