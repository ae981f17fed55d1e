"""Gradient compression with error feedback (port of
``repro/distributed/compression.py``).

int8 per-tensor-scaled quantization:

    q = round(g / s),  s = max|g| / 127        (int8 wire format)
    e' = g - s*q                               (residual fed back next step)

The quantize->dequantize pair is applied to the gradients right before
the optimizer, so convergence is what a run that sends the int8 payload
would see.  ``torch.round`` rounds half to even, as ``jnp.round`` does,
so the codes are the reference's bit for bit.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.training.optimizer import tree_map, tree_unzip


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize(g: torch.Tensor):
    """(int8 codes, f32 scale) of one f32 tensor."""
    scale = torch.clamp(g.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads, error_fb) -> Tuple[Any, Any]:
    """Returns (effective_grads, new_error_fb)."""

    def one(g, e):
        g = g.float() + e
        q, scale = quantize(g)
        deq = q.float() * scale
        return deq, g - deq

    out = tree_map(one, grads, error_fb)
    return tree_unzip(out, 0), tree_unzip(out, 1)
