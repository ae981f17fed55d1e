"""Post-training int8 weight quantization for inference (port of
``repro/core/quant.py``).

Weights are quantized per output channel to int8 and immediately
dequantized back to float32, so every matmul still runs in fp32 and the
model sees exactly the values an int8 deployment would see.  For a
weight of shape (..., d_out) the scale is the absmax over all axes but
the last: the reference's ``(d_in, d_out)`` layout, which the port keeps.
1-D leaves (biases, norm gains) are left untouched.
"""
from __future__ import annotations

import torch

Q_MAX = 127.0


def quantize_dequant(w: torch.Tensor) -> torch.Tensor:
    """Fake-quantize one weight to per-channel int8 and back to f32."""
    w = w.float()
    if w.dim() < 2:
        return w
    scale = w.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale * Q_MAX), -Q_MAX, Q_MAX)
    return q * (scale / Q_MAX)


def quantize_dequant_params(params) -> dict:
    """Fake-quantize every ≥2-D leaf of a nested parameter dict to int8."""
    if isinstance(params, dict):
        return {k: quantize_dequant_params(v) for k, v in params.items()}
    return quantize_dequant(params)
