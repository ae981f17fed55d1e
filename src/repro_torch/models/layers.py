"""Shared building blocks: param specs, seeded init, RMSNorm.

Ports ``repro/models/layers.py:20-95``.  A ``ParamSpec`` tree describes
the parameters; ``init_from_specs`` materializes it as a nested dict of
tensors with the reference's shapes and init std.  Dense weights keep
the reference's ``(d_in, d_out)`` layout (not ``nn.Linear``'s
``(out, in)``), so parameters move between the packages unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, "
                         f"got {name!r}") from None


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    std: float = 0.0          # 0.0 -> zeros; >0 -> normal(std)
    dtype: Optional[str] = None  # override param dtype (e.g. fp32 norms)


def dense_spec(d_in: int, d_out: int, scale: float = 1.0) -> ParamSpec:
    return ParamSpec((d_in, d_out), std=scale / math.sqrt(d_in))


def specs_with_leading_stack(specs: dict, n: int) -> dict:
    """Prepend a 'layers' dimension of size n to every spec."""
    return {k: ParamSpec((n,) + s.shape, std=s.std, dtype=s.dtype)
            for k, s in specs.items()}


def init_from_specs(specs, generator: torch.Generator, param_dtype: str,
                    device: torch.device):
    """Materialize a spec tree: normal·std for std > 0, zeros otherwise.

    Draws on the CPU from ``generator`` in sorted key order, so a seed
    gives the same parameters on every device."""
    if isinstance(specs, ParamSpec):
        dt = torch_dtype(specs.dtype or param_dtype)
        if specs.std == 0.0:
            w = torch.zeros(specs.shape, dtype=torch.float32)
        else:
            w = torch.randn(specs.shape, generator=generator,
                            dtype=torch.float32) * specs.std
        return w.to(device=device, dtype=dt)
    return {k: init_from_specs(specs[k], generator, param_dtype, device)
            for k in sorted(specs)}


def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
             eps: float = 1e-6) -> torch.Tensor:
    """f32 upcast, ``x·rsqrt(mean(x²)+eps)·(1+scale)``, cast back."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(dt)
