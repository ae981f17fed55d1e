"""Plain-PyTorch oracle for flash attention (ports
``repro/kernels/flash_attention/ref.py::attention_ref``).

Materializes the full (Sq, Skv) score matrix with an f32 softmax over
-inf-masked scores: the mathematically obvious implementation, written
independently of the kernel's max-shift/normalize order, so tests can
hold both the kernel and its plain version against it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, window: int = 0,
                  kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, H, D); kv_mask: (B, Skv) 1=valid.
    Returns (B, Sq, H, D) in q.dtype; fully masked rows are zeros."""
    Sq, D = q.shape[1], q.shape[3]
    Skv = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos >= kpos)
        if window > 0:
            mask = mask & (qpos - kpos < window)
    m = mask[None, None]
    if kv_mask is not None:
        m = m & (kv_mask[:, None, None, :] > 0)
    s = s.masked_fill(~m, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(m.any(-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
