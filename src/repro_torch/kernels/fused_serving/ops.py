"""Weighted attention: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/fused_serving/ops.py::weighted_attention`` with
``impl="pallas"`` (the Pallas kernel ``_wa_kernel``), not the clamped XLA
twin: the row max runs over every in-range key, zero-weight keys
included, and the weight multiplies the max-shifted exponential,
``Σ w·e^{s-m}·v / Σ w·e^{s-m}``.  A row whose keys all weigh 0 outputs
zeros.  Layout: q (B, Sq, H, D), k/v (B, Skv, H, D), kv_weight (B, Skv)
f32.  Inference only.

``weighted_attention`` launches ``csrc/weighted_attention.cu`` (flash
attention's body with the weight, ``csrc/flash_attention.cuh``) for CUDA
tensors and runs ``weighted_attention_plain`` for CPU tensors.  Like
flash attention's, the kernel copies q/k/v rows 16 bytes at a time: each
must start on 16 bytes and step by multiples of 16 bytes per batch and
row, or the wrapper raises ``ValueError``; the fused step's split QKV
views pass.  Head dims as flash attention's, 112 zero-padded to 128.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ops import (ARG_TYPES,
                                                     check_aligned,
                                                     check_attention_args,
                                                     current_stream,
                                                     launch_args,
                                                     pad_head_dim,
                                                     softmax_pv_plain)


def weighted_attention_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, kv_weight: torch.Tensor
                             ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, one materialized tile."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    valid = torch.ones(B, H, Sq, Skv, dtype=torch.bool, device=q.device)
    return softmax_pv_plain(s, valid, kv_weight, v, q.dtype)


@functools.cache
def _kernel():
    lib = build.load("weighted_attention")
    fn = lib.capsim_weighted_attention_fwd
    fn.argtypes = ARG_TYPES + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def weighted_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_weight: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, H, D); kv_weight: (B, Skv) f32.
    Returns (B, Sq, H, D) in q.dtype.  CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream."""
    if q.device.type == "cpu":
        return weighted_attention_plain(q, k, v, kv_weight)
    kv_weight = kv_weight.float().contiguous()
    check_attention_args(q, k, v, kv_weight, "weighted_attention")
    lib, fn = _kernel()
    D = q.shape[3]
    q, k, v = pad_head_dim(q, k, v)
    o = torch.empty_like(q)     # q's head and feature axes are dense
    stream = current_stream(q.device)
    rc = fn(*launch_args(q, k, v, kv_weight, o), 1.0 / math.sqrt(D), stream)
    check_aligned(rc, q, k, v, "weighted_attention")
    build.check(lib, rc, "weighted_attention")
    build.count_launch(weighted_attention)
    return o if o.shape[3] == D else o[..., :D].contiguous()


weighted_attention.launches = 0
