"""Flash attention: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/flash_attention/ops.py::flash_attention`` (the
Pallas kernel ``_fa_kernel``).  Layout is the reference's: q (B, Sq, H, D),
k/v (B, Skv, H, D), kv_mask (B, Skv) with 1 = valid; causal masks align q
to the end of kv (``q_offset = Skv - Sq``); a row with no valid key
outputs zeros.  Forward only: the port does inference.

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors
and runs ``flash_attention_plain`` for CPU tensors; anything else raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def softmax_pv_plain(s: torch.Tensor, valid: torch.Tensor, weight,
                     v: torch.Tensor, out_dtype: torch.dtype
                     ) -> torch.Tensor:
    """Shared tail of the plain versions, in the kernels' order: f32 max
    shift over the live scores, exp, weight after the shift, p rounded to
    the value dtype for the PV product, one division, zeros where the
    normalizer is 0.  s/valid: (B, H, Sq, Skv); weight (B, Skv) or None."""
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~valid, 0.0)
    if weight is not None:
        p = p * weight.float()[:, None, None, :]
    den = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = o / torch.where(den == 0.0, torch.ones_like(den), den)
    return o.transpose(1, 2).to(out_dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False, window: int = 0,
                          kv_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, one materialized tile."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    valid = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (qpos >= kpos)
        if window > 0:
            valid = valid & (qpos - kpos < window)
    valid = valid[None, None]
    if kv_mask is not None:
        valid = valid & (kv_mask[:, None, None, :] > 0)
    return softmax_pv_plain(s, valid.expand(B, H, Sq, Skv), None, v,
                            q.dtype)


def check_attention_args(q, k, v, aux, what: str) -> None:
    """Raise on what the CUDA kernels do not take.  q (B, Sq, H, D) and
    k/v (B, Skv, H, D) share one CUDA device and one dtype (float32 or
    bfloat16) with D in ``HEAD_DIMS``; the head and feature axes must be
    dense (strides D and 1), batch and row strides are free.  ``aux``
    (the mask or weights) is None or a contiguous float32 (B, Skv)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {x.device}, expected "
                             "a CUDA tensor like q")
        if x.device != q.device:
            raise ValueError(f"{what}: {name} is on {x.device}, q on "
                             f"{q.device}")
        if x.dim() != 4:
            raise ValueError(f"{what}: {name} must be (B, S, H, D), got "
                             f"{tuple(x.shape)}")
        if x.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {x.dtype}, q {q.dtype}")
        if x.stride(3) != 1 or x.stride(2) != x.shape[3]:
            raise ValueError(f"{what}: {name} needs dense heads (strides "
                             f"(.., .., D, 1)), got {x.stride()}")
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: dtype {q.dtype} not supported")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in {HEAD_DIMS}")
    if k.shape != (B, Skv, H, D) or v.shape != k.shape:
        raise ValueError(f"{what}: k/v shapes {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if aux is not None:
        if (aux.shape != (B, Skv) or aux.dtype != torch.float32
                or aux.device != q.device or not aux.is_contiguous()):
            raise ValueError(f"{what}: mask/weights must be a contiguous "
                             f"float32 (B, Skv) = ({B}, {Skv}) tensor on "
                             f"{q.device}")


def launch_args(q, k, v, aux, o):
    """The plain-C argument list shared by both attention entry points:
    dtype code, head_dim, pointers, sizes and (batch, row) strides."""
    B, Sq, H, D = q.shape
    return (_DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), None if aux is None else aux.data_ptr(),
            o.data_ptr(), B, Sq, k.shape[1], H,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), o.stride(0), o.stride(1))


ARG_TYPES = [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
             _L, _L, _L, _L, _L, _L, _L, _L]


@functools.cache
def _kernel():
    lib = build.load("flash_attention")
    fn = lib.capsim_flash_attention_fwd
    fn.argtypes = ARG_TYPES + [_I, _I, _F, _P]
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: int = 0,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, H, D); kv_mask: (B, Skv) 1 = valid.
    Returns (B, Sq, H, D) in q.dtype.  CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     kv_mask=kv_mask)
    if kv_mask is not None:
        kv_mask = kv_mask.float().contiguous()
    check_attention_args(q, k, v, kv_mask, "flash_attention")
    lib, fn = _kernel()
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(*launch_args(q, k, v, kv_mask, o), int(causal), int(window),
            1.0 / math.sqrt(q.shape[3]), stream)
    flash_attention.launches += 1
    build.check(lib, rc, "flash_attention")
    return o


flash_attention.launches = 0
