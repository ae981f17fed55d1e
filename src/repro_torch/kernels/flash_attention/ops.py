"""Flash attention: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/flash_attention/ops.py::flash_attention`` (the
Pallas kernel ``_fa_kernel``).  Layout is the reference's: q (B, Sq, H, D),
k/v (B, Skv, H, D), kv_mask (B, Skv) with 1 = valid; causal masks align q
to the end of kv (``q_offset = Skv - Sq``); a row with no valid key
outputs zeros.  Forward only: the port does inference.

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors
and runs ``flash_attention_plain`` for CPU tensors; anything else raises.
The kernel copies q/k/v rows 16 bytes at a time, so each must start on a
16-byte boundary and step by a multiple of 16 bytes per batch and row;
the C entry point checks that (it alone knows the kernel's loads) and the
wrapper raises ``ValueError`` where it does not hold.  The predictor's
projections and the split views of a fused QKV projection pass.
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
PADDED_HEAD_DIMS = {112: 128}   # head dim -> the instantiation it pads to
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_UNALIGNED = -2                 # capsim_flash_attention_fwd's refusal
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
    (the mask or weights) is None or a contiguous float32 (B, Skv).  D
    may also be a key of ``PADDED_HEAD_DIMS``."""
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
    if D not in HEAD_DIMS and D not in PADDED_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in {HEAD_DIMS} or "
                         f"{tuple(PADDED_HEAD_DIMS)}")
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


def current_stream(device: torch.device) -> int:
    """The raw handle of the current CUDA stream on ``device`` (the
    private accessor where PyTorch has it: a Stream object costs
    microseconds a launch)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index if device.index is not None
                   else torch.cuda.current_device())
    return torch.cuda.current_stream(device).cuda_stream


def pad_head_dim(q, k, v):
    """q/k/v zero-padded along D to the instantiation a head dim in
    ``PADDED_HEAD_DIMS`` runs on (new dense tensors); others as they
    are."""
    to = PADDED_HEAD_DIMS.get(q.shape[3])
    if to is None:
        return q, k, v
    return tuple(torch.nn.functional.pad(x, (0, to - x.shape[3]))
                 for x in (q, k, v))


def check_aligned(rc: int, q, k, v, what: str) -> None:
    """Raise ``ValueError`` if the C entry point refused q/k/v that do
    not start on 16 bytes or step by whole 16-byte units per batch and
    row (it alone knows the kernel's loads)."""
    if rc == _UNALIGNED:
        raise ValueError(f"{what}: q/k/v must start on 16 bytes and step "
                         "by multiples of 16 bytes per batch and row, got "
                         f"strides {q.stride()}/{k.stride()}/{v.stride()}")


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
    D = q.shape[3]
    q, k, v = pad_head_dim(q, k, v)
    o = torch.empty_like(q)     # q's head and feature axes are dense
    stream = current_stream(q.device)
    rc = fn(*launch_args(q, k, v, kv_mask, o), int(causal), int(window),
            1.0 / math.sqrt(D), stream)
    check_aligned(rc, q, k, v, "flash_attention")
    build.check(lib, rc, "flash_attention")
    build.count_launch(flash_attention)
    return o if o.shape[3] == D else o[..., :D].contiguous()


flash_attention.launches = 0


def shared_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory one launch of the kernel asks for."""
    lib, _ = _kernel()
    fn = lib.capsim_flash_attention_smem
    fn.argtypes = [_I, _I]
    fn.restype = ctypes.c_longlong
    return int(fn(_DTYPE_CODES[dtype], head_dim))
