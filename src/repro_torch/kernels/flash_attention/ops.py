"""Flash attention: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/flash_attention/ops.py::flash_attention`` (the
Pallas kernel ``_fa_kernel``).  Layout is the reference's: q (B, Sq, H, D),
k/v (B, Skv, H, D), kv_mask (B, Skv) with 1 = valid; causal masks align q
to the end of kv (``q_offset = Skv - Sq``); a row with no valid key
outputs zeros.

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors
and runs ``flash_attention_plain`` for CPU tensors (meta: below).
It carries a gradient to q, k and v (the mask gets none).  On the CPU
autograd differentiates the plain version.  On the card, when grad mode
is on and q, k or v requires grad, the launch is the forward of a
``torch.autograd.Function``: the forward launch also writes each row's
log-sum-exp (B, H, Sq), the Function saves it with the output, and the
backward is ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``:
dq, dk, dv from them, deterministic, no atomics), in the span
``flash_attention_backward``.  q's dtype chooses the kernels (there is
no knob): float32 on the FMA pipes, bfloat16 on the tensor cores, P
rounded to bfloat16 for dv and dS for dq and dk.  They replace no TPU
kernel: the reference's custom VJP recomputes through ``attention_ref``
(here ``flash_attention_backward``, the kernels' yardstick).
Their plain version is ``flash_attention_backward_plain``; the plain
log-sum-exp is ``flash_attention_plain(..., return_lse=True)``.

Each backward is counted in the registry,
``capsim_flash_backward_total{route="kernel", dtype}``.  The forward
launch is the same with or without a gradient: same arguments, same
output bits, one launch counted (``flash_attention.launches``;
``flash_attention.heads`` counts the launches by q's head count), its
``attention_cost`` added to the registry's ``capsim_kernel_*`` counters
(``kernels.cost.launched``); the backward kernels count apart
(``flash_attention_bwd.launches``, ``kernel="flash_attention_bwd"``).
On ``meta`` tensors (the dry-run's, ``launch/dryrun.py``) nothing runs:
the wrapper returns an empty output of the shape the kernel writes and
reports ``attention_cost``, the launch's FLOPs and HBM bytes, to
``kernels.cost`` (the plain version's S×S scores, which the card never
holds, are never built); under grad it goes through the same
``_FlashAttention``, whose backward on meta takes the card's route: it
reports ``attention_bwd_cost`` (``flash_attention_bwd``) and allocates
the card's outputs.  A meta tensor computes nothing, so this route hides
no device and no kernel.  Any other device raises.
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
from repro_torch import obs
from repro_torch.kernels import build, cost
from repro_torch.obs import REGISTRY

NEG_INF = -1e30
KEY_TILE = 64                   # keys per tile of the kernels (BK)
HEAD_DIMS = (16, 32, 64, 128)
PADDED_HEAD_DIMS = {112: 128}   # head dim -> the instantiation it pads to
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_UNALIGNED = -2                 # capsim_flash_attention_fwd's refusal
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def softmax_pv_plain(s: torch.Tensor, valid: torch.Tensor, weight,
                     v: torch.Tensor, out_dtype: torch.dtype,
                     return_lse: bool = False):
    """Shared tail of the plain versions, in the kernels' order: keys in
    tiles of ``KEY_TILE``, in key order; per tile the running f32 row max
    over the live scores, exp against it, the weight after the shift, l
    summing the f32 p, the accumulator and l rescaled by exp(m_old -
    m_new), and p rounded to the value dtype for the PV product; one
    division at the end, zeros where the normalizer is 0.  The rounding
    of p against the running max (not the row's final max) is the
    kernels' own: in bf16 it moves a model's logits by about as much as
    bf16 itself does.  s/valid: (B, H, Sq, Skv); weight (B, Skv) or
    None.  With ``return_lse``, also each row's log-sum-exp as the
    kernel stores it for the backward, m + log(l) (B, H, Sq), +inf where
    the row has no live key."""
    B, H, Sq, Skv = s.shape
    m = torch.full((B, H, Sq, 1), NEG_INF, device=s.device)
    den = torch.zeros(B, H, Sq, 1, device=s.device)
    o = torch.zeros(B, H, Sq, v.shape[-1], device=s.device)
    for k0 in range(0, Skv, KEY_TILE):
        ok = valid[..., k0:k0 + KEY_TILE]
        st = s[..., k0:k0 + KEY_TILE].masked_fill(~ok, NEG_INF)
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new).masked_fill(~ok, 0.0)
        if weight is not None:
            p = p * weight[:, None, None, k0:k0 + KEY_TILE].float()
        den = den * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                                     v[:, k0:k0 + KEY_TILE].float())
        m = m_new
    o = o / torch.where(den == 0.0, torch.ones_like(den), den)
    o = o.transpose(1, 2).to(out_dtype)
    if not return_lse:
        return o
    lse = torch.where(den == 0.0, torch.inf, m + torch.log(den))
    return o, lse[..., 0]


def live_pairs(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
               kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The (query, key) pairs the kernels score, (B, H, Sq, Skv) bool:
    the key valid under ``kv_mask`` and seen under the causal and window
    masks, q aligned to the end of kv."""
    B, Sq, H, _ = q.shape
    Skv = k.shape[1]
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
    return valid.expand(B, H, Sq, Skv)


def scores_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """scale q.k in f32, (B, H, Sq, Skv), scale = 1/sqrt(head_dim)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[3]))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False, window: int = 0,
                          kv_mask: Optional[torch.Tensor] = None,
                          return_lse: bool = False):
    """The kernel's function in plain PyTorch, one materialized tile.  With
    ``return_lse``, (output, log-sum-exp (B, H, Sq)) as the kernel
    writes them for the backward (``softmax_pv_plain``)."""
    return softmax_pv_plain(scores_plain(q, k),
                            live_pairs(q, k, causal, window, kv_mask), None,
                            v, q.dtype, return_lse)


def flash_attention_backward_plain(q, k, v, o, lse, g, kv_mask=None,
                                   causal: bool = False, window: int = 0):
    """The backward kernels' function in plain PyTorch, materialized, with
    no key tiles: (dq, dk, dv) from the forward's output ``o`` and its
    log-sum-exp ``lse`` (B, H, Sq) for the output gradient ``g``.  With s
    the scaled scores, P = exp(s - lse) on the live pairs (0 elsewhere,
    and on every key of a row whose lse is +inf), Δ = rowsum(g ∘ o),
    dV = Pᵀ g, dS = P ∘ (g Vᵀ - Δ), dQ = scale dS K, dK = scale dSᵀ Q;
    in f32, cast to q's dtype.  The bf16 kernels' rounding points: P is
    rounded to q's dtype before dV and dS before dQ and dK (a no-op in
    f32)."""
    scale = 1.0 / math.sqrt(q.shape[3])
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, o, g))
    live = live_pairs(q, k, causal, window, kv_mask)
    p = torch.exp(scores_plain(q, k) - lse[..., None]).masked_fill(~live,
                                                                   0.0)
    delta = (gf * of).sum(-1).transpose(1, 2)               # (B, H, Sq)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), gf)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def attention_cost(B: int, Sq: int, Skv: int, H: int, D: int,
                   elem_bytes: int, aux: bool, causal: bool = False):
    """(FLOPs, HBM bytes) of one attention launch: q/k/v read once, o
    written once, the per-key mask/weights (f32) read once; QK^T and PV
    at 2 FLOPs per MAC over the (query, key) pairs the mask leaves live:
    all of them, or under a causal mask (q aligned to the end of kv)
    Sq·(Skv-Sq) + Sq·(Sq+1)/2, so 2·B·H·D·S·(S+1) FLOPs at Sq = Skv = S.
    ``chip_smoke.py``'s bound and the dry-run both take it from here."""
    nbytes = (2 * B * Sq * H * D + 2 * B * Skv * H * D) * elem_bytes \
        + (4 * B * Skv if aux else 0)
    pairs = (Sq * (Skv - Sq) + Sq * (Sq + 1) / 2) if causal else Sq * Skv
    return 4.0 * B * H * pairs * D, float(nbytes)


def attention_bwd_cost(B: int, Sq: int, Skv: int, H: int, D: int,
                       elem_bytes: int, aux: bool, causal: bool = False):
    """(FLOPs, HBM bytes) of one backward call: the five products (S
    again, dP = dO Vᵀ, dV, dQ, dK) over the pairs ``attention_cost``
    counts, 2.5 times its FLOPs; q, O and dO read and dQ written, k and v
    read and dK, dV written, each once, the forward's f32 log-sum-exp
    read once and the mask (f32) once.  What the kernels compute beyond
    it (S and dP twice, Δ written and read) is left out: a least."""
    flops, _ = attention_cost(B, Sq, Skv, H, D, elem_bytes, aux, causal)
    nbytes = 4 * B * (Sq + Skv) * H * D * elem_bytes + 4 * B * H * Sq \
        + (4 * B * Skv if aux else 0)
    return 2.5 * flops, float(nbytes)


def launch_cost(q, k, aux, causal: bool):
    """``attention_cost`` of one launch over q (B, Sq, H, D) and k."""
    B, Sq, H, D = q.shape
    return attention_cost(B, Sq, k.shape[1], H, D, q.element_size(),
                          aux is not None, causal)


def meta_attention(name: str, q, k, aux, causal: bool) -> torch.Tensor:
    """The meta route of an attention wrapper: report the launch's cost
    (``attention_cost``) and return an empty (B, Sq, H, D) output."""
    cost.report(name, *launch_cost(q, k, aux, causal))
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def check_attention_args(q, k, v, aux, what: str) -> None:
    """Raise on what the CUDA kernels do not take.  q (B, Sq, H, D) and
    k/v (B, Skv, H, D) share one CUDA device (or, for the meta route,
    the meta device) and one dtype (float32 or bfloat16) with D in
    ``HEAD_DIMS``; the head and feature axes must be dense (strides D
    and 1), batch and row strides are free.  ``aux`` (the mask or
    weights) is None or a contiguous float32 (B, Skv).  D may also be a
    key of ``PADDED_HEAD_DIMS``."""
    if _taken(q, k, v, aux):
        return
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type not in ("cuda", "meta"):
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


def _taken(q, k, v, aux) -> bool:
    """Whether the kernels take these arguments: every condition that
    ``check_attention_args`` goes on to spell out (and to name the first
    that fails), in fewer tensor attribute reads.  At the serving shapes
    a launch is bound by its host time, so each read shows."""
    dev, dtype, shape = q.device, q.dtype, q.shape
    if (dev.type not in ("cuda", "meta") or k.device != dev
            or v.device != dev or k.dtype != dtype or v.dtype != dtype
            or dtype not in _DTYPE_CODES or len(shape) != 4):
        return False
    B, _, H, D = shape
    kv = k.shape
    if (D not in HEAD_DIMS and D not in PADDED_HEAD_DIMS) or v.shape != kv \
            or len(kv) != 4 or kv[0] != B or kv[2] != H or kv[3] != D:
        return False
    for st in (q.stride(), k.stride(), v.stride()):
        if st[3] != 1 or st[2] != D:
            return False
    return aux is None or (aux.shape == (B, kv[1]) and aux.dtype
                           == torch.float32 and aux.device == dev
                           and aux.is_contiguous())


def launch_args(q, k, v, aux, o):
    """The plain-C argument list shared by both attention entry points:
    dtype code, head_dim, pointers, sizes and (batch, row) strides."""
    B, Sq, H, D = q.shape
    qs, ks, vs, ost = q.stride(), k.stride(), v.stride(), o.stride()
    return (_DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), None if aux is None else aux.data_ptr(),
            o.data_ptr(), B, Sq, k.shape[1], H,
            qs[0], qs[1], ks[0], ks[1], vs[0], vs[1], ost[0], ost[1])


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
    fn.argtypes = ARG_TYPES + [_I, _I, _F, _P, _P]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _bwd_kernel():
    lib = build.load("flash_attention_bwd")
    fn = lib.capsim_flash_attention_bwd
    fn.argtypes = [_I, _I] + [_P] * 11 + [_I] * 4 + [_L] * 10 + [_I, _I, _F,
                                                                   _P]
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_bwd(q, k, v, o, lse, g, kv_mask=None,
                        causal: bool = False, window: int = 0):
    """(dq, dk, dv) by ``csrc/flash_attention_bwd.cu`` on the current
    stream: CUDA q/k/v as ``flash_attention`` checked them, the forward's
    output ``o`` and its log-sum-exp ``lse`` (B, H, Sq), the output
    gradient ``g``; q's dtype chooses the f32 or the bf16 kernels.  Its
    kernels (three, or in f32 one where Sq and Skv are at most 16) count
    as one launch
    (``flash_attention_bwd.launches``, apart from the forward's), its
    ``attention_bwd_cost`` added to the registry's ``capsim_kernel_*``
    counters under ``kernel="flash_attention_bwd"``.  Head dim 112 runs
    zero-padded to 128 and is cut back.  The function is
    ``flash_attention_backward_plain``'s.  On meta it computes nothing:
    it allocates what the card does and reports ``attention_bwd_cost`` to
    ``kernels.cost`` (the dry-run's route)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    work = attention_bwd_cost(B, Sq, Skv, H, D, q.element_size(),
                              kv_mask is not None, causal)
    q, k, v = pad_head_dim(q, k, v)
    o, g = (x.contiguous() for x in pad_head_dim(o, g, g)[:2])
    Dp = q.shape[3]
    dq = torch.empty(B, Sq, H, Dp, dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty(B, Skv, H, Dp, dtype=q.dtype, device=q.device)
              for _ in range(2))
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        cost.report("flash_attention_bwd", *work)
    else:
        lib, fn = _bwd_kernel()
        rc = fn(_DTYPE_CODES[q.dtype], Dp, *(
            None if x is None else x.data_ptr() for x in (
            q, k, v, o, g, kv_mask, lse, delta, dq, dk, dv)), B, Sq, Skv, H,
            *q.stride()[:2], *k.stride()[:2], *v.stride()[:2],
            *o.stride()[:2], *g.stride()[:2], int(causal), int(window),
            1.0 / math.sqrt(D), build.current_stream(q.device))
        check_aligned(rc, q, k, v, "flash_attention_bwd")
        build.check(lib, rc, "flash_attention_bwd")
        build.count_launch(flash_attention_bwd)
        cost.launched("flash_attention_bwd", q.dtype, *work)
    if Dp == D:
        return dq, dk, dv
    return tuple(x[..., :D].contiguous() for x in (dq, dk, dv))


flash_attention_bwd.launches = 0

BACKWARD_TOTAL = "capsim_flash_backward_total"
_BACKWARDS = {}


def count_backward(dtype: torch.dtype) -> None:
    """One backward of ``_FlashAttention`` by q's dtype: the registry's
    ``capsim_flash_backward_total{route="kernel", dtype}``, the route
    label its readers select on."""
    handle = _BACKWARDS.get(dtype)
    if handle is None:
        handle = REGISTRY.counter(
            BACKWARD_TOTAL, "Backwards of the flash attention Function, by "
            "route (the backward kernels) and dtype.",
            ("route", "dtype")).labels(
            route="kernel", dtype=str(dtype).removeprefix("torch."))
        handle = _BACKWARDS.setdefault(dtype, handle)
    handle.inc()


def flash_attention_backward(q, k, v, kv_mask, g, causal: bool = False,
                             window: int = 0):
    """(dq, dk, dv) of ``flash_attention`` at q/k/v for the output
    gradient ``g``: the attention recomputed through
    ``flash_attention_plain`` and differentiated by autograd, in a span
    of the same name (``obs.span``: a profiler range while one
    records), as the reference's custom VJP recomputes through
    ``attention_ref``.  No route of ``_FlashAttention`` takes it: it is
    the yardstick the backward kernels are checked and timed against."""
    with torch.enable_grad(), obs.span("flash_attention_backward"):
        qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = flash_attention_plain(*qkv, causal=causal, window=window,
                                  kv_mask=kv_mask)
        return torch.autograd.grad(o, qkv, g)


class _FlashAttention(torch.autograd.Function):
    """The kernel's launch as the forward, which also writes each row's
    log-sum-exp; the backward kernels (``flash_attention_bwd``, on the
    card and on meta as the card runs them) from the output and that
    log-sum-exp, in either dtype.  Each backward is counted
    (``count_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, window):
        B, Sq, H, _ = q.shape
        lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
        o = _launch(q, k, v, kv_mask, causal, window, lse)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        count_backward(q.dtype)
        with obs.span("flash_attention_backward"):
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g, kv_mask,
                                             ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: int = 0,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, H, D); kv_mask: (B, Skv) 1 = valid.
    Returns (B, Sq, H, D) in q.dtype.  CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream, through
    ``_FlashAttention`` where a gradient is wanted; meta tensors take the
    meta route (the module docstring)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     kv_mask=kv_mask)
    if kv_mask is not None:
        kv_mask = kv_mask.float().contiguous()
    check_attention_args(q, k, v, kv_mask, "flash_attention")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_mask, causal, window)
    return _launch(q, k, v, kv_mask, causal, window)


def _launch(q, k, v, kv_mask, causal: bool, window: int,
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the kernel on checked arguments; head dim 112 runs
    zero-padded to 128 and is cut back.  ``lse``: None, or a float32 (B,
    H, Sq) tensor the kernel fills with each row's log-sum-exp.  On
    meta: the meta route."""
    if q.device.type == "meta":
        return meta_attention("flash_attention", q, k, kv_mask, causal)
    lib, fn = _kernel()
    D = q.shape[3]
    work = launch_cost(q, k, kv_mask, causal)
    q, k, v = pad_head_dim(q, k, v)
    o = torch.empty_like(q)     # q's head and feature axes are dense
    stream = build.current_stream(q.device)
    rc = fn(*launch_args(q, k, v, kv_mask, o), int(causal), int(window),
            1.0 / math.sqrt(D), None if lse is None else lse.data_ptr(),
            stream)
    check_aligned(rc, q, k, v, "flash_attention")
    build.check(lib, rc, "flash_attention")
    build.count_launch(flash_attention, heads=q.shape[2])
    cost.launched("flash_attention", q.dtype, *work)
    return o if o.shape[3] == D else o[..., :D].contiguous()


flash_attention.launches = 0
flash_attention.heads = {}


def shared_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory one launch of the kernel asks for."""
    lib, _ = _kernel()
    fn = lib.capsim_flash_attention_smem
    fn.argtypes = [_I, _I]
    fn.restype = ctypes.c_longlong
    return int(fn(_DTYPE_CODES[dtype], head_dim))
