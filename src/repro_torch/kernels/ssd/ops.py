"""The SSD (Mamba2) chunked scan: the CUDA kernel's wrapper and its plain
version.

Replaces ``repro/kernels/ssd/ops.py::ssd_scan`` (the Pallas kernel
``_ssd_kernel``).  Model layout: x (Bt, S, H, P), dt (Bt, S, H) f32,
B/C (Bt, S, N) shared by every head, or (Bt, S, G, N) in G groups (head
h reads group h // (H / G): NemotronH's ``n_groups``), A (H,) f32
negative.  The scan runs
in chunks of ``q = min(chunk, S)`` steps; S is treated as padded up to a
multiple of q with dt = 0, so padded steps neither decay nor inject.
Within a chunk, with ``seg = cumsum(dt·A)``:

    y_i    = Σ_{j<=i} (C_i·B_j) exp(seg_i - seg_j) dt_j x_j
             + exp(seg_i) (C_i·state)
    state <- state·exp(seg_q) + Σ_j dt_j exp(seg_q - seg_j) x_j ⊗ B_j

All of it in f32, except that ``seg`` is accumulated in f64: over a
256-step chunk seg reaches -1e4 at large dt·|A|, where an f32 cumsum
keeps ~1e-3 of seg_i - seg_j, enough for the kernel and its plain version
to disagree at the 1e-5 gate.  The decay is always formed as one
``exp(seg_i - seg_j)``, never ``exp(seg_i)/exp(seg_j)`` (0/0 there).
Returns y (Bt, S, H, P) in x's dtype and the final state (Bt, H, P, N)
f32 (the state after the last real step; padded steps leave it).

``ssd_scan`` launches ``csrc/ssd.cu`` (four kernels on the current
stream: C·Bᵀ per chunk, each chunk's state contribution, the pass over
chunks, y) for CUDA tensors and runs ``ssd_scan_plain`` for CPU tensors.
On ``meta`` tensors (the dry-run's) nothing runs: it returns empty y and
state and reports ``ssd_cost`` to ``kernels.cost``, through the same
``_SSDScan`` under grad (its backward the plain recompute, on meta); a
meta tensor computes nothing, so this hides no device and no kernel.
Anything else raises.  It carries a gradient to x, dt, B, C and A from
both outputs.  On the CPU autograd differentiates the plain version.  On
the card, when grad mode is on and an input requires grad, the launches
are the forward of a ``torch.autograd.Function``; its backward,
``ssd_scan_backward``, recomputes the scan through the plain version and
differentiates that (the reference has no custom VJP: JAX
differentiates its chunked scan).  The plain version masks the decay's
exponent to -inf above the diagonal before the ``exp``, as the
reference's ``_segsum`` does: there ``seg_i - seg_j`` is positive and
overflows once a chunk's Σ dt·|A| passes ~88, and an ``exp`` taken
first and masked after gives the right forward but ``0 · inf = NaN`` in
its gradient.  The kernels' f32 workspace (C·Bᵀ per chunk and
one state per chunk and head, about x's size in bf16 at the Mamba2
shapes) is allocated here, on x's device.  A call counts one launch
(``ssd_scan.launches``) and one under its head count in ``ssd_scan.heads``,
and adds its ``ssd_cost`` to the registry's ``capsim_kernel_*`` counters
(``kernels.cost.launched``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import build, cost

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _grouped(B: torch.Tensor) -> torch.Tensor:
    """B or C as (Bt, S, G, N): a (Bt, S, N) tensor is one group."""
    return B[:, :, None] if B.dim() == 3 else B


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, chunk: int = 256):
    """The kernel's function in plain PyTorch: the chunk computation of
    ``_ssd_kernel`` over B/C (Bt, S, N), or (Bt, S, G, N) with head h
    reading group h // (H / G), every chunk at once (the heads as (G, H /
    G)), and a loop over the chunks only for the state they carry.  The
    card's backward recomputes through it, so it launches ~10x fewer
    kernels than a loop over chunks would."""
    B, C = _grouped(B), _grouped(C)
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    R = H // G
    q = min(chunk, S)
    pad = -S % q
    nc = (S + pad) // q
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).view(Bt, nc, q, G, R, P)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).view(Bt, nc, q, H)
    Bf = F.pad(B.float(), (0, 0, 0, 0, 0, pad)).view(Bt, nc, q, G, N)
    Cf = F.pad(C.float(), (0, 0, 0, 0, 0, pad)).view(Bt, nc, q, G, N)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    dtc = dtf.permute(0, 3, 1, 2)                           # (Bt, H, nc, q)
    seg = torch.cumsum((dtc * A.float()[None, :, None, None]).double(),
                       dim=-1)
    diff = (seg[..., :, None] - seg[..., None, :]).float()  # (Bt,H,nc,q,q)
    L = torch.exp(diff.masked_fill(~causal, float("-inf")))
    CB = torch.einsum("bcign,bcjgn->bgcij", Cf, Bf)          # (Bt,G,nc,q,q)
    xdt = xf * dtf.view(Bt, nc, q, G, R, 1)
    y = torch.einsum("bgrcij,bcjgrp->bcigrp",
                     CB[:, :, None] * L.view(Bt, G, R, nc, q, q), xdt)
    last = seg[..., -1:]
    w = (dtc * torch.exp((last - seg).float())).view(Bt, G, R, nc, q)
    upd = torch.einsum("bgrcj,bcjgrp,bcjgn->bcgrpn", w, xf, Bf)
    decay = torch.exp(last[..., 0].float())                 # (Bt, H, nc)
    state = torch.zeros(Bt, H, P, N, dtype=torch.float32, device=x.device)
    incoming = []
    for c in range(nc):
        incoming.append(state)
        state = state * decay[:, :, c, None, None] \
            + upd[:, c].reshape(Bt, H, P, N)
    y_off = torch.einsum("bcign,bcgrpn->bcigrp", Cf, torch.stack(
        incoming, dim=1).view(Bt, nc, G, R, P, N))
    y = y + torch.exp(seg.float()).permute(0, 2, 3, 1).reshape(
        Bt, nc, q, G, R, 1) * y_off
    y = y.reshape(Bt, nc * q, H, P)[:, :S]
    return y.to(x.dtype), state


def ssd_cost(Bt: int, S: int, H: int, P: int, N: int, q: int,
             elem_bytes: int, G: int = 1):
    """(FLOPs, HBM bytes) of one call.  Per chunk of L real steps (the
    last one ragged), batch row and group of B/C, C·Bᵀ over the causal
    half once, L(L+1)/2 pairs of N MACs, since a group's B and C are
    shared by its heads; per head the decayed causal product with x·dt,
    L(L+1)/2 pairs of P MACs, and L·N·P MACs each for the carried state's
    output and the state update.  Bytes: x read and y written, B/C of
    every group, dt and A read, the f32 state written once.
    ``chip_smoke.py``'s bound and the dry-run both take it from here."""
    lens = [min(q, S - t) for t in range(0, S, q)]
    flops = float(Bt * G) * sum(L * (L + 1) * N for L in lens) \
        + float(Bt * H) * sum(L * (L + 1) * P + 4 * L * N * P for L in lens)
    nbytes = (2 * Bt * S * H * P + 2 * Bt * S * G * N) * elem_bytes \
        + 4 * (Bt * S * H + H + Bt * H * P * N)
    return flops, float(nbytes)


def check_ssd_args(x, dt, B, C, A) -> None:
    """Raise on a layout the CUDA kernel does not take.  Everything on one
    CUDA device (or, for the meta route, the meta device); x (Bt, S, H,
    P) and B/C (Bt, S, N), or (Bt, S, G, N) with G dividing H, in one
    dtype (float32 or bfloat16) with the last axis dense; dt (Bt, S, H)
    and A (H,) float32 with dense last axes.  Batch, row and group strides
    are free: the kernel reads the model's layout in place.  The limits on head_dim,
    d_state and chunk belong to the kernel's entry point
    (``capsim_ssd_scan``), which refuses what it was not built for."""
    Bt, S, H, P = x.shape
    for name, t, shape in (("dt", dt, (Bt, S, H)), ("B", B, B.shape),
                           ("C", C, B.shape), ("A", A, (H,))):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on "
                             f"{x.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"ssd_scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {name} needs a dense last axis, "
                             f"got strides {t.stride()}")
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan: x is on {x.device}, expected a CUDA "
                         "tensor")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"ssd_scan: dtype {x.dtype} not supported")
    if B.dim() not in (3, 4) or B.shape[:2] != (Bt, S) \
            or (B.dim() == 4 and H % B.shape[2]) or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan: B/C must be (Bt, S, N) = ({Bt}, {S}, "
                         f"N) or (Bt, S, G, N) with G dividing {H}, in "
                         f"{x.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("ssd_scan: dt and A must be float32")
    if x.stride(3) != 1 or x.stride(2) != P:
        raise ValueError(f"ssd_scan: x needs dense heads (strides "
                         f"(.., .., P, 1)), got {x.stride()}")


@functools.cache
def _kernel():
    lib = build.load("ssd")
    fn = lib.capsim_ssd_scan
    fn.argtypes = [_I] + [_P] * 7 + [_I] * 7 + [_L] * 12 + [_P, _P]
    fn.restype = ctypes.c_int
    lib.capsim_ssd_workspace_bytes.argtypes = [_I] * 7
    lib.capsim_ssd_workspace_bytes.restype = _L
    return lib, fn


def ssd_scan_backward(x, dt, B, C, A, chunk: int, gy, gstate):
    """(dx, ddt, dB, dC, dA) of ``ssd_scan`` for the gradients of its two
    outputs: the scan recomputed through ``ssd_scan_plain`` and
    differentiated by autograd, inside the span ``ssd/backward``."""
    with obs.span("ssd/backward"), torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, B, C, A)]
        y, state = ssd_scan_plain(*ins, chunk)
        return torch.autograd.grad((y, state), ins, (gy, gstate))


class _SSDScan(torch.autograd.Function):
    """The kernels' launches as the forward, the plain version's
    recompute as the backward."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, chunk):
        ctx.save_for_backward(x, dt, B, C, A)
        ctx.chunk = chunk
        return _launch(x, dt, B, C, A, chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        return ssd_scan_backward(*ctx.saved_tensors, ctx.chunk, gy,
                                 gstate) + (None,)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, chunk: int = 256):
    """Returns (y (Bt, S, H, P) in x's dtype, final state (Bt, H, P, N)
    f32).  B and C are (Bt, S, N), shared by every head, or (Bt, S, G, N),
    head h reading group h // (H / G).  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream, through
    ``_SSDScan`` where a gradient is wanted."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, B, C, A, chunk)
    check_ssd_args(x, dt, B, C, A)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, B, C, A)):
        return _SSDScan.apply(x, dt, B, C, A, chunk)
    return _launch(x, dt, B, C, A, chunk)


def _launch(x, dt, B, C, A, chunk: int):
    """One call's four launches on checked arguments; on meta the meta
    route (the module docstring)."""
    Bt, S, H, P = x.shape
    B, C = _grouped(B), _grouped(C)
    G, N = B.shape[2], B.shape[3]
    q = min(chunk, S)
    work = ssd_cost(Bt, S, H, P, N, q, x.element_size(), G)
    if x.device.type == "meta":
        cost.report("ssd", *work)
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                torch.empty(Bt, H, P, N, dtype=torch.float32,
                            device=x.device))
    lib, fn = _kernel()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    state = torch.empty(Bt, H, P, N, dtype=torch.float32, device=x.device)
    workspace = torch.empty(
        lib.capsim_ssd_workspace_bytes(Bt, S, H, P, N, q, G),
        dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(),
            B.data_ptr(), C.data_ptr(), A.data_ptr(), y.data_ptr(),
            state.data_ptr(), Bt, S, H, P, N, q, G,
            x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            B.stride(0), B.stride(1), B.stride(2), C.stride(0), C.stride(1),
            C.stride(2), y.stride(0), y.stride(1), workspace.data_ptr(),
            stream)
    build.check(lib, rc, f"ssd_scan (head_dim {P}, d_state {N}, chunk {q})")
    build.count_launch(ssd_scan, heads=H)
    cost.launched("ssd", x.dtype, *work)
    return y, state


ssd_scan.launches = 0
ssd_scan.heads = {}


def shared_bytes(dtype: torch.dtype, head_dim: int, d_state: int,
                 chunk: int) -> tuple:
    """Dynamic shared memory of the kernel's four launches (C·Bᵀ, chunk
    states, the pass over chunks, y) at one shape."""
    lib, _ = _kernel()
    fn = lib.capsim_ssd_shared_bytes
    fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_L)]
    fn.restype = _I
    out = (_L * 4)()
    if fn(_DTYPE_CODES[dtype], head_dim, d_state, chunk, out) != 0:
        raise ValueError(f"ssd_scan: head_dim {head_dim}, d_state "
                         f"{d_state}, chunk {chunk} not supported")
    return tuple(int(v) for v in out)
