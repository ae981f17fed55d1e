"""The SSD (Mamba2) chunked scan: the CUDA kernel's wrapper and its plain
version.

Replaces ``repro/kernels/ssd/ops.py::ssd_scan`` (the Pallas kernel
``_ssd_kernel``).  Model layout: x (Bt, S, H, P), dt (Bt, S, H) f32,
B/C (Bt, S, N) shared by every head, A (H,) f32 negative.  The scan runs
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
chunks, y) for CUDA tensors and runs ``ssd_scan_plain`` for CPU tensors;
anything else raises.  The kernels' f32 workspace (C·Bᵀ per chunk and
one state per chunk and head, about x's size in bf16 at the Mamba2
shapes) is allocated here, on x's device.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, chunk: int = 256):
    """The kernel's function in plain PyTorch: the chunk computation of
    ``_ssd_kernel``, one chunk at a time over the whole batch."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    q = min(chunk, S)
    pad = -S % q
    nc = (S + pad) // q
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).view(Bt, nc, q, H, P)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).view(Bt, nc, q, H)
    Bf = F.pad(B.float(), (0, 0, 0, pad)).view(Bt, nc, q, N)
    Cf = F.pad(C.float(), (0, 0, 0, pad)).view(Bt, nc, q, N)
    Af = A.float()
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    state = torch.zeros(Bt, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        dtc = dtc.transpose(1, 2)                               # (Bt, H, q)
        seg = torch.cumsum((dtc * Af[None, :, None]).double(), dim=-1)
        diff = (seg[..., :, None] - seg[..., None, :]).float()  # (Bt,H,q,q)
        L = torch.where(causal, torch.exp(diff), 0.0)
        CB = torch.einsum("bin,bjn->bij", Cc, Bc)
        xdt = xc * dtc.transpose(1, 2)[..., None]               # (Bt,q,H,P)
        y = torch.einsum("bhij,bjhp->bihp", CB[:, None] * L, xdt)
        y_off = torch.einsum("bin,bhpn->bihp", Cc, state)
        y = y + torch.exp(seg.float()).transpose(1, 2)[..., None] * y_off
        last = seg[..., -1:]
        w = dtc * torch.exp((last - seg).float())               # (Bt, H, q)
        upd = torch.einsum("bhj,bjhp,bjn->bhpn", w, xc, Bc)
        state = state * torch.exp(last.float())[..., None] + upd
        ys.append(y)
    y = torch.stack(ys, dim=1).view(Bt, nc * q, H, P)[:, :S]
    return y.to(x.dtype), state


def check_ssd_args(x, dt, B, C, A) -> None:
    """Raise on a layout the CUDA kernel does not take.  Everything on one
    CUDA device; x (Bt, S, H, P) and B/C (Bt, S, N) in one dtype (float32
    or bfloat16) with the last axis dense; dt (Bt, S, H) and A (H,)
    float32 with dense last axes.  Batch and row strides are free: the
    kernel reads the model's layout in place.  The limits on head_dim,
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
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: x is on {x.device}, expected a CUDA "
                         "tensor")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"ssd_scan: dtype {x.dtype} not supported")
    if B.dim() != 3 or B.shape[:2] != (Bt, S) or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan: B/C must be (Bt, S, N) = ({Bt}, {S}, "
                         f"N) in {x.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("ssd_scan: dt and A must be float32")
    if x.stride(3) != 1 or x.stride(2) != P:
        raise ValueError(f"ssd_scan: x needs dense heads (strides "
                         f"(.., .., P, 1)), got {x.stride()}")


@functools.cache
def _kernel():
    lib = build.load("ssd")
    fn = lib.capsim_ssd_scan
    fn.argtypes = [_I] + [_P] * 7 + [_I] * 6 + [_L] * 10 + [_P, _P]
    fn.restype = ctypes.c_int
    lib.capsim_ssd_workspace_bytes.argtypes = [_I] * 6
    lib.capsim_ssd_workspace_bytes.restype = _L
    return lib, fn


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, chunk: int = 256):
    """Returns (y (Bt, S, H, P) in x's dtype, final state (Bt, H, P, N)
    f32).  CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, B, C, A, chunk)
    check_ssd_args(x, dt, B, C, A)
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    q = min(chunk, S)
    lib, fn = _kernel()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    state = torch.empty(Bt, H, P, N, dtype=torch.float32, device=x.device)
    workspace = torch.empty(
        lib.capsim_ssd_workspace_bytes(Bt, S, H, P, N, q),
        dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(),
            B.data_ptr(), C.data_ptr(), A.data_ptr(), y.data_ptr(),
            state.data_ptr(), Bt, S, H, P, N, q,
            x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            B.stride(0), B.stride(1), C.stride(0), C.stride(1),
            y.stride(0), y.stride(1), workspace.data_ptr(), stream)
    build.check(lib, rc, f"ssd_scan (head_dim {P}, d_state {N}, chunk {q})")
    build.count_launch(ssd_scan)
    return y, state


ssd_scan.launches = 0


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
