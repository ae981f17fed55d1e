"""The collectives that join the LM zoo's shard bodies across ranks, over
``launch/mesh.py``'s ``Mesh`` groups (the reference's ``lax.all_gather``,
``psum``, ``pmax`` and ``pmean`` inside ``shard_map``, and the
collectives GSPMD inserts for its weight layouts).

Each takes the mesh and a tuple of axes; over axes of total size 1 (and
on a local mesh) it returns its input untouched, so a world of one rank
computes bit for bit what the meshless path computes.  Shards are
ordered by their row-major combined coordinate over the axes.  A
bfloat16 tensor crosses the wire as float32 (exact for a gather; a sum
accumulates in f32 and is cast back).

Gradients.  ``all_gather`` and the ``all_reduce`` sum are autograd
functions with their exact adjoints: a gather's gradient is the
reduce-scatter of its output's (the gradient summed over the shards,
this rank's block kept), a sum's gradient is the sum of its output's.
So each rank's backward gives the gradient of the sum of every rank's
loss, where a value that several ranks compute alike carries a share
of its gradient on each of them: ``training/train_loop.py`` sums each
parameter's gradient over the ranks that hold the same block and
divides by the world size (the mean of the ranks' losses).  The row-
and column-parallel products need no other operator: Megatron's
identity-forward / all-reduce-backward copy is the adjoint of a sum
that this convention already takes.  A max has no gradient here
(its callers reduce values that need none), and ``mean_local_grad``
keeps each rank's own gradient.

Parameters gathered for use (``gather_param``: FSDP rows) are sharded
during a training step too, as FSDP and the reference's remat keep
them: under ``regather_saved()`` an op that saves a gathered parameter
(or a view of it) for its backward keeps the rank's block instead, and
the backward gathers it again when it needs it, so a layer's whole
weights live only while the layer runs, forward or backward.

``record_collectives()`` lists every collective this process issues
while it is open (``Collective``: op, result bytes on the wire, group
size, forward or backward), where the reference parses them out of its
compiled HLO (``launch/roofline.py``).  It changes nothing that runs.
The MoE's expert parallelism replicates tokens over 'model' and sums
the experts' outputs, so it records an all-gather and an all-reduce:
the port issues no all-to-all.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref

import torch


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as issued: ``op`` in the reference's HLO names
    ("all-gather", "all-reduce", "reduce-scatter"), ``nbytes`` its
    result's bytes as they cross the wire (bfloat16 as float32),
    ``group`` the ranks taking part, ``direction`` "forward" or
    "backward" (inside the autograd engine's backward)."""
    op: str
    nbytes: int
    group: int
    direction: str


_RECORDS: list = []
_RECORDS_LOCK = threading.Lock()


@contextlib.contextmanager
def record_collectives():
    """A list that every collective issued while the context is open is
    appended to, in order, from any thread."""
    out: list = []
    with _RECORDS_LOCK:
        _RECORDS.append(out)
    try:
        yield out
    finally:
        with _RECORDS_LOCK:
            _RECORDS.remove(out)


def _note(op: str, result: torch.Tensor, group: int) -> None:
    if not _RECORDS:
        return
    direction = ("backward" if torch._C._current_autograd_node() is not None
                 else "forward")
    rec = Collective(op, result.numel() * result.element_size(), group,
                     direction)
    with _RECORDS_LOCK:
        for out in _RECORDS:
            out.append(rec)


def _live(mesh, axes) -> bool:
    return mesh is not None and mesh.size(axes) > 1


def _wire(x: torch.Tensor) -> torch.Tensor:
    return (x.float() if x.dtype == torch.bfloat16 else x).contiguous()


def _gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(mesh.size(axes))]
    dist.all_gather(parts, w, group=mesh.group(axes))
    out = torch.cat(parts, dim=dim)
    _note("all-gather", out, mesh.size(axes))
    return out.to(x.dtype)


def _reduce(x: torch.Tensor, mesh, axes, op: str) -> torch.Tensor:
    import torch.distributed as dist
    out = _wire(x).clone()
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op],
                    group=mesh.group(axes))
    _note("all-reduce", out, mesh.size(axes))
    return out.to(x.dtype)


def _reduce_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` summed over the shards."""
    import torch.distributed as dist
    parts = [c.contiguous() for c in _wire(x).chunk(mesh.size(axes), dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=mesh.group(axes))
    _note("reduce-scatter", out, mesh.size(axes))
    return out.to(x.dtype)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None,
                None)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _reduce(x, mesh, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.axes, "sum"), None, None


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The shards' ``x`` concatenated along ``dim`` in shard order (the
    reference's ``all_gather(..., tiled=True)``); its gradient is the
    reduce-scatter of the output's."""
    if not _live(mesh, axes):
        return x
    return _AllGather.apply(x, mesh, tuple(axes), dim)


# a gathered parameter's storage -> (the gathered tensor, weakly; the
# rank's block; mesh; its (axes, dim) gathers)
_PARAM_GATHERS: dict = {}


def _storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage while it lives (its StorageImpl's
    address: unique on every device, meta included, where every data
    pointer is 0)."""
    return t.untyped_storage()._cdata


class _Regather:
    """A saved gathered parameter, held as the rank's block and the
    view's geometry."""

    def __init__(self, block, mesh, gathers, view):
        self.block, self.mesh, self.gathers = block, mesh, gathers
        self.view = (view.size(), view.stride(), view.storage_offset())

    def unpack(self) -> torch.Tensor:
        w = self.block
        for axes, dim in self.gathers:
            w = _gather(w, self.mesh, axes, dim)
        return w.as_strided(*self.view)


def _pack(t: torch.Tensor):
    if not _PARAM_GATHERS or t.layout != torch.strided:
        return t
    entry = _PARAM_GATHERS.get(_storage_key(t))
    whole = None if entry is None else entry[0]()
    if whole is None or whole.dtype != t.dtype:
        return t
    return _Regather(*entry[1:], t)


def _unpack(x):
    return x.unpack() if isinstance(x, _Regather) else x


def regather_saved():
    """A context within which what autograd saves of a
    ``gather_param`` result is its block, gathered again in the backward
    (the module docstring)."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


def gather_param(w: torch.Tensor, mesh, gathers) -> torch.Tensor:
    """Parameter block ``w`` all-gathered along each ``(axes, dim)`` of
    ``gathers`` in turn; under ``regather_saved()`` the result is saved
    for the backward as ``w``."""
    out = w
    for axes, dim in gathers:
        out = all_gather(out, mesh, axes, dim)
    if out is not w and out.requires_grad:
        key = _storage_key(out)
        _PARAM_GATHERS[key] = (
            weakref.ref(out, lambda _, k=key: _PARAM_GATHERS.pop(k, None)),
            w.detach(), mesh, tuple(gathers))
    return out


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum"
               ) -> torch.Tensor:
    """A new tensor: ``x`` summed (``psum``; its gradient is the summed
    gradient) or maxed (``pmax``; no gradient) over the shards of
    ``axes``."""
    if not _live(mesh, axes):
        return x
    if op == "sum":
        return _AllReduceSum.apply(x, mesh, tuple(axes))
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("all_reduce max has no gradient: reduce a "
                         "detached tensor")
    return _reduce(x, mesh, axes, op)


def all_mean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``pmean``: the sum over the shards divided by their count."""
    n = 1 if mesh is None else mesh.size(axes)
    return x if n == 1 else all_reduce(x, mesh, axes) / n


def mean_local_grad(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``pmean(x)`` in value, with the gradient of the rank's own ``x``:
    equal to ``pmean``'s where every shard's gradient of the mean is the
    same (the MoE's load-balance statistics, which every rank's loss
    reads alike)."""
    if mesh is None or mesh.size(axes) == 1:
        return x
    return x + (all_mean(x.detach(), mesh, axes) - x.detach())


def take_block(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``: block ``mesh.index(axes)``
    of ``mesh.size(axes)`` equal blocks (the inverse of ``all_gather``)."""
    n = 1 if mesh is None else mesh.size(axes)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * size, size)
