"""Embedding lookup: the gather, and its gradient's CUDA kernel and plain
version.

``embedding_lookup(table, ids)`` is ``table[ids]``: rows of a (V, E)
table at int ids of any shape, (*ids.shape, E).  Its gradient to the
table is ``grad_table[v] = Σ grad_out[r]`` over the rows r with
``ids[r] == v`` (a negative id counts as id + V, as the gather reads it).
PyTorch's own gradient of the gather (``index_put_`` with
``accumulate=True``, its ``indexing_backward_kernel``) sorts the ids and
walks each distinct id's rows in series, one warp an id; the CAPSim
predictor's token table (512 × 128, a few hundred ids in use) meets
hundreds of thousands of rows a train step, most of them ``<PAD>``.  So
on the card the gradient is ``csrc/embedding_grad.cu``, parallel over
rows (the source's note).  No TPU kernel is replaced: the JAX package
leaves this gradient to XLA.

The path rests on whether a gradient is wanted, and then on the device:

- No gradient wanted (``no_grad``, ``inference_mode``, a table that
  does not require grad): ``table[ids]`` and nothing else.
- Otherwise the gather is the forward of ``_EmbeddingLookup`` (the same
  ``table[ids]``, same bits), whose backward is ``embedding_grad``:
  - CPU tensors: ``embedding_grad_plain``, launching nothing;
  - CUDA tensors: the kernel, on the current stream, one launch counted
    (``embedding_grad.launches``), its ``embedding_grad_cost`` added to
    the registry's ``capsim_kernel_*`` counters (``kernels.cost.
    launched``).  The table must be float32 and 2-D and the ids int32 or
    int64 on its device (``check_lookup_args``, at the lookup); anything
    else raises;
  - ``meta`` tensors (the dry-run's): as on the card, but the backward
    reports ``embedding_grad_cost`` (the least bytes, without the card's
    partials) to ``kernels.cost`` and returns an empty gradient,
    computing nothing.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, cost

COLS = 32               # table columns a block of pass 1 owns
VOCAB_TILE = 512        # ids a block's shared table holds (64 KB + a row)
BLOCKS_PER_SM = 3       # blocks of pass 1 an SM holds (3 × 64.1 KB)
MIN_ROWS = 256          # rows a chunk at least
_ID_CODES = {torch.int32: 0, torch.int64: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def embedding_grad_plain(grad: torch.Tensor, ids: torch.Tensor,
                         vocab: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: grad (*ids.shape, E) summed
    into a (vocab, E) table at the ids, in row order on the CPU."""
    E = grad.shape[-1]
    flat = ids.reshape(-1).long()
    flat = torch.where(flat < 0, flat + vocab, flat)
    return torch.zeros(vocab, E, dtype=grad.dtype,
                       device=grad.device).index_add_(
        0, flat, grad.reshape(-1, E))


def embedding_grad_cost(n: int, vocab: int, E: int, id_bytes: int,
                        chunks: int = 0):
    """(FLOPs, HBM bytes) of one gradient launch over n rows: one add a
    gradient value; the n × E f32 values and the n ids read once, the
    (vocab, E) f32 table written once, and, where ``chunks`` is given,
    the chunks' partial tables written by pass 1 and read by pass 2.
    ``chunks`` = 0 gives the least bytes, ``chip_smoke.py``'s bound."""
    table = vocab * E * 4
    return float(n * E), float(n * E * 4 + n * id_bytes + table
                               + 2 * chunks * table)


def chunk_count(n: int, vocab: int, E: int, sms: int) -> int:
    """Row chunks of pass 1: as many as fill the card's SMs once with
    ``BLOCKS_PER_SM`` blocks each, over the column and vocabulary tiles,
    and no chunk under ``MIN_ROWS`` rows (at least one chunk)."""
    tiles = math.ceil(E / COLS) * math.ceil(vocab / VOCAB_TILE)
    return max(1, min(math.ceil(sms * BLOCKS_PER_SM / tiles),
                      math.ceil(n / MIN_ROWS)))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _kernel():
    lib = build.load("embedding_grad")
    fn = lib.capsim_embedding_grad
    fn.argtypes = [_P, _P, _I, _L, _I, _I, _I, _P, _P, _P]
    fn.restype = ctypes.c_int
    return lib, fn


def check_lookup_args(table: torch.Tensor, ids: torch.Tensor) -> None:
    """Raise on what the gradient kernel does not take: a float32 (V, E)
    table on a CUDA (or meta) device, int32 or int64 ids on the same.  The
    one check of the ids: ``embedding_grad`` takes them as passed here."""
    what = "embedding_lookup"
    if table.device.type not in ("cuda", "meta"):
        raise ValueError(f"{what}: table on {table.device}, expected CUDA")
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"{what}: the table must be a float32 (V, E) "
                         f"tensor, got {table.dtype} {tuple(table.shape)}")
    if ids.dtype not in _ID_CODES:
        raise ValueError(f"{what}: ids must be int32 or int64, got "
                         f"{ids.dtype}")
    if ids.device != table.device:
        raise ValueError(f"{what}: ids on {ids.device}, table on "
                         f"{table.device}")


def embedding_grad(grad: torch.Tensor, ids: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """The gradient of ``table[ids]`` to a (vocab, E) table for the output
    gradient ``grad`` (*ids.shape, E).  CPU tensors take the plain
    version; CUDA tensors (a float32 ``grad``, ids as ``check_lookup_args``
    takes them) launch the kernel on the current stream; meta tensors
    report the cost and return an empty table."""
    E = grad.shape[-1]
    if grad.shape[:-1] != ids.shape:
        raise ValueError(f"embedding_grad: grad must be of shape ids.shape "
                         f"+ (E,) = {tuple(ids.shape)} + (E,), got "
                         f"{tuple(grad.shape)}")
    if grad.device.type == "cpu":
        return embedding_grad_plain(grad, ids, vocab)
    if grad.dtype != torch.float32:
        raise ValueError(f"embedding_grad: grad must be float32 on "
                         f"{grad.device}, got {grad.dtype}")
    n = ids.numel()
    if grad.device.type == "meta":
        cost.report("embedding_grad",
                    *embedding_grad_cost(n, vocab, E, ids.element_size()))
        return torch.empty(vocab, E, dtype=grad.dtype, device=grad.device)
    lib, fn = _kernel()
    g = grad.reshape(n, E).contiguous()
    flat = ids.reshape(n).contiguous()
    chunks = chunk_count(n, vocab, E, _sm_count(grad.device.index))
    part = torch.empty(chunks, vocab, E, dtype=torch.float32,
                       device=grad.device)
    out = torch.empty(vocab, E, dtype=torch.float32, device=grad.device)
    rc = fn(g.data_ptr(), flat.data_ptr(), _ID_CODES[ids.dtype], n, vocab,
            E, chunks, part.data_ptr(), out.data_ptr(),
            build.current_stream(grad.device))
    build.check(lib, rc, "embedding_grad")
    build.count_launch(embedding_grad)
    cost.launched("embedding_grad", torch.float32, *embedding_grad_cost(
        n, vocab, E, ids.element_size(), chunks))
    return out


embedding_grad.launches = 0


class _EmbeddingLookup(torch.autograd.Function):
    """The gather as the forward, ``embedding_grad`` as the backward."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        return table[ids]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        return embedding_grad(g, ids, ctx.vocab), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: (V, E) table, int ids of any shape -> (*ids.shape,
    E).  Where a gradient is wanted it comes back through
    ``embedding_grad``: the plain version on the CPU, the kernel on the
    card (the module docstring)."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[ids]
    if table.device.type != "cpu":
        check_lookup_args(table, ids)
    return _EmbeddingLookup.apply(table, ids)
