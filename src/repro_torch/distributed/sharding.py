"""Logical-axis sharding rules of the LM zoo, PyTorch port of
``repro/distributed/sharding.py`` (:35-291): the seven rule tables,
``_norm``, ``axis_rules``, ``use_mesh_and_rules``, ``current_mesh``,
``current_rules`` and ``logical_sharding``, verbatim; ``shard_logical``
with one stated deviation (below).

Model code never names mesh axes directly.  Params and activations carry
*logical* axis names; a rules table maps logical names -> mesh axes per
execution mode (train/prefill vs decode), for a (16, 16) single-pod mesh,
a (2, 16, 16) multi-pod mesh and a (1, 1) test mesh alike.

Mesh axes (``launch/mesh.py``):
    'pod'    inter-pod data parallelism (multi-pod only)
    'data'   intra-pod data parallelism + FSDP weight sharding
    'model'  tensor / expert parallelism

``axis_rules`` returns the port's ``PartitionSpec``, a tuple whose
entries are the reference's: a bare axis name for one axis, a tuple for
several, ``None`` for a replicated dimension.  ``compat_shard_map`` is
JAX's own and has no counterpart: the port writes each ``shard_map``
body as a function of its mesh coordinates and joins the bodies with
``torch.distributed`` collectives (``distributed/collectives.py``).

Beyond the reference, ``fit_spec`` applies ``shard_logical``'s rule (an
entry whose axes do not divide the dimension is dropped) and ``Layout``
/ ``layout`` say which mesh axes split the rows a rank holds: the port's
activations are the rank's own block, where the reference's are global
arrays that XLA places.

A rank's parameters (the last section).  Under a mesh a rank holds each
parameter whole or as its block by the leaf's spec (``fit_spec`` of
``param_shardings``): ``shard_tree`` cuts whole leaves to blocks,
``gather_tree`` joins blocks back to whole leaves, and ``split_of``
reads the axes each dimension of a block is split over, which
``mark`` records on the tensor when it is cut or drawn (the optimizer,
the gradient clipping, the data-parallel average and the checkpoint
read them).  ``local_param`` is how the model uses a leaf: a dimension
the layer computes on in blocks (``COMPUTED_IN_BLOCKS``: heads, FFN
columns, vocab, SSM channels, experts) is the rank's block (cut from a
whole leaf), any other split dimension (the FSDP ``'embed'`` rows) is
all-gathered before the use.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Tuple

Rules = Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...]


class PartitionSpec(tuple):
    """One entry per dimension: a mesh axis name, a tuple of names, or
    None.  Compares equal to the plain tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _norm(rules) -> Rules:
    out = []
    for name, axes in rules:
        if axes is None:
            out.append((name, None))
        elif isinstance(axes, str):
            out.append((name, (axes,)))
        else:
            out.append((name, tuple(axes)))
    return tuple(out)


# --------------------------------------------------------------------------- #
# Rule tables
# --------------------------------------------------------------------------- #

LOGICAL_RULES_TRAIN: Rules = _norm([
    # activations
    ("batch", ("pod", "data")),
    ("act_seq", None),
    ("act_embed", None),
    ("act_heads", "model"),
    ("act_mlp", "model"),
    ("act_ssm", "model"),
    ("act_vocab", "model"),
    # weights: FSDP over 'data' on the d_model rows, TP over 'model'
    ("embed", "data"),
    ("vocab", "model"),
    ("vocab_in", None),
    ("qkv", "model"),
    ("kv", None),
    ("mlp", "model"),
    ("expert", "model"),
    ("expert_mlp", None),
    ("ssm_inner", "model"),
    ("ssm_heads", "model"),
    ("ssm_state", None),
    ("conv_dim", "model"),
    ("layers", None),
    ("codebook", None),
    # decode caches (unused in train but kept total)
    ("cache_batch", ("pod", "data")),
    ("cache_seq", None),
    ("cache_kv", None),
    ("cache_head_dim", None),
])

# Decode: KV caches are sequence-sharded over 'model' (flash-decoding);
# SSM states are head-sharded.  Weights are TP-sharded but not FSDP'd
# ('embed' -> None): decode is latency-critical, and resident weights
# save re-gathering them every token step.
LOGICAL_RULES_DECODE: Rules = _norm([
    ("batch", ("pod", "data")),
    ("act_seq", None),
    ("act_embed", None),
    ("act_heads", "model"),
    ("act_mlp", "model"),
    ("act_ssm", "model"),
    ("act_vocab", "model"),
    ("embed", None),
    ("vocab", "model"),
    ("vocab_in", None),
    ("qkv", "model"),
    ("kv", None),
    ("mlp", "model"),
    ("expert", "model"),
    ("expert_mlp", None),
    ("ssm_inner", "model"),
    ("ssm_heads", "model"),
    ("ssm_state", None),
    ("conv_dim", "model"),
    ("layers", None),
    ("codebook", None),
    ("cache_batch", ("pod", "data")),
    ("cache_seq", "model"),
    ("cache_kv", None),
    ("cache_head_dim", None),
])

# Long-context decode (global batch smaller than the DP axes, e.g. the
# 500k-token single-sequence cells): no batch sharding; the KV cache's
# sequence dim shards over the whole mesh.
LOGICAL_RULES_DECODE_LONG: Rules = tuple(
    (name, (("pod", "data", "model") if name == "cache_seq" else
            (None if name in ("batch", "cache_batch") else axes)))
    for name, axes in LOGICAL_RULES_DECODE
)


# ZeRO-3 across pods: the train table with weight rows also sharded over
# 'pod'.
LOGICAL_RULES_TRAIN_ZERO3: Rules = tuple(
    (name, (("pod", "data") if name == "embed" else axes))
    for name, axes in _norm([
        ("batch", ("pod", "data")),
        ("act_seq", None), ("act_embed", None), ("act_heads", "model"),
        ("act_mlp", "model"), ("act_ssm", "model"), ("act_vocab", "model"),
        ("embed", "data"), ("vocab", "model"), ("vocab_in", None),
        ("qkv", "model"), ("kv", None), ("mlp", "model"),
        ("expert", "model"), ("expert_mlp", None),
        ("ssm_inner", "model"), ("ssm_heads", "model"), ("ssm_state", None),
        ("conv_dim", "model"), ("layers", None), ("codebook", None),
        ("cache_batch", ("pod", "data")), ("cache_seq", None),
        ("cache_kv", None), ("cache_head_dim", None),
    ])
)

# Pure ZeRO/FSDP: the batch shards over every mesh axis and weights
# shard over ('data', 'model') on their d_model rows, with no tensor
# parallelism.  Requires global_batch % chips == 0.
LOGICAL_RULES_TRAIN_FSDP: Rules = _norm([
    ("batch", ("pod", "data", "model")),
    ("act_seq", None), ("act_embed", None), ("act_heads", None),
    ("act_mlp", None), ("act_ssm", None), ("act_vocab", None),
    ("embed", ("data", "model")),
    ("vocab", None), ("vocab_in", None),
    ("qkv", None), ("kv", None), ("mlp", None),
    ("expert", "model"),            # MoE keeps EP over 'model'
    ("expert_mlp", None),
    ("ssm_inner", None), ("ssm_heads", None), ("ssm_state", None),
    ("conv_dim", None), ("layers", None), ("codebook", None),
    ("cache_batch", ("pod", "data", "model")),
    ("cache_seq", None), ("cache_kv", None), ("cache_head_dim", None),
])

# Sequence-parallel prefill: the residual stream shards its sequence over
# 'model' (no tensor parallelism).  FFNs and norms are local; attention
# (models/attention.sp_prefill_attention) all-gathers the small GQA K/V
# heads per layer.  Emitted KV caches are already in the decode layout
# (cache_seq='model').
LOGICAL_RULES_PREFILL_SP: Rules = _norm([
    ("batch", ("pod", "data")),
    ("act_seq", "model"),
    ("act_embed", None), ("act_heads", None), ("act_mlp", None),
    ("act_ssm", None), ("act_vocab", None),
    ("embed", ("data", "model")),
    ("vocab", None), ("vocab_in", None),
    ("qkv", None), ("kv", None), ("mlp", None),
    ("expert", "model"), ("expert_mlp", None),
    ("ssm_inner", None), ("ssm_heads", None), ("ssm_state", None),
    ("conv_dim", None), ("layers", None), ("codebook", None),
    ("cache_batch", ("pod", "data")),
    ("cache_seq", "model"),
    ("cache_kv", None), ("cache_head_dim", None),
])

# CAPSim predictor: ~2M params -> weights replicate everywhere; the clip
# batch is i.i.d. and shards over every mesh axis.
LOGICAL_RULES_PREDICTOR: Rules = _norm([
    ("batch", ("pod", "data", "model")),
    ("act_seq", None), ("act_embed", None), ("act_heads", None),
    ("act_mlp", None), ("act_vocab", None),
    ("embed", None), ("vocab", None), ("vocab_in", None),
    ("qkv", None), ("kv", None), ("mlp", None),
    ("layers", None),
])


# --------------------------------------------------------------------------- #
# Context: active mesh + rules
# --------------------------------------------------------------------------- #

class _Ctx(threading.local):
    mesh = None
    rules: Optional[Rules] = None
    layout = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh_and_rules(mesh, rules: Optional[Rules]):
    """Activate (mesh, rules) for logical-axis resolution."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, _norm(rules) if rules else None
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def context() -> tuple:
    """The active (mesh, rules, layout), for ``use_context`` to make
    active again on another thread (the autograd engine's, where a
    remat recompute may run)."""
    return _CTX.mesh, _CTX.rules, _CTX.layout


@contextlib.contextmanager
def use_context(ctx: tuple):
    """Activate a ``context()`` on this thread."""
    prev = context()
    _CTX.mesh, _CTX.rules, _CTX.layout = ctx
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.layout = prev


def current_mesh():
    return _CTX.mesh


def current_rules() -> Optional[Rules]:
    return _CTX.rules


def axis_rules(logical_axes: Sequence[Optional[str]],
               rules: Optional[Rules] = None,
               mesh=None) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec.

    A mesh axis is consumed at most once per spec (first logical axis
    wins); mesh axes absent from the mesh (e.g. 'pod' on a single-pod
    mesh) are dropped; axes whose size does not divide the dimension are
    not checked here (``fit_spec`` drops them)."""
    rules = rules if rules is not None else (_CTX.rules or ())
    mesh = mesh if mesh is not None else _CTX.mesh
    table = dict(rules)
    mesh_axis_names = set(mesh.axis_names) if mesh is not None else None
    used = set()
    spec = []
    for name in logical_axes:
        if name is None:
            spec.append(None)
            continue
        axes = table.get(name)
        if axes is None:
            spec.append(None)
            continue
        picked = []
        for ax in axes:
            if mesh_axis_names is not None and ax not in mesh_axis_names:
                continue
            if ax in used:
                continue
            picked.append(ax)
            used.add(ax)
        spec.append(tuple(picked) if len(picked) > 1
                    else (picked[0] if picked else None))
    return P(*spec)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``):
    ``rescale_state`` and ``transformer.init_params``/``init_cache`` cut
    a global array to the rank's block by it."""
    mesh: object
    spec: PartitionSpec


def logical_sharding(logical_axes: Sequence[Optional[str]], mesh=None,
                     rules: Optional[Rules] = None) -> NamedSharding:
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        raise ValueError("no active mesh; wrap in use_mesh_and_rules(...)")
    return NamedSharding(mesh, axis_rules(logical_axes, rules=rules,
                                          mesh=mesh))


def entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of mesh axes (() for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def fit_spec(spec: Sequence, shape: Sequence[int], mesh) -> PartitionSpec:
    """``spec`` with every entry whose axes' total size does not divide
    its dimension dropped to None (``shard_logical``'s rule for smoke
    meshes and batches smaller than the DP axes)."""
    fixed = []
    for dim, entry in zip(shape, spec):
        total = mesh.size(entry_axes(entry)) if entry is not None else 1
        fixed.append(entry if (total and dim % total == 0) else None)
    return P(*fixed)


def shard_logical(x, *logical_axes):
    """The reference's ``with_sharding_constraint`` by logical names.
    Stated deviation: the port hands no layout to a compiler, and a
    constraint never changes a value, so this checks that one name (or
    None) is given per dimension and returns ``x`` as it is.  Where the
    reference's layouts move data, the port moves it with explicit
    collectives, listed in ``models/transformer.py``: the FSDP gathers
    of ``local_param``, the row-parallel sums of the attention output,
    the FFN, the SSM's ``out_proj`` and the MoE's experts, the SSM
    gate norm's sum of squares, the vocab-parallel lookup, logsumexp,
    label logit and argmax, the query heads' gather where the heads do
    not divide (and before flash-decoding's merge), and the sequence
    and token gathers of sequence-parallel prefill and the MoE."""
    if len(logical_axes) != x.dim() or not all(
            a is None or isinstance(a, str) for a in logical_axes):
        raise ValueError(f"shard_logical: {logical_axes} for a tensor of "
                         f"{x.dim()} dimensions")
    return x


# --------------------------------------------------------------------------- #
# A rank's rows
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Layout:
    """The mesh axes that split what a rank holds: the batch rows of the
    activations and caches, the activations' sequence, and the KV
    cache's sequence.  Each is a tuple in row-major order; () means the
    rank holds the whole dimension.  ``Layout()`` is one device's."""
    batch: Tuple[str, ...] = ()
    seq: Tuple[str, ...] = ()
    cache_seq: Tuple[str, ...] = ()


def layout(batch: int, seq: int, cache_len: Optional[int] = None,
           mesh=None, rules: Optional[Rules] = None) -> Layout:
    """The ``Layout`` of global (batch, seq) activations and a KV cache of
    ``cache_len`` positions under the active (or given) mesh and rules:
    ``batch``/``act_seq`` and ``cache_seq`` resolved and fitted to the
    sizes as ``shard_logical`` fits them; axes of total size 1 split
    nothing and are left out.  Without a mesh or rules: ``Layout()``."""
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules if rules is not None else _CTX.rules
    if mesh is None or not rules:
        return Layout()

    def axes(entry):
        a = entry_axes(entry)
        return a if mesh.size(a) > 1 else ()
    b, s = fit_spec(axis_rules(("batch", "act_seq"), rules, mesh),
                    (batch, seq), mesh)
    cb, cs = fit_spec(axis_rules(("cache_batch", "cache_seq"), rules, mesh),
                      (batch, cache_len or 1), mesh)
    if cache_len is not None and axes(cb) != axes(b):
        raise ValueError(f"cache batch axes {cb} differ from the "
                         f"activations' {b}")
    return Layout(axes(b), axes(s), axes(cs) if cache_len else ())


@contextlib.contextmanager
def use_layout(lay: Optional[Layout]):
    """Activate the ``Layout`` of the rows the model is given
    (``transformer.forward`` sets it for its layers)."""
    prev = _CTX.layout
    _CTX.layout = lay
    try:
        yield
    finally:
        _CTX.layout = prev


def current_layout() -> Layout:
    return _CTX.layout or Layout()


def block_bounds(shape: Sequence[int], spec: Sequence, mesh):
    """This rank's block of an array of ``shape`` laid out by ``spec`` on
    ``mesh``: one (start, size) a dimension.  A sharded dimension must
    divide by its axes' size."""
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, entry in zip(shape, spec):
        axes = entry_axes(entry)
        n = mesh.size(axes) if axes else 1
        if dim % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"divide over {axes} ({n})")
        size = dim // n
        out.append(((mesh.index(axes) if axes else 0) * size, size))
    return tuple(out)


def take_spec_block(x, spec: Sequence, mesh):
    """``x`` (an array or tensor) cut to this rank's block by ``spec``."""
    return x[tuple(slice(a, a + n)
                   for a, n in block_bounds(x.shape, spec, mesh))]


# --------------------------------------------------------------------------- #
# A rank's parameters
# --------------------------------------------------------------------------- #

# logical axes a layer computes on in blocks: a split one stays the
# rank's block (tensor and expert parallelism); any other split
# dimension is all-gathered before use (FSDP)
COMPUTED_IN_BLOCKS = frozenset({"qkv", "mlp", "vocab", "ssm_inner",
                                "ssm_heads", "conv_dim", "expert"})

Dims = Tuple[Tuple[str, ...], ...]
_DIMS: dict = {}          # local_param's split_dims, by (mesh, rules, leaf)


def split_dims(shape: Sequence[int], spec: Sequence, mesh) -> Dims:
    """The mesh axes that split each dimension of an array of ``shape``
    laid out by ``spec`` (fitted to the shape first), axes of size 1
    left out: () for a whole dimension."""
    fitted = fit_spec(tuple(spec) + (None,) * (len(shape) - len(spec)),
                      shape, mesh)
    return tuple(tuple(a for a in entry_axes(e) if mesh.size(a) > 1)
                 for e in fitted)


def mark(t, dims: Dims):
    """Record on tensor ``t`` the axes each of its dimensions is split
    over (``split_dims``); returns ``t``."""
    t.split_dims = tuple(tuple(d) for d in dims)
    return t


def split_of(t) -> Dims:
    """The axes each dimension of ``t`` is split over: what ``mark``
    recorded, () for every dimension of an unmarked (whole) tensor."""
    return getattr(t, "split_dims", ((),) * t.dim())


def split_axes(t) -> Tuple[str, ...]:
    """Every mesh axis that splits ``t``."""
    return tuple(a for d in split_of(t) for a in d)


def take_dims_block(x, dims: Dims, mesh):
    """``x`` cut to this rank's block along every split dimension."""
    return take_spec_block(x, tuple(d or None for d in dims), mesh)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def shard_tree(tree, shardings):
    """A tree of whole leaves cut to this rank's blocks by ``shardings``
    (a like tree of ``NamedSharding``s, e.g. ``param_shardings``), each
    spec fitted to its leaf; each block is marked."""
    def cut(x, s):
        dims = split_dims(x.shape, s.spec, s.mesh)
        return mark(take_dims_block(x, dims, s.mesh).clone(), dims)
    return _map(cut, tree, shardings)


def gather_tree(tree, mesh=None):
    """A tree of marked blocks all-gathered to whole leaves (unmarked
    leaves as they are).  A collective: every rank of the mesh calls
    it."""
    import torch
    from repro_torch.distributed import collectives as coll
    mesh = mesh if mesh is not None else _CTX.mesh

    def join(x):
        for dim, axes in enumerate(split_of(x)):
            if axes:
                x = coll.all_gather(x, mesh, axes, dim)
        return x
    with torch.no_grad():
        return _map(join, tree)


def inherit_marks(new_tree, old_tree):
    """Copy each old leaf's mark onto the new leaf at its place (a train
    step's new state from the old)."""
    def copy(n, o):
        if hasattr(o, "split_dims") and hasattr(n, "dim"):
            mark(n, o.split_dims)
        return n
    return _map(copy, new_tree, old_tree)


def local_param(w, logical_axes: Sequence[Optional[str]],
                shape: Sequence[int]):
    """Leaf ``w`` of global ``shape`` as this rank computes with it under
    the active mesh and rules: along a split dimension named in
    ``COMPUTED_IN_BLOCKS`` the rank's block (cut when ``w`` is whole),
    along any other dimension the whole (a block all-gathered over the
    axes its ``mark`` names, else the active rules' axes: parameters cut
    by one rule table serve under another, as GSPMD reshards them).
    Without a mesh or rules, ``w``."""
    from repro_torch.distributed import collectives as coll
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or not rules or logical_axes is None:
        return w
    key = (mesh, rules, tuple(logical_axes), tuple(shape))
    dims = _DIMS.get(key)
    if dims is None:
        dims = _DIMS[key] = split_dims(
            shape, axis_rules(logical_axes, rules, mesh), mesh)
    held, gathers = split_of(w), []
    for d, (axes, name, full) in enumerate(zip(dims, logical_axes, shape)):
        if w.shape[d] == full:
            if axes and name in COMPUTED_IN_BLOCKS:
                w = coll.take_block(w, mesh, axes, d)
            continue
        if name not in COMPUTED_IN_BLOCKS:
            # an FSDP block: gathered over the axes it was cut by (its
            # mark), else by the active rules
            axes = held[d] or axes
        if not axes or w.shape[d] * mesh.size(axes) != full:
            raise ValueError(f"a leaf of {tuple(w.shape)} for "
                             f"{tuple(shape)}: dimension {d} ({name}) is "
                             f"neither whole nor its block over "
                             f"{axes or 'no axes'}")
        if name not in COMPUTED_IN_BLOCKS:
            gathers.append((axes, d))
    return coll.gather_param(w, mesh, gathers)


def spec_split(logical: str, size: int) -> Tuple[str, ...]:
    """The mesh axes (of size > 1) that split a dimension of ``size``
    named ``logical`` under the active mesh and rules (fitted)."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or not rules:
        return ()
    key = (mesh, rules, logical, size)
    if key not in _DIMS:
        _DIMS[key] = split_dims((size,), axis_rules((logical,), rules, mesh),
                                mesh)[0]
    return _DIMS[key]
