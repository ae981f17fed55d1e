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
    port's rows do change layout, it moves them with an explicit
    collective (the places are listed in ``models/transformer.py``)."""
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
