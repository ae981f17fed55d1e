"""Shared building blocks: param specs, seeded init, norms, activations,
rotary embeddings, the numpy parameter bridge.

Ports ``repro/models/layers.py:20-169``.  A ``ParamSpec`` tree describes
the parameters; ``init_from_specs`` materializes it as a nested dict of
tensors with the reference's shapes and init rule.  Dense weights keep
the reference's ``(d_in, d_out)`` layout (not ``nn.Linear``'s
``(out, in)``), whether drawn by ``init_from_specs`` (a generator on the
CPU: the CAPSim predictor) or ``init_from_seed`` (a counter hash on the
device: the LM zoo), so ``params_from_numpy``/``params_to_numpy`` move a
parameter tree between the packages unchanged.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, "
                         f"got {name!r}") from None


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    # the reference's logical axis names, one per dimension (None: no
    # names)
    logical_axes: Optional[Tuple[Optional[str], ...]] = None
    std: float = 0.0          # 0.0 -> zeros; <0 -> ones; >0 -> normal(std)
    dtype: Optional[str] = None  # override param dtype (e.g. fp32 norms)


def dense_spec(d_in: int, d_out: int, axes=None,
               scale: float = 1.0) -> ParamSpec:
    return ParamSpec((d_in, d_out), axes, std=scale / math.sqrt(d_in))


def specs_with_leading_stack(specs: dict, n: int) -> dict:
    """Prepend a 'layers' dimension of size n to every spec of the tree."""
    if isinstance(specs, ParamSpec):
        axes = (None if specs.logical_axes is None
                else ("layers",) + specs.logical_axes)
        return ParamSpec((n,) + specs.shape, axes, std=specs.std,
                         dtype=specs.dtype)
    return {k: specs_with_leading_stack(s, n) for k, s in specs.items()}


def init_from_specs(specs, generator: torch.Generator, param_dtype: str,
                    device: torch.device):
    """Materialize a spec tree: zeros for std == 0, ones for std < 0
    (Mamba2's ``A_log`` and ``D``), normal·std for std > 0.

    Draws on the CPU from ``generator`` in sorted key order, so a seed
    gives the same parameters on every device."""
    if isinstance(specs, ParamSpec):
        dt = torch_dtype(specs.dtype or param_dtype)
        if specs.std == 0.0:
            w = torch.zeros(specs.shape, dtype=torch.float32)
        elif specs.std < 0:
            w = torch.ones(specs.shape, dtype=torch.float32)
        else:
            w = torch.randn(specs.shape, generator=generator,
                            dtype=torch.float32) * specs.std
        return w.to(device=device, dtype=dt)
    return {k: init_from_specs(specs[k], generator, param_dtype, device)
            for k in sorted(specs)}


def abstract_from_specs(specs, param_dtype: str, blocks=None):
    """A spec tree as ``meta`` tensors (shapes and dtypes, no storage):
    the reference's ``abstract_from_specs``.  ``blocks`` (a tree like
    ``specs`` of (start, size) a dimension, ``block_bounds_tree``) gives
    each leaf the shape of the rank's block instead of the whole."""
    if isinstance(specs, ParamSpec):
        shape = specs.shape if blocks is None else tuple(
            n for _, n in blocks)
        return torch.empty(shape, dtype=torch_dtype(specs.dtype or
                                                    param_dtype),
                           device="meta")
    return {k: abstract_from_specs(specs[k], param_dtype,
                                   None if blocks is None else blocks[k])
            for k in sorted(specs)}


# a 64-bit counter hash (splitmix64's finalizer) in int64 tensor ops:
# multiplication wraps, and each right shift is masked to a logical one
_GOLDEN, _MIX1, _MIX2 = (c - (1 << 64) for c in (
    0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB))
_NORMAL_BITS = 16
_CHUNK = 1 << 24


def _normal_quantiles(device: torch.device) -> torch.Tensor:
    """The 2^16 standard-normal quantiles at (j + 0.5) / 2^16, f32
    (|z| <= 4.32)."""
    n = 1 << _NORMAL_BITS
    u = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    return torch.special.ndtri(u).float().to(device)


def _leaf_key(seed: int, path: str) -> int:
    digest = hashlib.blake2b(f"{seed}/{path}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little", signed=True)


def _global_index(zc: torch.Tensor, block, shape) -> None:
    """Turn the local flat indices in ``zc`` of a block (``block``: one
    (start, size) a dimension) into the indices of the same elements in
    the whole tensor of ``shape``, in place."""
    rem = zc.clone()
    zc.zero_()
    stride = 1
    for (start, size), full in reversed(list(zip(block, shape))):
        zc.add_((rem % size + start) * stride)
        rem.div_(size, rounding_mode="floor")
        stride *= full


def _seeded_normal(out: torch.Tensor, key: int, std: float,
                   table: torch.Tensor, block=None, shape=None) -> None:
    """Fill ``out`` with normal·std: element i takes the quantile that the
    top 16 bits of hash(i, key) pick, times std in f32, cast to out's
    dtype.  Integer ops, a gather and one f32 product are exact on every
    device, so the CPU and the card give the same bits.  With ``block``
    (one (start, size) a dimension of the whole ``shape``), ``out`` is
    that block and i the element's index in the whole tensor."""
    flat = out.view(-1)
    z = torch.empty(min(_CHUNK, flat.numel()), dtype=torch.int64,
                    device=out.device)
    tmp = torch.empty_like(z)
    for lo in range(0, flat.numel(), _CHUNK):
        hi = min(lo + _CHUNK, flat.numel())
        zc, tc = z[:hi - lo], tmp[:hi - lo]
        torch.arange(lo, hi, out=zc)
        if block is not None:
            _global_index(zc, block, shape)
        zc.mul_(_GOLDEN).add_(key)
        for shift, mul in ((30, _MIX1), (27, _MIX2), (31, None)):
            torch.bitwise_right_shift(zc, shift, out=tc)
            zc.bitwise_xor_(tc.bitwise_and_((1 << (64 - shift)) - 1))
            if mul is not None:
                zc.mul_(mul)
        zc.bitwise_right_shift_(64 - _NORMAL_BITS)
        zc.bitwise_and_((1 << _NORMAL_BITS) - 1)
        flat[lo:hi] = table[zc].mul_(std)


def init_from_seed(specs, seed: int, param_dtype: str,
                   device: torch.device, blocks=None):
    """Materialize a spec tree on ``device`` by the rule of
    ``init_from_specs``, with normal·std drawn by a counter hash of
    (seed, the leaf's path, the element's index) instead of a generator:
    every element is drawn on the device on its own, and a seed gives the
    same bits on every device.  Each draw is one of 2^16 normal quantiles
    (|z| <= 4.32), finer than a bfloat16 parameter resolves.  The LM zoo's
    init (``transformer.init_params``).

    ``blocks``, a tree like ``specs`` whose leaves are None (the whole
    tensor) or one (start, size) a dimension, draws only that block of a
    leaf: the same bits as cutting it from the whole draw (a rank's
    expert shard under a mesh)."""
    table = _normal_quantiles(device)

    def build(s, path: str, blk):
        if not isinstance(s, ParamSpec):
            return {k: build(s[k], f"{path}/{k}",
                             None if blk is None else blk.get(k))
                    for k in sorted(s)}
        dt = torch_dtype(s.dtype or param_dtype)
        shape = s.shape if blk is None else tuple(n for _, n in blk)
        if s.std == 0.0:
            return torch.zeros(shape, dtype=dt, device=device)
        if s.std < 0:
            return torch.ones(shape, dtype=dt, device=device)
        out = torch.empty(shape, dtype=dt, device=device)
        _seeded_normal(out, _leaf_key(seed, path), s.std, table, blk,
                       s.shape)
        return out
    return build(specs, "", blocks)


def remat_call(enabled: bool, fn, *args):
    """``fn(*args)``; with ``enabled`` and grad mode on, under
    ``torch.utils.checkpoint`` (non-reentrant): autograd keeps only the
    inputs, and the backward runs ``fn`` again to rebuild what it needs
    (the reference's ``jax.checkpoint(policy=nothing_saveable)``).  The
    recompute launches the kernels of ``fn`` a second time and runs its
    collectives again, in the same order on every rank, under the mesh,
    rules and layout of the forward: on the card the autograd engine
    runs the backward on a thread of its own, where none of them is
    active.  Nothing here draws random numbers, so the RNG state is not
    saved."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    from torch.utils.checkpoint import checkpoint

    from repro_torch.distributed.sharding import context, use_context
    ctx = context()

    def run(*a):
        with use_context(ctx):
            return fn(*a)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def local_params(params, specs):
    """A layer's parameters as this rank computes with them
    (``sharding.local_param`` of each leaf by its spec): the rank's
    blocks of the tensor-parallel dimensions, the FSDP rows gathered.
    As given without a mesh, or on a mesh of one device."""
    from repro_torch.distributed.sharding import (current_mesh,
                                                  current_rules, local_param)
    mesh = current_mesh()
    if mesh is None or not current_rules() or \
            mesh.size(mesh.axis_names) == 1:
        return params

    def walk(p, s):
        if isinstance(s, ParamSpec):
            return local_param(p, s.logical_axes, s.shape)
        return {k: walk(p[k], s[k]) for k in p}
    return walk(params, specs)


def block_bounds_tree(specs, mesh, rules):
    """A tree like ``specs`` of this rank's block of every leaf, one
    (start, size) a dimension (``init_from_seed``'s ``blocks``), by the
    leaf's spec under ``rules`` fitted to its shape."""
    from repro_torch.distributed.sharding import (axis_rules, block_bounds,
                                                  split_dims)
    if isinstance(specs, ParamSpec):
        dims = split_dims(specs.shape, axis_rules(specs.logical_axes, rules,
                                                  mesh), mesh)
        return block_bounds(specs.shape, tuple(d or None for d in dims),
                            mesh)
    return {k: block_bounds_tree(v, mesh, rules) for k, v in specs.items()}


def mark_tree(params, specs, mesh, rules):
    """Mark every leaf drawn as its block (``block_bounds_tree``) with
    the axes that split it (``sharding.mark``)."""
    from repro_torch.distributed.sharding import axis_rules, mark, split_dims
    if isinstance(specs, ParamSpec):
        return mark(params, split_dims(
            specs.shape, axis_rules(specs.logical_axes, rules, mesh), mesh))
    return {k: mark_tree(params[k], v, mesh, rules)
            for k, v in specs.items()}


def shardings_from_specs(specs, mesh, rules):
    """The reference's ``NamedSharding`` of every leaf: its logical axes
    resolved by ``rules`` on ``mesh`` (``sharding.logical_sharding``)."""
    from repro_torch.distributed.sharding import logical_sharding
    if isinstance(specs, ParamSpec):
        return logical_sharding(specs.logical_axes, mesh=mesh, rules=rules)
    return {k: shardings_from_specs(v, mesh, rules)
            for k, v in specs.items()}


def params_from_numpy(tree, device: DeviceLike = "cuda") -> dict:
    """A reference parameter pytree, as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), -> the port's tensors; layouts
    and dtypes unchanged (bfloat16 arrays arrive via float32)."""
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)
    return conv(tree)


def params_to_numpy(params) -> dict:
    """The port's parameters -> the reference's tree of numpy arrays
    (bfloat16 as float32)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #

def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
             eps: float = 1e-6) -> torch.Tensor:
    """f32 upcast, ``x·rsqrt(mean(x²)+eps)·(1+scale)``, cast back."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(dt)


def nonparam_layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: standardize, no learnable affine."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def norm(x: torch.Tensor, params: dict, cfg) -> torch.Tensor:
    if cfg.nonparametric_norm:
        return nonparam_layer_norm(x)
    return rms_norm(x, params["scale"])


def norm_spec(cfg) -> dict:
    if cfg.nonparametric_norm:
        return {}
    return {"scale": ParamSpec((cfg.d_model,), ("embed",), std=0.0,
                               dtype="float32")}


def activation(h: torch.Tensor, kind: str) -> torch.Tensor:
    """The FFN nonlinearity: squared ReLU, tanh-approximated GELU (as
    ``jax.nn.gelu``'s default), or SiLU (also SwiGLU's gate)."""
    if kind == "squared_relu":
        r = torch.relu(h)
        return r * r
    if kind == "gelu":
        return torch.nn.functional.gelu(h, approximate="tanh")
    if kind in ("silu", "swiglu"):
        return torch.nn.functional.silu(h)
    raise ValueError(kind)


# --------------------------------------------------------------------------- #
# Rotary embeddings (standard + M-RoPE)
# --------------------------------------------------------------------------- #

def _rope_freqs(head_dim: int, theta: float,
                device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B, S, H, D).  positions: (B, S) int, or (3, B, S) for M-RoPE.

    Half-split rotation with f32 angles, cast back to x's dtype.  M-RoPE
    (Qwen2-VL): the head_dim/2 frequency slots are split into sections
    (t, h, w); section i rotates by position stream i.
    """
    B, S, H, D = x.shape
    half = D // 2
    freqs = _rope_freqs(D, theta, x.device)                # (half,)
    if mrope_sections:
        if sum(mrope_sections) != half:
            raise ValueError(f"mrope_sections {mrope_sections} must sum to "
                             f"head_dim/2 = {half}")
        if positions.dim() != 3:
            raise ValueError("M-RoPE needs (3, B, S) positions")
        pos = torch.cat([positions[i][..., None].expand(B, S, sec)
                         for i, sec in enumerate(mrope_sections)], dim=-1)
        angle = pos.float() * freqs[None, None, :]           # (B, S, half)
    else:
        if positions.dim() == 3:
            positions = positions[0]
        angle = positions.float()[..., None] * freqs         # (B, S, half)
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
