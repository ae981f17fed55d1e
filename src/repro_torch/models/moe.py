"""Top-k MoE FFN, PyTorch port of ``repro/models/moe.py``: ``moe_specs``
(:36-45), ``_capacity`` (:48-51), the expert-parallel path
(``_moe_local`` :53-122 and ``moe_forward`` under a mesh, :125-166) and
the meshless path ``_run_local_nomesh`` (:169-204).

  route     router scores ``x.float() @ router`` (f32), softmax, top-k
            (ties to the lower expert, as ``lax.top_k``), the gates
            renormalized with a 1e-9 floor; each (token, slot)'s position
            is the exclusive running count of its expert in flattened
            ``t*k`` order, and it is kept while that position is below
            the capacity, which is computed from the tokens of one
            device (all B·S without a mesh)
  dispatch  the kept (token, slot) pairs of the shard's experts copied
            into a dense ``(E_loc, cap, d)`` buffer in the activation
            dtype; each (expert, position) holds at most one pair, so
            the reference's scatter-add is a copy (dropped pairs and
            other shards' pairs go to a scratch row past ``cap``)
  experts   ``torch.bmm`` over the buffer, every local expert, as the
            reference's einsums (no Pallas kernel there either):
            SwiGLU, squared ReLU or tanh GELU
  combine   the k slots summed in the activation dtype, in slot order,
            each gate cast to that dtype before it multiplies

``moe_shard`` is one device's body as a function of its 'model'
coordinate ``m``; it returns the partials that the reference joins with
collectives: y (summed over 'model') and the load-balance counts, mean
router probabilities and z (summed / averaged over the DP axes).  The
meshless path is the body with ``m = 0`` and every expert local.  Under
a mesh (``distributed/sharding.current_mesh``):

- The experts shard over 'model' (``E % n_model`` must be 0, else
  ValueError) and their d_model rows over 'data'.  A rank given the whole
  tensors takes its experts; a rank holding its ``(E/n_model, d/n_data,
  f)`` shard (``transformer.init_params(mesh=...)``) all-gathers the
  data shards inside the layer, as the reference (:59-61).
- The tokens split over the DP axes ('pod', 'data') in blocks of
  ``t_loc = B·S/dp`` flattened tokens, each device with its own
  capacity; where B·S does not divide, the tokens replicate and
  ``t_loc = B·S`` (:146-149).  The rank's rows (``current_layout``)
  are first gathered to that block: a sequence split over 'model'
  (sequence-parallel prefill) and a batch split over 'model'
  (``LOGICAL_RULES_TRAIN_FSDP``) are all-gathered, since the tokens
  replicate over 'model' (:9-11); the output is cut back to the rank's
  rows.  Where the rows replicate over the DP axes, the rank runs every
  DP block itself, which gives what those devices would.

A token's output depends on the batch it came in: the capacity counts
the device's tokens, and positions run over its flattened tokens.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import current_layout, current_mesh
from repro_torch.models.layers import ParamSpec, activation


def moe_specs(cfg) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    std = 1.0 / math.sqrt(d)
    return {
        "router": ParamSpec((d, E), ("embed", None), std=std,
                            dtype="float32"),
        "w_gate": ParamSpec((E, d, f), ("expert", "embed", "expert_mlp"),
                            std=std),
        "w_up": ParamSpec((E, d, f), ("expert", "embed", "expert_mlp"),
                          std=std),
        "w_down": ParamSpec((E, f, d), ("expert", "expert_mlp", "embed"),
                            std=1.0 / math.sqrt(f)),
    }


def capacity(tokens: int, k: int, n_exp: int, cf: float) -> int:
    """Slots per expert: ceil(cf·tokens·k / E), rounded up to a multiple
    of 8, at least 8."""
    c = int(math.ceil(cf * tokens * k / n_exp))
    return max(8, ((c + 7) // 8) * 8)


@dataclasses.dataclass
class Routing:
    """One call's routing.  scores/probs: (T, E) f32; gates: (T, k) f32
    renormalized; idx/pos: (T, k) int64 expert and position in it; keep:
    (T, k) bool, pos < cap."""
    scores: torch.Tensor
    probs: torch.Tensor
    gates: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of each row's k largest, largest first; equal
    values in expert order, as ``lax.top_k`` (a stable descending
    sort)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def route(router: torch.Tensor, xf: torch.Tensor, k: int,
          cf: float) -> Routing:
    """Route the (T, d) tokens ``xf`` over the (d, E) ``router``."""
    T, E = xf.shape[0], router.shape[1]
    cap = capacity(T, k, E, cf)
    scores = xf.float() @ router
    probs = torch.softmax(scores, dim=-1)
    gates, idx = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # exclusive running count of each expert in flattened (t, slot) order:
    # a stable sort by expert keeps that order inside each expert's run
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(flat.numel(), device=flat.device)
    pos = (rank - starts[flat]).reshape(T, k)
    return Routing(scores, probs, gates, idx, pos, pos < cap, cap)


# the reference's shard_map in_specs of the expert weights (:160-161):
# experts over 'model', d_model rows over 'data'
EXPERT_SPECS = {"w_gate": ("model", "data", None),
                "w_up": ("model", "data", None),
                "w_down": ("model", None, "data")}


@dataclasses.dataclass
class Partial:
    """One device's MoE before its collectives: y (T, d), this shard's
    experts' share (summed over 'model'); counts (E,) f32 of every
    (token, slot)'s expert, the mean router probabilities (E,) and the
    router z loss (summed / averaged over the DP axes); the routing."""
    y: torch.Tensor
    counts: torch.Tensor
    mean_probs: torch.Tensor
    z: torch.Tensor
    routing: Routing


def moe_shard(xf: torch.Tensor, router: torch.Tensor, w_gate, w_up,
              w_down: torch.Tensor, *, m: int, k: int, cf: float,
              activation_kind: str) -> Partial:
    """The body of one device (``_moe_local``): route every token of
    ``xf`` (T, d) over all E experts, with the capacity from T; keep the
    pairs whose expert is among this shard's ``E_loc = w_up.shape[0]``
    (experts ``m·E_loc ..``); run them."""
    E, e_loc, d = router.shape[1], w_up.shape[0], xf.shape[1]
    r = route(router, xf, k, cf)
    cap = r.cap
    local_e = r.idx - m * e_loc
    is_local = (local_e >= 0) & (local_e < e_loc)
    e_sel = torch.where(is_local, local_e, 0)
    keep = is_local & r.keep

    # dispatch: pair (t, j) -> buf[e, pos]; dropped pairs -> row cap
    buf = xf.new_zeros((e_loc, cap + 1, d))
    for j in range(k):
        buf[e_sel[:, j], torch.where(keep[:, j], r.pos[:, j], cap)] = xf
    buf = buf[:, :cap]

    up = torch.bmm(buf, w_up)
    if activation_kind == "swiglu":
        h = activation(torch.bmm(buf, w_gate), "silu") * up
    else:
        h = activation(up, activation_kind)
    down = torch.bmm(h, w_down)                              # (E_loc, cap, d)

    y = torch.zeros_like(xf)
    for j in range(k):
        p = torch.where(keep[:, j], r.pos[:, j], 0)
        w = (r.gates[:, j] * keep[:, j]).to(xf.dtype)
        y = y + down[e_sel[:, j], p] * w[:, None]

    counts = torch.bincount(r.idx.reshape(-1), minlength=E).float()
    z = torch.logsumexp(r.scores, dim=-1).square().mean()
    return Partial(y, counts, r.probs.mean(0), z, r)


def load_balance(counts, mean_probs, tokens: int, k: int) -> torch.Tensor:
    """E · sum(counts / (tokens·k) · mean_probs)."""
    E = counts.shape[0]
    return E * torch.sum(counts / (tokens * k) * mean_probs)


def local_experts(params: dict, mesh, m: int, e_loc: int) -> dict:
    """This shard's expert weights, (E_loc, d, f) / (E_loc, f, d): cut
    from whole tensors, or the rank's stored shard with its d_model rows
    all-gathered over 'data'."""
    out = {}
    for name, spec in EXPERT_SPECS.items():
        w = params[name]
        if w.shape[0] != e_loc:
            w = w[m * e_loc:(m + 1) * e_loc]
        d_dim = spec.index("data")
        if w.shape[d_dim] != params["router"].shape[0]:
            w = coll.all_gather(w, mesh, ("data",), d_dim)
        out[name] = w
    return out


def moe_forward(params: dict, x: torch.Tensor,
                cfg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d), the rank's rows -> (y (B, S, d) in x's dtype, lb_loss,
    z_loss)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    mesh = current_mesh()
    if mesh is None:
        p = moe_shard(x.reshape(B * S, d), params["router"],
                      params["w_gate"], params["w_up"],
                      params["w_down"], m=0, k=k, cf=cfg.capacity_factor,
                      activation_kind=cfg.activation)
        return (p.y.reshape(B, S, d),
                load_balance(p.counts, p.mean_probs, B * S, k), p.z)

    lay = current_layout()
    n_model = mesh.size("model") if "model" in mesh.axis_names else 1
    if E % n_model != 0:
        raise ValueError(f"{cfg.name}: experts={E} not divisible by "
                         f"model={n_model}")
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp = mesh.size(dp_axes)
    tokens = B * mesh.size(lay.batch) * S * mesh.size(lay.seq)
    if tokens % dp != 0:
        # batch too small to shard over the DP axes (long-context
        # decode): replicate tokens, keep EP over 'model' only
        dp_axes, dp = (), 1
    held = tuple(a for a in lay.batch if a in dp_axes)
    extra = tuple(a for a in lay.batch if a not in dp_axes)
    if held not in ((), dp_axes) or set(lay.seq) - {"model"}:
        raise NotImplementedError(f"MoE rows split over {lay}")
    # the rank's rows -> its DP block of tokens, replicated over 'model'
    xg = coll.all_gather(x, mesh, lay.seq, 1)
    xg = coll.all_gather(xg, mesh, extra, 0)
    t_loc = tokens // dp
    xf = xg.reshape(-1, d)
    blocks = [xf] if held or dp == 1 else list(xf.split(t_loc))
    m = mesh.index("model") if n_model > 1 else 0
    w = local_experts(params, mesh, m, E // n_model)
    parts = [moe_shard(b, params["router"], w["w_gate"], w["w_up"],
                       w["w_down"], m=m, k=k, cf=cfg.capacity_factor,
                       activation_kind=cfg.activation) for b in blocks]
    if len(parts) == 1:
        p = parts[0]
        y, counts, mean_probs, z = p.y, p.counts, p.mean_probs, p.z
    else:
        y = torch.cat([p.y for p in parts])
        counts = torch.stack([p.counts for p in parts]).sum(0)
        mean_probs = torch.stack([p.mean_probs for p in parts]).mean(0)
        z = torch.stack([p.z for p in parts]).mean()
    y = coll.all_reduce(y, mesh, ("model",), "sum") if n_model > 1 else y
    if held:
        counts = coll.all_reduce(counts, mesh, dp_axes, "sum")
        mean_probs = coll.mean_local_grad(mean_probs, mesh, dp_axes)
        z = coll.mean_local_grad(z, mesh, dp_axes)
    lb = load_balance(counts, mean_probs, t_loc * dp, k)
    y = coll.take_block(y.reshape(xg.shape), mesh, extra, 0)
    return coll.take_block(y, mesh, lay.seq, 1), lb, z


def moe_shards(params: dict, x: torch.Tensor, cfg, n_model: int) -> list:
    """The expert-parallel layer as ``n_model`` shards in one process
    (one device holding every shard; no DP split): each shard's
    ``Partial`` over all of x's tokens, their y to be summed."""
    e_loc = cfg.num_experts // n_model
    xf = x.reshape(-1, x.shape[-1])
    return [moe_shard(xf, params["router"],
                      params["w_gate"][m * e_loc:(m + 1) * e_loc],
                      params["w_up"][m * e_loc:(m + 1) * e_loc],
                      params["w_down"][m * e_loc:(m + 1) * e_loc], m=m,
                      k=cfg.experts_per_token, cf=cfg.capacity_factor,
                      activation_kind=cfg.activation)
            for m in range(n_model)]
