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
  combine   the k slots gathered from the experts' rows and summed in
            the activation dtype, in slot order, each gate cast to that
            dtype before it multiplies

``moe_shard`` is one device's body as a function of its 'model'
coordinate ``m``; it returns the partials that the reference joins with
collectives: y (summed over 'model') and the load-balance counts, mean
router probabilities and z (summed / averaged over the DP axes).  The
meshless path is the body with ``m = 0`` and every expert local.  Under
a mesh (``distributed/sharding.current_mesh``):

- The experts shard over 'model' (``E % n_model`` must be 0, else
  ValueError) and, where the rules split them (FSDP), their d_model rows
  over 'data'.  A rank given the whole tensors takes its experts; a rank
  holding its block (``transformer.init_params(mesh=...)``) all-gathers
  the rows inside the layer, as the reference (:59-61), and the router's
  likewise (``local_experts``).
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

NemotronH's layer (``cfg.router == "sigmoid"``): the scores are
``sigmoid(x.float() @ router)``; the top-k choice is made on the scores
plus ``router_bias`` (the published ``e_score_correction_bias``, which
only chooses: no gradient reaches it), the chosen scores are the
weights, renormalized (``/ (sum + 1e-20)``) and scaled by
``cfg.routed_scaling``; there is no load-balance or z loss (zeros).  A
shared expert (``cfg.shared_expert_d_ff``) runs on every token and is
added after the routed experts' sum (after the 'model' all-reduce under
a mesh, so it counts once).

Expert parallelism without a mesh (``cfg.experts_held``): the layer
holds ``experts_held`` experts, block ``cfg.expert_shard`` of them,
routes every token over all ``num_experts`` with the capacity from all
of them, and computes its own experts' part of the result, which is what
one rank of an expert-parallel deployment adds before the exchange.

Each call counts the (token, slot) pairs routed to the experts it holds
in ``capsim_moe_slots_total{outcome="kept"|"dropped"}`` (over capacity:
dropped; a remat recompute counts again).  The counts add up on the
device and reach the registry when it is next read (``count_slots``), so
a layer makes no host round trip for them; nothing is counted on
``meta``.  Within ``recorded_choices()`` each routing also hands its
expert choice to the caller, for a reference that replays it.

Gradients flow through every gather and sum of the expert-parallel
body (``distributed/collectives.py``'s adjoints), so the layer trains
with 'model' > 1; the routing is computed alike on every 'model' rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (current_layout, current_mesh,
                                              local_param)
from repro_torch.models.layers import ParamSpec, activation
from repro_torch.obs import REGISTRY

SLOTS_TOTAL = "capsim_moe_slots_total"
# sigmoid router: the spread of the drawn correction bias
ROUTER_BIAS_STD = 0.05


def moe_specs(cfg) -> dict:
    """The router over all ``num_experts`` and the experts held here
    (``experts_held``, or all); the sigmoid router's correction bias and
    the shared expert where the config has them."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    held = cfg.experts_held or E
    std = 1.0 / math.sqrt(d)
    specs = {
        "router": ParamSpec((d, E), ("embed", None), std=std,
                            dtype="float32"),
        "w_up": ParamSpec((held, d, f), ("expert", "embed", "expert_mlp"),
                          std=std),
        "w_down": ParamSpec((held, f, d), ("expert", "expert_mlp", "embed"),
                            std=1.0 / math.sqrt(f)),
    }
    if cfg.activation == "swiglu" or cfg.router == "softmax":
        specs["w_gate"] = ParamSpec((held, d, f),
                                    ("expert", "embed", "expert_mlp"),
                                    std=std)
    if cfg.router == "sigmoid":
        specs["router_bias"] = ParamSpec((E,), (None,), std=ROUTER_BIAS_STD,
                                         dtype="float32")
    fs = cfg.shared_expert_d_ff
    if fs:
        # whole on every 'model' rank: it runs once, after the exchange
        specs["shared_up"] = ParamSpec((d, fs), ("embed", None), std=std)
        specs["shared_down"] = ParamSpec((fs, d), (None, "embed"),
                                         std=1.0 / math.sqrt(fs))
        if cfg.activation == "swiglu":
            specs["shared_gate"] = ParamSpec((d, fs), ("embed", None),
                                             std=std)
    return specs


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


def expert_counts(idx: torch.Tensor, n_exp: int) -> torch.Tensor:
    """(E,) int64: how many entries of the flat ``idx`` pick each expert,
    ``bincount(idx, minlength=E)`` for ids < E, as a scatter of ones into
    E slots.  bincount's length follows the largest id, so it has no meta
    kernel; this one's is E whatever the data (the dry-run runs it on
    meta)."""
    return torch.zeros(n_exp, dtype=torch.int64, device=idx.device
                       ).index_add_(0, idx, torch.ones_like(idx))


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of each row's k largest, largest first; equal
    values in expert order, as ``lax.top_k`` (a stable descending
    sort)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def route(router: torch.Tensor, xf: torch.Tensor, k: int,
          cf: float, bias: Optional[torch.Tensor] = None,
          scaling: float = 1.0) -> Routing:
    """Route the (T, d) tokens ``xf`` over the (d, E) ``router``: softmax
    scores, or with ``bias`` (the sigmoid router's correction bias)
    sigmoid scores, chosen on scores + bias, weighted by the chosen
    scores renormalized and times ``scaling``."""
    T, E = xf.shape[0], router.shape[1]
    cap = capacity(T, k, E, cf)
    scores = xf.float() @ router
    if bias is None:
        probs = torch.softmax(scores, dim=-1)
        gates, idx = top_k(probs, k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.sigmoid(scores)
        _, idx = top_k(probs + bias, k)
        gates = probs.gather(1, idx)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) * scaling
    # exclusive running count of each expert in flattened (t, slot) order:
    # a stable sort by expert keeps that order inside each expert's run
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = expert_counts(flat, E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(flat.numel(), device=flat.device)
    pos = (rank - starts[flat]).reshape(T, k)
    for tap in _CHOICE_TAPS:
        tap.append(idx)
    return Routing(scores, probs, gates, idx, pos, pos < cap, cap)


_CHOICE_TAPS: list = []


@contextlib.contextmanager
def recorded_choices():
    """Within the block every routing appends its (T, k) expert choice
    (``Routing.idx``, in the order the routings run) to the yielded
    list."""
    got: list = []
    _CHOICE_TAPS.append(got)
    try:
        yield got
    finally:
        _CHOICE_TAPS.remove(got)


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
    slots: torch.Tensor = None     # (2,) int64: this shard's kept, dropped


def moe_shard(xf: torch.Tensor, router: torch.Tensor, w_gate, w_up,
              w_down: torch.Tensor, *, m: int, k: int, cf: float,
              activation_kind: str, bias: Optional[torch.Tensor] = None,
              scaling: float = 1.0) -> Partial:
    """The body of one device (``_moe_local``): route every token of
    ``xf`` (T, d) over all E experts, with the capacity from T; keep the
    pairs whose expert is among this shard's ``E_loc = w_up.shape[0]``
    (experts ``m·E_loc ..``); run them.  ``bias`` and ``scaling``: the
    sigmoid router (``route``)."""
    E, e_loc, d = router.shape[1], w_up.shape[0], xf.shape[1]
    r = route(router, xf, k, cf, bias, scaling)
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
    rows = down.reshape(e_loc * cap, d)
    for j in range(k):
        p = torch.where(keep[:, j], r.pos[:, j], 0)
        w = (r.gates[:, j] * keep[:, j]).to(xf.dtype)
        # a gather by index_select: its gradient is an index_add, parallel
        # over the pairs.  Advanced indexing's sorts the rows and walks each
        # row's repeats in series, and every pair not kept here reads row 0
        # (with weight 0): ~43,000 repeats a slot with 16 of 128 experts.
        y = y + rows.index_select(0, e_sel[:, j] * cap + p) * w[:, None]

    counts = expert_counts(r.idx.reshape(-1), E).float()
    z = torch.logsumexp(r.scores, dim=-1).square().mean()
    slots = torch.stack([keep.sum(), (is_local & ~r.keep).sum()])
    return Partial(y, counts, r.probs.mean(0), z, r, slots)


# device -> (2,) int64: kept and dropped pairs not yet in the registry
_PENDING_SLOTS: dict = {}
_PENDING_LOCK = threading.Lock()


def count_slots(parts) -> None:
    """Add the parts' kept and dropped pairs to the device's running
    total (no host round trip); ``_fold_slots`` moves it into
    ``capsim_moe_slots_total`` when the registry is read.  Nothing on
    ``meta``."""
    dev = parts[0].slots.device
    if dev.type == "meta":
        return
    total = torch.stack([p.slots for p in parts]).sum(0)
    with _PENDING_LOCK:
        acc = _PENDING_SLOTS.get(dev)
        _PENDING_SLOTS[dev] = total if acc is None else acc + total


def _fold_slots() -> None:
    with _PENDING_LOCK:
        totals = list(_PENDING_SLOTS.values())
        _PENDING_SLOTS.clear()
    if not totals:
        return
    fam = REGISTRY.counter(SLOTS_TOTAL, "(token, slot) pairs routed to the "
                           "experts held here, kept or dropped over their "
                           "capacity.", ("outcome",))
    for t in totals:
        kept, dropped = t.tolist()
        fam.labels(outcome="kept").inc(kept)
        fam.labels(outcome="dropped").inc(dropped)


REGISTRY.before_read(_fold_slots)


def shared_expert(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The shared expert over every token of ``x`` (.., d), in x's
    dtype."""
    h = x @ params["shared_up"]
    if cfg.activation == "swiglu":
        h = activation(x @ params["shared_gate"], "silu") * h
    else:
        h = activation(h, cfg.activation)
    return h @ params["shared_down"]


def load_balance(counts, mean_probs, tokens: int, k: int) -> torch.Tensor:
    """E · sum(counts / (tokens·k) · mean_probs)."""
    E = counts.shape[0]
    return E * torch.sum(counts / (tokens * k) * mean_probs)


def local_experts(params: dict, cfg) -> dict:
    """This rank's router and expert weights as its body computes with
    them (``sharding.local_param`` by ``moe_specs``): the router whole,
    the experts ``(E_loc, d, f)`` / ``(E_loc, f, d)``, cut from whole
    tensors or the rank's stored block, whose d_model rows are
    all-gathered over the axes that split them (the reference's
    ``shard_map`` in_specs, :59-61)."""
    specs = moe_specs(cfg)
    return {k: local_param(params[k], s.logical_axes, s.shape)
            for k, s in specs.items()}


def moe_forward(params: dict, x: torch.Tensor,
                cfg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d), the rank's rows -> (y (B, S, d) in x's dtype, lb_loss,
    z_loss)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    mesh = current_mesh()
    sigmoid = cfg.router == "sigmoid"
    kw = dict(k=k, cf=cfg.capacity_factor, activation_kind=cfg.activation,
              bias=params["router_bias"] if sigmoid else None,
              scaling=cfg.routed_scaling)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if mesh is None:
        p = moe_shard(x.reshape(B * S, d), params["router"],
                      params.get("w_gate"), params["w_up"],
                      params["w_down"], m=cfg.expert_shard, **kw)
        count_slots([p])
        y = p.y.reshape(B, S, d)
        if cfg.shared_expert_d_ff:
            y = y + shared_expert(params, x, cfg)
        if sigmoid:
            return y, zero, zero
        return y, load_balance(p.counts, p.mean_probs, B * S, k), p.z
    if cfg.experts_held:
        raise NotImplementedError("experts_held is the meshless layer of "
                                  "one expert-parallel rank")

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
    w = local_experts(params, cfg)
    if w["w_up"].shape[0] != E // n_model:
        raise ValueError(f"{cfg.name}: experts held {w['w_up'].shape[0]}, "
                         f"expected {E // n_model} a 'model' shard")
    parts = [moe_shard(b, w["router"], w.get("w_gate"), w["w_up"],
                       w["w_down"], m=m, **kw) for b in blocks]
    count_slots(parts)
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
    y = coll.take_block(y, mesh, lay.seq, 1)
    if cfg.shared_expert_d_ff:
        y = y + shared_expert(local_experts(params, cfg), x, cfg)
    if sigmoid:
        return y, zero, zero
    return y, lb, z


def moe_shards(params: dict, x: torch.Tensor, cfg, n_model: int) -> list:
    """The expert-parallel layer as ``n_model`` shards in one process
    (one device holding every shard; no DP split): each shard's
    ``Partial`` over all of x's tokens, their y to be summed."""
    e_loc = cfg.num_experts // n_model
    xf = x.reshape(-1, x.shape[-1])
    gate = params.get("w_gate")
    return [moe_shard(xf, params["router"],
                      None if gate is None
                      else gate[m * e_loc:(m + 1) * e_loc],
                      params["w_up"][m * e_loc:(m + 1) * e_loc],
                      params["w_down"][m * e_loc:(m + 1) * e_loc], m=m,
                      k=cfg.experts_per_token, cf=cfg.capacity_factor,
                      activation_kind=cfg.activation,
                      bias=params.get("router_bias"),
                      scaling=cfg.routed_scaling)
            for m in range(n_model)]
