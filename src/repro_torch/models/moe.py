"""Top-k MoE FFN, PyTorch port of ``repro/models/moe.py``: ``moe_specs``
(:36-45), ``_capacity`` (:48-51) and the meshless path
``_run_local_nomesh`` (:169-204) that ``moe_forward`` takes without a
mesh.

  route     router scores ``x.float() @ router`` (f32), softmax, top-k
            (ties to the lower expert, as ``lax.top_k``), the gates
            renormalized with a 1e-9 floor; each (token, slot)'s position
            is the exclusive running count of its expert in flattened
            ``t*k`` order, and it is kept while that position is below
            the capacity, which is computed from every token of the call
  dispatch  the kept (token, slot) pairs copied into a dense ``(E, cap,
            d)`` buffer in the activation dtype; each (expert, position)
            holds at most one pair, so the reference's scatter-add is a
            copy (dropped pairs go to a scratch row past ``cap``)
  experts   ``torch.bmm`` over the buffer, every expert, as the
            reference's einsums (no Pallas kernel there either): SwiGLU,
            squared ReLU or tanh GELU
  combine   the k slots summed in the activation dtype, in slot order,
            each gate cast to that dtype before it multiplies

A token's output depends on the batch it came in: the capacity counts
all B·S tokens, and positions run over the flattened batch.  The
reference's expert-parallel ``shard_map`` path (per-device capacity) is
a multi-device path (ROADMAP port queue item 6b).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.models.layers import ParamSpec, activation


def moe_specs(cfg) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    std = 1.0 / math.sqrt(d)
    return {
        "router": ParamSpec((d, E), std=std, dtype="float32"),
        "w_gate": ParamSpec((E, d, f), std=std),
        "w_up": ParamSpec((E, d, f), std=std),
        "w_down": ParamSpec((E, f, d), std=1.0 / math.sqrt(f)),
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


def moe_forward(params: dict, x: torch.Tensor,
                cfg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, lb_loss, z_loss)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    xf = x.reshape(B * S, d)
    T = xf.shape[0]
    r = route(params["router"], xf, k, cfg.capacity_factor)
    cap = r.cap

    # dispatch: pair (t, j) -> buf[idx, pos]; dropped pairs -> row cap
    buf = xf.new_zeros((E, cap + 1, d))
    for j in range(k):
        buf[r.idx[:, j], torch.where(r.keep[:, j], r.pos[:, j], cap)] = xf
    buf = buf[:, :cap]

    up = torch.bmm(buf, params["w_up"])
    if cfg.activation == "swiglu":
        h = activation(torch.bmm(buf, params["w_gate"]), "silu") * up
    else:
        h = activation(up, cfg.activation)
    down = torch.bmm(h, params["w_down"])                   # (E, cap, d)

    y = torch.zeros_like(xf)
    for j in range(k):
        p = torch.where(r.keep[:, j], r.pos[:, j], 0)
        w = (r.gates[:, j] * r.keep[:, j]).to(xf.dtype)
        y = y + down[r.idx[:, j], p] * w[:, None]

    counts = torch.bincount(r.idx.reshape(-1), minlength=E).float()
    lb = E * torch.sum(counts / (T * k) * r.probs.mean(0))
    z = torch.logsumexp(r.scores, dim=-1).square().mean()
    return y.reshape(B, S, d), lb, z

