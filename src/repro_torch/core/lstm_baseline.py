"""Ithemal-style LSTM baseline (paper Fig 10 comparison), PyTorch port of
``repro/core/lstm_baseline.py``.

Hierarchical LSTM as Ithemal [16]: a token-level LSTM summarizes each
instruction's standardized tokens into an instruction embedding, an
instruction-level LSTM runs over the clip's instruction embeddings, and a
linear head maps the final hidden state to the clip runtime.  Same
softplus(CPI) · length output parameterization as the attention
predictor, so the Fig-10 comparison isolates the architecture.

The cell is the reference's, not ``nn.LSTM``'s (cuDNN's cell has two
biases, gates in another order and no forget-gate offset), so the loop
is written out: gates split i, f, g, o from one ``(d_in, 4·d_h)``
product plus one bias; the forget gate is ``sigmoid(f + 1)``; each
product is taken in the dtype JAX promotes its operands to (the compute
dtype meeting f32 parameters gives f32) and the gates cast to f32; ``c``
stays f32 and ``h`` is cast back to the input's dtype; a masked step
carries ``h`` and ``c`` through unchanged.  The input products of every
step are taken in one product before the loop.  The LSTM has no kernel
(the reference has no Pallas kernel for it); the token gather is the
predictor's ``embedding_lookup``, whose gradient on the card is a kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.embedding.ops import embedding_lookup
from repro_torch.models.layers import (ParamSpec, abstract_from_specs,
                                       dense_spec, init_from_specs,
                                       torch_dtype)


def _lstm_specs(d_in: int, d_h: int) -> dict:
    return {"wx": dense_spec(d_in, 4 * d_h, ("embed", "mlp")),
            "wh": dense_spec(d_h, 4 * d_h, ("embed", "mlp")),
            "b": ParamSpec((4 * d_h,), ("mlp",), std=0.0)}


def model_specs(cfg) -> dict:
    E = cfg.d_model
    return {
        "embed": ParamSpec((cfg.vocab_size, E), ("vocab_in", "embed"),
                           std=1.0 / math.sqrt(E)),
        "tok_lstm": _lstm_specs(E, E),
        "inst_lstm": _lstm_specs(E, E),
        "head": {"w": dense_spec(E, 1, ("embed", None)),
                 "b": ParamSpec((1,), (None,), std=0.0)},
    }


def init_params(cfg, seed: int = 0, device: DeviceLike = "cuda") -> dict:
    """Seeded random parameters by the reference's spec rule, drawn from a
    CPU ``torch.Generator`` (so not the reference's numbers)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return init_from_specs(model_specs(cfg), gen, cfg.param_dtype, dev)


def abstract_params(cfg) -> dict:
    """The parameters as ``meta`` tensors (the dry-run's)."""
    return abstract_from_specs(model_specs(cfg), cfg.param_dtype)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the dtype JAX's einsum promotes the two to."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _lstm(p: dict, xs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """xs: (B, S, D); mask: (B, S) 1 = valid.  Returns the last valid
    hidden state (B, H): masked steps carry the state through, so the
    final one is each sequence's at its true end."""
    B, S, _ = xs.shape
    H = p["wh"].shape[0]
    h = torch.zeros(B, H, dtype=xs.dtype, device=xs.device)
    c = torch.zeros(B, H, dtype=torch.float32, device=xs.device)
    gx = _mm(xs, p["wx"])                                # (B, S, 4H)
    keep = mask > 0
    for t in range(S):
        gates = gx[:, t] + _mm(h, p["wh"])
        gates = (gates + p["b"].to(gates.dtype)).float()
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = (torch.sigmoid(o) * torch.tanh(c_new)).to(h.dtype)
        m = keep[:, t, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
    return h


def forward(params: dict, batch: dict, cfg) -> torch.Tensor:
    """The attention predictor's batch layout (clip_tokens (B, L, T),
    clip_mask (B, L)); the context is unused (Ithemal has none).
    Returns predicted clip times (B,) in cycles: ``softplus(y) ·
    max(Σ clip_mask, 1)``."""
    clip_tokens = batch["clip_tokens"]
    clip_mask = batch["clip_mask"].float()
    B, L, T = clip_tokens.shape
    flat = clip_tokens.reshape(B * L, T)
    x = embedding_lookup(params["embed"], flat).to(torch_dtype(cfg.dtype))
    inst_emb = _lstm(params["tok_lstm"], x, (flat != 0).float())
    h = _lstm(params["inst_lstm"], inst_emb.reshape(B, L, -1), clip_mask)
    y = (_mm(h, params["head"]["w"]) + params["head"]["b"])[:, 0].float()
    n_inst = clip_mask.sum(-1).clamp(min=1.0)
    # jax.nn.softplus is logaddexp(y, 0) at every y (torch's softplus
    # switches to y above 20)
    return torch.logaddexp(y, torch.zeros_like(y)) * n_inst


def mape_loss(params: dict, batch: dict, cfg):
    """|prediction - fact| / fact averaged over the batch, the fact
    clamped to >= 1.  Returns (mape, {"mape": mape})."""
    pred = forward(params, batch, cfg)
    fact = batch["time"].float().clamp(min=1.0)
    mape = ((pred - fact).abs() / fact).mean()
    return mape, {"mape": mape}
