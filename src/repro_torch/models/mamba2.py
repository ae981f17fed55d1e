"""Mamba2 (SSD — state-space duality) mixer block, PyTorch port of
``repro/models/mamba2.py``.

Two paths over the same math (arXiv:2405.21060):

  prefill  the chunked SSD scan over the whole prompt, always through
           ``kernels.ssd.ops.ssd_scan`` (the CUDA kernel on a CUDA tensor,
           its plain version on a CPU tensor); returns the decode cache
  decode   the O(1) single-step state update, plain PyTorch (plain jnp in
           the reference too)

The reference's dtype order is kept: dt = softplus(f32(x·wdt) + dt_bias),
A = -exp(A_log) in f32, the skip ``xh·D`` in x's dtype, and the gate
``rms_norm(y · silu(f32 z).to(y.dtype), gate_norm)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import ParamSpec, dense_spec, rms_norm


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads


def ssm_specs(cfg) -> dict:
    d = cfg.d_model
    d_inner, nheads = ssm_dims(cfg)
    ds, w = cfg.ssm_state, cfg.ssm_conv_width
    return {
        "wz": dense_spec(d, d_inner),
        "wx": dense_spec(d, d_inner),
        "wB": dense_spec(d, ds),
        "wC": dense_spec(d, ds),
        "wdt": dense_spec(d, nheads),
        "conv_x": ParamSpec((w, d_inner), std=0.5),
        "conv_B": ParamSpec((w, ds), std=0.5),
        "conv_C": ParamSpec((w, ds), std=0.5),
        "A_log": ParamSpec((nheads,), std=-1.0, dtype="float32"),
        "dt_bias": ParamSpec((nheads,), std=0.0, dtype="float32"),
        "D": ParamSpec((nheads,), std=-1.0, dtype="float32"),
        "gate_norm": ParamSpec((d_inner,), std=0.0, dtype="float32"),
        "out_proj": dense_spec(d_inner, d),
    }


def _shift_conv(x: torch.Tensor, w: torch.Tensor,
                cache: Optional[torch.Tensor] = None):
    """Causal depthwise conv of width W via shifted adds, then SiLU.

    x: (B, S, C); w: (W, C).  With a decode cache (B, W-1, C) holding the
    previous W-1 inputs, S may be 1.  Returns (y, new_cache).

    Without a cache the input is padded with W-1 zero rows whatever S is;
    the reference pads with ``x[:, :W-1]``'s shape, which is short when
    S < W-1 (a 1-token prompt fails there, a 2-token one is misaligned)."""
    W = w.shape[0]
    if cache is None:
        cache = x.new_zeros(x.shape[0], W - 1, x.shape[2])
    xp = torch.cat([cache.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i: i + S] * w[i]
    # a copy: a view would keep the whole padded prefill input alive
    new_cache = xp[:, xp.shape[1] - (W - 1):].clone()
    return F.silu(y), new_cache


def ssd_decode_step(x, dt, B, C, A, state):
    """One-token SSD update.  x: (Bt, H, P); dt: (Bt, H); B/C: (Bt, N);
    state: (Bt, H, P, N) f32.  Returns (y in x's dtype, new_state)."""
    dA = torch.exp(dt.float() * A[None, :])                     # (Bt, H)
    upd = torch.einsum("bn,bh,bhp->bhpn", B.float(), dt.float(), x.float())
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", C.float(), new_state)
    return y.to(x.dtype), new_state


def init_ssm_cache_specs(cfg, batch: int) -> dict:
    d_inner, nheads = ssm_dims(cfg)
    ds, w = cfg.ssm_state, cfg.ssm_conv_width
    return {
        "conv_x": ParamSpec((batch, w - 1, d_inner)),
        "conv_B": ParamSpec((batch, w - 1, ds)),
        "conv_C": ParamSpec((batch, w - 1, ds)),
        "state": ParamSpec((batch, nheads, cfg.ssm_head_dim, ds),
                           dtype="float32"),
    }


def ssm_forward(params: dict, x: torch.Tensor, cfg, mode: str,
                cache: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (Bt, S, d).  mode: 'prefill' (returns the decode cache),
    'decode' (S == 1 against ``cache``) or 'train' (no cache).  Returns
    (out (Bt, S, d), updated cache or None)."""
    Bt, S, d = x.shape
    d_inner, nheads = ssm_dims(cfg)
    Pd = cfg.ssm_head_dim

    z = x @ params["wz"]
    xin = x @ params["wx"]
    Bp = x @ params["wB"]
    Cp = x @ params["wC"]
    dt = x @ params["wdt"]
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"].float())

    xin, cx = _shift_conv(xin, params["conv_x"],
                          None if cache is None else cache["conv_x"])
    Bp, cB = _shift_conv(Bp, params["conv_B"],
                         None if cache is None else cache["conv_B"])
    Cp, cC = _shift_conv(Cp, params["conv_C"],
                         None if cache is None else cache["conv_C"])

    xh = xin.view(Bt, S, nheads, Pd)

    new_cache = None
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError(f"decode needs a cache and S == 1, got S={S}")
        y, new_state = ssd_decode_step(
            xh[:, 0], dt[:, 0], Bp[:, 0], Cp[:, 0], A, cache["state"])
        y = y[:, None]                                   # (Bt, 1, H, P)
        new_cache = {"conv_x": cx, "conv_B": cB, "conv_C": cC,
                     "state": new_state}
    else:
        y, final_state = ssd_ops.ssd_scan(xh, dt, Bp, Cp, A, cfg.ssm_chunk)
        if mode == "prefill":
            new_cache = {"conv_x": cx, "conv_B": cB, "conv_C": cC,
                         "state": final_state}

    y = y + xh * params["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bt, S, d_inner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["gate_norm"])
    out = (y @ params["out_proj"]).to(x.dtype)
    return out, new_cache
