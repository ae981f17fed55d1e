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

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import current_mesh, spec_split
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
        "wz": dense_spec(d, d_inner, ("embed", "ssm_inner")),
        "wx": dense_spec(d, d_inner, ("embed", "ssm_inner")),
        "wB": dense_spec(d, ds, ("embed", None)),
        "wC": dense_spec(d, ds, ("embed", None)),
        "wdt": dense_spec(d, nheads, ("embed", None)),
        "conv_x": ParamSpec((w, d_inner), (None, "ssm_inner"), std=0.5),
        "conv_B": ParamSpec((w, ds), (None, None), std=0.5),
        "conv_C": ParamSpec((w, ds), (None, None), std=0.5),
        "A_log": ParamSpec((nheads,), (None,), std=-1.0, dtype="float32"),
        "dt_bias": ParamSpec((nheads,), (None,), std=0.0, dtype="float32"),
        "D": ParamSpec((nheads,), (None,), std=-1.0, dtype="float32"),
        "gate_norm": ParamSpec((d_inner,), ("ssm_inner",), std=0.0,
                               dtype="float32"),
        "out_proj": dense_spec(d_inner, d, ("ssm_inner", "embed")),
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
        "conv_x": ParamSpec((batch, w - 1, d_inner),
                            ("cache_batch", None, "act_ssm")),
        "conv_B": ParamSpec((batch, w - 1, ds), ("cache_batch", None, None)),
        "conv_C": ParamSpec((batch, w - 1, ds), ("cache_batch", None, None)),
        "state": ParamSpec((batch, nheads, cfg.ssm_head_dim, ds),
                           ("cache_batch", "act_ssm", None, None),
                           dtype="float32"),
    }


def _gate_out(params: dict, g: torch.Tensor, sumsq: torch.Tensor,
              width: int, dtype: torch.dtype, eps: float = 1e-6
              ) -> torch.Tensor:
    """The gate norm and ``out_proj`` of a shard's channels: ``g`` (the
    gated y of its channels), normalized by ``sumsq``, the sum of squares
    over all ``width`` channels, then its rows of ``out_proj``: its
    partial output, before the row-parallel sum."""
    y = g.float() * torch.rsqrt(sumsq / width + eps)
    y = (y * (1.0 + params["gate_norm"].float())).to(g.dtype)
    return (y @ params["out_proj"]).to(dtype)


def ssm_heads(params: dict, x: torch.Tensor, cfg, mode: str,
              cache: Optional[dict] = None, heads: Optional[slice] = None,
              widen=None):
    """The mixer up to its gate norm on the channels ``params`` hold:
    ``wz``/``wx``/``conv_x`` whole or one shard's d_inner block, ``wB``,
    ``wC``, ``wdt``, the B/C convolutions, ``dt_bias``, ``A_log`` and
    ``D`` whole; ``heads`` the block's heads (None: all), or ``widen``
    the gather of the conv output to every channel where the block is
    not whole heads (its y is then every head's).  Returns (y (Bt, S,
    channels) in x's dtype with its skip term, z of the channels
    ``params`` hold, the cache of its heads)."""
    Bt, S, d = x.shape
    Pd = cfg.ssm_head_dim

    z = x @ params["wz"]
    xin = x @ params["wx"]
    Bp = x @ params["wB"]
    Cp = x @ params["wC"]
    dt = x @ params["wdt"]
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"].float())
    Dp = params["D"]

    xin, cx = _shift_conv(xin, params["conv_x"],
                          None if cache is None else cache["conv_x"])
    Bp, cB = _shift_conv(Bp, params["conv_B"],
                         None if cache is None else cache["conv_B"])
    Cp, cC = _shift_conv(Cp, params["conv_C"],
                         None if cache is None else cache["conv_C"])
    if heads is not None:
        dt, A, Dp = dt[..., heads], A[heads], Dp[heads]
    if widen is not None:
        xin = widen(xin)
    Hl = xin.shape[-1] // Pd
    xh = xin.view(Bt, S, Hl, Pd)

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

    y = y + xh * Dp.to(x.dtype)[None, None, :, None]
    y = y.reshape(Bt, S, Hl * Pd)
    return y, z, new_cache


def ssm_forward(params: dict, x: torch.Tensor, cfg, mode: str,
                cache: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (Bt, S, d).  mode: 'prefill' (returns the decode cache),
    'decode' (S == 1 against ``cache``) or 'train' (no cache).  Returns
    (out (Bt, S, d), updated cache or None).

    Tensor parallelism (``'ssm_inner'`` split over n ranks; ``params``
    as ``layers.local_params`` gives them): ``wz``, ``wx``, ``conv_x``,
    ``gate_norm`` are the rank's d_inner/n channels and ``out_proj`` its
    rows; ``wB``, ``wC``, ``wdt`` and the B/C convolutions are whole, and
    the rank takes its heads' slice of ``dt``, ``A`` and ``D``.  Where the
    heads divide over n the scan runs on the rank's nheads/n heads (the
    caches are its heads' block: conv_x channels and state heads, as
    ``'act_ssm'`` splits them); otherwise its conv output is
    all-gathered, every head scanned, and its channels kept.  The gate
    norm's sum of squares over d_inner and the row-parallel ``out_proj``
    are summed over the n ranks."""
    d_inner, nheads = ssm_dims(cfg)
    mesh = current_mesh()
    tp = spec_split("ssm_inner", d_inner)
    n = mesh.size(tp) if tp else 1
    if n == 1:
        y, z, new_cache = ssm_heads(params, x, cfg, mode, cache)
        y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["gate_norm"])
        return (y @ params["out_proj"]).to(x.dtype), new_cache
    if nheads % n == 0:
        hl = nheads // n
        y, z, new_cache = ssm_heads(params, x, cfg, mode, cache, slice(
            mesh.index(tp) * hl, (mesh.index(tp) + 1) * hl))
    else:
        y, z, new_cache = ssm_heads(params, x, cfg, mode, cache,
                                    widen=lambda t: coll.all_gather(
                                        t, mesh, tp, 2))
        y = coll.take_block(y, mesh, tp, 2)
    g = y * F.silu(z.float()).to(y.dtype)
    sumsq = coll.all_reduce(g.float().square().sum(dim=-1, keepdim=True),
                            mesh, tp)
    return coll.all_reduce(_gate_out(params, g, sumsq, d_inner, x.dtype),
                           mesh, tp), new_cache


def tp_shards(params: dict, x: torch.Tensor, cfg, n: int) -> list:
    """The tensor-parallel mixer (prefill, no cache) as n shards in one
    process: each shard's partial output from whole ``params`` cut to
    its d_inner/n channels and nheads/n heads (the SSD kernel at nheads/n
    heads), the gate norm's sums of squares added over the shards."""
    d_inner, nheads = ssm_dims(cfg)
    if nheads % n:
        raise ValueError(f"{nheads} heads do not split into {n} shards")
    c, hl = d_inner // n, nheads // n
    cut = []
    for m in range(n):
        ch = slice(m * c, (m + 1) * c)
        cut.append(dict(params, wz=params["wz"][:, ch],
                        wx=params["wx"][:, ch],
                        conv_x=params["conv_x"][:, ch],
                        gate_norm=params["gate_norm"][ch],
                        out_proj=params["out_proj"][ch]))
    gs = []
    for m, p in enumerate(cut):
        y, z, _ = ssm_heads(p, x, cfg, "train", None,
                            slice(m * hl, (m + 1) * hl))
        gs.append(y * F.silu(z.float()).to(y.dtype))
    sumsq = sum(g.float().square().sum(dim=-1, keepdim=True) for g in gs)
    return [_gate_out(p, g, sumsq, d_inner, x.dtype)
            for p, g in zip(cut, gs)]
