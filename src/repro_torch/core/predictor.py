"""CAPSim attention-based performance predictor (paper §III/§V, Fig 4),
PyTorch port of ``repro/core/predictor.py``.

Two-level architecture, Eq 5-9:

  instruction encoder   4 pre-norm transformer layers of self-attention over
                        each instruction's standardized tokens (L_token, E);
                        the <REP> position's output is RT_i (Eq 5-8).
  block encoder         sinusoidal positional encoding over the clip
                        sequence, then 4 layers in which the context matrix
                        self-attends and cross-attends into the instruction
                        vectors (Eq 9).
  head                  MLP -> per-row scalar -> mean -> softplus × the
                        clip's instruction count (cycles).

Parameters are a nested dict of tensors with the reference's tree and
layouts: dense weights are ``(d_in, d_out)`` and per-layer weights carry a
leading layer-stack axis, so ``params_from_numpy``/``params_to_numpy``
move a parameter tree between the packages unchanged.

Every attention goes through the port's kernels: ``flash_attention``
(instruction and block encoders) and ``weighted_attention`` (fused serving
step).  On CUDA tensors they launch the hand-written kernels, on CPU
tensors they run their plain versions; both follow the Pallas contract, in
which a query row with no valid key outputs zeros.  The reference's XLA
path (``attn_impl="chunked"``) averages V uniformly there instead, which
only changes rows that are masked downstream (RT row 0, padded drain
rows).  bf16 keeps f32 softmax and f32 accumulation inside the kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.fused_serving.ops import weighted_attention
from repro_torch.models.layers import (  # noqa: F401 (the bridge)
    ParamSpec, dense_spec, init_from_specs, params_from_numpy,
    params_to_numpy, rms_norm, specs_with_leading_stack, torch_dtype)

N_INST_LAYERS = 4
N_BLOCK_LAYERS = 4


# --------------------------------------------------------------------------- #
# Param specs, init and the bridge to the reference's parameter tree
# --------------------------------------------------------------------------- #

def _mha_specs(cfg, prefix: str = "") -> dict:
    E, HD = cfg.d_model, cfg.num_heads * cfg.head_dim
    return {f"{prefix}wq": dense_spec(E, HD),
            f"{prefix}wk": dense_spec(E, HD),
            f"{prefix}wv": dense_spec(E, HD),
            f"{prefix}wo": dense_spec(HD, E)}


def _ffn_specs(cfg) -> dict:
    E, F_ = cfg.d_model, cfg.d_ff
    return {"w1": dense_spec(E, F_), "w2": dense_spec(F_, E)}


def _norm_spec(cfg) -> ParamSpec:
    return ParamSpec((cfg.d_model,), std=0.0, dtype="float32")


def model_specs(cfg) -> dict:
    E, V = cfg.d_model, cfg.vocab_size
    inst = {**_mha_specs(cfg), **_ffn_specs(cfg),
            "norm1": _norm_spec(cfg), "norm2": _norm_spec(cfg)}
    block = {**_mha_specs(cfg, "self_"), **_mha_specs(cfg, "cross_"),
             **_ffn_specs(cfg), "norm1": _norm_spec(cfg),
             "norm2": _norm_spec(cfg), "norm3": _norm_spec(cfg)}
    return {
        "embed": ParamSpec((V, E), std=1.0 / math.sqrt(E)),
        "inst": specs_with_leading_stack(inst, N_INST_LAYERS),
        "block": specs_with_leading_stack(block, N_BLOCK_LAYERS),
        "final_norm": _norm_spec(cfg),
        "head": {"w1": dense_spec(E, E), "b1": ParamSpec((E,)),
                 "w2": dense_spec(E, 1), "b2": ParamSpec((1,))},
    }


def init_params(cfg, seed: int = 0, device: DeviceLike = "cuda") -> dict:
    """Seeded random parameters: normal·std for dense weights and the
    embedding, zeros for norms and biases (the reference's spec init,
    drawn from a ``torch.Generator``, so not the reference's numbers)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return init_from_specs(model_specs(cfg), gen, cfg.param_dtype, dev)


# --------------------------------------------------------------------------- #
# Attention primitives
# --------------------------------------------------------------------------- #

def _layer(stacked: dict, i: int) -> dict:
    return {k: v[i] for k, v in stacked.items()}


def _w(p, name, cfg):
    """fp32 master params compute in cfg.dtype (mixed precision)."""
    return p[name].to(torch_dtype(cfg.dtype))


def _heads(x, cfg):
    return x.unflatten(-1, (cfg.num_heads, cfg.head_dim))


def _mha(p, q_in, kv_in, cfg, kv_mask=None, prefix: str = ""):
    """q_in: (B, Sq, E); kv_in: (B, Sk, E); kv_mask: (B, Sk) 1=valid."""
    q = _heads(q_in @ _w(p, f"{prefix}wq", cfg), cfg)
    k = _heads(kv_in @ _w(p, f"{prefix}wk", cfg), cfg)
    v = _heads(kv_in @ _w(p, f"{prefix}wv", cfg), cfg)
    o = flash_attention(q, k, v, kv_mask=kv_mask).flatten(-2)
    return (o @ _w(p, f"{prefix}wo", cfg)).to(q_in.dtype)


def _ffn(p, x, cfg):
    h = x @ _w(p, "w1", cfg)
    out = F.gelu(h, approximate="tanh") @ _w(p, "w2", cfg)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #

def _sinusoidal(n: int, e: int, dtype, device=None) -> torch.Tensor:
    """[sin | cos] over positions 0..n-1, as the reference."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(e // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, 2.0 * dim / e)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


# On the card the instruction encoder runs its rows in passes of exactly
# ENCODE_CHUNK instructions (the last one padded with all-<PAD> rows).
# cuBLAS picks its GEMM kernel, and so its summation order, by the row
# count: the FFN's down-projection of a 32-row RT-cache encode pass and of
# a 32768-row monolithic batch differ in the last bits (ROADMAP C2,
# ``tools/c2_probe.py``).  With one pass size, an instruction's RT vector
# is the same bits whichever path and batch encode it.
ENCODE_CHUNK = 4096


def _encode_rows(params, flat, cfg):
    """(N, L_token) int rows -> (N, E): the 4 encoder layers, <REP> slot."""
    mask = (flat != 0).float()                           # <PAD> == 0
    x = params["embed"][flat].to(torch_dtype(cfg.dtype))
    inst = params["inst"]
    for i in range(inst["wq"].shape[0]):
        p = _layer(inst, i)
        h = rms_norm(x, p["norm1"])
        x = x + _mha(p, h, h, cfg, kv_mask=mask)
        x = x + _ffn(p, rms_norm(x, p["norm2"]), cfg)
    return x[:, 0, :]                                    # <REP> slot (Eq 8)


def instruction_encoder(params, clip_tokens, cfg):
    """clip_tokens: (B, L_clip, L_token) int -> RT vectors (B, L_clip, E).
    The (B, L_clip) axes fold into one batch: every instruction encodes
    independently (Eq 7), on the card in passes of ``ENCODE_CHUNK``."""
    B, L, T = clip_tokens.shape
    flat = clip_tokens.reshape(B * L, T)
    if flat.device.type != "cuda":
        return _encode_rows(params, flat, cfg).reshape(B, L, cfg.d_model)
    n = flat.shape[0]
    pad = -n % ENCODE_CHUNK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad, T)])
    rt = torch.cat([_encode_rows(params, flat[i:i + ENCODE_CHUNK], cfg)
                    for i in range(0, flat.shape[0], ENCODE_CHUNK)])
    return rt[:n].reshape(B, L, cfg.d_model)


def block_encoder(params, rt, ctx, clip_mask, cfg):
    """rt: (B, L_clip, E) instruction vectors; ctx: (B, M, E) context rows
    or None (the no-context ablation, where the instruction stream
    self-attends).  Returns (out, out_mask); out_mask None = all rows."""
    B, L, E = rt.shape
    rt = rt + _sinusoidal(L, E, rt.dtype, rt.device)[None]
    blk = params["block"]
    h = rt if ctx is None else ctx
    for i in range(blk["self_wq"].shape[0]):
        p = _layer(blk, i)
        n1 = rms_norm(h, p["norm1"])
        self_mask = clip_mask if ctx is None else None
        h = h + _mha(p, n1, n1, cfg, kv_mask=self_mask, prefix="self_")
        h = h + _mha(p, rms_norm(h, p["norm2"]), rt, cfg, kv_mask=clip_mask,
                     prefix="cross_")
        h = h + _ffn(p, rms_norm(h, p["norm3"]), cfg)
    return h, (clip_mask if ctx is None else None)


def encode_instructions(params, token_rows, cfg):
    """Static half of the split forward: (N, L_token) int standardized
    rows -> (N, E) RT vectors — the RT-cache build."""
    return instruction_encoder(params, token_rows[None], cfg)[0]


def _head(params, out, cfg):
    """final norm + MLP head -> per-row f32 scalar (B, rows)."""
    dt = torch_dtype(cfg.dtype)
    h = rms_norm(out, params["final_norm"])
    hw = params["head"]
    h = F.gelu(h @ hw["w1"].to(dt) + hw["b1"].to(dt), approximate="tanh")
    y = (h @ hw["w2"].to(dt) + hw["b2"].to(dt))[..., 0]
    return y.float()


def block_forward(params, rt, batch, cfg, use_context: bool = True):
    """Dynamic half of the split forward: block encoder + head over
    already-encoded RT vectors.  batch supplies context_tokens (B, M) and
    clip_mask (B, L_clip).  Returns predicted clip times (B,) in cycles."""
    clip_mask = batch["clip_mask"].float()
    ctx = None
    if use_context:
        ctx = params["embed"][batch["context_tokens"]].to(
            torch_dtype(cfg.dtype))
    out, out_mask = block_encoder(params, rt, ctx, clip_mask, cfg)
    y = _head(params, out, cfg)
    if out_mask is None:
        cpi = y.mean(dim=-1)                             # arithmetic mean
    else:
        cpi = (y * out_mask).sum(-1) / out_mask.sum(-1).clamp(min=1.0)
    n_inst = clip_mask.sum(-1).clamp(min=1.0)
    return F.softplus(cpi) * n_inst                      # cycles


def forward(params, batch, cfg, use_context: bool = True):
    """batch: clip_tokens (B,L,T), context_tokens (B,M), clip_mask (B,L).
    Monolithic path: the instruction encoder runs over every clip row."""
    rt = instruction_encoder(params, batch["clip_tokens"], cfg)
    return block_forward(params, rt, batch, cfg, use_context)


def forward_cached(params, rt_table, batch, cfg, use_context: bool = True):
    """RT-cache path: batch carries rt_idx (B, L_clip) rows into
    ``rt_table`` ((C, E), from ``encode_instructions``)."""
    return block_forward(params, rt_table[batch["rt_idx"]], batch, cfg,
                         use_context)


# --------------------------------------------------------------------------- #
# Fused serving step (EngineConfig.fused_serving)
# --------------------------------------------------------------------------- #
#
# The reference's two identities: cross-attention K/V are linear in
# rt_table[rt_idx] + posenc, so (table @ cross_wk/wv) is precomputed once
# per table version; and the context stream carries no positional
# encoding, so self-attention over the M context tokens equals weighted
# attention over each row's unique tokens with multiplicity weights.

def serving_plan(params, rt_table, cfg):
    """Per-table-version precompute for ``forward_cached_fused``: the
    cross-attention K/V projections of every RT row, (L_layers, N, H·Dh).
    Rebuild whenever the table's rows change (the engine keys on the
    cache's version counter)."""
    dt = torch_dtype(cfg.dtype)
    table = rt_table.to(dt)
    blk = params["block"]
    return {"cross_kt": table @ blk["cross_wk"].to(dt),
            "cross_vt": table @ blk["cross_wv"].to(dt)}


def _weighted_mha(q, k, v, weight, cfg):
    """Multi-head weighted attention over projected q/k/v ((B, S, H·Dh),
    any row stride); weight (B, Skv) f32 multiplicities."""
    o = weighted_attention(_heads(q, cfg), _heads(k, cfg), _heads(v, cfg),
                           weight)
    return o.flatten(-2)


def forward_cached_fused(params, plan, batch, cfg):
    """Fused serving twin of ``forward_cached`` (context path only).

    batch carries rt_idx (B, L_clip), ctx_uniq (B, U) deduped context
    token ids, ctx_count (B, U) f32 multiplicities (summing to M per row),
    clip_mask (B, L_clip).  Returns predicted clip times (B,) in cycles."""
    idx = batch["rt_idx"]
    cw = batch["ctx_count"].float()
    clip_mask = batch["clip_mask"].float()
    L = idx.shape[1]
    dt = torch_dtype(cfg.dtype)
    blk = params["block"]
    hd = cfg.num_heads * cfg.head_dim

    pos = _sinusoidal(L, cfg.d_model, dt, idx.device)
    pk = pos @ blk["cross_wk"].to(dt)                    # (Lyr, L, HDh)
    pv = pos @ blk["cross_wv"].to(dt)
    k_all = plan["cross_kt"][:, idx] + pk[:, None]       # (Lyr, B, L, HDh)
    v_all = plan["cross_vt"][:, idx] + pv[:, None]
    wqkv = torch.cat([blk["self_wq"], blk["self_wk"], blk["self_wv"]],
                     dim=-1).to(dt)                      # (Lyr, E, 3·HDh)

    h = params["embed"][batch["ctx_uniq"]].to(dt)        # (B, U, E)
    for i in range(wqkv.shape[0]):
        lp = _layer(blk, i)
        q, sk, sv = (rms_norm(h, lp["norm1"]) @ wqkv[i]).split(hd, dim=-1)
        o = _weighted_mha(q, sk, sv, cw, cfg)
        h = h + (o @ _w(lp, "self_wo", cfg)).to(h.dtype)
        q2 = rms_norm(h, lp["norm2"]) @ _w(lp, "cross_wq", cfg)
        o2 = _weighted_mha(q2, k_all[i], v_all[i], clip_mask, cfg)
        h = h + (o2 @ _w(lp, "cross_wo", cfg)).to(h.dtype)
        h = h + _ffn(lp, rms_norm(h, lp["norm3"]), cfg)

    y = _head(params, h, cfg)
    # head mean over the M context rows == count-weighted mean over uniques
    cpi = (y * cw).sum(-1) / cw.sum(-1).clamp(min=1.0)
    n_inst = clip_mask.sum(-1).clamp(min=1.0)
    return F.softplus(cpi) * n_inst


# Inference precision: fp32 is the reference mode; bf16 casts the fp32
# master params at dispatch (``_w``) with f32 softmax and accumulation in
# the kernels; int8 is storage precision — weights are per-channel
# fake-quantized once at engine build (``core.quant``), compute stays fp32.
PRECISION_DTYPES = {"fp32": "float32", "bf16": "bfloat16",
                    "int8": "float32"}


def inference_config(cfg, precision: Optional[str] = None):
    """Resolve the inference-time numerics: ``precision`` None leaves
    cfg.dtype untouched; "fp32"/"bf16"/"int8" select the compute dtype."""
    if precision is None:
        return cfg
    try:
        return cfg.replace(dtype=PRECISION_DTYPES[precision])
    except KeyError:
        raise ValueError(
            f"precision must be one of {sorted(PRECISION_DTYPES)}, "
            f"got {precision!r}") from None
