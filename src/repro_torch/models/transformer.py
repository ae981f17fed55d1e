"""Decoder LM of the zoo, PyTorch port of ``repro/models/transformer.py``
(:46-300, :338-346): parameter and cache specs, seeded init, the forward
pass in its three modes, and the prefill/decode steps.

One model definition driven by ``ArchConfig``: the per-layer schedule
``cfg.pattern()`` gives each layer of a super-block its mixer and FFN, and
the stack runs ``num_repeats`` super-blocks (a Python loop over the stacked
layer parameters where the reference scans).  Ported: the SSM mixer
(Mamba2), the attention mixer (``models/attention.py``, with Qwen2-VL's
M-RoPE), the dense FFN and the top-k MoE FFN (``models/moe.py``), in any
schedule the config gives (jamba's super-block mixes all four); the
modality frontend stubs (precomputed embeddings prepended to the token
embeddings) and MusicGen's parallel codebooks (a (C, V, d) embedding
table summed over the codebooks, a (C, d, V) unembedding giving (B, S,
C, V) logits), and ``loss_fn``, the causal-LM loss with the MoE's
load-balance and router z losses that training minimizes.

Decode writes each attention layer's new key and value into the caches
it is given, in place, and returns those caches; an SSM layer's new
state is a new tensor.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as ssm_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (ParamSpec, activation, dense_spec,
                                       init_from_seed, norm, norm_spec,
                                       specs_with_leading_stack, torch_dtype)

NEG_LOGIT = -1e30


# --------------------------------------------------------------------------- #
# Param specs
# --------------------------------------------------------------------------- #

def _ffn_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.activation == "swiglu":
        return {"w_gate": dense_spec(d, f), "w_up": dense_spec(d, f),
                "w_down": dense_spec(f, d)}
    return {"w_up": dense_spec(d, f), "w_down": dense_spec(f, d)}


def _block_specs(cfg, mixer: str, ffn: str) -> dict:
    specs = {"norm1": norm_spec(cfg)}
    specs["mixer"] = (attn_mod.attn_specs(cfg) if mixer == "attn"
                      else ssm_mod.ssm_specs(cfg))
    if ffn == "dense":
        specs["norm2"] = norm_spec(cfg)
        specs["ffn"] = _ffn_specs(cfg)
    elif ffn == "moe":
        specs["norm2"] = norm_spec(cfg)
        specs["ffn"] = moe_mod.moe_specs(cfg)
    return specs


def padded_vocab(cfg) -> int:
    """Embedding tables pad the vocab up to a multiple of 16 (the
    reference's tensor-parallel table padding).  Padded logit columns are
    set to -1e30 in ``_logits``; token ids stay < cfg.vocab_size."""
    m = 16
    return (cfg.vocab_size + m - 1) // m * m


def model_specs(cfg) -> dict:
    """The parameter tree's specs.  With C > 1 codebooks the embedding is
    (C, V_pad, d) and an untied unembedding (C, d, V_pad)."""
    d, V = cfg.d_model, padded_vocab(cfg)
    books = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    std = 1.0 / math.sqrt(d)
    specs: dict = {"embed": ParamSpec(books + (V, d), std=std)}
    specs["blocks"] = {
        f"i{j}": specs_with_leading_stack(_block_specs(cfg, mixer, ffn),
                                          cfg.num_repeats)
        for j, (mixer, ffn) in enumerate(cfg.pattern())}
    specs["final_norm"] = norm_spec(cfg)
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec(books + (d, V), std=std)
    return specs


def cache_specs(cfg, batch: int, max_seq: int) -> dict:
    """Stacked per-layer decode caches (leading num_repeats dim): the
    attention KV cache (B, max_seq, KV, Dh), or the SSM cache, which does
    not grow with the sequence."""
    return {f"i{j}": specs_with_leading_stack(
        attn_mod.init_cache_specs(cfg, batch, max_seq) if mixer == "attn"
        else ssm_mod.init_ssm_cache_specs(cfg, batch), cfg.num_repeats)
        for j, (mixer, _) in enumerate(cfg.pattern())}


def init_params(cfg, seed: int = 0, device: DeviceLike = "cuda") -> dict:
    """Seeded random parameters by the reference's spec rule (zeros for
    the norm scales, ones for ``A_log``/``D``, normal·std), drawn on
    ``device`` by ``layers.init_from_seed``: a seed gives the same
    parameters on every device (not the reference's numbers)."""
    return init_from_seed(model_specs(cfg), seed, cfg.param_dtype,
                          resolve_device(device))


def init_cache(cfg, batch: int, max_seq: int, dtype: Optional[str] = None,
               device: DeviceLike = "cuda") -> dict:
    dev = resolve_device(device)
    dt = dtype or cfg.dtype

    def zeros(s):
        if isinstance(s, ParamSpec):
            return torch.zeros(s.shape, dtype=torch_dtype(s.dtype or dt),
                               device=dev)
        return {k: zeros(v) for k, v in s.items()}
    return zeros(cache_specs(cfg, batch, max_seq))


def place_caches(cfg, caches: dict, max_seq: int) -> dict:
    """A prefill's caches as decode caches of ``max_seq`` positions: each
    attention layer's (R, B, S, KV, Dh) k/v copied to positions [0, S) of
    a zero cache (the reference's ``serve_lm`` placement); SSM caches (a
    hybrid's too) as they are."""
    out = dict(caches)
    for j, (mixer, _) in enumerate(cfg.pattern()):
        if mixer != "attn":
            continue
        out[f"i{j}"] = {}
        for name, src in caches[f"i{j}"].items():
            R, B, S = src.shape[:3]
            if S > max_seq:
                raise ValueError(f"a prefill of {S} tokens does not fit "
                                 f"{max_seq} cache positions")
            dst = src.new_zeros((R, B, max_seq) + tuple(src.shape[3:]))
            dst[:, :, :S] = src
            out[f"i{j}"][name] = dst
    return out


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #

def _embed_tokens(params, tokens, cfg):
    """(B, S) ids, or (B, S, C) with codebooks -> (B, S, d) in cfg.dtype.
    The C lookups are summed in the parameter dtype in codebook order
    (the reference's ``sum``: ((e0 + e1) + e2) + e3), then cast."""
    emb = params["embed"]
    if cfg.num_codebooks > 1:
        x = emb[0][tokens[..., 0]]
        for c in range(1, cfg.num_codebooks):
            x = x + emb[c][tokens[..., c]]
    else:
        x = emb[tokens]
    return x.to(torch_dtype(cfg.dtype))


def _block_forward(bparams, x, cfg, mode, cache, positions=None,
                   cache_pos=None, kind=None):
    """One layer: pre-norm mixer and residual, then (dense or MoE FFN)
    pre-norm FFN and residual.  ``kind`` is its (mixer, ffn), by default
    the schedule's first; ``positions`` and ``cache_pos`` feed attention.
    Returns (x, new cache, lb, z): the MoE FFN's auxiliary losses, f32
    zeros for another layer."""
    mixer, ffn = kind or cfg.pattern()[0]
    h = norm(x, bparams["norm1"], cfg)
    if mixer == "attn":
        y, new_cache = attn_mod.attention_forward(
            bparams["mixer"], h, positions, cfg, mode, cache, cache_pos)
    else:
        y, new_cache = ssm_mod.ssm_forward(bparams["mixer"], h, cfg, mode,
                                           cache)
    x = x + y
    lb = z = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "moe":
        y, lb, z = moe_mod.moe_forward(bparams["ffn"],
                                       norm(x, bparams["norm2"], cfg), cfg)
        x = x + y
    elif ffn == "dense":
        h = norm(x, bparams["norm2"], cfg)
        p = bparams["ffn"]
        up = h @ p["w_up"]
        if cfg.activation == "swiglu":
            a = activation(h @ p["w_gate"], "silu") * up
        else:
            a = activation(up, cfg.activation)
        x = x + a @ p["w_down"]
    return x, new_cache, lb, z


def _index(tree, r: int):
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _stack(trees: list):
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _stack_forward(params, x, cfg, mode: str, caches=None, positions=None,
                   cache_pos=None):
    """Run the ``num_repeats`` super-blocks in order; returns (x, stacked
    new caches or None, lb, z), the MoE losses summed over the layers in
    order.  In decode an attention layer's cache is a view of ``caches``,
    updated in place, so those stay as they are."""
    pattern = cfg.pattern()
    per_repeat = []
    lb_sum = z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(cfg.num_repeats):
        bparams = _index(params["blocks"], r)
        bcaches = None if caches is None else _index(caches, r)
        new_caches = {}
        for j, kind in enumerate(pattern):
            cache_j = None if bcaches is None else bcaches[f"i{j}"]
            x, nc, lb, z = _block_forward(bparams[f"i{j}"], x, cfg, mode,
                                          cache_j, positions, cache_pos,
                                          kind)
            new_caches[f"i{j}"] = nc
            lb_sum = lb_sum + lb
            z_sum = z_sum + z
        per_repeat.append(new_caches)
    if mode == "train":
        return x, None, lb_sum, z_sum
    return x, {f"i{j}": caches[f"i{j}"]
               if mode == "decode" and mixer == "attn"
               else _stack([c[f"i{j}"] for c in per_repeat])
               for j, (mixer, _) in enumerate(pattern)}, lb_sum, z_sum


def _logits(params, x, cfg):
    """(B, S, V_pad) logits, or (B, S, C, V_pad) with codebooks."""
    w = (params["embed"].transpose(-2, -1) if cfg.tie_embeddings
         else params["unembed"])                     # ([C,] d, V_pad)
    logits = (torch.einsum("bsd,cdv->bscv", x, w) if w.dim() == 3
              else x @ w)
    if logits.shape[-1] != cfg.vocab_size:
        # padded columns never win an argmax and carry no probability
        logits[..., cfg.vocab_size:] = NEG_LOGIT
    return logits


def forward(params, batch, cfg, mode: str, caches=None, cache_pos=None):
    """Returns (logits, new_caches, lb_loss, z_loss), as the reference:
    the MoE layers' load-balance and router z losses summed over the
    layers (f32 zeros without MoE).

    batch: 'tokens' (B, S[, C]) int; optional 'frontend' (B, F, d_model),
    precomputed modality embeddings prepended to the token embeddings
    when ``cfg.frontend`` is set (the caches then hold F + S positions);
    optional 'positions', (B, S) or M-RoPE's (3, B, S), over the F + S
    positions.  Without them positions are ``arange(F + S)`` for
    train/prefill (an M-RoPE config needs them there: ``apply_rope``
    raises) and ``cache_pos`` (the decode position, an int; in all three
    streams for M-RoPE) for decode; the SSM cache does not read them."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    if cfg.frontend != "none" and "frontend" in batch:
        x = torch.cat([batch["frontend"].to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    if "positions" in batch:
        positions = batch["positions"]
    elif mode == "decode":
        shape = (3, B, 1) if cfg.mrope_sections else (B, 1)
        positions = torch.full(shape, int(cache_pos), dtype=torch.long,
                               device=x.device)
    else:
        positions = torch.arange(S, device=x.device).expand(B, S)
    x, new_caches, lb, z = _stack_forward(params, x, cfg, mode, caches,
                                          positions, cache_pos)
    x = norm(x, params["final_norm"], cfg)
    return _logits(params, x, cfg), new_caches, lb, z


# --------------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------------- #

LB_COEF = 0.01
Z_COEF = 1e-3


def loss_fn(params, batch, cfg):
    """Causal-LM loss, as the reference's.  batch: tokens, labels (B, S[,
    C]) and loss_mask (B, S) over all S positions (a frontend's too: the
    labels and mask are sized to match).  The label's logit is a gather,
    which equals the reference's one-hot sum bit for bit (one value added
    to exact zeros); with codebooks the CE is averaged over them; the
    mask is normalized by max(sum, 1).  Returns (ce + LB_COEF·lb +
    Z_COEF·z, {"ce", "lb", "z"})."""
    logits, _, lb, z = forward(params, batch, cfg, "train")
    logits = logits.float()
    mask = batch["loss_mask"].float()
    lab_logit = logits.gather(-1, batch["labels"][..., None].long())[..., 0]
    ce = torch.logsumexp(logits, dim=-1) - lab_logit
    if cfg.num_codebooks > 1:
        ce = ce.mean(-1)                                 # mean codebooks
    ce = (ce * mask).sum() / mask.sum().clamp(min=1.0)
    total = ce + LB_COEF * lb + Z_COEF * z
    return total, {"ce": ce, "lb": lb, "z": z}


def prefill_step(params, batch, cfg):
    """(logits, caches), as the reference's."""
    logits, caches, _, _ = forward(params, batch, cfg, "prefill")
    return logits, caches


def decode_step(params, batch, cfg, caches, cache_pos):
    """(logits, caches), as the reference's."""
    logits, caches, _, _ = forward(params, batch, cfg, "decode", caches,
                                   cache_pos)
    return logits, caches
