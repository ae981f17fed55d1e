"""Decoder LM of the zoo, PyTorch port of ``repro/models/transformer.py``
(:46-300, :338-346): parameter and cache specs, seeded init, the forward
pass in its three modes, and the prefill/decode steps.

One model definition driven by ``ArchConfig``: the per-layer schedule
``cfg.pattern()`` gives each layer of a super-block its mixer and FFN, and
the stack runs ``num_repeats`` super-blocks (a Python loop over the stacked
layer parameters where the reference scans).  Ported so far: the SSM
mixer (Mamba2) with no FFN.  The attention mixer and the dense / MoE FFN
raise ``NotImplementedError`` (ROADMAP port queue item 1); the modality
frontends and multi-codebook heads come with the configs that use them.
``loss_fn`` is training (port queue item 7).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mamba2 as ssm_mod
from repro_torch.models.layers import (ParamSpec, dense_spec,
                                       init_from_specs, norm, norm_spec,
                                       specs_with_leading_stack, torch_dtype)

NEG_LOGIT = -1e30
_NOT_PORTED = "is not ported yet (ROADMAP port queue item 1, the LM zoo)"


def _check_ported(cfg) -> None:
    for mixer, ffn in cfg.pattern():
        if mixer != "ssm":
            raise NotImplementedError(f"{cfg.name}: the attention mixer "
                                      + _NOT_PORTED)
        if ffn != "none":
            raise NotImplementedError(f"{cfg.name}: the {ffn} FFN "
                                      + _NOT_PORTED)


# --------------------------------------------------------------------------- #
# Param specs
# --------------------------------------------------------------------------- #

def _block_specs(cfg) -> dict:
    """One ported block: pre-norm and the SSM mixer, no FFN."""
    return {"norm1": norm_spec(cfg), "mixer": ssm_mod.ssm_specs(cfg)}


def padded_vocab(cfg) -> int:
    """Embedding tables pad the vocab up to a multiple of 16 (the
    reference's tensor-parallel table padding).  Padded logit columns are
    set to -1e30 in ``_logits``; token ids stay < cfg.vocab_size."""
    m = 16
    return (cfg.vocab_size + m - 1) // m * m


def model_specs(cfg) -> dict:
    _check_ported(cfg)
    d, V = cfg.d_model, padded_vocab(cfg)
    specs: dict = {"embed": ParamSpec((V, d), std=1.0 / math.sqrt(d))}
    specs["blocks"] = {
        f"i{j}": specs_with_leading_stack(_block_specs(cfg), cfg.num_repeats)
        for j in range(len(cfg.pattern()))}
    specs["final_norm"] = norm_spec(cfg)
    if not cfg.tie_embeddings:
        specs["unembed"] = dense_spec(d, V)
    return specs


def cache_specs(cfg, batch: int, max_seq: int) -> dict:
    """Stacked per-layer decode caches (leading num_repeats dim).  An SSM
    cache does not grow with the sequence, so max_seq is not read."""
    _check_ported(cfg)
    return {f"i{j}": specs_with_leading_stack(
        ssm_mod.init_ssm_cache_specs(cfg, batch), cfg.num_repeats)
        for j in range(len(cfg.pattern()))}


def init_params(cfg, seed: int = 0, device: DeviceLike = "cuda") -> dict:
    """Seeded random parameters by the reference's spec rule (zeros, ones
    for ``A_log``/``D``, normal·std), drawn on the CPU from a
    ``torch.Generator`` so a seed gives the same parameters on every
    device (not the reference's numbers)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return init_from_specs(model_specs(cfg), gen, cfg.param_dtype, dev)


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


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #

def _embed_tokens(params, tokens, cfg):
    return params["embed"][tokens].to(torch_dtype(cfg.dtype))


def _block_forward(bparams, x, cfg, mode, cache):
    h = norm(x, bparams["norm1"], cfg)
    y, new_cache = ssm_mod.ssm_forward(bparams["mixer"], h, cfg, mode, cache)
    return x + y, new_cache


def _index(tree, r: int):
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _stack(trees: list):
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _stack_forward(params, x, cfg, mode: str, caches=None):
    """Run the ``num_repeats`` super-blocks in order; returns (x, stacked
    new caches or None)."""
    per_repeat = []
    for r in range(cfg.num_repeats):
        bparams = _index(params["blocks"], r)
        bcaches = None if caches is None else _index(caches, r)
        new_caches = {}
        for j in range(len(cfg.pattern())):
            cache_j = None if bcaches is None else bcaches[f"i{j}"]
            x, nc = _block_forward(bparams[f"i{j}"], x, cfg, mode, cache_j)
            new_caches[f"i{j}"] = nc
        per_repeat.append(new_caches)
    if mode == "train":
        return x, None
    return x, _stack(per_repeat)


def _logits(params, x, cfg):
    w = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    logits = x @ w
    if logits.shape[-1] != cfg.vocab_size:
        # padded columns never win an argmax and carry no probability
        logits[..., cfg.vocab_size:] = NEG_LOGIT
    return logits


def forward(params, batch, cfg, mode: str, caches=None, cache_pos=None):
    """Returns (logits, new_caches).  batch: {'tokens': (B, S) int}.
    ``cache_pos`` (the decode position) is the reference's signature; the
    SSM cache does not read it.  The reference's auxiliary MoE losses are
    zero without MoE and are not returned."""
    _check_ported(cfg)
    x = _embed_tokens(params, batch["tokens"], cfg)
    x, new_caches = _stack_forward(params, x, cfg, mode, caches)
    x = norm(x, params["final_norm"], cfg)
    return _logits(params, x, cfg), new_caches


def prefill_step(params, batch, cfg):
    return forward(params, batch, cfg, "prefill")


def decode_step(params, batch, cfg, caches, cache_pos):
    return forward(params, batch, cfg, "decode", caches, cache_pos)
