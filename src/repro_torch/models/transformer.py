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
load-balance and router z losses that training minimizes.  A lettered
pattern (NemotronH's ``cfg.layer_pattern``) gives each layer one op, a
mixer or an FFN: the layer has no parameters, cache or residual for the
other, and the one super-block holds every layer.

Decode writes each attention layer's new key and value into the caches
it is given, in place, and returns those caches; an SSM layer's new
state is a new tensor.

Under a mesh (``distributed/sharding.use_mesh_and_rules``) every rank
runs the forward on its own rows, and the active ``Layout``
(``sharding.use_layout``, from ``sharding.layout``) says which mesh axes
split them: the batch over the DP axes, the sequence over 'model' under
``LOGICAL_RULES_PREFILL_SP`` (the rank's tokens are its slice, with
global positions), the decode cache's sequence over 'model' (or the
whole mesh under ``_DECODE_LONG``).

The parameters follow the active rule table.  A rank holds each leaf
whole or as its block by the leaf's spec (``init_params(mesh=...)``
draws only the block; ``sharding.shard_tree`` cuts one from a whole
tree), and each layer uses it through ``layers.local_params``: a
dimension the layer computes on in blocks is the rank's block, every
other split dimension (the FSDP ``'embed'`` rows, norm scales
included) is all-gathered before the use and its gradient
reduce-scattered.  So under ``LOGICAL_RULES_TRAIN`` a rank of a (data,
model) mesh holds 1/(n_data·n_model) of every attention and FFN weight.
The reference's GSPMD moves data between layouts without saying so; the
port does it with explicit collectives (``distributed/collectives.py``,
each with its gradient), in these places:

- FSDP: a leaf's rows split over 'data' (('data', 'model') under
  ``_TRAIN_FSDP`` and ``PREFILL_SP``, ('pod', 'data') under ``_ZERO3``)
  are all-gathered at each use (``sharding.local_param``);
- tensor parallelism over 'model': attention's column-parallel ``wq``
  and row-parallel ``wo`` (``attention.attention_forward``: the rank's
  query heads, the query columns gathered where the heads do not divide
  and before flash-decoding's merge), the dense FFN's ``w_gate``/``w_up``
  columns and ``w_down`` rows, the SSM's ``'ssm_inner'`` channels and
  heads with its gate norm's sum of squares and ``out_proj`` rows
  (``mamba2.ssm_forward``): each row-parallel product all-reduced;
- the vocabulary over 'model': a tied table's lookup is the rank's rows
  masked and all-reduced (``_embed_tokens``), the logits are the rank's
  vocab block (padded columns masked by their global index), and
  ``loss_fn``'s logsumexp and label logit reduce across the blocks;
- sequence-parallel attention all-gathers K/V over 'model'
  (``attention.sp_prefill_attention``), and flash-decoding merges its
  shards' partials (``attention.flash_decode``);
- the MoE's tokens replicate over 'model' (its ``shard_map`` token spec):
  a sequence-sharded residual is all-gathered over 'model' before the
  expert-parallel layer and cut back to the rank's rows after
  (``moe.moe_forward``), which also sums the experts' outputs over
  'model' and the load-balance statistics over the DP axes;
- an SSM layer's scan runs over the whole sequence: a sequence-sharded
  input is all-gathered, scanned, and the rank's slice kept
  (``_block_forward``; jamba under SP rules);
- ``place_caches`` moves a prefill's sequence-sharded caches into the
  decode cache's own blocks (directly where both split S the same way),
  and cuts an SSM cache to the decode rules' heads.

``param_shardings``/``cache_shardings`` return the reference's specs;
a cache's TP dimension (the SSM's ``'act_ssm'``) is the rank's block as
its layer computes it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (Layout, axis_rules,
                                              current_layout, current_mesh,
                                              current_rules, local_param,
                                              mark, spec_split, split_dims,
                                              split_of, take_spec_block)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as ssm_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (ParamSpec, abstract_from_specs,
                                       activation, block_bounds_tree,
                                       dense_spec, init_from_seed,
                                       local_params, mark_tree, norm,
                                       norm_spec, remat_call,
                                       shardings_from_specs,
                                       specs_with_leading_stack, torch_dtype)

NEG_LOGIT = -1e30


# --------------------------------------------------------------------------- #
# Param specs
# --------------------------------------------------------------------------- #

def _ffn_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.activation == "swiglu":
        return {"w_gate": dense_spec(d, f, ("embed", "mlp")),
                "w_up": dense_spec(d, f, ("embed", "mlp")),
                "w_down": dense_spec(f, d, ("mlp", "embed"))}
    return {"w_up": dense_spec(d, f, ("embed", "mlp")),
            "w_down": dense_spec(f, d, ("mlp", "embed"))}


def _block_specs(cfg, mixer: str, ffn: str) -> dict:
    specs = {}
    if mixer != "none":
        specs["norm1"] = norm_spec(cfg)
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
    book_axes = ("codebook",) if books else ()
    std = 1.0 / math.sqrt(d)
    # tied tables are the unembedding too ('vocab', TP over 'model');
    # untied input tables replicate ('vocab_in')
    vocab_axis = "vocab" if cfg.tie_embeddings else "vocab_in"
    specs: dict = {"embed": ParamSpec(books + (V, d),
                                      book_axes + (vocab_axis, "embed"),
                                      std=std)}
    specs["blocks"] = {
        f"i{j}": specs_with_leading_stack(_block_specs(cfg, mixer, ffn),
                                          cfg.num_repeats)
        for j, (mixer, ffn) in enumerate(cfg.pattern())}
    specs["final_norm"] = norm_spec(cfg)
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec(books + (d, V),
                                     book_axes + ("embed", "vocab"), std=std)
    return specs


def cache_specs(cfg, batch: int, max_seq: int) -> dict:
    """Stacked per-layer decode caches (leading num_repeats dim): the
    attention KV cache (B, max_seq, KV, Dh), or the SSM cache, which does
    not grow with the sequence; none (an empty dict) for a layer without
    a mixer."""
    def layer(mixer):
        if mixer == "attn":
            return attn_mod.init_cache_specs(cfg, batch, max_seq)
        return ssm_mod.init_ssm_cache_specs(cfg, batch) if mixer == "ssm" \
            else {}
    return {f"i{j}": specs_with_leading_stack(layer(mixer), cfg.num_repeats)
            for j, (mixer, _) in enumerate(cfg.pattern())}


def init_params(cfg, seed: int = 0, device: DeviceLike = "cuda",
                mesh=None) -> dict:
    """Seeded random parameters by the reference's spec rule (zeros for
    the norm scales, ones for ``A_log``/``D``, normal·std), drawn on
    ``device`` by ``layers.init_from_seed``: a seed gives the same
    parameters on every device (not the reference's numbers).  With a
    mesh of more than one device, under the active rules, each leaf is
    drawn as the rank's block
    of ``param_shardings`` (fitted to its shape), the bits of that block
    of the whole draw, and marked with the axes that split it
    (``sharding.mark``)."""
    specs = model_specs(cfg)
    if mesh is None or mesh.size(mesh.axis_names) == 1:
        return init_from_seed(specs, seed, cfg.param_dtype,
                              resolve_device(device))
    rules = current_rules()
    if not rules:
        raise ValueError("init_params(mesh=...) draws each leaf's block by "
                         "the active rules: wrap it in use_mesh_and_rules")
    params = init_from_seed(specs, seed, cfg.param_dtype,
                            resolve_device(device),
                            block_bounds_tree(specs, mesh, rules))
    return mark_tree(params, specs, mesh, rules)


def _abstract(specs, dtype: str, mesh):
    """``specs`` as meta tensors: whole leaves, or with a mesh of more
    than one device the rank's blocks under the active rules
    (``block_bounds_tree``), marked as ``init_params`` marks them."""
    if mesh is None or mesh.size(mesh.axis_names) == 1:
        return abstract_from_specs(specs, dtype)
    rules = current_rules()
    if not rules:
        raise ValueError("a rank's blocks follow the active rules: wrap "
                         "the call in use_mesh_and_rules")
    return mark_tree(abstract_from_specs(
        specs, dtype, block_bounds_tree(specs, mesh, rules)), specs, mesh,
        rules)


def abstract_params(cfg, mesh=None) -> dict:
    """The parameters as ``meta`` tensors (the dry-run's): the shapes
    ``init_params(cfg, mesh=mesh)`` draws, without storage."""
    return _abstract(model_specs(cfg), cfg.param_dtype, mesh)


def abstract_cache(cfg, batch: int, max_seq: int,
                   dtype: Optional[str] = None, mesh=None) -> dict:
    """The decode caches of ``init_cache`` as ``meta`` tensors; under a
    mesh the rank's blocks of ``cache_shardings`` by the active rules
    (its batch rows, its block of the KV sequence, its SSM heads)."""
    return _abstract(cache_specs(cfg, batch, max_seq), dtype or cfg.dtype,
                     mesh)


def param_shardings(cfg, mesh, rules) -> dict:
    """The reference's sharding of every parameter (its logical axes
    under ``rules`` on ``mesh``)."""
    return shardings_from_specs(model_specs(cfg), mesh, rules)


def cache_shardings(cfg, batch: int, max_seq: int, mesh, rules) -> dict:
    return shardings_from_specs(cache_specs(cfg, batch, max_seq), mesh,
                                rules)


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


def place_caches(cfg, caches: dict, max_seq: int,
                 src: Optional[Layout] = None,
                 dst: Optional[Layout] = None) -> dict:
    """A prefill's caches as decode caches of ``max_seq`` positions: each
    attention layer's (R, B, S, KV, Dh) k/v copied to positions [0, S) of
    a zero cache (the reference's ``serve_lm`` placement); SSM caches (a
    hybrid's too) as they are.  Under a mesh, ``src`` is the prefill's
    layout and ``dst`` the decode's (same batch rows): where both split
    the sequence over the same axes and S = max_seq, each rank's prefill
    slice is its decode block; otherwise the sequence is all-gathered,
    placed, and the rank's block of ``dst.cache_seq`` kept."""
    src, dst, mesh = src or Layout(), dst or Layout(), current_mesh()
    if src.batch != dst.batch:
        raise ValueError(f"prefill rows {src} and decode rows {dst} split "
                         "the batch differently")
    out = dict(caches)
    for j, (mixer, _) in enumerate(cfg.pattern()):
        if mixer == "ssm":
            out[f"i{j}"] = _place_ssm_cache(cfg, caches[f"i{j}"])
        if mixer != "attn":
            continue
        out[f"i{j}"] = {}
        for name, x in caches[f"i{j}"].items():
            S = x.shape[2] * (mesh.size(src.seq) if src.seq else 1)
            if S > max_seq:
                raise ValueError(f"a prefill of {S} tokens does not fit "
                                 f"{max_seq} cache positions")
            if src.seq and src.seq == dst.cache_seq and S == max_seq:
                out[f"i{j}"][name] = x
                continue
            x = coll.all_gather(x, mesh, src.seq, 2)
            R, B = x.shape[:2]
            full = x.new_zeros((R, B, max_seq) + tuple(x.shape[3:]))
            full[:, :, :S] = x
            out[f"i{j}"][name] = full if not dst.cache_seq else \
                take_spec_block(full, (None, None, dst.cache_seq), mesh
                                ).clone()
    return out


def _place_ssm_cache(cfg, cache: dict) -> dict:
    """An SSM layer's prefill cache in the active rules' layout: a
    dimension those rules split over 'model' (``'act_ssm'``, the
    channels and heads) cut from a whole one; one held as a block kept
    (the prefill ran under the same split)."""
    mesh = current_mesh()
    if mesh is None or not current_rules():
        return cache
    specs = ssm_mod.init_ssm_cache_specs(cfg, 1)
    out = {}
    for name, x in cache.items():
        axes = specs[name].logical_axes
        full = (1,) + specs[name].shape[1:]
        dims = split_dims(full, axis_rules(axes, mesh=mesh), mesh)
        for d, (a, n) in enumerate(zip(dims, full)):
            if d and a and x.shape[d + 1] == n:
                x = take_spec_block(x, (None,) * (d + 1) + (a,), mesh
                                    ).clone()
        out[name] = x
    return out


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #

def vocab_block(cfg) -> tuple:
    """(axes, first column) of the rank's block of the padded vocab
    under the active rules: ((), 0) where it holds the whole."""
    axes = spec_split("vocab", padded_vocab(cfg))
    if not axes:
        return (), 0
    mesh = current_mesh()
    return axes, mesh.index(axes) * (padded_vocab(cfg) // mesh.size(axes))


def _table(params, cfg):
    """The embedding table as this rank uses it: its 'embed' columns
    gathered; with tied weights under vocab parallelism, its vocab
    rows."""
    spec = _layer_specs(cfg)["embed"]
    return local_param(params["embed"], spec.logical_axes, spec.shape)


def _embed_tokens(params, tokens, cfg):
    """(B, S) ids, or (B, S, C) with codebooks -> (B, S, d) in cfg.dtype.
    The C lookups are summed in the parameter dtype in codebook order
    (the reference's ``sum``: ((e0 + e1) + e2) + e3), then cast.  A
    table split over the vocab (tied weights under TP) is looked up in
    the rank's rows, other ids giving zeros, and summed over the vocab
    shards: each lookup exact."""
    emb = _table(params, cfg)
    axes, v0 = vocab_block(cfg) if cfg.tie_embeddings else ((), 0)

    def look(table, ids):
        if not axes:
            return table[ids]
        local = ids - v0
        inside = (local >= 0) & (local < table.shape[0])
        e = table[torch.where(inside, local, 0)] * inside[..., None].to(
            table.dtype)
        return coll.all_reduce(e, current_mesh(), axes)
    if cfg.num_codebooks > 1:
        x = look(emb[0], tokens[..., 0])
        for c in range(1, cfg.num_codebooks):
            x = x + look(emb[c], tokens[..., c])
    else:
        x = look(emb, tokens)
    return x.to(torch_dtype(cfg.dtype))


_SPECS: dict = {}


def _layer_specs(cfg, kind=None) -> dict:
    """One layer's parameter specs (``_block_specs``), or the model's
    (``model_specs``) without ``kind``, cached."""
    key = (cfg, kind)
    if key not in _SPECS:
        _SPECS[key] = model_specs(cfg) if kind is None else \
            _block_specs(cfg, *kind)
    return _SPECS[key]


def _block_forward(bparams, x, cfg, mode, cache, positions=None,
                   cache_pos=None, kind=None):
    """One layer: pre-norm mixer and residual, then (dense or MoE FFN)
    pre-norm FFN and residual; a lettered pattern's layer has one of the
    two ('none' the other).  ``kind`` is its (mixer, ffn), by default the
    schedule's first; ``positions`` and ``cache_pos`` feed attention.
    The mixer runs in the span ``lm/attention`` or ``lm/mamba``, the MoE
    FFN in ``lm/moe``.  Returns (x, new cache ({} without a mixer), lb,
    z): the MoE FFN's auxiliary losses, f32 zeros for another layer."""
    mixer, ffn = kind or cfg.pattern()[0]
    bparams = local_params(bparams, _layer_specs(cfg, (mixer, ffn)))
    new_cache = {}
    if mixer == "attn":
        with obs.span("lm/attention"):
            y, new_cache = attn_mod.attention_forward(
                bparams["mixer"], norm(x, bparams["norm1"], cfg), positions,
                cfg, mode, cache, cache_pos)
        x = x + y
    elif mixer == "ssm":
        # the scan runs over the whole sequence: gather, scan, keep the
        # rank's slice (the prefill state is the whole sequence's)
        mesh, seq = current_mesh(), current_layout().seq
        with obs.span("lm/mamba"):
            y, new_cache = ssm_mod.ssm_forward(
                bparams["mixer"], coll.all_gather(
                    norm(x, bparams["norm1"], cfg), mesh, seq, 1), cfg,
                mode, cache)
            y = coll.take_block(y, mesh, seq, 1)
        x = x + y
    lb = z = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "moe":
        with obs.span("lm/moe"):
            y, lb, z = moe_mod.moe_forward(
                bparams["ffn"], norm(x, bparams["norm2"], cfg), cfg)
        x = x + y
    elif ffn == "dense":
        h = norm(x, bparams["norm2"], cfg)
        p = bparams["ffn"]
        up = h @ p["w_up"]
        if cfg.activation == "swiglu":
            a = activation(h @ p["w_gate"], "silu") * up
        else:
            a = activation(up, cfg.activation)
        # column-parallel up, row-parallel down: the rank's partial sum
        # over its d_ff columns, all-reduced
        x = x + coll.all_reduce(a @ p["w_down"], current_mesh(),
                                spec_split("mlp", cfg.d_ff))
    return x, new_cache, lb, z


def _index(tree, r: int):
    """Layer ``r`` of the stacked leaves (a marked leaf's mark kept)."""
    def one(v):
        return mark(v[r], split_of(v)[1:]) if hasattr(v, "split_dims") \
            else v[r]
    return {k: _index(v, r) if isinstance(v, dict) else one(v)
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
    updated in place, so those stay as they are.  In train mode with
    ``cfg.remat`` (and grad on) each super-block runs under
    ``layers.remat_call``: its backward recomputes it; a lettered
    pattern's one super-block is every layer, so there each layer is
    recomputed on its own."""
    pattern = cfg.pattern()
    per_repeat = []
    lb_sum = z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        def layers_of(kinds):
            def run(bparams, x, lb_sum, z_sum):
                for j, kind in kinds:
                    x, _, lb, z = _block_forward(bparams[f"i{j}"], x, cfg,
                                                 mode, None, positions, None,
                                                 kind)
                    lb_sum = lb_sum + lb
                    z_sum = z_sum + z
                return x, lb_sum, z_sum
            return run
        units = ([[(j, kind)] for j, kind in enumerate(pattern)]
                 if cfg.layer_pattern else [list(enumerate(pattern))])
        for r in range(cfg.num_repeats):
            # remat: each unit's activations are recomputed in the
            # backward (the reference's jax.checkpoint of the scan body)
            bparams = _index(params["blocks"], r)
            for unit in units:
                x, lb_sum, z_sum = remat_call(
                    cfg.remat, layers_of(unit),
                    {f"i{j}": bparams[f"i{j}"] for j, _ in unit}, x, lb_sum,
                    z_sum)
        return x, None, lb_sum, z_sum
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
    return x, {f"i{j}": caches[f"i{j}"]
               if mode == "decode" and mixer == "attn"
               else _stack([c[f"i{j}"] for c in per_repeat])
               for j, (mixer, _) in enumerate(pattern)}, lb_sum, z_sum


def _logits(params, x, cfg):
    """(B, S, V_pad) logits, or (B, S, C, V_pad) with codebooks; under
    vocab parallelism the rank's block of the V_pad columns."""
    if cfg.tie_embeddings:
        w = _table(params, cfg).transpose(-2, -1)        # ([C,] d, V)
    else:
        spec = _layer_specs(cfg)["unembed"]
        w = local_param(params["unembed"], spec.logical_axes, spec.shape)
    logits = (torch.einsum("bsd,cdv->bscv", x, w) if w.dim() == 3
              else x @ w)
    axes, v0 = vocab_block(cfg)
    if axes:
        # the padded columns by their global index
        cols = v0 + torch.arange(logits.shape[-1], device=logits.device)
        return logits.masked_fill(cols >= cfg.vocab_size, NEG_LOGIT)
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
    streams for M-RoPE) for decode; the SSM cache does not read them.

    Under a mesh, the active ``sharding.Layout`` says which axes split
    the rows given: the batch, the caches and the returned logits are
    the rank's block.  A sequence-sharded batch takes no frontend (its
    embeddings would have to be split with the tokens)."""
    lay = current_layout()
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    if cfg.frontend != "none" and "frontend" in batch:
        if lay.seq:
            raise NotImplementedError(
                "a frontend under a sequence-sharded layout")
        x = torch.cat([batch["frontend"].to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    if "positions" in batch:
        positions = batch["positions"]
    elif mode == "decode":
        shape = (3, B, 1) if cfg.mrope_sections else (B, 1)
        positions = torch.full(shape, int(cache_pos), dtype=torch.long,
                               device=x.device)
    else:
        start = current_mesh().index(lay.seq) * S if lay.seq else 0
        positions = torch.arange(start, start + S,
                                 device=x.device).expand(B, S)
    x, new_caches, lb, z = _stack_forward(params, x, cfg, mode, caches,
                                          positions, cache_pos)
    x = norm(x, local_params(params["final_norm"],
                             _layer_specs(cfg)["final_norm"]), cfg)
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
    mask is normalized by max(sum, 1), the sum over the global batch
    where the rank holds a block of its rows (the mean of the ranks'
    losses is then the reference's).  Returns (ce + LB_COEF·lb +
    Z_COEF·z, {"ce", "lb", "z"})."""
    logits, _, lb, z = forward(params, batch, cfg, "train")
    logits = logits.float()
    mask = batch["loss_mask"].float()
    axes, v0 = vocab_block(cfg)
    if axes:
        ce = _sharded_ce(logits, batch["labels"].long(), axes, v0)
    else:
        lab_logit = logits.gather(-1, batch["labels"][..., None].long()
                                  )[..., 0]
        ce = torch.logsumexp(logits, dim=-1) - lab_logit
    if cfg.num_codebooks > 1:
        ce = ce.mean(-1)                                 # mean codebooks
    rows = current_layout().batch + current_layout().seq
    if rows:
        # the global batch's masked mean: the data-parallel trainer
        # averages the ranks' losses, so each is its rows' masked sum
        # times the rank count over the global mask count
        mesh = current_mesh()
        den = coll.all_reduce(mask.sum(), mesh, rows).clamp(min=1.0)
        ce = (ce * mask).sum() * mesh.size(rows) / den
    else:
        ce = (ce * mask).sum() / mask.sum().clamp(min=1.0)
    total = ce + LB_COEF * lb + Z_COEF * z
    return total, {"ce": ce, "lb": lb, "z": z}


def _sharded_ce(logits, labels, axes, v0: int):
    """logsumexp - label logit over logits split by vocab blocks: the
    blocks' max (no gradient), their sums of exp and the label's logit
    from the block that holds it, each reduced over ``axes``."""
    mesh = current_mesh()
    m = coll.all_reduce(logits.detach().amax(-1), mesh, axes, "max")
    s = coll.all_reduce(torch.exp(logits - m[..., None]).sum(-1), mesh,
                        axes)
    local = labels - v0
    inside = (local >= 0) & (local < logits.shape[-1])
    picked = logits.gather(-1, torch.where(inside, local, 0)[..., None]
                           )[..., 0]
    lab = coll.all_reduce(torch.where(inside, picked, 0.0), mesh, axes)
    return m + torch.log(s) - lab


def prefill_step(params, batch, cfg):
    """(logits, caches), as the reference's."""
    logits, caches, _, _ = forward(params, batch, cfg, "prefill")
    return logits, caches


def decode_step(params, batch, cfg, caches, cache_pos):
    """(logits, caches), as the reference's."""
    logits, caches, _, _ = forward(params, batch, cfg, "decode", caches,
                                   cache_pos)
    return logits, caches
