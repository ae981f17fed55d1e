"""GQA attention of the LM zoo, PyTorch port of ``repro/models/attention.py``
(``attn_specs`` :36-47, the flash route :90-92, ``sp_prefill_attention``
:99-149, ``flash_decode`` :158-232, ``init_cache_specs`` :239-248 and
``attention_forward`` :251-315).

Three paths share one set of weights:

  train/prefill  full-sequence causal attention.  K/V heads are repeated
                 to the H query heads as the reference repeats them
                 (``jnp.repeat(k, G, axis=2)``: head h reads KV head
                 h // G), then ``kernels.flash_attention.ops.
                 flash_attention(causal=True)``: the CUDA kernel on a CUDA
                 tensor, its plain version on a CPU tensor.  That is the
                 reference's ``attn_impl="pallas"`` route; its chunked XLA
                 path computes the same function.
  sequence-      (``attn_impl="sp"``, or whenever the rank's rows are a
  parallel       slice of the sequence: ``LOGICAL_RULES_PREFILL_SP``)
                 each 'model' shard m holds query rows [m·s_loc, (m+1)·
                 s_loc); it all-gathers the GQA K/V heads over 'model'
                 and runs the causal flash kernel on its rows against keys
                 [0, (m+1)·s_loc): the kernel aligns q to the end of kv,
                 which is the reference's ``q_start = m·s_loc``, and the
                 keys past the shard's last row, which its causal mask
                 would discard, are not passed (``sp_shard_attention``).
                 With replicated rows the rank takes its own query rows
                 and all-gathers the output, as the reference's
                 ``shard_map`` does.
  decode         one query token against the KV cache.  A cache whose
                 sequence is split over mesh axes (``cache_seq``:
                 'model' under ``LOGICAL_RULES_DECODE``, the whole mesh
                 under ``_DECODE_LONG``) runs flash-decoding: each shard's
                 partial softmax over its slice (``flash_decode_partial``:
                 the max, the sum and the f32 accumulator against its own
                 max) merged by ``all_reduce`` MAX and SUM.  Otherwise
                 (no mesh, one shard, a length the shards do not divide)
                 ``decode_attention``: a masked softmax over the cache with
                 -1e30 past ``cache_pos``, scores in f32 and p rounded to
                 the value dtype, in plain PyTorch (the reference reaches
                 no Pallas kernel here either).  The new key and value
                 are written into the cache in place, at ``cache_pos``,
                 by the rank whose slice holds it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (current_layout, current_mesh,
                                              spec_split)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import (ParamSpec, apply_rope, dense_spec,
                                       rms_norm)

NEG_SCORE = -1e30


def attn_specs(cfg) -> dict:
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": dense_spec(d, H * Dh, ("embed", "qkv")),
        "wk": dense_spec(d, KV * Dh, ("embed", "kv")),
        "wv": dense_spec(d, KV * Dh, ("embed", "kv")),
        "wo": dense_spec(H * Dh, d, ("qkv", "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((Dh,), (None,), std=0.0, dtype="float32")
        specs["k_norm"] = ParamSpec((Dh,), (None,), std=0.0, dtype="float32")
    return specs


def init_cache_specs(cfg, batch: int, max_seq: int) -> dict:
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    axes = ("cache_batch", "cache_seq", "cache_kv", "cache_head_dim")
    return {"k": ParamSpec((batch, max_seq, KV, Dh), axes),
            "v": ParamSpec((batch, max_seq, KV, Dh), axes)}


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, Dh); k/v: (B, S, KV, Dh).  KV heads repeated to H
    (new dense tensors, as the kernel's dense-head layout needs), then
    causal flash attention.  Returns (B, S, H, Dh)."""
    G = q.shape[2] // k.shape[2]
    kb = k.repeat_interleave(G, dim=2)
    vb = v.repeat_interleave(G, dim=2)
    return fa_ops.flash_attention(q, kb, vb, causal=True)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_pos: int) -> torch.Tensor:
    """q: (B, 1, H, Dh); caches (B, S_max, KV, Dh) filled up to and with
    ``cache_pos``.  Query head h reads KV head h // G."""
    B, _, H, Dh = q.shape
    KV = k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) \
        * (1.0 / math.sqrt(Dh))
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    s = s.masked_fill(kpos > cache_pos, NEG_SCORE)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache)
    return o.reshape(B, 1, H, Dh)


def sp_shard_attention(q: torch.Tensor, k_full: torch.Tensor,
                       v_full: torch.Tensor, m: int) -> torch.Tensor:
    """One sequence-parallel shard's body: its query rows q (B, s_loc, H,
    Dh), rows [m·s_loc, (m+1)·s_loc) of the sequence, against the
    gathered k/v (B, S, KV, Dh); causal flash over keys [0, (m+1)·
    s_loc), the kernel's end alignment giving the offset m·s_loc."""
    kv = (m + 1) * q.shape[1]
    return causal_attention(q, k_full[:, :kv], v_full[:, :kv])


def sp_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cfg) -> torch.Tensor:
    """Sequence-parallel prefill attention on the rank's rows.  q: (B, S,
    H, Dh); k/v: (B, S, KV, Dh), the KV heads repeated only after the
    gather.  Returns (B, S, H, Dh), laid out as q."""
    mesh, lay = current_mesh(), current_layout()
    if lay.seq:
        if lay.seq != ("model",):
            raise NotImplementedError(f"a sequence split over {lay.seq}")
        return sp_shard_attention(q, coll.all_gather(k, mesh, lay.seq, 1),
                                  coll.all_gather(v, mesh, lay.seq, 1),
                                  mesh.index(lay.seq))
    S = q.shape[1]
    n_sp = (mesh.size("model") if mesh is not None
            and "model" in mesh.axis_names else 1)
    if n_sp <= 1 or S % n_sp != 0:
        return causal_attention(q, k, v)
    m, s_loc = mesh.index("model"), S // n_sp
    o = sp_shard_attention(q[:, m * s_loc:(m + 1) * s_loc], k, v, m)
    return coll.all_gather(o, mesh, ("model",), 1)


def sp_shards(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              n: int) -> list:
    """Sequence-parallel attention as n shards in one process: each
    shard's output rows, ``sp_shard_attention`` on the whole K/V (what
    the gather gives each rank)."""
    s_loc = q.shape[1] // n
    return [sp_shard_attention(q[:, m * s_loc:(m + 1) * s_loc], k, v, m)
            for m in range(n)]


def flash_decode_partial(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cache_pos: int, shard: int):
    """One flash-decoding shard's body over its cache slice k/v (B, s_loc,
    KV, Dh), positions [shard·s_loc, (shard+1)·s_loc); qg (B, KV, G, Dh).
    Returns (m, l, o): the f32 row max of its valid scores (-inf where it
    has none), the sum of exp(s - m) and the f32 accumulator of p·v, p
    rounded to the value dtype (B, KV, G[, Dh])."""
    s_loc = k.shape[1]
    kpos = shard * s_loc + torch.arange(s_loc, device=qg.device)
    valid = kpos <= cache_pos
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) \
        * (1.0 / math.sqrt(qg.shape[-1]))
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    p = p.masked_fill(~valid, 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    return m, p.sum(dim=-1), o


def merge_decode(m, l, o, reduce, out_dtype: torch.dtype) -> torch.Tensor:
    """Merge the shards' partials: ``reduce(x, op)`` joins a partial over
    the shards ("max" or "sum"; ``all_reduce`` across ranks, or a
    reduction over a stacked leading dim in one process)."""
    m_all = reduce(m, "max")
    w = torch.exp(m - m_all)                  # 0 for a shard with no key
    l_all = reduce(l * w, "sum")
    o_all = reduce(o * w[..., None], "sum")
    return (o_all / torch.clamp(l_all, min=1e-30)[..., None]).to(out_dtype)


def stacked(x: torch.Tensor, op: str) -> torch.Tensor:
    """``merge_decode``'s reduction over shards stacked on dim 0 (n
    shards in one process)."""
    return x.amax(0) if op == "max" else x.sum(0)


def flash_decode_shards(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, cache_pos: int,
                        n: int) -> torch.Tensor:
    """Flash-decoding as n shards of the cache's sequence in one process
    (one device holding every shard): the shard bodies of
    ``flash_decode``, merged over a stacked dim."""
    B, _, H, Dh = q.shape
    KV = k_cache.shape[2]
    if k_cache.shape[1] % n:
        raise ValueError(f"{k_cache.shape[1]} cache positions do not "
                         f"divide into {n} shards")
    qg = q.reshape(B, KV, H // KV, Dh)
    parts = [flash_decode_partial(qg, k, v, cache_pos, i) for i, (k, v) in
             enumerate(zip(k_cache.chunk(n, 1), v_cache.chunk(n, 1)))]
    m, l, o = (torch.stack(t) for t in zip(*parts))
    return merge_decode(m, l, o, stacked, v_cache.dtype).reshape(
        B, 1, H, Dh)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_pos: int) -> torch.Tensor:
    """q: (B, 1, H, Dh); caches (B, S, KV, Dh), the rank's slice of the
    sequence where ``current_layout().cache_seq`` names axes (merged
    across them), else the whole cache (``decode_attention``)."""
    mesh, axes = current_mesh(), current_layout().cache_seq
    if mesh is None or not axes:
        return decode_attention(q, k_cache, v_cache, cache_pos)
    B, _, H, Dh = q.shape
    KV = k_cache.shape[2]
    m, l, o = flash_decode_partial(q.reshape(B, KV, H // KV, Dh), k_cache,
                                   v_cache, cache_pos, mesh.index(axes))
    out = merge_decode(m, l, o, lambda x, op: coll.all_reduce(
        x, mesh, axes, op), v_cache.dtype)
    return out.reshape(B, 1, H, Dh)


def _project(params, x, q, positions, cfg, Hl: int):
    """(q, k, v): the query columns ``q`` (x @ wq) as Hl heads and x's
    keys and values, qk-normed and rotated."""
    B, S, _ = x.shape
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    q = q.reshape(B, S, Hl, Dh)
    k = (x @ params["wk"]).reshape(B, S, KV, Dh)
    v = (x @ params["wv"]).reshape(B, S, KV, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def tp_shard_attention(params: dict, x: torch.Tensor,
                       positions: torch.Tensor, cfg, h0: int, Hl: int):
    """One tensor-parallel shard's train/prefill body: ``params``' ``wq``
    is its query columns, heads [h0, h0 + Hl) (whole heads reading whole
    KV groups, ``_local_heads``), ``wo`` the matching rows, ``wk``/``wv``
    whole.  Causal flash attention at Hl heads over the KV heads they
    read.  Returns (its partial (B, S, d) output, before the row-parallel
    sum; k and v (B, S, KV, Dh), the prefill cache)."""
    B, S, _ = x.shape
    G = cfg.num_heads // cfg.num_kv_heads
    q, k, v = _project(params, x, x @ params["wq"], positions, cfg, Hl)
    kv = slice(h0 // G, (h0 + Hl - 1) // G + 1)
    o = causal_attention(q, k[:, :, kv], v[:, :, kv])
    return o.reshape(B, S, Hl * cfg.head_dim) @ params["wo"], k, v


def tp_shards(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg, n: int) -> list:
    """Tensor-parallel prefill attention as n shards in one process (one
    device holding every shard): each shard's partial output from whole
    ``params`` cut to its ``wq`` columns and ``wo`` rows, to be summed."""
    Hl, Dh = cfg.num_heads // n, cfg.head_dim
    if not _local_heads(cfg.num_heads, cfg.num_kv_heads, n):
        raise ValueError(f"{cfg.num_heads} heads over {cfg.num_kv_heads} "
                         f"KV heads do not split into {n} whole shards")
    outs = []
    for m in range(n):
        cols = slice(m * Hl * Dh, (m + 1) * Hl * Dh)
        p = dict(params, wq=params["wq"][:, cols], wo=params["wo"][cols])
        outs.append(tp_shard_attention(p, x, positions, cfg, m * Hl, Hl)[0])
    return outs


def _local_heads(H: int, KV: int, n: int) -> bool:
    """Whether ``n`` tensor-parallel ranks each attend over whole query
    heads that read whole KV groups: H divides over them, and either the
    KV heads do too or each rank's heads share one KV head."""
    return H % n == 0 and (KV % n == 0 or n % KV == 0)


def attention_forward(params: dict, x: torch.Tensor,
                      positions: torch.Tensor, cfg, mode: str,
                      cache: Optional[dict] = None,
                      cache_pos: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, d).  mode: 'train' | 'prefill' | 'decode'.  positions:
    (B, S), or M-RoPE's (3, B, S) where ``cfg.mrope_sections`` is set.

    decode: S == 1; ``cache`` holds (B, S_max, KV, Dh) k/v and the query
    position is ``cache_pos``; the new k/v are written into it in place.
    Returns (out (B, S, d), the cache: this prompt's k/v for prefill, the
    updated cache for decode, None for train).

    Tensor parallelism (``'qkv'`` split over n ranks by the active
    rules; ``params`` as ``layers.local_params`` gives them): ``wq`` is
    the rank's columns, ``wo`` its rows, ``wk``/``wv`` whole (``'kv'``
    is never split), so every rank has every KV head and writes the
    whole cache.  Where H and the KV heads divide (``_local_heads``) the
    rank attends over its H/n query heads and the KV heads they read,
    the flash kernel running at H/n heads.  Otherwise the rank's query
    columns are all-gathered and it attends over all heads, then keeps
    the columns of its ``wo`` rows: where H does not divide over n (the
    reference drops the ``act_heads`` constraint there and a rank's
    columns are not whole heads), under the sequence-parallel route,
    and in decode against a cache whose sequence is split, where the
    query heads are gathered before flash-decoding's merge so that each
    rank's partials cover every head.  The rank's partial ``o @ wo`` is
    summed over the n ranks (the row-parallel all-reduce)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got "
                         f"{mode!r}")
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mesh, lay = current_mesh(), current_layout()
    tp = spec_split("qkv", H * Dh)
    n = mesh.size(tp) if tp else 1
    sp = mode != "decode" and (cfg.attn_impl == "sp" or bool(lay.seq))
    local = n > 1 and _local_heads(H, KV, n) and not sp and not (
        mode == "decode" and lay.cache_seq)

    h0, Hl = (mesh.index(tp) * (H // n), H // n) if local else (0, H)
    if local and mode != "decode":
        out, k, v = tp_shard_attention(params, x, positions, cfg, h0, Hl)
        return coll.all_reduce(out, mesh, tp), (
            {"k": k, "v": v} if mode == "prefill" else None)

    q = x @ params["wq"]
    if n > 1 and not local:
        q = coll.all_gather(q, mesh, tp, 2)
    q, k, v = _project(params, x, q, positions, cfg, Hl)
    # the KV heads the rank's query heads read
    G = H // KV
    kv = slice(h0 // G, (h0 + Hl - 1) // G + 1)

    new_cache = None
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a KV cache")
        axes = lay.cache_seq
        s_loc = cache["k"].shape[1]
        pos = int(cache_pos)
        if not 0 <= pos < s_loc * (mesh.size(axes) if axes else 1):
            raise ValueError(f"cache_pos {pos} outside the cache's "
                             f"positions")
        local_pos = pos - (mesh.index(axes) * s_loc if axes else 0)
        if 0 <= local_pos < s_loc:      # the rank whose slice holds pos
            cache["k"][:, local_pos] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, local_pos] = v[:, 0].to(cache["v"].dtype)
        if local:
            o = decode_attention(q, cache["k"][:, :, kv],
                                 cache["v"][:, :, kv], pos)
        else:
            o = flash_decode(q, cache["k"], cache["v"], pos)
        new_cache = cache
    else:
        if sp:
            o = sp_prefill_attention(q, k, v, cfg)
        else:
            o = causal_attention(q, k, v)
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    o = o.reshape(B, S, Hl * Dh)
    if n == 1:
        return o @ params["wo"], new_cache
    if not local:
        o = coll.take_block(o, mesh, tp, 2)
    return coll.all_reduce(o @ params["wo"], mesh, tp), new_cache
