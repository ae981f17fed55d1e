"""GQA attention of the LM zoo, PyTorch port of ``repro/models/attention.py``
(``attn_specs`` :36-47, the flash route :90-92, ``flash_decode``'s
single-device branch :184-214, ``init_cache_specs`` :239-248 and
``attention_forward`` :251-315).

Two paths share one set of weights:

  train/prefill  full-sequence causal attention.  K/V heads are repeated
                 to the H query heads as the reference repeats them
                 (``jnp.repeat(k, G, axis=2)``: head h reads KV head
                 h // G), then ``kernels.flash_attention.ops.
                 flash_attention(causal=True)``: the CUDA kernel on a CUDA
                 tensor, its plain version on a CPU tensor.  That is the
                 reference's ``attn_impl="pallas"`` route; its chunked XLA
                 path computes the same function.
  decode         one query token against the KV cache: a masked softmax
                 over the cache with -1e30 past ``cache_pos``, scores in
                 f32 and p rounded to the value dtype, in plain PyTorch
                 (the reference reaches no Pallas kernel here either).
                 The new key and value are written into the cache in
                 place, at ``cache_pos``.

The sequence-parallel prefill and the ``shard_map`` flash-decoding are
multi-device paths (ROADMAP port queue item 6b).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import (ParamSpec, apply_rope, dense_spec,
                                       rms_norm)

NEG_SCORE = -1e30


def attn_specs(cfg) -> dict:
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": dense_spec(d, H * Dh),
        "wk": dense_spec(d, KV * Dh),
        "wv": dense_spec(d, KV * Dh),
        "wo": dense_spec(H * Dh, d),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((Dh,), std=0.0, dtype="float32")
        specs["k_norm"] = ParamSpec((Dh,), std=0.0, dtype="float32")
    return specs


def init_cache_specs(cfg, batch: int, max_seq: int) -> dict:
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    return {"k": ParamSpec((batch, max_seq, KV, Dh)),
            "v": ParamSpec((batch, max_seq, KV, Dh))}


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
    updated cache for decode, None for train)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got "
                         f"{mode!r}")
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q = (x @ params["wq"]).reshape(B, S, H, Dh)
    k = (x @ params["wk"]).reshape(B, S, KV, Dh)
    v = (x @ params["wv"]).reshape(B, S, KV, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    new_cache = None
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a KV cache")
        pos = int(cache_pos)
        if not 0 <= pos < cache["k"].shape[1]:
            raise ValueError(f"cache_pos {pos} outside the cache's "
                             f"{cache['k'].shape[1]} positions")
        cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
        o = decode_attention(q, cache["k"], cache["v"], pos)
        new_cache = cache
    else:
        o = causal_attention(q, k, v)
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    return o.reshape(B, S, H * Dh) @ params["wo"], new_cache
