"""Input batch shapes and seeded random batches for the LM zoo (port of
``repro/launch/specs.py``: ``lm_batch_shapes`` and ``random_batch`` for
the train, prefill and decode kinds).  Batches are drawn from
``np.random.RandomState(seed)`` in the reference's order, so a seed gives
the JAX package's batch, bit for bit.  The dry-run's abstract batches
(``input_specs``: ``meta`` tensors, the CAPSim predictor's by
``capsim_batch_shapes``) and their shardings (``batch_shardings``) are
the reference's too."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ShapeConfig
from repro_torch.configs import capsim as capsim_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import NamedSharding, axis_rules


def _token_len(cfg, seq_len: int) -> int:
    """Token positions of a sequence of ``seq_len``: the frontend's
    embeddings take the first ``frontend_len``."""
    return seq_len - (cfg.frontend_len if cfg.frontend != "none" else 0)


def lm_batch_shapes(cfg, shape: ShapeConfig, kind: str) -> dict:
    """{name: (shape, numpy dtype)} of one input batch (without caches),
    in the reference's key order: tokens (B, S_tok[, C]), the frontend's
    (B, F, d_model) embeddings and M-RoPE's (3, B, S) positions where the
    config has them; a train batch adds labels (B, S[, C]) and the
    loss_mask (B, S) over all S positions; a decode batch is one (B, 1[,
    C]) token."""
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"kind must be train, prefill or decode, got "
                         f"{kind!r}")
    B, S = shape.global_batch, shape.seq_len
    codebooks = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    if kind == "decode":
        return {"tokens": ((B, 1) + codebooks, np.int32)}
    batch = {"tokens": ((B, _token_len(cfg, S)) + codebooks, np.int32)}
    if cfg.frontend != "none":
        batch["frontend"] = ((B, cfg.frontend_len, cfg.d_model), np.float32)
    if cfg.mrope_sections:
        batch["positions"] = ((3, B, S), np.int32)
    if kind == "train":
        batch["labels"] = ((B, S) + codebooks, np.int32)
        batch["loss_mask"] = ((B, S), np.float32)
    return batch


def random_batch(cfg, shape: ShapeConfig, kind: str, seed: int = 0,
                 device: DeviceLike = "cuda") -> dict:
    """Concrete random batch matching ``lm_batch_shapes`` on ``device``:
    token ids and labels in [0, vocab_size) as int64, frontend embeddings
    standard normal in float32, the loss mask ones (no draw), and the
    M-RoPE positions as the reference gives them: drawn (the draw
    advances the generator) and then replaced by ``arange(S)`` in all
    three streams."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    out = {}
    for k, (shp, dt) in lm_batch_shapes(cfg, shape, kind).items():
        if dt == np.int32:
            hi = cfg.vocab_size if k in ("tokens", "labels") \
                else shape.seq_len
            a = rng.randint(0, max(2, hi), size=shp).astype(np.int64)
        elif k == "loss_mask":
            a = np.ones(shp, np.float32)
        else:
            a = rng.randn(*shp).astype(np.float32)
        out[k] = torch.from_numpy(a).to(dev)
    if "positions" in out:
        B, S = shape.global_batch, shape.seq_len
        out["positions"] = torch.arange(S, device=dev).expand(
            3, B, S).contiguous()
    return out


def capsim_batch_shapes(cfg, shape: ShapeConfig, kind: str) -> dict:
    """{name: (shape, numpy dtype)} of one CAPSim predictor batch: clip
    tokens (B, L_clip, L_token), context tokens (B, M), the clip mask (B,
    L_clip) and, to train, the clip times (B,)."""
    B, L_clip = shape.global_batch, shape.seq_len
    batch = {"clip_tokens": ((B, L_clip, cfg.clip_tokens), np.int32),
             "context_tokens": ((B, cfg.context_tokens), np.int32),
             "clip_mask": ((B, L_clip), np.float32)}
    if kind == "train":
        batch["time"] = ((B,), np.float32)
    return batch


def input_specs(cfg, shape: ShapeConfig, kind: str) -> dict:
    """One batch of ``cfg`` at ``shape`` as ``meta`` tensors (the
    reference's ``ShapeDtypeStruct`` stand-ins): ids int64, as the
    port's batches carry them, the rest float32."""
    shapes = (capsim_batch_shapes if isinstance(cfg, capsim_config.ArchConfig)
              else lm_batch_shapes)(cfg, shape, kind)
    return {k: torch.empty(shp, device="meta", dtype=torch.int64
                           if dt == np.int32 else torch.float32)
            for k, (shp, dt) in shapes.items()}


_BATCH_AXES = {
    "tokens": ("batch",),
    "labels": ("batch",),
    "loss_mask": ("batch",),
    "frontend": ("batch",),
    "clip_tokens": ("batch",),
    "context_tokens": ("batch",),
    "clip_mask": ("batch",),
    "time": ("batch",),
    "positions": (None, "batch"),  # (3, B, S): batch is dim 1
}


def batch_shardings(batch_abs: dict, mesh, rules) -> dict:
    """The reference's sharding of each batch entry: its batch axis by
    the ``batch`` rule, every other dimension whole."""
    out = {}
    for k, v in batch_abs.items():
        lead = _BATCH_AXES[k]
        logical = lead + (None,) * (len(v.shape) - len(lead))
        out[k] = NamedSharding(mesh, axis_rules(logical, rules=rules,
                                                mesh=mesh))
    return out
