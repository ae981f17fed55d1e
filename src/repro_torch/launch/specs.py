"""Input batch shapes and seeded random batches for the LM zoo (port of
``repro/launch/specs.py``: ``lm_batch_shapes`` and ``random_batch`` for
the prefill and decode kinds).  Batches are drawn from
``np.random.RandomState(seed)`` in the reference's order, so a seed gives
the JAX package's tokens."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ShapeConfig
from repro_torch.device import DeviceLike, resolve_device


def lm_batch_shapes(cfg, shape: ShapeConfig, kind: str) -> dict:
    """{name: (shape, numpy dtype)} of one input batch (without caches)."""
    if kind == "train":
        raise NotImplementedError("training batches: ROADMAP port queue "
                                  "item 7")
    if kind not in ("prefill", "decode"):
        raise ValueError(f"kind must be prefill or decode, got {kind!r}")
    S = 1 if kind == "decode" else shape.seq_len
    return {"tokens": ((shape.global_batch, S), np.int32)}


def random_batch(cfg, shape: ShapeConfig, kind: str, seed: int = 0,
                 device: DeviceLike = "cuda") -> dict:
    """Concrete random batch matching ``lm_batch_shapes``: token ids in
    [0, vocab_size), as int64 tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    out = {}
    for k, (shp, _) in lm_batch_shapes(cfg, shape, kind).items():
        tok = rng.randint(0, max(2, cfg.vocab_size), size=shp)
        out[k] = torch.from_numpy(tok.astype(np.int64)).to(dev)
    return out
