"""CAPSim attention performance predictor — the paper's own model (§V, Fig 4).

E=128 embeddings, 4-head MHA, 4 instruction-encoder layers + 4 block-encoder
layers, MLP head with arithmetic mean (paper §VI-B).

The reference describes every model of its zoo with one wide
``repro.configs.ArchConfig``; the port keeps only the fields the predictor
reads.  The attention implementation is not a field: the port always calls
its kernels' wrappers, which launch the CUDA kernel on a CUDA tensor and run
the plain PyTorch version on a CPU tensor.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.context import CONTEXT_LEN


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    d_model: int                     # E
    num_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    clip_tokens: int = 16            # L_token
    context_tokens: int = CONTEXT_LEN  # M
    dtype: str = "float32"           # compute dtype: float32 | bfloat16
    param_dtype: str = "float32"

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def config() -> ArchConfig:
    return ArchConfig(
        name="capsim",
        d_model=128,                  # E
        num_heads=4,
        head_dim=32,
        d_ff=512,
        vocab_size=512,               # standardized-token vocab is 383 (incl.
                                      # the <CORE> channel token), padded
        clip_tokens=16,               # L_token: max standardized length is 14
        context_tokens=CONTEXT_LEN,   # M = 40 registers x (1 name + 8 value
                                      # tokens)
        dtype="bfloat16",
        param_dtype="float32",
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        d_model=32, num_heads=2, head_dim=16, d_ff=64, vocab_size=256,
        clip_tokens=16, context_tokens=36, dtype="float32",
        param_dtype="float32")
