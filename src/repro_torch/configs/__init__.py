"""Architecture / shape configs of the port (``repro/configs/__init__.py``).

The LM zoo's ``ArchConfig`` keeps the reference's layer-schedule helpers
and the fields that the ported paths read: the stack, the embedding and
norms, the Mamba2 mixer, the attention mixer (heads, ``qk_norm``, RoPE
and Qwen2-VL's M-RoPE sections), the dense FFN's activation, the MoE
FFN's routing (experts, top-k, capacity factor, the interleave), the
modality frontend stubs (``frontend``, ``frontend_len``) and MusicGen's
parallel codebooks (``num_codebooks``), and ``attn_impl`` with the
reference's values: ``"sp"`` selects the sequence-parallel prefill
route (``models/attention.py``), every other value the kernel route.
the shape lists (``shape_names``, ``skipped_shapes``, ``skip_reason``:
the dry-run's cells) and ``remat`` (activation rematerialization: a
train step recomputes each super-block's activations in the backward,
``models/transformer.py``; on by default, off in the smoke configs, as
the reference's).  Left out: the sliding window and the logit soft-cap
(``attn_window``, ``attn_logit_softcap``), which no config of the zoo
sets; ``ssm_impl`` (the port always calls the SSD wrapper, which
launches the CUDA kernel on a CUDA tensor and runs the plain PyTorch
version on a CPU tensor), the XLA execution knobs (``scan_layers``,
``attn_chunk``) and the CAPSim predictor extras, whose config is
``configs/capsim.py`` (with its shapes, ``CAPSIM_SHAPES``).

``get_config``/``get_smoke_config`` resolve ``--arch`` names: ``capsim``
and every model of the LM zoo (``mamba2-780m``; the dense decoders
``olmo-1b``, ``qwen3-4b``, ``internlm2-20b``, ``nemotron-4-15b``; the MoE
and hybrid models ``kimi-k2-1t-a32b``, ``llama4-maverick-400b-a17b``,
``jamba-1.5-large-398b``; the frontend and codebook models
``qwen2-vl-2b`` and ``musicgen-large``).  An unknown name raises
``KeyError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# CAPSim predictor shapes: "seq_len" is the clip length (instructions per
# clip), batch is clips per step.  Kinds map onto the same train/serve
# entry points.
CAPSIM_SHAPES = {
    "train_clips": ShapeConfig("train_clips", 128, 4_096, "train"),
    "serve_clips": ShapeConfig("serve_clips", 128, 16_384, "prefill"),
}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1               # MoE FFN on layers with (i % moe_every == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm_state: int = 0               # Mamba2 d_state (0 -> no ssm layers)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256             # SSD chunk size
    attn_every: int = 0              # hybrid: attention on layers with (i % attn_every == attn_offset)
    attn_offset: int = 0

    # --- attention features ---
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (temporal, h, w) dims

    # --- FFN / norm features ---
    activation: str = "swiglu"       # swiglu | squared_relu | gelu
    nonparametric_norm: bool = False # olmo: LN without learnable params
    tie_embeddings: bool = False

    # --- modality frontend stubs ---
    frontend: str = "none"           # none | vision | audio
    frontend_len: int = 0            # number of precomputed frontend embeddings
    num_codebooks: int = 1           # musicgen: parallel EnCodec streams

    # --- implementation ---
    attn_impl: str = "chunked"       # chunked | pallas: the kernel route; sp: sequence-parallel
    remat: bool = True               # recompute each super-block in the backward

    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    pattern_len: int = 1             # layers per super-block (jamba: 8)

    # --- which assigned shape names apply (the dry-run's cells) ---
    shape_names: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    skipped_shapes: Tuple[str, ...] = ("long_500k",)
    skip_reason: str = "pure full-attention arch: 500k decode needs sub-quadratic mixer"

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_layers % self.pattern_len != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern_len={self.pattern_len}")

    def mixer_at(self, i: int) -> str:
        """'attn' | 'ssm' for layer i."""
        if self.ssm_state == 0:
            return "attn"
        if self.attn_every == 0:
            return "ssm"
        return "attn" if (i % self.attn_every) == self.attn_offset else "ssm"

    def ffn_at(self, i: int) -> str:
        """'dense' | 'moe' | 'none' for layer i."""
        if self.d_ff == 0 and self.num_experts == 0:
            return "none"
        if self.num_experts and (i % self.moe_every) == self.moe_offset:
            return "moe"
        return "dense" if self.d_ff else "none"

    def pattern(self) -> Tuple[Tuple[str, str], ...]:
        """The (mixer, ffn) schedule of one super-block."""
        return tuple((self.mixer_at(i), self.ffn_at(i))
                     for i in range(self.pattern_len))

    @property
    def num_repeats(self) -> int:
        return self.num_layers // self.pattern_len

    def shapes(self):
        return {n: LM_SHAPES[n] for n in self.shape_names}

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #

_PORTED = {"capsim": "capsim", "mamba2-780m": "mamba2_780m",
           "nemotron-4-15b": "nemotron_4_15b", "qwen3-4b": "qwen3_4b",
           "internlm2-20b": "internlm2_20b", "olmo-1b": "olmo_1b",
           "jamba-1.5-large-398b": "jamba_1_5_large_398b",
           "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
           "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
           "qwen2-vl-2b": "qwen2_vl_2b", "musicgen-large": "musicgen_large"}
ARCH_NAMES = tuple(_PORTED)


def _module(name: str):
    if name not in _PORTED:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCH_NAMES)}")
    return importlib.import_module(f"repro_torch.configs.{_PORTED[name]}")


def get_config(name: str):
    """The full (paper-exact) config for ``--arch <name>``."""
    return _module(name).config()


def get_smoke_config(name: str):
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).smoke_config()
