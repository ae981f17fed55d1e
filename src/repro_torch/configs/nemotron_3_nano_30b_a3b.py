"""NVIDIA-Nemotron-3-Nano-30B-A3B (31.6B total / 3.2B active) — NemotronH:
Mamba2, MoE and GQA attention as single-op layers.

[hf: nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16, config.json].  52 layers
in ``hybrid_override_pattern`` order: 23 Mamba2 mixers (M: 64 heads × 64,
d_state 128, 8 B/C groups, conv 4 with bias, chunk 128), 23 MoE FFNs (E:
128 routed experts of width 1856, top-6 by a sigmoid router with a
correction bias, weights renormalized and scaled by 2.5, one shared
expert of width 3712, both non-gated relu²) and 6 attention layers (*:
32 query heads, 2 KV heads, head_dim 128, causal, no positional
rotation: the published modelling code applies none, so ``rope_theta``
and ``partial_rotary_factor`` are unread).  Each layer is ``x + op(
RMSNorm(x))`` (eps 1e-5); a final RMSNorm and an untied head over
131,072 tokens.  The JAX package has no such model.
"""
from repro_torch.configs import ArchConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"


def config() -> ArchConfig:
    return ArchConfig(
        name="nemotron-3-nano-30b-a3b",
        family="hybrid",
        num_layers=52,
        d_model=2688,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=1856,
        vocab_size=131072,
        num_experts=128,
        experts_per_token=6,
        router="sigmoid",
        routed_scaling=2.5,
        shared_expert_d_ff=3712,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_num_heads=64,
        ssm_groups=8,
        ssm_conv_width=4,
        ssm_chunk=128,
        ssm_conv_bias=True,
        layer_pattern=PATTERN,
        rope=False,
        activation="squared_relu",
        norm_eps=1e-5,
        shape_names=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        skipped_shapes=(),
        skip_reason="",
    )


def smoke_config() -> ArchConfig:
    """Every kind of layer at small widths: ``MEMEM*E``, 8 Mamba2 heads in
    4 groups, 8 experts top-2 and a shared expert."""
    return config().replace(
        num_layers=7, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256, num_experts=8, experts_per_token=2,
        shared_expert_d_ff=48, ssm_state=16, ssm_head_dim=16,
        ssm_num_heads=8, ssm_groups=4, ssm_chunk=16,
        dtype="float32", param_dtype="float32", remat=False,
    )
