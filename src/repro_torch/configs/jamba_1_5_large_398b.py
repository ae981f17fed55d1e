"""Jamba-1.5-Large (398B) — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf].  72 layers in 9 super-blocks of 8: attention at
in-block index 4, Mamba elsewhere; MoE FFN on every other layer.  Runs
``long_500k`` (sub-quadratic SSM majority; the few attention layers decode
against a KV cache, which is O(S) per emitted token).

Port of ``repro/configs/jamba_1_5_large_398b.py``, verbatim but for the
XLA knob the port's ``ArchConfig`` lacks (``attn_chunk``).
"""
from repro_torch.configs import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        num_experts=16,
        experts_per_token=2,
        moe_every=2,
        moe_offset=1,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        attn_every=8,
        attn_offset=4,
        pattern_len=8,
        activation="swiglu",
        shape_names=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        skipped_shapes=(),
        skip_reason="",
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, num_experts=4, experts_per_token=2,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16, pattern_len=8,
        dtype="float32", param_dtype="float32", remat=False,
    )
