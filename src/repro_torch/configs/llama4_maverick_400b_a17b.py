"""Llama-4 Maverick (400B total / 17B active) — MoE 128 experts top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  48L, d_model=5120,
40 heads (head_dim 128), GQA kv=8, d_ff=8192, vocab 202048.  MoE interleaved
every other layer (interleave_moe_layer_step=2), top-1 routing.

Port of ``repro/configs/llama4_maverick_400b_a17b.py``, verbatim but for
the XLA knob the port's ``ArchConfig`` lacks (``attn_chunk``).
"""
from repro_torch.configs import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        num_experts=128,
        experts_per_token=1,
        moe_every=2,
        moe_offset=1,
        pattern_len=2,
        activation="swiglu",
        rope_theta=500_000.0,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256, num_experts=4, experts_per_token=1,
        pattern_len=2,
        dtype="float32", param_dtype="float32", remat=False,
    )
