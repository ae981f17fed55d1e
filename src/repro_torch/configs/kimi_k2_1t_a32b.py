"""Kimi-K2 (1T total / 32B active) — trillion-parameter MoE, 384 experts top-8.

[arXiv:2501.kimi2; unverified, paper-table].  61L, d_model=7168, 64 heads
(head_dim 112), GQA kv=8, per-expert d_ff=2048, vocab 163840.  Every layer is
MoE (384 routed experts, top-8).

Port of ``repro/configs/kimi_k2_1t_a32b.py``, verbatim but for the XLA
knob the port's ``ArchConfig`` lacks (``attn_chunk``).
"""
from repro_torch.configs import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        head_dim=112,
        d_ff=2048,
        vocab_size=163840,
        num_experts=384,
        experts_per_token=8,
        moe_every=1,
        activation="swiglu",
        rope_theta=50_000.0,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256, num_experts=8, experts_per_token=2,
        dtype="float32", param_dtype="float32", remat=False,
    )
