"""Qwen3-4B — dense, GQA kv=8, QK-norm.

[hf:Qwen/Qwen3-8B; hf].  36L, d_model=2560, 32 heads with explicit
head_dim=128 (q proj dim 4096 != d_model, as in Qwen3), d_ff=9728 SwiGLU,
vocab 151936, RMS qk_norm on per-head q/k.

Port of ``repro/configs/qwen3_4b.py``, verbatim but for the XLA knob
the port's ``ArchConfig`` lacks (``attn_chunk``).
"""
from repro_torch.configs import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-4b",
        family="dense",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151936,
        qk_norm=True,
        activation="swiglu",
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        dtype="float32", param_dtype="float32", remat=False,
    )
