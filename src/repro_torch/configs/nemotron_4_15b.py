"""Nemotron-4-15B — dense, GQA kv=8, squared-ReLU MLP.

[arXiv:2402.16819; unverified].  32L, d_model=6144, 48 heads (head_dim 128),
d_ff=24576 with squared-ReLU (2-matrix MLP, no gate), vocab 256000.

Port of ``repro/configs/nemotron_4_15b.py``, verbatim but for the XLA knob
the port's ``ArchConfig`` lacks (``attn_chunk``).
"""
from repro_torch.configs import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-15b",
        family="dense",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=256000,
        activation="squared_relu",
        rope_theta=10_000.0,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        dtype="float32", param_dtype="float32", remat=False,
    )
