"""InternLM2-20B — dense, GQA kv=8.

[arXiv:2403.17297; hf].  48L, d_model=6144, 48 heads (head_dim 128),
d_ff=16384 SwiGLU, vocab 92544.

Port of ``repro/configs/internlm2_20b.py``, verbatim but for the XLA knob
the port's ``ArchConfig`` lacks (``attn_chunk``).
"""
from repro_torch.configs import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="internlm2-20b",
        family="dense",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92544,
        activation="swiglu",
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        dtype="float32", param_dtype="float32", remat=False,
    )
