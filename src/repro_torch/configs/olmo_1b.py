"""OLMo-1B — dense, MHA (kv=16), non-parametric LayerNorm.

[arXiv:2402.00838; hf].  16L, d_model=2048, 16 heads (head_dim 128),
d_ff=8192 SwiGLU, vocab 50304, LayerNorm without learnable affine params,
tied input/output embeddings.

Port of ``repro/configs/olmo_1b.py``, verbatim but for the XLA knob
the port's ``ArchConfig`` lacks (``attn_chunk``).
"""
from repro_torch.configs import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="olmo-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab_size=50304,
        nonparametric_norm=True,
        tie_embeddings=True,
        activation="swiglu",
        rope_theta=10_000.0,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        dtype="float32", param_dtype="float32", remat=False,
    )
