"""Qwen2-VL-2B — VLM backbone, M-RoPE, GQA kv=2.

[arXiv:2409.12191; hf].  28L, d_model=1536, 12 heads (head_dim 128),
d_ff=8960 SwiGLU, vocab 151936.  The vision frontend is a STUB:
``input_specs()`` supplies precomputed patch embeddings (frontend_len=256)
that are prepended to token embeddings; M-RoPE uses 3 position streams
(temporal/height/width) with sections (16, 24, 24) over head_dim 128 halves.

Port of ``repro/configs/qwen2_vl_2b.py``, verbatim but for the XLA knob
the port's ``ArchConfig`` lacks (``attn_chunk``).
"""
from repro_torch.configs import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b",
        family="vlm",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        mrope_sections=(16, 24, 24),
        activation="swiglu",
        rope_theta=1_000_000.0,
        frontend="vision",
        frontend_len=256,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        mrope_sections=(4, 2, 2), frontend_len=8,
        d_ff=128, vocab_size=256,
        dtype="float32", param_dtype="float32", remat=False,
    )
