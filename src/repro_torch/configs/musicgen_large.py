"""MusicGen-Large — decoder-only over EnCodec tokens, 4 codebooks.

[arXiv:2306.05284; hf].  48L, d_model=2048, 32 heads MHA (head_dim 64),
d_ff=8192 GELU, vocab 2048 per codebook, 4 parallel codebooks (delay pattern).
Token input is (B, S, 4); codebook embeddings are summed, and 4 output heads
predict the next token of each codebook.  The text/melody conditioning
frontend is a STUB: ``input_specs()`` supplies precomputed conditioning
frames (frontend_len=64) prepended to the sequence.

Port of ``repro/configs/musicgen_large.py``, verbatim but for the XLA
knob the port's ``ArchConfig`` lacks (``attn_chunk``).
"""
from repro_torch.configs import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large",
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        activation="gelu",
        rope_theta=10_000.0,
        frontend="audio",
        frontend_len=64,
        num_codebooks=4,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128, frontend_len=8, num_codebooks=4,
        dtype="float32", param_dtype="float32", remat=False,
    )
