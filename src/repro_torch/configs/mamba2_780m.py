"""Mamba2-780m — pure SSM (attention-free), SSD state-space duality.

Port of ``repro/configs/mamba2_780m.py`` [arXiv:2405.21060; unverified].
48 layers, d_model=1536, d_inner=2*d_model, head_dim=64 -> 48 SSD heads,
d_state=128, no FFN (the Mamba block is the whole layer).
"""
from repro_torch.configs import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk=256,
        shape_names=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        skipped_shapes=(),
        skip_reason="",
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        num_layers=4, d_model=64, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=16,
        dtype="float32", param_dtype="float32", remat=False,
    )
