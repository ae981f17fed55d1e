"""The yardstick's FLOP and byte formulas against hand counts."""
import pytest

from capsim_bench import cost

PAPER = dict(d_model=128, num_heads=4, head_dim=32, d_ff=512,
             n_inst_layers=4, n_block_layers=4, clip_tokens=16,
             clip_len=128, context_tokens=360)


def test_attention_cost_by_hand():
    # (B, Sq, Skv, H, D) = (2, 3, 5, 4, 8), bf16, masked
    flops, nbytes = cost.attention_cost(2, 3, 5, 4, 8, 2, True)
    assert flops == 2 * 2 * (2 * 4 * 3 * 5 * 8)        # QK^T and PV
    assert nbytes == (2 * 3 * 4 * 8 * 2 + 2 * 5 * 4 * 8 * 2) * 2 + 4 * 2 * 5


def test_instruction_pass_bound_is_the_bytes_at_hbm_rate():
    f, b = cost.attention_cost(4096, 16, 16, 4, 32, 2, True)
    s = cost.least_seconds(f, b, "bfloat16")
    assert s == b / cost.PEAK_BYTES_PER_S
    assert s * 1e3 == pytest.approx(0.0201, abs=1e-4)


def test_forward_flops_per_clip_by_hand():
    E, HD, F, T, L, M = 128, 128, 512, 16, 128, 360
    per_token_layer = 4 * E * HD + 4 * E * HD + 4 * T * HD + 4 * E * F
    inst = L * 4 * T * per_token_layer
    self_ = M * (8 * E * HD + 4 * M * HD + 4 * E * F)
    cross = 4 * M * E * HD + 4 * M * L * HD + 4 * L * E * HD
    head = M * (2 * E * E + 2 * E)
    want = inst + 4 * (self_ + cross) + head
    assert cost.forward_flops_per_clip(PAPER) == pytest.approx(want)
    assert cost.forward_flops_per_clip(PAPER) == pytest.approx(4.34e9,
                                                               rel=0.01)
    assert cost.forward_flops_per_clip(PAPER, instruction_encoder=False) \
        == pytest.approx(want - inst)


def test_flash_launches_of_a_batch():
    # 256 clips: 32768 instruction rows in 8 passes of 4096 a layer
    n = cost.flash_launches(PAPER, 256, "bfloat16")
    assert len(n) == 8 * 4 + 2 * 4
    # 8 clips: one padded pass a layer
    assert len(cost.flash_launches(PAPER, 8, "bfloat16")) == 4 + 8


def test_flash_kernel_names():
    assert cost.FLASH_KERNEL.search("void fa_fwd_bf16<32, false>(Args)")
    assert cost.FLASH_KERNEL.search("void fa_fwd_f32<32, false>(Args)")
    assert not cost.FLASH_KERNEL.search("void fa_fwd_bf16<32, true>(Args)")


def test_flash_ops_of_one_dtype():
    ops = [("void fa_fwd_bf16<32, false>(Args)", 0, 10, 1),
           ("void fa_fwd_f32<32, false>(Args)", 10, 30, 2),
           ("void fa_fwd_bf16<32, true>(Args)", 30, 35, 3)]
    assert cost.flash_ops(ops, "bfloat16") == ops[:1]
    assert cost.flash_ops(ops, "float32") == ops[1:2]
