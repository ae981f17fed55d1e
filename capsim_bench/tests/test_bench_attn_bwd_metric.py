"""The reader of flash attention's backward in the LM train cell,
``attn_bwd_ms.lm_train``: device milliseconds a step of the kernels
launched inside span ``flash_attention_backward``, on a hand-built
trace; nothing (None) where the trace has no such span or no step."""
import pytest

from capsim_bench import harness
from capsim_bench.trace import Trace

LM = "nemo3.train-s4k-b2"
NAME = "attn_bwd_ms.lm_train"


def _read(rec):
    return harness.reader(NAME)(rec, harness.load_cell(LM))


def _trace(ranges):
    # 2 steps; kernels launched inside the backward's two spans (4 + 6 +
    # 10 us), one launched before them and one between them
    ops = [("fa_bwd_dkdv", 1_000, 5_000, 1), ("fa_bwd_dq", 6_000, 12_000, 2),
           ("gemm", 13_000, 113_000, 3), ("fa_bwd_dkdv", 200_000, 210_000, 4),
           ("elementwise", 300_000, 400_000, 5)]
    launches = {1: 100, 2: 200, 3: 5_000, 4: 150_000, 5: 50}
    return Trace(ops, launches, ranges, 1.0)


def test_reads_the_kernels_launched_inside_the_span_a_step():
    ranges = {"train/forward": [(0, 10), (20, 30)],
              "flash_attention_backward": [(90, 1_000), (140_000, 160_000)]}
    assert _read({"trace": _trace(ranges)}) == pytest.approx(
        (0.004 + 0.006 + 0.010) / 2, rel=1e-9)


def test_finds_nothing_without_the_span_or_the_steps():
    assert _read({"trace": _trace({"train/forward": [(0, 10)]})}) is None
    assert _read({"trace": _trace(
        {"flash_attention_backward": [(90, 1_000)]})}) is None
    assert _read({}) is None
