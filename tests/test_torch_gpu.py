"""The port on the card: each CUDA kernel against its plain version, and
the engine on the card against the same engine on the CPU.  Every test
here is marked ``gpu`` and skips without a CUDA device; the file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import numpy as np  # noqa: E402
from _torch_cases import (FA_CASES, TOL, WA_CASES, fa_inputs,  # noqa: E402
                          wa_inputs)

from repro_torch.configs.capsim import config  # noqa: E402
from repro_torch.core import predictor  # noqa: E402
from repro_torch.core import standardize as std_mod  # noqa: E402
from repro_torch.core.engine import SimulationEngine  # noqa: E402
from repro_torch.core.engine_config import EngineConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.fused_serving import ops as wa_ops  # noqa: E402

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _cuda(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to("cuda", dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(dtype):
    _need_card()
    tdt = getattr(torch, dtype)
    before = fa_ops.flash_attention.launches
    for case in FA_CASES:
        causal, window = case[5], case[6]
        q, k, v, m = fa_inputs(case)
        args = [_cuda(x, tdt) for x in (q, k, v)]
        tm = None if m is None else _cuda(m, torch.float32)
        out = fa_ops.flash_attention(*args, causal=causal, window=window,
                                     kv_mask=tm)
        ref = fa_ops.flash_attention_plain(*args, causal=causal,
                                           window=window, kv_mask=tm)
        torch.cuda.synchronize()
        assert out.dtype == tdt and out.is_cuda
        err = float((out.float() - ref.float()).abs().max())
        assert err < TOL[dtype], (case, err)
    assert fa_ops.flash_attention.launches == before + len(FA_CASES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_kernel_matches_plain(dtype):
    _need_card()
    tdt = getattr(torch, dtype)
    for case in WA_CASES:
        q, k, v, w = wa_inputs(case)
        if case[4] not in fa_ops.HEAD_DIMS:          # kernel head dims
            q, k, v = (np.concatenate([x, x], axis=-1) for x in (q, k, v))
        args = [_cuda(x, tdt) for x in (q, k, v)]
        tw = _cuda(w, torch.float32)
        tw[0] = 0.0                                   # all-zero row
        out = wa_ops.weighted_attention(*args, tw)
        ref = wa_ops.weighted_attention_plain(*args, tw)
        torch.cuda.synchronize()
        assert float(out[0].float().abs().max()) == 0.0
        err = float((out.float() - ref.float()).abs().max())
        assert err < TOL[dtype], (case, err)


def test_kernels_refuse_what_they_do_not_take():
    _need_card()
    q = torch.zeros(1, 4, 2, 8, device="cuda")        # head_dim 8
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_ops.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match="mask/weights"):
        wa_ops.weighted_attention(q, q, q, torch.ones(1, 5, device="cuda"))


@pytest.mark.parametrize("fused", [False, True])
def test_engine_on_card_matches_cpu(fused):
    _need_card()
    cfg = config().replace(d_model=32, num_heads=2, head_dim=16, d_ff=64,
                           dtype="float32")
    params = predictor.init_params(cfg, seed=0, device="cpu")
    vocab = std_mod.build_vocab()
    ec = EngineConfig(interval_size=2_000, warmup=200, max_checkpoints=2,
                      l_min=32, l_clip=32, batch_size=16, precision="fp32",
                      fused_serving=fused)
    runs = {}
    for device in ("cpu", "cuda"):
        eng = SimulationEngine(params, cfg, vocab, ec, device=device)
        eng.submit_names(["503.bwaves", "541.leela"])
        runs[device] = eng.run()
    for a, b in zip(runs["cpu"], runs["cuda"]):
        assert a.oracle_cycles == b.oracle_cycles
        assert abs(b.predicted_cycles - a.predicted_cycles) \
            / abs(a.predicted_cycles) < 1e-4
