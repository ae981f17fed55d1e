"""The port on the card: each CUDA kernel against its plain version, and
the engine and the Mamba2 LM on the card against the same code on the
CPU.  Every test here is marked ``gpu`` and skips without a CUDA device;
the file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import numpy as np  # noqa: E402
from _torch_cases import (FA_CASES, FA_EDGE_CASES, SSD_CASES,  # noqa: E402
                          SSD_EDGE_CASES, SSD_TOL, TOL, WA_CASES,
                          WA_EDGE_CASES, fa_inputs, scaled_err, ssd_inputs,
                          wa_inputs)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.capsim import config  # noqa: E402
from repro_torch.core import predictor  # noqa: E402
from repro_torch.core import standardize as std_mod  # noqa: E402
from repro_torch.core.engine import SimulationEngine  # noqa: E402
from repro_torch.core.engine_config import EngineConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.fused_serving import ops as wa_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

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
    cases = FA_CASES + FA_EDGE_CASES
    for case in cases:
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
    assert fa_ops.flash_attention.launches == before + len(cases)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_strided_views_and_keyless_rows(dtype):
    """q/k/v as strided views of one fused QKV tensor (ragged 16-row and
    64-key tiles), and a batch row whose keys are all masked: exact
    zeros."""
    _need_card()
    tdt = getattr(torch, dtype)
    rng = np.random.RandomState(3)
    qkv = _cuda(rng.randn(3, 100, 3 * 4 * 32), tdt)
    q, k, v = (x.unflatten(-1, (4, 32)) for x in qkv.split(128, dim=-1))
    m = _cuda((rng.rand(3, 100) > 0.3).astype(np.float32), torch.float32)
    m[1] = 0.0                                        # batch row 1: no key
    for causal in (False, True):
        out = fa_ops.flash_attention(q, k, v, causal=causal, kv_mask=m)
        ref = fa_ops.flash_attention_plain(q, k, v, causal=causal,
                                           kv_mask=m)
        torch.cuda.synchronize()
        assert float(out[1].float().abs().max()) == 0.0
        err = float((out.float() - ref.float()).abs().max())
        assert err < TOL[dtype], (causal, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_kernel_matches_plain(dtype):
    _need_card()
    tdt = getattr(torch, dtype)
    before = wa_ops.weighted_attention.launches
    cases = WA_CASES + WA_EDGE_CASES
    for case in cases:
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
    assert wa_ops.weighted_attention.launches == before + len(cases)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_kernel_strided_views(dtype):
    """q/k/v as strided views of one fused QKV tensor, as the fused step
    hands them over, over 100 deduplicated tokens (ragged tiles)."""
    _need_card()
    tdt = getattr(torch, dtype)
    rng = np.random.RandomState(4)
    qkv = _cuda(rng.randn(3, 100, 3 * 4 * 32), tdt)
    q, k, v = (x.unflatten(-1, (4, 32)) for x in qkv.split(128, dim=-1))
    w = _cuda(rng.randint(0, 5, (3, 100)).astype(np.float32), torch.float32)
    out = wa_ops.weighted_attention(q, k, v, w)
    ref = wa_ops.weighted_attention_plain(q, k, v, w)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    assert err < TOL[dtype], err


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
    shifted = torch.zeros(1, 4, 33, device="cuda")[..., 1:].unflatten(
        -1, (2, 16))                                  # starts 4 bytes in
    with pytest.raises(ValueError, match="16 bytes"):
        fa_ops.flash_attention(q, shifted, q)
    with pytest.raises(ValueError, match="16 bytes"):
        wa_ops.weighted_attention(q, shifted, q,
                                  torch.ones(1, 4, device="cuda"))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain(dtype):
    """SSD_CASES, SSD_EDGE_CASES, a large-decay case and an all-padding
    chunk."""
    _need_card()
    tdt = getattr(torch, dtype)
    before = ssd_ops.ssd_scan.launches
    cases = [(case, 1.0) for case in SSD_CASES + SSD_EDGE_CASES] + [
        ((2, 300, 4, 64, 128, 256), 60.0)]
    for case, a_scale in cases:
        x, dt, B, C, A = ssd_inputs(case, a_scale=a_scale)
        if case == SSD_CASES[1]:                      # all-padding chunk
            for a in (x, dt, B, C):
                a[:, 64:] = 0.0
        args = (_cuda(x, tdt), _cuda(dt, torch.float32), _cuda(B, tdt),
                _cuda(C, tdt), _cuda(A, torch.float32))
        y, st = ssd_ops.ssd_scan(*args, chunk=case[-1])
        yp, sp = ssd_ops.ssd_scan_plain(*args, chunk=case[-1])
        torch.cuda.synchronize()
        assert y.dtype == tdt and y.is_cuda and st.dtype == torch.float32
        assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
        for out, ref in ((y, yp), (st, sp)):
            err = scaled_err(out.float().cpu().numpy(),
                             ref.float().cpu().numpy())
            assert err < SSD_TOL[dtype], (case, a_scale, err)
    assert ssd_ops.ssd_scan.launches == before + len(cases)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_on_unaligned_views(dtype):
    """B/C as views one element past a 16-byte boundary, rows N + 1
    apart, N = 20: the kernel's plain-copy path."""
    _need_card()
    tdt = getattr(torch, dtype)
    x, dt, B, C, A = ssd_inputs((2, 300, 4, 64, 20, 128), seed=8)
    wide = [_cuda(np.pad(t, ((0, 0), (0, 0), (1, 0))), tdt) for t in (B, C)]
    args = (_cuda(x, tdt), _cuda(dt, torch.float32), wide[0][..., 1:],
            wide[1][..., 1:], _cuda(A, torch.float32))
    y, st = ssd_ops.ssd_scan(*args, chunk=128)
    yp, sp = ssd_ops.ssd_scan_plain(*args, chunk=128)
    torch.cuda.synchronize()
    for out, ref in ((y, yp), (st, sp)):
        err = scaled_err(out.float().cpu().numpy(), ref.float().cpu().numpy())
        assert err < SSD_TOL[dtype], err


def test_ssd_kernel_refuses_what_it_does_not_take():
    _need_card()
    x = torch.zeros(1, 8, 2, 8, device="cuda")          # head_dim 8
    dt = torch.zeros(1, 8, 2, device="cuda")
    B = torch.zeros(1, 8, 16, device="cuda")
    A = -torch.ones(2, device="cuda")
    with pytest.raises(ValueError, match="head_dim 8.*not supported"):
        ssd_ops.ssd_scan(x, dt, B, B, A)
    x = torch.zeros(1, 8, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        ssd_ops.ssd_scan(x, dt.double(), B, B, A)
    with pytest.raises(ValueError, match="on cpu"):
        ssd_ops.ssd_scan(x, dt, B.cpu(), B, A)


def test_mamba2_on_card_matches_cpu():
    """The smoke-size Mamba2 LM: the same seeded parameters on both
    devices, prefill over 40 tokens (padded third chunk) + 3 greedy
    decode steps; logits <= 1e-4 relative, the same tokens."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("mamba2-780m")
    params = tfm.init_params(cfg, seed=0, device="cpu")
    on_card = tfm.init_params(cfg, seed=0, device="cuda")
    for a, b in zip(params["blocks"]["i0"]["mixer"].values(),
                    on_card["blocks"]["i0"]["mixer"].values()):
        assert torch.equal(a, b.cpu())                # one seed, one init
    tok = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 40)))
    before = ssd_ops.ssd_scan.launches
    card = generate(on_card, cfg, {"tokens": tok}, 3, device="cuda")
    assert ssd_ops.ssd_scan.launches == before + cfg.num_layers
    cpu = generate(params, cfg, {"tokens": tok}, 3, device="cpu")
    rel = float((card.logits.cpu() - cpu.logits).abs().max()
                / cpu.logits.abs().max())
    assert rel <= 1e-4, rel
    assert torch.equal(card.tokens.cpu(), cpu.tokens)
