"""The port on the card: each CUDA kernel against its plain version (the
flash and SSD kernels' gradients too), and the engine (single-core and
multicore, sampled, its RT store's restart, and on a data mesh of one
or two cards), the serving layer, the
Mamba2 LM, the dense decoders, the MoE and hybrid models, the frontend
and codebook models and a train step of the CAPSim predictor and of two
LMs on the card against the same code on the CPU.
Every test here is marked ``gpu`` and skips without a CUDA device; the
file imports no JAX, so it runs on a machine that has only PyTorch:

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

from repro_torch.configs import ShapeConfig, get_smoke_config  # noqa: E402
from repro_torch.configs.capsim import config  # noqa: E402
from repro_torch.core import predictor  # noqa: E402
from repro_torch.core import standardize as std_mod  # noqa: E402
from repro_torch.core.engine import SimulationEngine  # noqa: E402
from repro_torch.core.engine_config import (EngineConfig,  # noqa: E402
                                            SamplingConfig)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.fused_serving import ops as wa_ops  # noqa: E402
from repro_torch.isa import multicore  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.specs import random_batch  # noqa: E402
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_112_runs_zero_padded(dtype):
    """head_dim 112 (kimi-k2's) on the D=128 instantiation with q/k/v
    zero-padded and the scale of D=112: flash (causal and not, a masked
    key tail, a query block and key tile that end mid-way) and weighted
    attention (zero weights, an all-zero row) against their plain
    versions, which take D=112 as it is."""
    _need_card()
    tdt = getattr(torch, dtype)
    rng = np.random.RandomState(11)
    q, k, v = (_cuda(rng.randn(2, s, 3, 112), tdt) for s in (100, 257, 257))
    m = _cuda((rng.rand(2, 257) > 0.3).astype(np.float32), torch.float32)
    w = _cuda(rng.randint(0, 5, (2, 257)).astype(np.float32), torch.float32)
    w[0] = 0.0
    before = (fa_ops.flash_attention.launches,
              wa_ops.weighted_attention.launches)
    for causal in (False, True):
        out = fa_ops.flash_attention(q, k, v, causal=causal, kv_mask=m)
        ref = fa_ops.flash_attention_plain(q, k, v, causal=causal,
                                           kv_mask=m)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.is_contiguous()
        err = float((out.float() - ref.float()).abs().max())
        assert err < TOL[dtype], (causal, err)
    kq = k[:, :100]
    out = wa_ops.weighted_attention(kq, k, v, w)
    ref = wa_ops.weighted_attention_plain(kq, k, v, w)
    torch.cuda.synchronize()
    assert out.shape == kq.shape
    assert float(out[0].float().abs().max()) == 0.0
    err = float((out.float() - ref.float()).abs().max())
    assert err < TOL[dtype], err
    assert (fa_ops.flash_attention.launches,
            wa_ops.weighted_attention.launches) == (before[0] + 2,
                                                    before[1] + 1)


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


def _multicore_engine_config(**kw):
    return EngineConfig(interval_size=1_200, warmup=150, max_checkpoints=2,
                        l_min=32, l_clip=32, batch_size=16,
                        precision="fp32", **kw)


@pytest.mark.parametrize("fused", [False, True])
def test_multicore_engine_on_card_matches_cpu(fused):
    """run_multicore at context width 369 on the card and on the CPU:
    the same clips and oracle cycles per core, predictions <= 1e-4
    relative, both kernels launched."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config().replace(d_model=32, num_heads=2, head_dim=16, d_ff=64,
                           dtype="float32")
    params = predictor.init_params(cfg, seed=0, device="cpu")
    vocab = std_mod.build_vocab()
    ec = _multicore_engine_config(fused_serving=fused)
    runs = {}
    before = (fa_ops.flash_attention.launches,
              wa_ops.weighted_attention.launches)
    for device in ("cuda", "cpu"):
        eng = SimulationEngine(params, cfg, vocab, ec, device=device)
        runs[device] = eng.run_multicore(
            [multicore.build_multicore_benchmark("mt.mix", 2),
             multicore.build_multicore_benchmark("mt.chase", 3)])
    assert fa_ops.flash_attention.launches > before[0]
    assert (wa_ops.weighted_attention.launches > before[1]) == fused
    for a, b in zip(runs["cpu"], runs["cuda"]):
        for ca, cb in zip(a.cores, b.cores):
            assert (ca.name, ca.n_clips) == (cb.name, cb.n_clips)
            assert ca.oracle_cycles == cb.oracle_cycles
            assert abs(cb.predicted_cycles - ca.predicted_cycles) \
                / abs(ca.predicted_cycles) < 1e-4


def test_rt_store_restart_bitwise_on_card(tmp_path):
    """An engine on the card persists its RT table; a second one adopts
    it (rows loaded, nothing encoded) and reproduces the first run bit
    for bit; an engine on the CPU in the same directory adopts nothing."""
    _need_card()
    cfg = config().replace(d_model=32, num_heads=2, head_dim=16, d_ff=64,
                           dtype="float32")
    params = predictor.init_params(cfg, seed=0, device="cpu")
    vocab = std_mod.build_vocab()
    ec = _multicore_engine_config(rt_store_dir=str(tmp_path))
    mbs = [multicore.build_multicore_benchmark("mt.mix", 2)]
    runs = []
    for _ in range(2):
        eng = SimulationEngine(params, cfg, vocab, ec, device="cuda")
        runs.append(([c.predicted_cycles for c in
                      eng.run_multicore(mbs)[0].cores], eng.last_rt_stats))
    (p1, st1), (p2, st2) = runs
    assert st1.n_rows_loaded == 0 and st1.n_rows_encoded > 0
    assert st2.n_rows_loaded == st1.n_rows_encoded
    assert st2.n_rows_encoded == 0
    assert p1 == p2                                   # bitwise
    cpu = SimulationEngine(params, cfg, vocab, ec, device="cpu")
    cpu.run_multicore(mbs)
    assert cpu.last_rt_stats.n_rows_loaded == 0


def _mesh_runs(fused, meshes):
    """The unsharded engine on the card, then one run per mesh: (results,
    RT table) each."""
    from repro_torch.launch.mesh import make_data_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config().replace(d_model=32, num_heads=2, head_dim=16, d_ff=64,
                           dtype="float32")
    params = predictor.init_params(cfg, seed=0, device="cpu")
    vocab = std_mod.build_vocab()
    ec = EngineConfig(interval_size=2_000, warmup=200, max_checkpoints=2,
                      l_min=32, l_clip=32, batch_size=16, precision="fp32",
                      fused_serving=fused)
    runs = []
    for mesh in (None, *meshes):
        config_ = ec if mesh is None else ec.replace(
            mesh_shape=(mesh[0],))
        kw = {} if mesh is None else {"mesh": make_data_mesh(*mesh[:2],
                                                             **mesh[2])}
        eng = SimulationEngine(params, cfg, vocab, config_, device="cuda",
                               **kw)
        eng.submit_names(["503.bwaves", "541.leela"])
        res = eng.run()
        cache = eng._stack.cache
        runs.append((res, cache.table[:cache.n_rows].cpu()))
    return runs


def _mesh_close(base, other):
    (r0, t0), (r1, t1) = base, other
    assert torch.equal(t0, t1)                  # the table, byte for byte
    for a, b in zip(r0, r1, strict=True):
        assert (a.name, a.n_clips) == (b.name, b.n_clips)
        assert abs(b.predicted_cycles - a.predicted_cycles) \
            / abs(a.predicted_cycles) <= 1e-6


@pytest.mark.parametrize("fused", [False, True])
def test_mesh_on_one_card_matches_unsharded(fused):
    """Meshes (1,) and (2,) asked for on one card, each shard on its own
    stream: the RT table byte-identical to the unsharded engine's (the
    sharded encode keeps the 4096-row passes), predictions within the
    service's rt gate of 1e-6 per benchmark, (1,) bitwise."""
    _need_card()
    one = {"on_one_device": True}
    base, m1, m2 = _mesh_runs(fused, [(1, "cuda:0", one),
                                      (2, "cuda:0", one)])
    _mesh_close(base, m2)
    _mesh_close(base, m1)
    assert [r.predicted_cycles for r in m1[0]] == \
        [r.predicted_cycles for r in base[0]]


def test_mesh_on_two_cards_matches_unsharded():
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards, {torch.cuda.device_count()} "
                    "visible")
    base, m2 = _mesh_runs(True, [(2, "cuda", {})])
    _mesh_close(base, m2)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ssd_kernel_matches_plain(dtype):
    """B/C in G groups (head h reads group h // (H / G)): the kernel
    against the plain version at small shapes, a ragged last chunk, and
    NemotronH's layer (Bt 2, S 4096, 64 heads x 64, N 128, G 8, chunk
    128); B/C as slices of one (Bt, S, 2, G, N) projection, as the mixer
    gives them.  One group as a 4-d view launches the same bits as the
    shared (Bt, S, N) layout."""
    _need_card()
    tdt = getattr(torch, dtype)
    cases = [((2, 300, 8, 64, 32, 128), 2), ((1, 200, 16, 64, 128, 64), 8),
             ((2, 4096, 64, 64, 128, 128), 8)]
    for case, G in cases:
        Bt, S, H, P, N, q = case
        x, dt, _, _, A = ssd_inputs(case, seed=11)
        bc = np.random.RandomState(3).randn(Bt, S, 2, G, N).astype(
            np.float32) * 0.3
        bc = _cuda(bc, tdt)
        args = (_cuda(x, tdt), _cuda(dt, torch.float32), bc[:, :, 0],
                bc[:, :, 1], _cuda(A, torch.float32))
        y, st = ssd_ops.ssd_scan(*args, chunk=q)
        yp, sp = ssd_ops.ssd_scan_plain(*args, chunk=q)
        torch.cuda.synchronize()
        for out, ref in ((y, yp), (st, sp)):
            err = scaled_err(out.float().cpu().numpy(),
                             ref.float().cpu().numpy())
            assert err < SSD_TOL[dtype], (case, G, err)
    x, dt, B, C, A = ssd_inputs(SSD_CASES[0])
    args = [_cuda(t, d) for t, d in ((x, tdt), (dt, torch.float32), (B, tdt),
                                     (C, tdt), (A, torch.float32))]
    shared = ssd_ops.ssd_scan(*args, chunk=SSD_CASES[0][-1])
    one = ssd_ops.ssd_scan(args[0], args[1], args[2][:, :, None],
                           args[3][:, :, None], args[4],
                           chunk=SSD_CASES[0][-1])
    for a, b in zip(shared, one):
        assert torch.equal(a, b)


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


def test_sampled_engine_on_card_matches_cpu():
    """EngineConfig.sampling on the card: the sample (host numpy) is the
    CPU run's, the estimate and CI within 1e-4; fraction=1.0 bitwise the
    unsampled card run, single-core and (one checkpoint) multicore."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config().replace(d_model=32, num_heads=2, head_dim=16, d_ff=64,
                           dtype="float32")
    params = predictor.init_params(cfg, seed=0, device="cpu")
    vocab = std_mod.build_vocab()
    ec = EngineConfig(interval_size=2_000, warmup=200, max_checkpoints=3,
                      l_min=32, l_clip=32, batch_size=16, precision="fp32")
    sampled = ec.replace(sampling=SamplingConfig(
        fraction=0.25, strata=3, bootstrap_resamples=30))
    runs = {}
    for key, config_, device in (("cpu", sampled, "cpu"),
                                 ("cuda", sampled, "cuda"),
                                 ("full", ec, "cuda"),
                                 ("one", ec.replace(sampling=SamplingConfig(
                                     fraction=1.0)), "cuda")):
        eng = SimulationEngine(params, cfg, vocab, config_, device=device)
        eng.submit_names(["503.bwaves", "541.leela"])
        runs[key] = eng.run()
    for a, b in zip(runs["cpu"], runs["cuda"], strict=True):
        assert np.array_equal(a.clip_provenance, b.clip_provenance)
        assert 0 < b.clips_predicted < b.n_clips
        for x, y in zip((a.predicted_cycles, *a.cycles_ci),
                        (b.predicted_cycles, *b.cycles_ci)):
            assert abs(y - x) / abs(x) < 1e-4
    for a, b in zip(runs["full"], runs["one"], strict=True):
        assert b.predicted_cycles == a.predicted_cycles      # bitwise
    mc = _multicore_engine_config().replace(max_checkpoints=1)
    mbs = [multicore.build_multicore_benchmark("mt.mix", 2)]
    full = SimulationEngine(params, cfg, vocab, mc,
                            device="cuda").run_multicore(mbs)[0]
    one = SimulationEngine(params, cfg, vocab, mc.replace(
        sampling=SamplingConfig(fraction=1.0)), device="cuda"
        ).run_multicore(mbs)[0]
    assert [c.predicted_cycles for c in one.cores] == \
        [c.predicted_cycles for c in full.cores]


def test_rt_path_is_bitwise_the_monolithic_path_on_card():
    """C2 on the card: the RT cache's encode pass and a monolithic batch
    run the instruction encoder in passes of the same size, so the RT
    path's clip times are the monolithic path's bit for bit."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.rt_cache import RTCache
    cfg = config().replace(dtype="float32")
    params = predictor.init_params(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(0)
    tok = rng.randint(1, 300, (40, 128, 16)).astype(np.int32)
    tok[:, :, 9:] = 0                       # <PAD> tails, as real rows
    tok[5, 60:] = 0                         # a short clip
    mask = (tok[:, :, 0] != 0).astype(np.float32)
    ctx = rng.randint(0, 300, (40, cfg.context_tokens)).astype(np.int32)
    batch = {"context_tokens": torch.as_tensor(ctx, device="cuda"),
             "clip_mask": torch.as_tensor(mask, device="cuda")}
    mono = predictor.forward(params, {**batch, "clip_tokens":
                                      torch.as_tensor(tok, device="cuda")},
                             cfg)
    cache = RTCache(params, cfg, 16, device="cuda")
    cache.ensure_rows(tok[:3].reshape(-1, 16))       # an earlier, small pass
    idx = cache.index_clips(tok)
    rt = predictor.forward_cached(params, cache.table, {
        **batch, "rt_idx": torch.as_tensor(idx, device="cuda")}, cfg)
    assert cache.stats.n_encode_passes == 2
    assert torch.equal(rt, mono)


def test_service_on_card():
    """SimulationService on the card at small width: a healthy burst is
    ok at the top rung, and each rung's spot check against the monolithic
    fp32 reference is within its gate (rt bitwise)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.serving import Request, ServiceSLA, SimulationService
    from repro_torch.serving.service import _QueuedRequest
    cfg = config().replace(d_model=32, num_heads=2, head_dim=16, d_ff=64,
                           dtype="float32")
    params = predictor.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(1)

    def req(i, n=6):
        tok = rng.randint(0, 300, (n, 128, 16)).astype(np.int32)
        ctx = rng.randint(0, 300, (n, cfg.context_tokens)).astype(np.int32)
        return Request(i, tok, ctx, np.ones((n, 128), np.float32))
    reqs = [req(i) for i in range(6)]
    svc = SimulationService(params, cfg, EngineConfig(batch_size=8),
                            sla=ServiceSLA(check_clips=6), device="cuda")
    svc.prewarm(reqs[0])
    with svc:
        results = [t.result(timeout=120)
                   for t in [svc.submit(r) for r in reqs]]
    assert all(r.status == "ok" and r.tier == "fused_int8" for r in results)
    qr = _QueuedRequest(req=reqs[2], ticket=None, arrival=0.0, deadline=0.0)
    errs = {s.name: svc._spot_check(t, [qr])
            for t, s in zip(svc._tiers[:-1], svc.tier_stats)}
    assert errs["rt"] == 0.0
    for name, err in errs.items():
        assert err <= svc.sla.tier_tolerances[name], (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_flash_head_dim_128_matches_plain(dtype):
    """The dense prefill's route: causal flash at head dim 128 over KV
    heads repeated to the query heads (GQA, G = 4), at lengths that end
    inside a 16-row query block and a 64-key tile, and at 1024."""
    _need_card()
    tdt = getattr(torch, dtype)
    rng = np.random.RandomState(12)
    before = fa_ops.flash_attention.launches
    for B, S, H, KV in ((2, 300, 8, 2), (1, 1024, 8, 8)):
        q = _cuda(rng.randn(B, S, H, 128), tdt)
        k, v = (_cuda(rng.randn(B, S, KV, 128), tdt).repeat_interleave(
            H // KV, dim=2) for _ in range(2))
        out = fa_ops.flash_attention(q, k, v, causal=True)
        ref = fa_ops.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        assert err < TOL[dtype], (B, S, H, err)
    assert fa_ops.flash_attention.launches == before + 2


def test_dense_on_card_matches_cpu():
    """qwen3-4b at full width cut to 2 layers, f32 (TF32 off): the same
    seeded parameters on both devices, a prompt of 2 x 300 tokens + 2
    greedy decode steps (one causal flash launch per layer in the
    prefill); logits <= 1e-4 relative, the same tokens."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-4b").replace(num_layers=2, dtype="float32",
                                         param_dtype="float32")
    threads = torch.get_num_threads()
    torch.set_num_threads(8)          # the CPU side at full width
    try:
        params = tfm.init_params(cfg, seed=0, device="cpu")
        on_card = tfm.init_params(cfg, seed=0, device="cuda")
        tok = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (2, 300)))
        before = fa_ops.flash_attention.launches
        card = generate(on_card, cfg, {"tokens": tok}, 2, device="cuda")
        assert fa_ops.flash_attention.launches == before + cfg.num_layers
        cpu = generate(params, cfg, {"tokens": tok}, 2, device="cpu")
    finally:
        torch.set_num_threads(threads)
    rel = float((card.logits.cpu() - cpu.logits).abs().max()
                / cpu.logits.abs().max())
    assert rel <= 1e-4, rel
    assert torch.equal(card.tokens.cpu(), cpu.tokens)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "kimi-k2-1t-a32b", "jamba-1.5-large-398b",
                                  "nemotron-3-nano-30b-a3b"])
def test_moe_on_card_matches_cpu(arch):
    """The MoE and hybrid smoke models, f32 (TF32 off): one seed gives
    the same parameters on the card as on the CPU, bit for bit (bf16
    too); prefill over 40 tokens + 3 greedy decode steps (one causal
    flash launch per attention layer and one SSD launch per SSM layer in
    the prefill; jamba's hybrid caches placed); logits <= 1e-4 relative,
    the same tokens."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    for c in (cfg, cfg.replace(dtype="bfloat16", param_dtype="bfloat16")):
        cpu_init = dict(_leaves(tfm.init_params(c, seed=0, device="cpu")))
        card_init = dict(_leaves(tfm.init_params(c, seed=0, device="cuda")))
        assert cpu_init.keys() == card_init.keys()
        for name, a in cpu_init.items():          # one seed, one init
            assert torch.equal(a, card_init[name].cpu()), name
    params = tfm.init_params(cfg, seed=0, device="cpu")
    on_card = tfm.init_params(cfg, seed=0, device="cuda")
    tok = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 40)))
    mixers = [m for m, _ in cfg.pattern()] * cfg.num_repeats
    before = (fa_ops.flash_attention.launches, ssd_ops.ssd_scan.launches)
    card = generate(on_card, cfg, {"tokens": tok}, 3, device="cuda")
    assert fa_ops.flash_attention.launches == before[0] + mixers.count("attn")
    assert ssd_ops.ssd_scan.launches == before[1] + mixers.count("ssm")
    cpu = generate(params, cfg, {"tokens": tok}, 3, device="cpu")
    rel = float((card.logits.cpu() - cpu.logits).abs().max()
                / cpu.logits.abs().max())
    assert rel <= 1e-4, rel
    assert torch.equal(card.tokens.cpu(), cpu.tokens)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large"])
def test_frontends_on_card_matches_cpu(arch):
    """The frontend and codebook smoke models, f32 (TF32 off): one seed
    gives the same parameters on the card as on the CPU, bit for bit
    (bf16 too); a prefill of 8 frontend embeddings + 32 tokens (musicgen:
    4 codebooks a token; qwen2-vl: three different position streams) + 3
    greedy decode steps, one causal flash launch per layer in the
    prefill; logits <= 1e-4 relative, the same tokens."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    for c in (cfg, cfg.replace(dtype="bfloat16", param_dtype="bfloat16")):
        cpu_init = dict(_leaves(tfm.init_params(c, seed=0, device="cpu")))
        card_init = dict(_leaves(tfm.init_params(c, seed=0, device="cuda")))
        assert cpu_init.keys() == card_init.keys()
        for name, a in cpu_init.items():          # one seed, one init
            assert torch.equal(a, card_init[name].cpu()), name
    params = tfm.init_params(cfg, seed=0, device="cpu")
    on_card = tfm.init_params(cfg, seed=0, device="cuda")
    S = cfg.frontend_len + 32
    batch = random_batch(cfg, ShapeConfig("p", S, 2, "prefill"), "prefill",
                         seed=0, device="cpu")
    if cfg.mrope_sections:
        gen = torch.Generator().manual_seed(0)
        batch["positions"] = torch.stack([torch.stack([torch.randperm(
            S, generator=gen) for _ in range(2)]) for _ in range(3)])
    before = fa_ops.flash_attention.launches
    card = generate(on_card, cfg, batch, 3, device="cuda")
    assert fa_ops.flash_attention.launches == before + cfg.num_layers
    cpu = generate(params, cfg, batch, 3, device="cpu")
    assert card.tokens.shape == cpu.tokens.shape
    rel = float((card.logits.cpu() - cpu.logits).abs().max()
                / cpu.logits.abs().max())
    assert rel <= 1e-4, rel
    assert torch.equal(card.tokens.cpu(), cpu.tokens)


def _grads_close(got, ref, tol, what):
    for a, b, name in zip(got, ref, "qkv" if len(got) == 3 else
                          ("x", "dt", "B", "C", "A")):
        assert torch.isfinite(a).all(), (what, name)
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        assert rel <= tol, (what, name, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gradient_matches_plain_on_card(dtype):
    """The Function's gradients (the kernel's forward, the backward
    kernels) against autograd through the plain version on the card, at the predictor's three shapes, a causal window with a key
    mask and head dim 112: f32 <= 1e-4 relative norm per input, bf16 <=
    2e-2; one kernel launch per forward, and the forward bitwise the
    no-grad launch's."""
    _need_card()
    tdt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    rng = np.random.RandomState(9)
    for B, Sq, Skv, H, D, causal, window, masked in (
            (64, 16, 16, 4, 32, False, 0, True),
            (2, 360, 360, 4, 32, False, 0, False),
            (2, 360, 128, 4, 32, False, 0, True),
            (2, 100, 130, 2, 32, True, 40, True),
            (1, 64, 64, 2, 112, True, 0, False)):
        q, k, v = (_cuda(rng.randn(B, S, H, D), tdt).requires_grad_(True)
                   for S in (Sq, Skv, Skv))
        g = _cuda(rng.randn(B, Sq, H, D), tdt)
        m = _cuda(rng.rand(B, Skv) > 0.3, torch.float32) if masked else None
        before = fa_ops.flash_attention.launches
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     kv_mask=m)
        assert fa_ops.flash_attention.launches == before + 1
        with torch.no_grad():
            plain_launch = fa_ops.flash_attention(q, k, v, causal=causal,
                                                  window=window, kv_mask=m)
        assert torch.equal(out.detach(), plain_launch)
        got = torch.autograd.grad(out, (q, k, v), g)
        ref = torch.autograd.grad(fa_ops.flash_attention_plain(
            q, k, v, causal=causal, window=window, kv_mask=m), (q, k, v), g)
        _grads_close(got, ref, tol, (B, Sq, Skv, H, D))
        assert got[0].shape == q.shape


def test_flash_backward_kernel_matches_plain_equations_on_card():
    """The f32 backward kernels against ``flash_attention_backward_plain``
    from the same forward output and log-sum-exp, at the kernel cases,
    its edges and the one-tile shapes (Sq, Skv <= 16): <= 1e-4 relative
    norm per input, the same bits twice, a masked key's dk and dv 0, one
    launch counted a call, the Function's backward routed to the kernel
    (``capsim_flash_backward_total{route="kernel"}``)."""
    _need_card()
    from repro_torch.obs import REGISTRY
    cases = FA_CASES + FA_EDGE_CASES + [(6, 16, 16, 4, 32, False, 0, True),
                                        (3, 9, 14, 2, 64, True, 4, True)]
    for case in cases:
        q, k, v, m = (None if x is None else _cuda(x, torch.float32)
                      for x in fa_inputs(case))
        B, Sq, Skv, H, D, causal, window, _ = case
        g = torch.randn_like(q)
        lse = torch.empty(B, H, Sq, device="cuda")
        o = fa_ops._launch(q, k, v, m, causal, window, lse)
        before = fa_ops.flash_attention_bwd.launches
        got = fa_ops.flash_attention_bwd(q, k, v, o, lse, g, m, causal,
                                         window)
        again = fa_ops.flash_attention_bwd(q, k, v, o, lse, g, m, causal,
                                           window)
        assert fa_ops.flash_attention_bwd.launches == before + 2
        assert all(torch.equal(x, y) for x, y in zip(got, again)), case
        ref = fa_ops.flash_attention_backward_plain(q, k, v, o, lse, g, m,
                                                    causal, window)
        _grads_close(got, ref, 1e-4, case)
        if m is not None:
            off = m == 0
            assert bool((got[1][off] == 0).all() and (got[2][off] == 0).all())
    qg = q.clone().requires_grad_(True)

    def routed():
        found = REGISTRY.collect(fa_ops.BACKWARD_TOTAL, route="kernel",
                                 dtype="float32")
        return found[0][1] if found else 0.0
    was = routed()
    torch.autograd.grad(fa_ops.flash_attention(qg, k, v, kv_mask=m), qg, g)
    assert routed() == was + 1


def test_flash_backward_bf16_kernel_matches_plain_equations_on_card():
    """The bf16 backward kernels against ``flash_attention_backward_plain``
    (P and dS rounded to bf16 where the kernels round them) from the same
    forward output and log-sum-exp, at the kernel cases and their edges
    (head dims 16-128, causal, window, a query offset, ``kv_mask``), head
    dim 112 and a causal GQA block at D = 128: <= ``TOL["bfloat16"]``
    relative norm per input, the same bits twice, a masked key's dk and
    dv 0, one launch counted a call; the bf16 forward's O bitwise the
    same with and without the log-sum-exp, which is the plain one's
    within 1e-4 (+inf on a keyless row); the Function's backward routed
    to the kernels (``capsim_flash_backward_total{route="kernel",
    dtype="bfloat16"}``)."""
    _need_card()
    from repro_torch.obs import REGISTRY
    gqa = (2, 512, 512, 4, 128, True, 0, False)   # 2 query heads a KV head
    cases = FA_CASES + FA_EDGE_CASES + [(3, 9, 14, 2, 64, True, 4, True),
                                        (2, 33, 257, 2, 112, True, 50, True),
                                        gqa]
    for case in cases:
        q, k, v, m = (None if x is None else _cuda(x, torch.float32)
                      for x in fa_inputs(case))
        q, k, v = (x.bfloat16() for x in (q, k, v))
        if case == gqa:
            k, v = (x[:, :, ::2].repeat_interleave(2, dim=2) for x in (k, v))
        B, Sq, Skv, H, D, causal, window, _ = case
        g = torch.randn_like(q)
        lse = torch.empty(B, H, Sq, device="cuda")
        o = fa_ops._launch(q, k, v, m, causal, window, lse)
        assert torch.equal(o, fa_ops._launch(q, k, v, m, causal, window))
        _, lse_ref = fa_ops.flash_attention_plain(
            q, k, v, causal=causal, window=window, kv_mask=m,
            return_lse=True)
        keyless = torch.isinf(lse_ref)
        assert bool(torch.isposinf(lse[keyless]).all()), case
        assert float((lse - lse_ref)[~keyless].abs().max()) <= 1e-4, case
        before = fa_ops.flash_attention_bwd.launches
        got = fa_ops.flash_attention_bwd(q, k, v, o, lse, g, m, causal,
                                         window)
        again = fa_ops.flash_attention_bwd(q, k, v, o, lse, g, m, causal,
                                           window)
        assert fa_ops.flash_attention_bwd.launches == before + 2
        assert all(x.dtype == torch.bfloat16 for x in got)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), case
        ref = fa_ops.flash_attention_backward_plain(q, k, v, o, lse, g, m,
                                                    causal, window)
        _grads_close(got, ref, TOL["bfloat16"], case)
        if m is not None:
            off = m == 0
            assert bool((got[1][off] == 0).all() and (got[2][off] == 0).all())
    qg = q.clone().requires_grad_(True)

    def routed():
        found = REGISTRY.collect(fa_ops.BACKWARD_TOTAL, route="kernel",
                                 dtype="bfloat16")
        return found[0][1] if found else 0.0
    was, before = routed(), fa_ops.flash_attention_bwd.launches
    torch.autograd.grad(fa_ops.flash_attention(qg, k, v, causal=True), qg, g)
    assert routed() == was + 1
    assert fa_ops.flash_attention_bwd.launches == before + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_gradient_matches_plain_on_card(dtype):
    """The SSD Function's gradients from both outputs against autograd
    through the plain version on the card, at a ragged last chunk and at
    a decay that overflows an exp taken before the mask: finite, f32 <=
    1e-4 relative norm, bf16 <= 2e-2."""
    _need_card()
    tdt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for case, a_scale in [(c, 1.0) for c in SSD_CASES[:3]] + [
            (SSD_CASES[1], 60.0)]:
        x, dt, B, C, A = ssd_inputs(case, a_scale=a_scale)
        ins = [_cuda(x, tdt), _cuda(dt, torch.float32), _cuda(B, tdt),
               _cuda(C, tdt), _cuda(A, torch.float32)]
        ins = [t.requires_grad_(True) for t in ins]
        chunk = case[5]
        before = ssd_ops.ssd_scan.launches
        y, st = ssd_ops.ssd_scan(*ins, chunk)
        assert ssd_ops.ssd_scan.launches == before + 1
        gy = torch.randn_like(y)
        gs = torch.randn_like(st)
        got = torch.autograd.grad((y, st), ins, (gy, gs))
        ref = torch.autograd.grad(ssd_ops.ssd_scan_plain(*ins, chunk),
                                  ins, (gy, gs))
        _grads_close(got, ref, tol, case)


def test_capsim_train_step_on_card_matches_cpu():
    """One SGD-momentum train step of the CAPSim predictor (mape_loss on
    the monolithic forward, the paper's recipe) at full width in f32, on
    the card against the CPU from the same parameters and batch: every
    parameter <= 1e-4 relative, every leaf's gradient nonzero on the card
    (gradients come back through the flash kernel's Function), one flash
    launch per attention of the forward, twice a step under the full
    config's remat."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.training import train_loop as ttl
    cfg = config().replace(dtype="float32")
    rng = np.random.RandomState(0)
    B, L, T, M = 4, 128, cfg.clip_tokens, cfg.context_tokens
    tok = rng.randint(1, cfg.vocab_size, (B, L, T))
    tok[np.arange(T) >= rng.randint(2, T + 1, (B, L))[..., None]] = 0
    batch = {"clip_tokens": torch.from_numpy(tok),
             "context_tokens": torch.from_numpy(
                 rng.randint(1, cfg.vocab_size, (B, M))),
             "clip_mask": torch.ones(B, L),
             "time": torch.from_numpy(rng.uniform(50, 500, B).astype(
                 np.float32))}
    tcfg = ttl.TrainConfig(optimizer="sgdm", base_lr=1e-3)
    step = ttl.make_train_step(
        lambda p, b: predictor.mape_loss(p, b, cfg), tcfg)
    params = predictor.init_params(cfg, seed=0, device="cpu")
    card_params = _to_card(params)
    (_, _), grads = ttl.value_and_grad(
        lambda p, b: predictor.mape_loss(p, b, cfg), card_params,
        _to_card(batch))
    for name, g in _leaves(grads):
        assert torch.isfinite(g).all() and bool((g != 0).any()), name
    before = fa_ops.flash_attention.launches
    card, _ = step(ttl.init_train_state(card_params, tcfg), _to_card(batch))
    # the forward runs again in the backward under the config's remat
    assert fa_ops.flash_attention.launches == before + (4 + 4 * 2) * (
        2 if cfg.remat else 1)
    cpu, _ = step(ttl.init_train_state(params, tcfg), batch)
    cpu_leaves = dict(_leaves(cpu["params"]))
    for name, a in _leaves(card["params"]):
        b = cpu_leaves[name]
        rel = float((a.cpu() - b).abs().max() / b.abs().max().clamp(
            min=1e-30))
        assert rel <= 1e-4, (name, rel)


def _to_card(tree):
    return {k: _to_card(v) if isinstance(v, dict) else v.to("cuda")
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_lm_train_step_on_card_matches_cpu(arch):
    """One AdamW train step of the smoke model, f32, on the card against
    the CPU: the loss <= 1e-5 relative, every gradient leaf finite and
    <= 1e-4 relative norm (through causal flash or the SSD scan)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.training import train_loop as ttl
    cfg = get_smoke_config(arch)
    params = tfm.init_params(cfg, seed=0, device="cpu")
    batch = random_batch(cfg, ShapeConfig("t", 64, 2, "train"), "train",
                         seed=0, device="cpu")

    def loss(p, b):
        return tfm.loss_fn(p, b, cfg)
    (l_cpu, _), g_cpu = ttl.value_and_grad(loss, params, batch)
    (l_card, _), g_card = ttl.value_and_grad(loss, _to_card(params),
                                             _to_card(batch))
    assert abs(float(l_card) - float(l_cpu)) <= 1e-5 * abs(float(l_cpu))
    cpu_leaves = dict(_leaves(g_cpu))
    for name, g in _leaves(g_card):
        ref = cpu_leaves[name]
        assert torch.isfinite(g).all(), name
        rel = float((g.cpu() - ref).norm() / ref.norm().clamp(min=1e-30))
        assert rel <= 1e-4, (name, rel)


def test_weighted_attention_refuses_a_gradient_on_card():
    """Nothing trains through the fused serving step: on the card the
    weighted kernel raises when an input requires grad (it would return
    an output cut off from autograd); under no_grad it launches."""
    _need_card()
    rng = np.random.RandomState(1)
    q, k, v = (_cuda(rng.randn(2, 16, 4, 32), torch.float32)
               for _ in range(3))
    w = _cuda(rng.rand(2, 16), torch.float32)
    with pytest.raises(RuntimeError, match="no gradient"):
        wa_ops.weighted_attention(q.requires_grad_(True), k, v, w)
    with torch.no_grad():
        out = wa_ops.weighted_attention(q, k, v, w)
    assert out.shape == q.shape


# ---- the LM zoo's multi-device shard bodies, n shards on the one card ---- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_shards_on_card_match_the_full_causal_rows(dtype):
    """Each sequence-parallel shard: the flash kernel at Sq = S/n and Skv
    = (m+1)·S/n against its plain version and against the full causal
    output's rows."""
    from repro_torch.models import attention as att
    _need_card()
    tdt, tol = getattr(torch, dtype), TOL[dtype]
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(2, 256, 8, 64, generator=g, device="cuda", dtype=tdt)
    k, v = (torch.randn(2, 256, 2, 64, generator=g, device="cuda",
                        dtype=tdt) for _ in range(2))
    full = att.causal_attention(q, k, v).float()
    for n in (2, 4):
        s_loc = 256 // n
        for m, o in enumerate(att.sp_shards(q, k, v, n)):
            rows = slice(m * s_loc, (m + 1) * s_loc)
            kv = (m + 1) * s_loc
            plain = fa_ops.flash_attention_plain(
                q[:, rows], k[:, :kv].repeat_interleave(4, 2),
                v[:, :kv].repeat_interleave(4, 2), causal=True)
            assert (o.float() - plain.float()).abs().max().item() <= tol
            assert (o.float() - full[:, rows]).abs().max().item() <= tol


def test_decode_and_moe_shards_on_card_match_unsharded():
    """Flash-decoding merged over 2, 4 and 8 shards against
    ``decode_attention``, and the expert-parallel MoE over 2 and 4 model
    shards against the meshless layer, in f32 on the card."""
    from repro_torch.models import attention as att
    from repro_torch.models import moe as moe_mod
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(4, 1, 8, 64, generator=g, device="cuda")
    kc, vc = (torch.randn(4, 64, 2, 64, generator=g, device="cuda")
              for _ in range(2))
    want = att.decode_attention(q, kc, vc, 37)
    for n in (2, 4, 8):
        got = att.flash_decode_shards(q, kc, vc, 37, n)
        assert (got - want).abs().max().item() <= 1e-5
    cfg = get_smoke_config("llama4-maverick-400b-a17b").replace(
        num_experts=8, capacity_factor=8.0)
    params = tfm.init_params(cfg, seed=2, device="cuda")["blocks"]["i1"][
        "ffn"]
    params = {k: v[0] for k, v in params.items()}
    x = torch.randn(2, 16, cfg.d_model, generator=g, device="cuda")
    y0, _, _ = moe_mod.moe_forward(params, x, cfg)
    for n in (2, 4):
        parts = moe_mod.moe_shards(params, x, cfg, n)
        y = sum(p.y for p in parts).reshape(x.shape)
        assert all(torch.equal(p.routing.idx, parts[0].routing.idx)
                   for p in parts)
        assert (y - y0).abs().max().item() <= 1e-5 * y0.abs().max().item()
