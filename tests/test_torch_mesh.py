"""The port's data mesh (``EngineConfig.mesh_shape``, ``launch/mesh.py``,
``predictor.sharded_*``) on the CPU: the cases of
``tests/test_mesh_engine.py`` and the RT store's mesh case of
``tests/test_rt_store.py``.

Rows are independent of each other, so a sharded engine computes each
row as the unsharded one does: on the CPU the mesh is held to the
unsharded port **bitwise** (single-core unfused, fused, monolithic and
bf16, the RT table's bytes, multicore per core, a pool smaller than the
mesh, the sampled engine, a mesh of 3).  torch does not lock the device
count as jax does, so the 8-shard program the reference runs in a
subprocess runs here in process, its n shards sharing the one CPU.  The
port's mesh engine is held to the JAX engine at mesh (1,) at the
tolerance of ``test_torch_engine.py::test_engine_matches_jax_engine``.
"""
import json
import sys

import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import predictor as jp  # noqa: E402
from repro.core import standardize as jstd  # noqa: E402
from repro.core.engine import SimulationEngine as JaxEngine  # noqa: E402
from repro.core.engine import bucket_sizes as jax_bucket_sizes  # noqa: E402
from repro.core.engine_config import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.core.rt_cache import encode_bucket as jax_encode_bucket  # noqa: E402
from repro_torch.configs.capsim import config  # noqa: E402
from repro_torch.core import predictor as tp  # noqa: E402
from repro_torch.core.engine import (BatchedPredictor,  # noqa: E402
                                     SimulationEngine, bucket_sizes)
from repro_torch.core.engine_config import (EngineConfig,  # noqa: E402
                                            SamplingConfig)
from repro_torch.core.rt_cache import RTCache, encode_bucket  # noqa: E402
from repro_torch.core.standardize import build_vocab  # noqa: E402
from repro_torch.isa import multicore, progen  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import (FaultInjector, PredictorEngine,  # noqa: E402
                                 Request, ServiceSLA, SimulationService)

VOCAB = build_vocab()
# test_torch_engine.py's widths: head_dim 16, a width the kernels take
JCFG = get_config("capsim").replace(d_model=32, num_heads=2, num_kv_heads=2,
                                    head_dim=16, d_ff=64, dtype="float32")
TCFG = config().replace(d_model=32, num_heads=2, head_dim=16, d_ff=64,
                        dtype="float32")
# the reference mesh tests' engine config: buckets (16, 8), all 8-aligned
EC = EngineConfig(interval_size=1_000, warmup=100, max_checkpoints=1,
                  batch_size=16)
MIX = ["505.mcf", "541.leela"]


@pytest.fixture(scope="module")
def jparams():
    return jp.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return tp.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _run(params, config, names=MIX, **kw):
    eng = SimulationEngine(params, TCFG, VOCAB, config, device="cpu", **kw)
    eng.submit_names(names)
    return eng.run(), eng


def _table(eng):
    cache = eng._rt_cache
    return cache.table[:cache.n_rows]


def _clips(n, seed=0):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, VOCAB.size, (n, 128, TCFG.clip_tokens)
                      ).astype(np.int32)
    ctx = rng.randint(0, VOCAB.size, (n, TCFG.context_tokens)
                      ).astype(np.int32)
    return tok, ctx, np.ones((n, 128), np.float32)


def _same(a_results, b_results):
    for a, b in zip(a_results, b_results, strict=True):
        assert (a.name, a.n_clips) == (b.name, b.n_clips)
        assert a.predicted_cycles == b.predicted_cycles, a.name   # bitwise
        assert a.oracle_cycles == b.oracle_cycles, a.name


# ------------------------------ pure math ------------------------------ #

@pytest.mark.parametrize("batch", [8, 16, 24, 32, 48, 64, 96, 256])
def test_bucket_sizes_match_the_reference(batch):
    """The reference's tuples wherever its floor ``max(8, n)`` divides by
    n; for a mesh of 3 or 6 its smallest bucket (8) does not, which its
    own dispatch contract refuses, and the port's floor is the least
    multiple of n >= 8 instead."""
    for n in (1, 2, 3, 4, 6, 8):
        if batch % n:
            continue
        ours, ref = bucket_sizes(batch, n), jax_bucket_sizes(batch, n)
        assert ours[0] == batch
        assert all(s % n == 0 for s in ours), (batch, n, ours)
        assert all(a > b for a, b in zip(ours, ours[1:]))
        assert ours[-1] >= 8 or ours == (batch,)
        if all(s % n == 0 for s in ref):
            assert ours == ref, (batch, n)
        else:
            floor = -(-8 // n) * n
            assert n in (3, 6) and ref[-1] == 8
            assert ours == tuple(s for s in ref if s > floor) + (floor,)
    assert bucket_sizes(batch) == jax_bucket_sizes(batch)


@pytest.mark.parametrize("align", [1, 32, 64, 96, 128, 256])
def test_encode_bucket_matches_the_reference(align):
    for rows in (1, 5, 9, 31, 32, 33, 100, 300, 1000, 4097):
        got = encode_bucket(rows, align)
        assert got == jax_encode_bucket(rows, align), (rows, align)
        assert got >= rows and got % max(align, 1) == 0
    assert encode_bucket(5, 8 * 32) == 256        # 32 rows a shard at 8
    assert encode_bucket(9, 3 * 32) == 96


def test_make_data_mesh_refuses_what_it_cannot_place(monkeypatch):
    with pytest.raises(ValueError, match="n_shards"):
        mesh_mod.make_data_mesh(0, "cpu")
    mesh = mesh_mod.make_data_mesh(3, "cpu")
    assert mesh.n_shards == 3 and mesh.streams == (None,) * 3
    assert mesh_mod.mesh_axis_sizes(mesh) == {"data": 3}
    assert mesh_mod.num_chips(mesh) == 1
    # on cuda, n shards are n cards: more than are visible raises, with
    # both numbers
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"mesh of 2 devices.*only 1"):
        mesh_mod.make_data_mesh(2, "cuda")
    with pytest.raises(ValueError, match=r"mesh of 2 devices.*only 1"):
        SimulationEngine(tp.init_params(TCFG, 0, "cpu"), TCFG, VOCAB,
                         EngineConfig(mesh_shape=(2,)), device="cuda")
    with pytest.raises(ValueError, match="mesh of 3 shards passed"):
        mesh_mod.resolve_mesh(2, "cpu", mesh)


# ------------------------------ mesh (1,) ------------------------------ #

@pytest.mark.parametrize("kw", [dict(), dict(fused_serving=True),
                                dict(rt_cache=False)],
                         ids=["rt", "fused", "monolithic"])
def test_mesh1_engine_bitwise_equal(params, kw):
    """A (1,) mesh still dispatches through the sharded path, bitwise the
    unsharded engine."""
    r0, e0 = _run(params, EC.replace(**kw))
    r1, e1 = _run(params, EC.replace(mesh_shape=(1,), **kw))
    _same(r0, r1)
    assert e1.mesh.n_shards == 1 and e0.mesh is None


def test_mesh1_rt_table_byte_identical(params):
    rows = progen.build_benchmark("519.lbm").compiled().token_table(VOCAB, 16)
    c0 = RTCache(params, TCFG, 16, device="cpu")
    c1 = RTCache(params, TCFG, 16, device="cpu", n_shards=1)
    np.testing.assert_array_equal(c0.ensure_rows(rows), c1.ensure_rows(rows))
    assert c0.table[:c0.n_rows].numpy().tobytes() == \
        c1.table[:c1.n_rows].numpy().tobytes()


def test_mesh1_pool_smaller_than_bucket(params):
    tok, ctx, mask = _clips(3)
    ref = BatchedPredictor(params, TCFG, config=EC.replace(rt_cache=False),
                           device="cpu")
    ref.add(tok, ctx, mask)
    bp = BatchedPredictor(params, TCFG,
                          config=EC.replace(mesh_shape=(1,), rt_cache=False),
                          device="cpu")
    bp.add(tok, ctx, mask)
    preds = bp.drain()
    assert preds.shape == (3,) and bp.stats.n_pad == 5     # bucket floor 8
    np.testing.assert_array_equal(preds, ref.drain())


# ------------------------------ mesh (8,) ------------------------------ #

@pytest.mark.parametrize("kw", [dict(), dict(fused_serving=True),
                                dict(rt_cache=False),
                                dict(precision="bf16")],
                         ids=["rt", "fused", "monolithic", "bf16"])
def test_mesh8_single_core_bitwise(params, kw):
    """8 shards, batch 16 (2 rows a shard, the last bucket padded): the
    predictions, and the RT table built by sharded encode passes, are
    the unsharded engine's bits; the fused step's dedupe over the whole
    batch gives every shard the batch's U."""
    r0, e0 = _run(params, EC.replace(**kw))
    r8, e8 = _run(params, EC.replace(mesh_shape=(8,), **kw))
    _same(r0, r8)
    assert e8.last_stats.n_batches == e0.last_stats.n_batches
    if e0._rt_cache is not None:
        assert e8._rt_cache.n_rows == e0._rt_cache.n_rows
        assert torch.equal(_table(e8), _table(e0))
        assert _table(e8).view(torch.uint8).numpy().tobytes() == \
            _table(e0).view(torch.uint8).numpy().tobytes()


def test_fused_mesh_dedupes_the_whole_batch_before_the_split(params,
                                                             monkeypatch):
    """The fused step dedupes each dispatch's whole padded batch once, and
    every shard attends over that batch's U (per-shard dedupes would
    give each shard its own U, and on the card its own GEMM shapes)."""
    from repro_torch.core import engine as engine_mod
    seen = {"dedupe": [], "shard_u": []}
    dedupe = engine_mod.std_mod.dedupe_context_tokens
    fused = tp.forward_cached_fused

    def recording_dedupe(ctx):
        uniq, counts = dedupe(ctx)
        seen["dedupe"].append((ctx.shape[0], uniq.shape[1]))
        return uniq, counts

    def recording_fused(p, plan, batch, cfg):
        seen["shard_u"].append((batch["rt_idx"].shape[0],
                                batch["ctx_uniq"].shape[1]))
        return fused(p, plan, batch, cfg)
    monkeypatch.setattr(engine_mod.std_mod, "dedupe_context_tokens",
                        recording_dedupe)
    monkeypatch.setattr(tp, "forward_cached_fused", recording_fused)
    _run(params, EC.replace(mesh_shape=(8,), fused_serving=True))
    assert seen["dedupe"] and len(seen["shard_u"]) == 8 * len(seen["dedupe"])
    for k, (rows, u) in enumerate(seen["dedupe"]):
        assert rows in (16, 8)                     # a whole bucket
        shards = seen["shard_u"][8 * k:8 * (k + 1)]
        assert shards == [(rows // 8, u)] * 8


def test_mesh8_multicore_demux_bitwise(params):
    mbenches = [multicore.build_multicore_benchmark(n, 2)
                for n in multicore.MULTICORE_NAMES]
    m0 = SimulationEngine(params, TCFG, VOCAB, EC,
                          device="cpu").run_multicore(mbenches)
    m8 = SimulationEngine(params, TCFG, VOCAB, EC.replace(mesh_shape=(8,)),
                          device="cpu").run_multicore(mbenches)
    for a, b in zip(m0, m8, strict=True):
        assert a.predicted_cycles == b.predicted_cycles, a.name
        assert a.oracle_cycles == b.oracle_cycles, a.name
        _same(a.cores, b.cores)


def test_mesh8_pool_of_3_pads_a_full_set_of_shards(params):
    tok, ctx, mask = _clips(3)
    bp8 = BatchedPredictor(params, TCFG,
                           config=EC.replace(mesh_shape=(8,), rt_cache=False),
                           device="cpu")
    bp8.add(tok, ctx, mask)
    p8 = bp8.drain()
    assert p8.shape == (3,) and bp8.stats.n_pad == 5
    bp0 = BatchedPredictor(params, TCFG, config=EC.replace(rt_cache=False),
                           device="cpu")
    bp0.add(tok, ctx, mask)
    np.testing.assert_array_equal(p8, bp0.drain())


def test_mesh8_sampled_engine_bitwise(params):
    cfg = EC.replace(max_checkpoints=2,
                     sampling=SamplingConfig(fraction=0.5, strata=2))
    r0, _ = _run(params, cfg)
    r8, _ = _run(params, cfg.replace(mesh_shape=(8,)))
    _same(r0, r8)
    for a, b in zip(r0, r8):
        assert a.cycles_ci == b.cycles_ci
        assert a.clips_predicted == b.clips_predicted < a.n_clips
        np.testing.assert_array_equal(a.clip_provenance, b.clip_provenance)


def test_mesh3_batch24_and_a_pool_of_5(params):
    """A mesh that does not divide 8: batch 24, buckets (24, 12, 9)."""
    cfg = EC.replace(batch_size=24)
    r0, _ = _run(params, cfg)
    r3, e3 = _run(params, cfg.replace(mesh_shape=(3,)))
    _same(r0, r3)
    assert e3.mesh.n_shards == 3
    tok, ctx, mask = _clips(5, seed=1)
    bp3 = BatchedPredictor(params, TCFG,
                           config=cfg.replace(mesh_shape=(3,)), device="cpu",
                           rt_cache=None)
    assert bp3.buckets == (24, 12, 9)
    bp0 = BatchedPredictor(params, TCFG, config=cfg.replace(rt_cache=False),
                           device="cpu")
    for bp in (bp3, bp0):
        bp.add(tok, ctx, mask)
    np.testing.assert_array_equal(bp3.drain(), bp0.drain())
    assert bp3.stats.n_pad == 4


def test_sharded_dispatch_refuses_a_ragged_split(params):
    mesh = mesh_mod.make_data_mesh(3, "cpu")
    tok, ctx, mask = _clips(4)
    batch = {"clip_tokens": torch.as_tensor(tok),
             "context_tokens": torch.as_tensor(ctx),
             "clip_mask": torch.as_tensor(mask)}
    with pytest.raises(ValueError, match="4 rows do not split into 3"):
        tp.sharded_predict_step(mesh.replicate(params), batch, TCFG, True,
                                mesh)
    with pytest.raises(ValueError, match="batch_size 7 must divide"):
        EngineConfig(mesh_shape=(2,), batch_size=7)


@pytest.mark.parametrize("fused,tol", [(False, 1e-4), (True, 1e-3)],
                         ids=["rt", "fused"])
def test_mesh8_matches_jax_engine_at_mesh1(jparams, params, fused, tol):
    """The port's 8-shard engine against the JAX engine on its 1-device
    mesh, in process (the reference's 8-device run fails on the
    reference itself), at ``test_engine_matches_jax_engine``'s
    tolerance."""
    jv = jstd.build_vocab()
    jeng = JaxEngine(jparams, JCFG, jv, JaxEngineConfig(
        interval_size=1_000, warmup=100, max_checkpoints=1, batch_size=16,
        fused_serving=fused, mesh_shape=(1,)))
    jeng.submit_names(MIX)
    ref = jeng.run()
    ours, _ = _run(params, EC.replace(mesh_shape=(8,), fused_serving=fused))
    for a, b in zip(ref, ours, strict=True):
        assert (a.name, a.n_clips) == (b.name, b.n_clips)
        assert a.oracle_cycles == b.oracle_cycles
        assert abs(b.predicted_cycles - a.predicted_cycles) \
            / abs(a.predicted_cycles) < tol, a.name


# ----------------------------- the RT store ----------------------------- #

@pytest.mark.parametrize("write,read", [(8, 0), (0, 8)],
                         ids=["sharded-to-unsharded", "unsharded-to-sharded"])
def test_store_composes_with_the_mesh(params, tmp_path, write, read):
    """The store key names no mesh: a table a mesh encoded loads into an
    unsharded cache with no encode pass, and the other way round, byte
    for byte (the reference's ``test_store_composes_with_mesh_sharded
    _encode``)."""
    table = progen.build_benchmark("505.mcf").compiled().token_table(
        VOCAB, 16)

    def cache(n):
        return RTCache(params, TCFG, 16, device="cpu", n_shards=n,
                       store_dir=str(tmp_path),
                       store_extra=VOCAB.signature())
    first = cache(write)
    first.ensure_rows(table)
    assert first.stats.n_encode_passes == 1
    first.persist()
    second = cache(read)
    assert second.stats.n_rows_loaded == first.n_rows
    second.ensure_rows(table)
    assert second.stats.n_rows_encoded == 0
    assert second.stats.n_encode_passes == 0
    assert first.table[:first.n_rows].numpy().tobytes() == \
        second.table[:second.n_rows].numpy().tobytes()
    assert cache(0).stats.n_rows_loaded == first.n_rows


# ------------------------------- serving -------------------------------- #

def _req(i, n):
    tok, ctx, mask = _clips(n, seed=i)
    return Request(i, tok, ctx, mask)


@pytest.mark.parametrize("kw", [dict(), dict(fused_serving=True),
                                dict(rt_cache=False)],
                         ids=["rt", "fused", "monolithic"])
def test_predictor_engine_mesh4_bitwise(params, kw):
    cfg = EngineConfig(batch_size=8, **kw)
    out = {}
    for mesh_shape in ((), (4,)):
        eng = PredictorEngine(params, TCFG, cfg.replace(mesh_shape=mesh_shape),
                              device="cpu")
        for i, n in ((0, 4), (1, 7), (2, 2)):
            eng.submit(_req(i, n))
        out[mesh_shape] = [(r.request_id, r.n_clips, r.total_cycles)
                           for r in eng.flush()]
        if mesh_shape:
            assert eng.backend()._mesh is eng.mesh
    assert out[()] == out[(4,)]


def _service(params, config, **kw):
    return SimulationService(params, TCFG, config,
                             sla=ServiceSLA(watchdog_s=120.0,
                                            promote_after=1, **kw.pop(
                                                "sla", {})),
                             device="cpu", **kw)


def test_service_mesh4_typed_results_bitwise(params):
    """Every rung and its RT cache run on the service's one mesh; the
    auditor stays unsharded.  Requests one at a time: each typed result
    is the unsharded service's, bit for bit."""
    out = {}
    for mesh_shape in ((), (4,)):
        svc = _service(params, EngineConfig(batch_size=8,
                                            mesh_shape=mesh_shape))
        with svc:
            out[mesh_shape] = [svc.submit(_req(i, n)).result(timeout=300)
                               for i, n in ((0, 4), (1, 6), (2, 3))]
        if mesh_shape:
            assert all(t.mesh is svc.mesh for t in svc._tiers)
            assert all(t.cache._mesh is svc.mesh for t in svc._tiers
                       if t.cache is not None)
            assert svc._reference.mesh is None
            assert svc._reference.config.mesh_shape == ()
    for a, b in zip(out[()], out[(4,)], strict=True):
        assert a.status == b.status == "ok" and a.tier == b.tier
        assert a.total_cycles == b.total_cycles


def test_service_mesh4_chaos_stays_typed_and_gated(params):
    inj = FaultInjector({"nan_output": 0.6}, seed=3)
    svc = _service(params, EngineConfig(batch_size=8, mesh_shape=(4,)),
                   sla={"check_every": 0}, fault_injector=inj)
    with svc:
        results = [svc.submit(_req(i, 2)).result(timeout=600)
                   for i in range(6)]
    assert any(r.status == "degraded" for r in results)
    ref = PredictorEngine(params, TCFG, EngineConfig(batch_size=8,
                                                     rt_cache=False),
                          device="cpu")
    for i, r in enumerate(results):
        assert r.status in ("ok", "degraded", "failed")
        if not r.ok:
            continue
        ref.submit(_req(i, 2))
        want = ref.flush()[0].total_cycles
        tol = 0.05 if r.tier == "fused_int8" else 1e-3
        assert abs(r.total_cycles - want) / abs(want) <= tol


# ------------------------------- launcher -------------------------------- #

def _serve(monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    tserve.main()


def test_serve_mesh_on_the_cpu(capsys, monkeypatch, tmp_path):
    small = ["--device", "cpu", "--n-benchmarks", "2", "--interval-size",
             "2000", "--batch-size", "32"]
    _serve(monkeypatch, *small)
    plain = capsys.readouterr().out
    _serve(monkeypatch, *small, "--mesh", "2")
    sharded = capsys.readouterr().out
    assert "over a 2-shard mesh on cpu" in sharded
    # the per-benchmark lines are the unsharded run's
    assert [ln for ln in sharded.splitlines() if "predicted=" in ln] == \
        [ln for ln in plain.splitlines() if "predicted=" in ln]
    spec = tmp_path / "engine.json"
    spec.write_text(json.dumps({"mesh_shape": [2], "fused_serving": True}))
    for text in (str(spec), spec.read_text()):
        _serve(monkeypatch, *small, "--engine-config", text)
        assert "over a 2-shard mesh on cpu" in capsys.readouterr().out
    _serve(monkeypatch, *small, "--mesh", "2", "--multicore", "2")
    assert "over a 2-shard mesh" in capsys.readouterr().out


def test_serve_mesh_refusals(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _serve(monkeypatch, "--mesh", "2", "--n-benchmarks", "1")
    with pytest.raises(SystemExit):
        _serve(monkeypatch, "--arch", "qwen3-4b", "--device", "cpu",
               "--mesh", "2")
