"""The port's host front-end and ``SimulationEngine`` against the JAX
reference on the CPU: the copied front-end is bitwise the reference's,
and engine predictions match per benchmark within tolerance."""
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import context as jctx  # noqa: E402
from repro.core import predictor as jp  # noqa: E402
from repro.core import standardize as jstd  # noqa: E402
from repro.core.engine import SimulationEngine as JaxEngine  # noqa: E402
from repro.core.engine_config import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.isa import funcsim as jfuncsim  # noqa: E402
from repro.isa import progen as jprogen  # noqa: E402
from repro.isa import timing as jtiming  # noqa: E402
from repro_torch.configs.capsim import config  # noqa: E402
from repro_torch.core import context as tctx  # noqa: E402
from repro_torch.core import predictor as tp  # noqa: E402
from repro_torch.core import standardize as tstd  # noqa: E402
from repro_torch.core.engine import BatchedPredictor, SimulationEngine  # noqa: E402
from repro_torch.core.engine_config import EngineConfig  # noqa: E402
from repro_torch.core.rt_cache import PAD_ROW_ID, RTCache  # noqa: E402
from repro_torch.core.simulate import capsim_simulate  # noqa: E402
from repro_torch.isa import funcsim as tfuncsim  # noqa: E402
from repro_torch.isa import progen as tprogen  # noqa: E402
from repro_torch.isa import timing as ttiming  # noqa: E402

JV, TV = jstd.build_vocab(), tstd.build_vocab()
# head_dim 16: a width the CUDA kernels are built for
JCFG = get_config("capsim").replace(d_model=32, num_heads=2, num_kv_heads=2,
                                    head_dim=16, d_ff=64, dtype="float32")
TCFG = config().replace(d_model=32, num_heads=2, head_dim=16, d_ff=64,
                        dtype="float32")
MIX = ["503.bwaves", "541.leela"]
SIM = dict(interval_size=2_000, warmup=200, max_checkpoints=2, l_min=32,
           l_clip=32, l_token=16, batch_size=16)


@pytest.fixture(scope="module")
def jparams():
    return jp.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return tp.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("name", MIX)
def test_front_end_is_bitwise_the_reference(name):
    assert JV.id_to_token == TV.id_to_token
    jb, tb = jprogen.build_benchmark(name), tprogen.build_benchmark(name)
    jc, tc = jb.compiled(), tb.compiled()
    np.testing.assert_array_equal(jc.token_table(JV, 16),
                                  tc.token_table(TV, 16))
    assert jc.token_row_keys(JV, 16) == tc.token_row_keys(TV, 16)
    _, jst = jfuncsim.run_compiled(jc, 200, jprogen.fresh_compiled_state(jb))
    _, tst = tfuncsim.run_compiled(tc, 200, tprogen.fresh_compiled_state(tb))
    for _ in range(2):
        jt, jst = jfuncsim.run_compiled(jc, 2_000, jst, snapshot_every=32)
        tt, tst = tfuncsim.run_compiled(tc, 2_000, tst, snapshot_every=32)
        for col in ("pc", "ea", "taken", "snapshots"):
            np.testing.assert_array_equal(getattr(jt, col), getattr(tt, col))
        jctx_m = jctx.context_tokens_from_matrix(jt.snapshots, JV)
        np.testing.assert_array_equal(
            jctx_m, tctx.context_tokens_from_matrix(tt.snapshots, TV))
        assert jtiming.total_cycles_columnar(jt, jtiming.TimingParams()) \
            == ttiming.total_cycles_columnar(tt, ttiming.TimingParams())
        ids = np.arange(jc.token_table(JV, 16).shape[0], dtype=np.int32)
        for a, b in zip(jstd.fixed_clip_indices(ids, jt.pc, 32, 32),
                        tstd.fixed_clip_indices(ids, tt.pc, 32, 32)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jstd.dedupe_context_tokens(jctx_m),
                        tstd.dedupe_context_tokens(jctx_m)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_runs(jparams):
    runs = {}
    for precision in ("fp32", "int8", "bf16"):
        eng = JaxEngine(jparams, JCFG, JV,
                        JaxEngineConfig(precision=precision, **SIM))
        eng.submit_names(MIX)
        runs[precision] = eng.run()
    return runs


@pytest.mark.parametrize("precision,fused,rt_cache,tol", [
    ("fp32", False, True, 1e-4), ("fp32", True, True, 1e-3),
    ("fp32", False, False, 1e-4),            # monolithic: no RT cache
    ("int8", False, True, 1e-4), ("bf16", False, True, 2e-2)])
def test_engine_matches_jax_engine(params, jax_runs, precision, fused,
                                   rt_cache, tol):
    eng = SimulationEngine(params, TCFG, TV,
                           EngineConfig(precision=precision,
                                        fused_serving=fused,
                                        rt_cache=rt_cache, **SIM),
                           device="cpu")
    eng.submit_names(MIX)
    res = eng.run()
    for a, b in zip(jax_runs[precision], res):
        assert (a.name, a.n_clips, a.n_instructions, a.n_intervals) == \
            (b.name, b.n_clips, b.n_instructions, b.n_intervals)
        assert a.oracle_cycles == b.oracle_cycles          # bitwise
        assert np.isfinite(b.predicted_cycles)
        assert _rel(b.predicted_cycles, a.predicted_cycles) < tol, \
            (a.name, precision, fused)
    st = eng.last_stats
    assert st.n_clips == st.n_predicted == sum(r.n_clips for r in res)
    assert (eng.last_rt_stats is not None) == rt_cache


def test_fused_matches_unfused_and_single_benchmark_wrapper(params):
    runs = {}
    for fused in (False, True):
        eng = SimulationEngine.from_config(
            params, TCFG, TV, EngineConfig(fused_serving=fused, **SIM),
            device="cpu")
        eng.submit_names(MIX)
        runs[fused] = eng.run()
    for a, b in zip(runs[False], runs[True]):
        assert _rel(b.predicted_cycles, a.predicted_cycles) < 1e-3
    solo = capsim_simulate(tprogen.build_benchmark(MIX[1]), params, TCFG,
                           TV, EngineConfig(**SIM), device="cpu")
    assert solo.n_clips == runs[False][1].n_clips
    assert _rel(solo.predicted_cycles, runs[False][1].predicted_cycles) \
        < 1e-5


def test_fused_plan_follows_in_place_table_growth(params):
    """The RT table is written in place, so its identity survives growth:
    the fused step's plan must key on the cache's version, or a batch
    gathering freshly encoded rows would see a stale (zero) plan."""
    cprog = tprogen.build_benchmark("505.mcf").compiled()
    table = cprog.token_table(TV, 16)
    cfg = tp.inference_config(TCFG, None)
    cache = RTCache(params, cfg, 16, device="cpu")
    ids_a = cache.ensure_rows(table[:8])
    pred = BatchedPredictor(
        params, cfg, config=EngineConfig(fused_serving=True, batch_size=8,
                                         max_in_flight=8),
        rt_cache=cache, device="cpu")
    rng = np.random.default_rng(0)
    ctx = rng.integers(1, 60, (16, 360)).astype(np.int32)
    mask = np.ones((16, 32), np.float32)
    idx_a = ids_a[rng.integers(0, 8, (8, 32))].astype(np.int32)
    pred.add_indexed(idx_a, ctx[:8], mask[:8])         # dispatches
    tensor_before, version_before = cache.table, cache.version

    ids_b = cache.ensure_rows(table[8:])               # in-place growth
    assert cache.table is tensor_before
    assert cache.version > version_before
    new = np.setdiff1d(ids_b, ids_a)
    assert new.size and (new > ids_a.max()).all()
    idx_b = new[rng.integers(0, new.size, (8, 32))].astype(np.int32)
    pred.add_indexed(idx_b, ctx[8:], mask[8:])
    out = pred.drain()

    ref = tp.forward_cached(
        params, cache.table,
        {"rt_idx": torch.from_numpy(np.concatenate([idx_a, idx_b])),
         "context_tokens": torch.from_numpy(ctx),
         "clip_mask": torch.from_numpy(mask)}, cfg).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-3)


def test_rt_cache_pad_row_growth_and_index_clips(params):
    cache = RTCache(params, TCFG, 16, capacity=4, device="cpu")
    rng = np.random.default_rng(1)
    rows = rng.integers(1, 300, (6, 16)).astype(np.int32)
    ids = cache.ensure_rows(rows)
    assert ids.tolist() == [1, 2, 3, 4, 5, 6]
    assert cache.n_rows == 7 and cache.table.shape[0] == 8   # doubled
    assert not cache.table[PAD_ROW_ID].isnan().any()
    np.testing.assert_allclose(
        cache.table[1:7].numpy(),
        tp.encode_instructions(params, torch.from_numpy(rows), TCFG).numpy(),
        rtol=1e-5, atol=1e-6)
    clips = np.zeros((2, 3, 16), np.int32)
    clips[0, 0], clips[1, 2] = rows[2], rows[5]
    np.testing.assert_array_equal(cache.index_clips(clips),
                                  [[3, 0, 0], [0, 0, 6]])
    assert cache.stats.n_rows_encoded == 7
    assert cache.stats.n_encode_passes == 1
    assert cache.ensure_rows(rows[:2]).tolist() == [1, 2]
    assert cache.stats.n_encode_passes == 1                  # all cached


@pytest.mark.parametrize("field,value", [("mesh_shape", (2,))])
def test_unported_config_fields_raise(params, field, value, monkeypatch):
    """Nothing is refused as unported any more (the mesh is ported); what
    a mesh cannot take still raises: a batch that does not split into
    equal shards, and more cards than are visible."""
    with pytest.raises(ValueError, match="must divide by the mesh size 2"):
        EngineConfig(**{field: value}, batch_size=15)
    eng = SimulationEngine(params, TCFG, TV, EngineConfig(**{field: value}),
                           device="cpu")
    assert eng.mesh.n_shards == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"mesh of 2 devices.*only 1 "
                                         "visible"):
        SimulationEngine(params, TCFG, TV, EngineConfig(**{field: value}),
                         device="cuda")


def test_engine_without_device_needs_a_card(params):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimulationEngine(params, TCFG, TV, EngineConfig(**SIM))
