"""The port's analytical-ML fusion path against the JAX reference on the
CPU: the copied numpy modules (``core/{slicer,analytical,sampler,
intervals}.py``) give bitwise the reference's outputs, and the sampled
engine, single-core and multicore, draws the same sample
(``clip_provenance``) and lands within 1e-4 of the reference's estimate
and CI; ``fraction=1.0`` is bitwise the port's unsampled run."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import analytical as jan  # noqa: E402
from repro.core import intervals as jint  # noqa: E402
from repro.core import predictor as jp  # noqa: E402
from repro.core import sampler as jsam  # noqa: E402
from repro.core import slicer as jsl  # noqa: E402
from repro.core import standardize as jstd  # noqa: E402
from repro.core.engine import SimulationEngine as JaxEngine  # noqa: E402
from repro.core.engine_config import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.core.engine_config import SamplingConfig as JaxSamplingConfig  # noqa: E402
from repro.isa import funcsim as jfuncsim  # noqa: E402
from repro.isa import multicore as jmc  # noqa: E402
from repro.isa import progen as jprogen  # noqa: E402
from repro.isa import timing as jtiming  # noqa: E402
from repro_torch.configs.capsim import config  # noqa: E402
from repro_torch.core import analytical as tan  # noqa: E402
from repro_torch.core import intervals as tint  # noqa: E402
from repro_torch.core import predictor as tp  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.core import slicer as tsl  # noqa: E402
from repro_torch.core import standardize as tstd  # noqa: E402
from repro_torch.core.engine import SimulationEngine  # noqa: E402
from repro_torch.core.engine_config import EngineConfig, SamplingConfig  # noqa: E402
from repro_torch.core.simulate import (capsim_simulate,  # noqa: E402
                                       capsim_simulate_multicore)
from repro_torch.isa import funcsim as tfuncsim  # noqa: E402
from repro_torch.isa import multicore as tmc  # noqa: E402
from repro_torch.isa import progen as tprogen  # noqa: E402
from repro_torch.isa import timing as ttiming  # noqa: E402

JV, TV = jstd.build_vocab(), tstd.build_vocab()
# the reference tests' SMALL_CFG (4 heads of 8)
JCFG = get_config("capsim").replace(d_model=32, head_dim=8, d_ff=64,
                                    dtype="float32")
TCFG = config().replace(d_model=32, head_dim=8, d_ff=64, dtype="float32")
# tests/test_subsample.py's engine config
SIM = dict(interval_size=1_000, warmup=100, max_checkpoints=2,
           batch_size=16)
MC_SIM = dict(interval_size=1_200, warmup=150, max_checkpoints=2, l_min=32,
              l_clip=32, batch_size=16)
NAMES = list(jprogen.TABLE_II)[:2]
SAMPLING = dict(fraction=0.25, strata=3, min_clips_per_stratum=2,
                bootstrap_resamples=30, seed=5)


@pytest.fixture(scope="module")
def jparams():
    return jp.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return tp.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _traces(progen, funcsim, name, n_ckp=2, size=1_000):
    bench = progen.build_benchmark(name)
    cprog = bench.compiled()
    _, st = funcsim.run_compiled(cprog, 100,
                                 progen.fresh_compiled_state(bench))
    out = []
    for _ in range(n_ckp):
        trace, st = funcsim.run_compiled(cprog, size, st, snapshot_every=100)
        out.append(trace)
    return out


def _synthetic(n, seed, noise=0.05):
    """tests/test_subsample.py's features + noisy affine target."""
    rng = np.random.default_rng(seed)
    feats = rng.uniform(0.5, 50.0, (n, jan.N_FEATURES))
    w = rng.uniform(0.1, 1.0, jan.N_FEATURES)
    y = feats @ w + 5.0 + rng.normal(0, noise * 10, n)
    return feats, np.maximum(y, 0.1)


def _rel(a, b):
    return abs(a - b) / abs(b)


# --------------------------------------------------------------------------- #
# The copied numpy modules: bitwise the reference
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(jprogen.TABLE_II)[:3])
def test_clip_features_bitwise_the_reference(name):
    jt = _traces(jprogen, jfuncsim, name)
    tt = _traces(tprogen, tfuncsim, name)
    for a, b in zip(jt, tt):
        for l_min in (100, 37):
            fa = jan.clip_features(a, l_min, jtiming.TimingParams())
            fb = tan.clip_features(b, l_min, ttiming.TimingParams())
            assert fa.shape[1] == tan.N_FEATURES
            np.testing.assert_array_equal(fa, fb)
    assert jan.FEATURE_NAMES == tan.FEATURE_NAMES


@pytest.mark.parametrize("ndim", [2, 3])
def test_token_clip_features_bitwise_the_reference(ndim):
    rng = np.random.default_rng(ndim)
    shape = (12, 128) if ndim == 2 else (12, 128, 16)
    tok = rng.integers(0, 40, shape).astype(np.int32)
    mask = (rng.random((12, 128)) > 0.2).astype(np.float32)
    mask[3] = 0.0                                  # a clip with no rows
    np.testing.assert_array_equal(jan.token_clip_features(tok, mask),
                                  tan.token_clip_features(tok, mask))


@pytest.mark.parametrize("n_strata", [1, 3, 4, 7])
def test_stratify_bitwise_the_reference(n_strata):
    feats, _ = _synthetic(90, seed=n_strata)
    feats[::5, -1] = feats[0, -1]                  # ties collapse bins
    for key in (jan.N_FEATURES - 1, 0):
        np.testing.assert_array_equal(
            jan.stratify(feats, n_strata, key_column=key),
            tan.stratify(feats, n_strata, key_column=key))
    np.testing.assert_array_equal(jan.stratify(feats[:0], n_strata),
                                  tan.stratify(feats[:0], n_strata))


@pytest.mark.parametrize("fraction,min_per,seed,key", [
    (0.08, 2, 0, 0), (0.25, 1, 3, 9), (0.5, 3, 11, 2), (1.0, 2, 0, 1),
    (0.05, 1, 2 ** 31, 32)])
def test_stratified_sample_bitwise_the_reference(fraction, min_per, seed,
                                                 key):
    rng = np.random.default_rng(seed % 97)
    strata = rng.integers(0, 5, 200).astype(np.int32)
    a, sa = jsam.stratified_sample(strata, fraction, min_per, seed, key)
    b, sb = tsam.stratified_sample(strata, fraction, min_per, seed, key)
    np.testing.assert_array_equal(a, b)
    assert dataclasses.astuple(sa) == dataclasses.astuple(sb)
    if fraction == 1.0:
        np.testing.assert_array_equal(b, np.arange(200))


def test_sample_indices_bitwise_the_reference():
    rng = np.random.default_rng(4)
    keys = [bytes([int(k)]) for k in
            np.concatenate([np.full(300, 1), np.full(250, 2),
                            rng.integers(3, 60, 200)])]
    rng.shuffle(keys)
    for threshold, coef in ((200, 0.02), (10, 0.1), (1, 0.5)):
        a, sa = jsam.sample_indices(keys, threshold, coef)
        b, sb = tsam.sample_indices(keys, threshold, coef)
        assert a == b
        assert dataclasses.astuple(sa) == dataclasses.astuple(sb)


@pytest.mark.parametrize("fraction,resamples", [(0.25, 50), (0.25, 0),
                                                (1.0, 100)])
def test_fuse_predictions_bitwise_the_reference(fraction, resamples):
    feats, y = _synthetic(120, seed=7)
    strata = jan.stratify(feats, 4)
    sampled, _ = jsam.stratified_sample(strata, fraction, 2, seed=7, key=0)
    y32 = y.astype(np.float32)
    a = jan.fuse_predictions(feats, strata, sampled, y32[sampled],
                             bootstrap_resamples=resamples, seed=7, key=3)
    b = tan.fuse_predictions(feats, strata, sampled, y32[sampled],
                             bootstrap_resamples=resamples, seed=7, key=3)
    assert (a.total_cycles, a.cycles_ci, a.clips_predicted,
            a.clips_extrapolated) == (b.total_cycles, b.cycles_ci,
                                      b.clips_predicted,
                                      b.clips_extrapolated)
    np.testing.assert_array_equal(a.clip_provenance, b.clip_provenance)
    np.testing.assert_array_equal(a.times, b.times)
    if fraction == 1.0:                            # dtype-exact sum
        assert b.total_cycles == float(y32.sum())
        assert b.cycles_ci == (b.total_cycles, b.total_cycles)


def test_slice_trace_columnar_bitwise_the_reference():
    for jt, tt in zip(_traces(jprogen, jfuncsim, "505.mcf"),
                      _traces(tprogen, tfuncsim, "505.mcf")):
        ja = np.asarray(jtiming.simulate_columnar(jt), np.int64)
        tb = np.asarray(ttiming.simulate_columnar(tt), np.int64)
        np.testing.assert_array_equal(ja, tb)
        for l_min in (16, 100):
            for x, y in zip(jsl.slice_trace_columnar(ja, l_min),
                            tsl.slice_trace_columnar(tb, l_min)):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(jsl.fixed_bounds(len(jt), 100),
                                      tsl.fixed_bounds(len(tt), 100))


@pytest.mark.parametrize("k", [1, 3])
def test_pick_intervals_bitwise_the_reference(k):
    jb = jprogen.build_benchmark("505.mcf")
    tb = tprogen.build_benchmark("505.mcf")
    a = jint.pick_intervals(jb.program, 6_000, 1_000, k=k)
    b = tint.pick_intervals(tb.program, 6_000, 1_000, k=k)
    assert [(i.index, i.start, i.weight) for i in a] == \
        [(i.index, i.start, i.weight) for i in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.bbv, y.bbv)
    np.testing.assert_array_equal(jint.basic_block_leaders(jb.program),
                                  tint.basic_block_leaders(tb.program))


def test_clip_features_invariant_to_clip_order():
    """tests/test_subsample.py's contract on the port's copy: each row is
    a pure function of its own window."""
    trace = _traces(tprogen, tfuncsim, "505.mcf", n_ckp=1)[0]
    feats = tan.clip_features(trace, 100)
    k_full = len(trace) // 100
    sub = dataclasses.replace(trace, pc=trace.pc[100:], ea=trace.ea[100:],
                              taken=trace.taken[100:],
                              snapshots=trace.snapshots[1:])
    np.testing.assert_array_equal(tan.clip_features(sub, 100)[:k_full - 1],
                                  feats[1:k_full])
    assert (feats[:, -1] > 0).all()


# --------------------------------------------------------------------------- #
# The sampled engine against the JAX engine
# --------------------------------------------------------------------------- #

def _jax_run(jparams, names=NAMES, **sampling):
    ec = JaxEngineConfig(**SIM, sampling=JaxSamplingConfig(**sampling))
    eng = JaxEngine.from_config(jparams, JCFG, JV, ec)
    eng.submit_names(names)
    return eng.run()


def _port_engine(params, sampling=None, **kw):
    ec = EngineConfig(**SIM, **kw)
    if sampling is not None:
        ec = ec.replace(sampling=SamplingConfig(**sampling))
    return SimulationEngine(params, TCFG, TV, ec, device="cpu")


def _port_run(params, sampling=None, names=NAMES, **kw):
    eng = _port_engine(params, sampling, **kw)
    eng.submit_names(names)
    return eng.run(), eng


def test_sampled_engine_matches_jax(jparams, params):
    ref = _jax_run(jparams, **SAMPLING)
    got, eng = _port_run(params, SAMPLING)
    for a, b in zip(ref, got):
        assert (a.name, a.n_clips, a.n_intervals, a.n_instructions) == \
            (b.name, b.n_clips, b.n_intervals, b.n_instructions)
        np.testing.assert_array_equal(a.clip_provenance, b.clip_provenance)
        assert (a.clips_predicted, a.clips_extrapolated) == \
            (b.clips_predicted, b.clips_extrapolated)
        assert 0 < b.clips_predicted < b.n_clips
        assert _rel(b.predicted_cycles, a.predicted_cycles) <= 1e-4
        for x, y in zip(a.cycles_ci, b.cycles_ci):
            assert _rel(y, x) <= 1e-4
        lo, hi = b.cycles_ci
        assert lo <= b.predicted_cycles <= hi
    assert eng.last_stats.n_predicted == sum(r.clips_predicted for r in got)
    assert eng.frontend_stats.analytical_seconds > 0
    assert eng.frontend_stats.as_dict()["analytical_seconds"] > 0


def test_sampled_multicore_matches_jax(jparams, params):
    sampling = dict(SAMPLING, fraction=0.3)
    mbs = [("mt.mix", 2), ("mt.chase", 3)]
    jec = JaxEngineConfig(**MC_SIM,
                          sampling=JaxSamplingConfig(**sampling))
    ref = JaxEngine.from_config(jparams, JCFG, JV, jec).run_multicore(
        [jmc.build_multicore_benchmark(n, c) for n, c in mbs])
    eng = SimulationEngine(params, TCFG, TV, EngineConfig(
        **MC_SIM, sampling=SamplingConfig(**sampling)), device="cpu")
    got = eng.run_multicore([tmc.build_multicore_benchmark(n, c)
                             for n, c in mbs])
    for a, b in zip(ref, got):
        assert b.cycles_ci is not None
        assert (a.clips_predicted, a.clips_extrapolated) == \
            (b.clips_predicted, b.clips_extrapolated)
        for ca, cb in zip(a.cores, b.cores, strict=True):
            assert (ca.name, ca.n_clips, ca.oracle_cycles) == \
                (cb.name, cb.n_clips, cb.oracle_cycles)
            np.testing.assert_array_equal(ca.clip_provenance,
                                          cb.clip_provenance)
            assert _rel(cb.predicted_cycles, ca.predicted_cycles) <= 1e-4
            for x, y in zip(ca.cycles_ci, cb.cycles_ci):
                assert _rel(y, x) <= 1e-4
    assert sum(r.clips_extrapolated for r in got) > 0


@pytest.mark.parametrize("fused", [False, True])
def test_fraction_one_bitwise_unsampled(params, fused):
    """At fraction=1.0 every clip is fed in the unsampled order, so the
    device batches hold the same rows and the totals are the same
    float32 sums: bitwise, and the report degenerates to the point."""
    full, _ = _port_run(params, fused_serving=fused)
    f1, _ = _port_run(params, dict(fraction=1.0), fused_serving=fused)
    for a, b in zip(full, f1):
        assert b.predicted_cycles == a.predicted_cycles        # bitwise
        assert b.n_clips == a.n_clips == b.clips_predicted
        assert b.clips_extrapolated == 0
        assert b.cycles_ci == (b.predicted_cycles, b.predicted_cycles)
        assert b.clip_provenance.all()
    assert full[0].cycles_ci is None
    assert full[0].clips_predicted == full[0].n_clips
    assert full[0].prediction_report.cycles_ci == \
        (full[0].predicted_cycles,) * 2


def test_fraction_one_bitwise_unsampled_multicore(params):
    """The multicore condition: with one checkpoint a core's clips are
    one segment, fed in the same (benchmark, core) order and summed once
    on both paths, so fraction=1.0 is bitwise per core.  (With more
    checkpoints the unsampled path interleaves cores per checkpoint and
    sums per segment.)"""
    ec = EngineConfig(**dict(MC_SIM, max_checkpoints=1))

    def run(e):
        return SimulationEngine(params, TCFG, TV, e, device="cpu") \
            .run_multicore([tmc.build_multicore_benchmark("mt.stream", 3),
                            tmc.build_multicore_benchmark("mt.mix", 2)])
    full = run(ec)
    f1 = run(ec.replace(sampling=SamplingConfig(fraction=1.0)))
    for a, b in zip(full, f1):
        assert b.cycles_ci == (b.predicted_cycles, b.predicted_cycles)
        for ca, cb in zip(a.cores, b.cores, strict=True):
            assert cb.predicted_cycles == ca.predicted_cycles   # bitwise
            assert cb.clips_predicted == ca.n_clips
            assert cb.clips_extrapolated == 0


def test_sampled_engine_deterministic_under_seed(params):
    runs = [_port_run(params, SAMPLING, names=NAMES[:1])[0][0]
            for _ in range(2)]
    a, b = runs
    assert a.predicted_cycles == b.predicted_cycles
    assert a.cycles_ci == b.cycles_ci
    np.testing.assert_array_equal(a.clip_provenance, b.clip_provenance)
    other = _port_run(params, dict(SAMPLING, seed=6), names=NAMES[:1])[0][0]
    assert not np.array_equal(other.clip_provenance, a.clip_provenance)


def test_sampled_engine_reduces_clips_and_reports(params):
    """tests/test_subsample.py's engine contract on the port."""
    got, eng = _port_run(params, SAMPLING)
    full, ref = _port_run(params)
    assert eng.last_stats.n_predicted < ref.last_stats.n_predicted
    for r, f in zip(got, full):
        assert r.n_clips == f.n_clips
        assert r.clips_predicted + r.clips_extrapolated == r.n_clips
        assert r.clip_provenance.sum() == r.clips_predicted
        assert abs(r.predicted_cycles - f.predicted_cycles) \
            / f.predicted_cycles < 0.5
        rep = r.prediction_report
        assert rep.total_cycles == r.predicted_cycles
        assert rep.n_clips == r.n_clips


def test_simulate_wrappers_return_the_sampled_result(params):
    ec = EngineConfig(**SIM, sampling=SamplingConfig(**SAMPLING))
    r = capsim_simulate(tprogen.build_benchmark(NAMES[0]), params, TCFG, TV,
                        ec, device="cpu")
    assert r.clips_extrapolated > 0 and r.cycles_ci is not None
    m = capsim_simulate_multicore(tmc.build_multicore_benchmark("mt.mix", 2),
                                  params, TCFG, TV,
                                  EngineConfig(**MC_SIM).replace(
                                      sampling=SamplingConfig(**SAMPLING)),
                                  device="cpu")
    assert m.cycles_ci is not None
    assert m.clips_predicted + m.clips_extrapolated == m.n_clips
