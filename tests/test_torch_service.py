"""The port's serving layer on the CPU: the contracts of
``tests/test_service.py`` and ``tests/test_faults.py`` held by
``repro_torch.serving`` (typed results, admission, watchdog, the
degradation ladder, fault injection on the real engine paths, crash-safe
store publishes), ``PredictorEngine`` flushes against the JAX engine's,
and the thread-safety the serving threads need (one ``nvcc`` for two
threads meeting a stale library, no autograd graph in a flush thread, a
shared RT cache filled from many threads)."""
import json
import os
import sys
import threading
import time
import warnings

import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import predictor as jp  # noqa: E402
from repro.core.engine_config import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.core.engine_config import SamplingConfig as JaxSamplingConfig  # noqa: E402
from repro.serving.engine import PredictorEngine as JaxPredictorEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch.checkpoint.ckpt import (latest_step, read_manifest,  # noqa: E402
                                         restore, save)
from repro_torch.configs.capsim import config  # noqa: E402
from repro_torch.core import predictor as tp  # noqa: E402
from repro_torch.core.engine import BatchedPredictor, SimulationEngine  # noqa: E402
from repro_torch.core.engine_config import (FAULT_KINDS,  # noqa: E402
                                            EngineConfig, SamplingConfig)
from repro_torch.core.rt_cache import RTCache  # noqa: E402
from repro_torch.core.standardize import build_vocab  # noqa: E402
from repro_torch.isa import progen  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.serving import (FaultInjected, FaultInjector,  # noqa: E402
                                 PredictorEngine, Request, ServiceSLA,
                                 SimulationService, build_ladder)
from repro_torch.serving.service import (STATUSES,  # noqa: E402
                                         DegradationController,
                                         ServiceTicket, _QueuedRequest)

VOCAB = build_vocab()
# the reference tests' SMALL_CFG (4 heads of 8)
JCFG = get_config("capsim").replace(d_model=32, head_dim=8, d_ff=64,
                                    dtype="float32")
SMALL_CFG = config().replace(d_model=32, head_dim=8, d_ff=64,
                             dtype="float32")
BASE = EngineConfig(batch_size=8)


@pytest.fixture(scope="module")
def jparams():
    return jp.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return tp.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def table():
    cprog = progen.build_benchmark("505.mcf").compiled()
    return cprog.token_table(VOCAB, 16)


def _req(i, n=4, seed=None):
    rng = np.random.RandomState(i if seed is None else seed)
    tok = rng.randint(0, VOCAB.size, (n, 128, SMALL_CFG.clip_tokens)
                      ).astype(np.int32)
    ctx = rng.randint(0, VOCAB.size, (n, SMALL_CFG.context_tokens)
                      ).astype(np.int32)
    return Request(i, tok, ctx, np.ones((n, 128), np.float32))


def _clips(n=4, seed=0):
    r = _req(0, n, seed)
    return r.clip_tokens, r.context_tokens, r.clip_mask


def _sla(**kw):
    kw.setdefault("watchdog_s", 120.0)
    kw.setdefault("promote_after", 1)
    return ServiceSLA(**kw)


def _service(params, sla=None, **kw):
    return SimulationService(params, SMALL_CFG, kw.pop("config", BASE),
                             sla=sla or _sla(), device="cpu", **kw)


def _engine(params, config=BASE):
    return PredictorEngine(params, SMALL_CFG, config, device="cpu")


# --------------------------------------------------------------------------- #
# Ladder + controller units (tests/test_service.py)
# --------------------------------------------------------------------------- #

def test_build_ladder_respects_structural_axes():
    assert [n for n, _ in build_ladder(BASE)] == [
        "fused_int8", "fused", "rt", "monolithic"]
    assert [n for n, _ in build_ladder(BASE.replace(rt_cache=False))] == [
        "monolithic"]
    assert [n for n, _ in build_ladder(BASE.replace(use_context=False))
            ] == ["rt", "monolithic"]
    for _, cfg in build_ladder(BASE):
        cfg.validate()
    mono = dict(build_ladder(BASE))["monolithic"]
    assert not mono.rt_cache and mono.rt_store_dir is None


def test_degradation_controller_backoff():
    ctrl = DegradationController(4, ServiceSLA(promote_after=2,
                                               backoff_max=8))
    assert ctrl.on_trip() == 1
    assert ctrl.on_trip() == 2
    assert ctrl.backoff == 8
    for _ in range(7):
        assert ctrl.on_healthy() is None
    assert ctrl.on_healthy() == 1
    for _ in range(7):
        assert ctrl.on_healthy() is None
    assert ctrl.on_healthy() == 0
    ctrl.on_healthy()
    ctrl.on_healthy()
    assert ctrl.backoff == 2
    ctrl.idx = 3
    assert ctrl.on_trip() is None


# --------------------------------------------------------------------------- #
# Request validation + persistent engine backend
# --------------------------------------------------------------------------- #

def test_submit_validates_shapes_and_dtypes(params):
    eng = _engine(params)
    good = _req(0)
    eng.submit(good)
    with pytest.raises(ValueError, match="clip_tokens"):
        eng.submit(Request(1, good.clip_tokens[:, 0], good.context_tokens,
                           good.clip_mask))
    with pytest.raises(ValueError, match="l_clip"):
        eng.submit(Request(2, good.clip_tokens[:, :7], good.context_tokens,
                           good.clip_mask[:, :7]))
    with pytest.raises(ValueError, match="dtype"):
        eng.submit(Request(3, good.clip_tokens.astype(np.float32),
                           good.context_tokens, good.clip_mask))
    with pytest.raises(ValueError, match="context_tokens"):
        eng.submit(Request(4, good.clip_tokens,
                           good.context_tokens[:2], good.clip_mask))
    with pytest.raises(ValueError, match="clip_mask"):
        eng.submit(Request(5, good.clip_tokens, good.context_tokens,
                           good.clip_mask.astype(np.int32)))
    with pytest.raises(ValueError, match="context"):
        eng.submit(Request(6, good.clip_tokens,
                           good.context_tokens[:, :13], good.clip_mask))


def test_engine_backend_persists_across_flushes(params):
    eng = _engine(params)
    eng.submit(_req(0))
    r1 = eng.flush()[0]
    backend = eng.backend()
    eng.submit(_req(1, n=3))
    eng.submit(_req(0))
    r2 = eng.flush()
    assert eng.backend() is backend
    assert [r.n_clips for r in r2] == [3, 4]
    assert r2[1].total_cycles == r1.total_cycles       # replay is bitwise
    assert eng.rt_stats.n_rows_encoded > 0


@pytest.mark.parametrize("kw,tol", [
    (dict(), 1e-4), (dict(rt_cache=False), 1e-4),
    (dict(fused_serving=True), 1e-3), (dict(precision="int8"), 1e-4)])
def test_predictor_engine_flush_matches_jax(jparams, params, kw, tol):
    """The same requests through the port's and the reference's
    ``PredictorEngine``: per-request totals within 1e-4 in fp32 (the
    fused step 1e-3, as the engines' parity tests gate it)."""
    ours = _engine(params, BASE.replace(**kw))
    ref = JaxPredictorEngine(jparams, JCFG, JaxEngineConfig(batch_size=8,
                                                            **kw))
    for i, n in ((0, 4), (1, 7), (2, 2)):
        r = _req(i, n)
        ours.submit(r)
        ref.submit(JaxRequest(i, r.clip_tokens, r.context_tokens,
                              r.clip_mask))
    for a, b in zip(ref.flush(), ours.flush(), strict=True):
        assert (a.request_id, a.n_clips) == (b.request_id, b.n_clips)
        assert abs(b.total_cycles - a.total_cycles) \
            / abs(a.total_cycles) <= tol


def test_predictor_engine_sampled_flush_matches_jax(jparams, params):
    sampling = dict(fraction=0.3, strata=3, bootstrap_resamples=40, seed=2)
    ours = _engine(params, BASE.replace(
        sampling=SamplingConfig(**sampling)))
    ref = JaxPredictorEngine(jparams, JCFG, JaxEngineConfig(
        batch_size=8, sampling=JaxSamplingConfig(**sampling)))
    for i in range(3):
        r = _req(i, 24)
        r.clip_mask[:, 100 + 8 * i:] = 0.0          # clips of several lengths
        r.clip_mask[::3, 40:] = 0.0
        ours.submit(r)
        ref.submit(JaxRequest(i, r.clip_tokens, r.context_tokens,
                              r.clip_mask))
    for a, b in zip(ref.flush(), ours.flush(), strict=True):
        assert (a.clips_predicted, a.clips_extrapolated) == \
            (b.clips_predicted, b.clips_extrapolated)
        assert b.clips_extrapolated > 0
        assert abs(b.total_cycles - a.total_cycles) \
            / abs(a.total_cycles) <= 1e-4
        for x, y in zip(a.cycles_ci, b.cycles_ci):
            assert abs(y - x) / abs(x) <= 1e-4


# --------------------------------------------------------------------------- #
# Service behavior (tests/test_service.py)
# --------------------------------------------------------------------------- #

def test_service_healthy_top_tier(params):
    with _service(params) as svc:
        tickets = [svc.submit(_req(i)) for i in range(3)]
        results = [t.result(timeout=300) for t in tickets]
    assert all(r.status == "ok" and r.ok for r in results)
    assert all(r.tier == "fused_int8" for r in results)
    assert all(r.total_cycles and np.isfinite(r.total_cycles)
               for r in results)
    eng = _engine(params, BASE.replace(fused_serving=True,
                                       precision="int8"))
    eng.submit(_req(0))
    assert eng.flush()[0].total_cycles == pytest.approx(
        results[0].total_cycles, rel=1e-6)


def test_service_sheds_when_queue_full(params):
    svc = _service(params, _sla(queue_limit=1))
    svc._running = True                 # accepting, but no worker drains
    t1 = svc.submit(_req(0))
    t2 = svc.submit(_req(1))
    assert not t1.done()
    assert t2.done() and t2.result().status == "overloaded"
    assert "queue full" in t2.result().error
    svc.stop(drain=False)
    assert t1.result(timeout=5).status == "cancelled"


def test_service_rejects_after_stop_and_validates(params):
    svc = _service(params)
    assert svc.submit(_req(0)).result().status == "overloaded"
    with pytest.raises(ValueError):
        svc.submit(Request(1, np.zeros((2, 3), np.int32),
                           np.zeros((2, 4), np.int32),
                           np.zeros((2, 3), np.float32)))


def test_service_deadline_exceeded_is_typed(params):
    with _service(params) as svc:
        res = svc.submit(_req(0), deadline_s=-1.0).result(timeout=60)
    assert res.status == "deadline_exceeded"
    assert res.total_cycles is None and not res.ok


def test_service_nan_demotes_then_repromotes(params):
    inj = FaultInjector({"nan_output": 1.0})
    with _service(params, _sla(check_every=0, backoff_max=2),
                  fault_injector=inj) as svc:
        top = svc.tier_stats[0].name
        res = svc.submit(_req(0)).result(timeout=600)
        assert res.status == "failed"
        assert "non-finite" in res.error or "tiers failed" in res.error
        assert svc.current_tier != top
        assert sum(t.nan_trips for t in svc.tier_stats) > 0
        inj.set_enabled(False)
        for i in range(1, 12):
            assert svc.submit(_req(i)).result(timeout=600).ok
            if svc.current_tier == top:
                break
        assert svc.current_tier == top
        assert sum(t.promotions for t in svc.tier_stats) > 0
        stats = svc.stats()
    assert stats["statuses"]["failed"] == 1
    assert set(stats["statuses"]) == set(STATUSES)


def test_service_watchdog_aborts_stuck_flush(params):
    """A flush stuck on every rung ends in a typed failure, each attempt
    cut by the watchdog long before the stall ends; once the fault stops
    the service serves again without a restart.  The clock starts at
    submit and is bounded by the watchdog's own arithmetic: at most
    rungs + 2 attempts (the service's cap) of ``watchdog_s`` each, plus
    MARGIN for the backend rebuilt between attempts on a loaded host.
    The stall (30 s, as the reference's test) outlasts that bound, and
    the abandoned threads are joined at the end: a thread killed inside
    a torch call at exit aborts the process."""
    slow, watchdog_s, margin = 30.0, 0.8, 15.0
    inj = FaultInjector({"slow_flush": 1.0}, slow_seconds=slow)
    svc = _service(params, _sla(watchdog_s=watchdog_s, check_every=0),
                   fault_injector=inj)
    with svc:
        max_attempts = len(svc.tier_stats) + 2
        bound = max_attempts * watchdog_s + margin
        assert bound < slow
        t0 = time.monotonic()
        res = svc.submit(_req(0, n=1)).result(timeout=120)
        assert res.status == "failed"
        assert "watchdog" in res.error
        assert time.monotonic() - t0 < bound
        trips = sum(t.watchdog_trips for t in svc.tier_stats)
        assert trips >= len(svc.tier_stats)       # every rung, then capped
        assert svc.snapshot().abandoned_flush_threads_total == trips
        inj.set_enabled(False)
        assert svc.submit(_req(1, n=1)).result(timeout=600).ok
    assert svc.join_abandoned(timeout=slow + 60) == 0
    assert svc.snapshot().abandoned_flush_threads == 0


def test_service_degraded_results_stay_gated(params):
    inj = FaultInjector({"nan_output": 0.6}, seed=3)
    with _service(params, _sla(check_every=0), fault_injector=inj) as svc:
        results = [svc.submit(_req(i, n=2)).result(timeout=600)
                   for i in range(6)]
    assert any(r.status == "degraded" for r in results)
    ref = _engine(params, BASE.replace(rt_cache=False))
    for i, r in enumerate(results):
        assert r.status in ("ok", "degraded", "failed")
        if not r.ok:
            continue
        ref.submit(_req(i, n=2))
        want = ref.flush()[0].total_cycles
        tol = 0.05 if r.tier == "fused_int8" else 1e-3
        assert abs(r.total_cycles - want) / abs(want) <= tol


def test_service_spot_checks_every_rung_within_its_gate(params):
    """Each rung's spot check against the monolithic fp32 reference stays
    within its gate, and the rt rung is bitwise (C2 on the CPU).  The
    checks run on the caller's thread after the service's threads grew
    the RT tables in inference mode, and grow them again."""
    svc = _service(params)
    with svc:
        assert svc.submit(_req(3)).result(timeout=300).ok
    qr = _QueuedRequest(req=_req(7, n=6), ticket=None, arrival=0.0,
                        deadline=0.0)
    errs = {s.name: svc._spot_check(t, [qr])
            for t, s in zip(svc._tiers[:-1], svc.tier_stats)}
    assert errs["rt"] == 0.0
    for name, err in errs.items():
        assert err <= svc.sla.tier_tolerances[name], (name, err)


def test_rungs_share_one_tree_and_cache_per_precision(params, monkeypatch):
    """One predict stack a rung: rungs of one (precision, rt_cache) share
    their parameter tree and RT cache (``fused`` and ``rt``), the int8
    tree is quantized once for ``fused_int8`` alone, and ``monolithic``
    and the auditor read the device tree with no cache, the auditor
    unsharded."""
    from repro_torch.core import quant
    quantized = []

    def counting(tree):
        quantized.append(tree)
        return real(tree)
    real = quant.quantize_dequant_params
    monkeypatch.setattr(quant, "quantize_dequant_params", counting)
    svc = _service(params, config=BASE.replace(mesh_shape=(2,)))
    int8, fused, rt, mono = svc._tiers
    ref = svc._reference
    assert [s.name for s in svc.tier_stats] == [
        "fused_int8", "fused", "rt", "monolithic"]
    assert fused.cache is not None and fused.cache is rt.cache
    assert fused.params is rt.params is mono.params is ref.params
    assert fused.cache.params is fused.params
    whole = [t for t in quantized if isinstance(t, dict) and "head" in t]
    assert len(whole) == 1 and whole[0] is fused.params
    assert int8.params is not fused.params
    assert int8.cache is not None and int8.cache is not fused.cache
    assert int8.cache.params is int8.params
    assert not torch.equal(int8.params["head"]["w1"],
                           fused.params["head"]["w1"])
    assert mono.cache is None and ref.cache is None
    assert all(t.mesh is svc.mesh for t in svc._tiers)
    assert svc.mesh is not None and ref.mesh is None
    assert ref.config.mesh_shape == () and ref.faults is None
    assert ref.cfg == mono.cfg == SMALL_CFG


@pytest.mark.parametrize("sampled", [False, True], ids=["plain", "sampled"])
@pytest.mark.parametrize("start_tier", range(4))
def test_service_and_predictor_engine_flush_alike(params, start_tier,
                                                  sampled):
    """One flush body behind both front ends: a window of three requests
    (8-clip batches spanning them) served on each rung gives the
    per-request totals of a ``PredictorEngine`` with that rung's config,
    bitwise for plain flushes; sampled ones to 1e-12 relative (the
    service sums the fused per-clip times, the engine reads the
    report's total)."""
    config = BASE
    if sampled:
        config = BASE.replace(sampling=SamplingConfig(fraction=0.5,
                                                      strata=2))
    svc = _service(params, _sla(check_every=0, promote_after=10**6),
                   config=config, start_tier=start_tier)
    reqs = [_req(i, n) for i, n in ((0, 5), (1, 7), (2, 12))]
    window = [_QueuedRequest(req=r, ticket=ServiceTicket(r.request_id,
                                                         r.clip_tokens
                                                         .shape[0]),
                             arrival=0.0, deadline=float("inf"))
              for r in reqs]
    svc._serve_batch(window)
    got = [qr.ticket.result(timeout=0) for qr in window]
    name = svc.tier_stats[start_tier].name
    assert all(r.status == ("ok" if start_tier == 0 else "degraded")
               and r.tier == name for r in got)
    eng = _engine(params, svc._tiers[start_tier].config)
    for r in reqs:
        eng.submit(r)
    want = eng.flush()
    assert [r.n_clips for r in got] == [r.n_clips for r in want]
    for a, b in zip(got, want, strict=True):
        if sampled:
            assert b.clips_extrapolated > 0
            assert abs(a.total_cycles - b.total_cycles) \
                <= 1e-12 * abs(b.total_cycles)
        else:
            assert a.total_cycles == b.total_cycles


def test_service_sampled_flushes_stay_typed(params):
    config = BASE.replace(sampling=SamplingConfig(fraction=0.5, strata=2))
    with _service(params, config=config) as svc:
        results = [svc.submit(_req(i, n=12)).result(timeout=300)
                   for i in range(2)]
    assert all(r.status == "ok" and np.isfinite(r.total_cycles)
               for r in results)


def test_service_stats_shape(params):
    with _service(params) as svc:
        svc.submit(_req(0)).result(timeout=300)
        st = svc.stats()
    assert st["submitted"] == 1 and st["statuses"]["ok"] == 1
    assert list(st["tiers"]) == ["fused_int8", "fused", "rt", "monolithic"]
    assert st["tiers"]["fused_int8"]["clips"] == 4
    assert st["current_tier"] == "fused_int8"


def test_service_prewarm_suspends_injection(params):
    inj = FaultInjector({"device_error": 1.0})
    svc = _service(params, fault_injector=inj)
    svc.prewarm(_req(0, n=2))
    assert inj.stats() == {}
    assert all(t._backend is not None for t in svc._tiers)


def test_service_mesh_is_not_ported(params):
    """Once the refusal of ``mesh_shape``; the mesh is ported (item 6a):
    a service on a 2-shard CPU mesh serves typed results equal to the
    unsharded service's, and its auditor stays unsharded."""
    totals = {}
    for mesh_shape in ((), (2,)):
        svc = _service(params, config=BASE.replace(mesh_shape=mesh_shape))
        with svc:
            results = [svc.submit(_req(i)).result(timeout=300)
                       for i in range(2)]
        assert all(r.status == "ok" and r.tier == "fused_int8"
                   for r in results)
        totals[mesh_shape] = [r.total_cycles for r in results]
        assert (svc.mesh is None) == (mesh_shape == ())
        assert svc._reference.config.mesh_shape == ()
    assert totals[()] == totals[(2,)]


# --------------------------------------------------------------------------- #
# Injector + config plumbing (tests/test_faults.py)
# --------------------------------------------------------------------------- #

def test_fault_config_round_trips_and_validates():
    cfg = EngineConfig(faults={"nan_output": 0.1, "device_error": 0.05},
                       fault_seed=7)
    back = EngineConfig.from_json(cfg.to_json())
    assert back == cfg and back.faults == cfg.faults
    assert json.loads(cfg.to_json())["faults"] == [
        ["device_error", 0.05], ["nan_output", 0.1]]
    with pytest.raises(ValueError, match="fault"):
        EngineConfig(faults={"meteor_strike": 0.1})
    with pytest.raises(ValueError, match="rate"):
        EngineConfig(faults={"nan_output": 1.5})
    assert FaultInjector.from_config(EngineConfig()) is None


def test_injector_deterministic_and_toggleable():
    def mk():
        return FaultInjector({"nan_output": 0.3}, seed=11)
    a, b = mk(), mk()
    draws_a = [a.maybe("nan_output") for _ in range(64)]
    draws_b = [b.maybe("nan_output") for _ in range(64)]
    assert draws_a == draws_b and any(draws_a) and not all(draws_a)
    assert a.fired["nan_output"] == sum(draws_a)
    assert a.set_enabled(False) is True
    assert not any(a.maybe("nan_output") for _ in range(64))
    a.set_enabled(True)
    with pytest.raises(ValueError):
        FaultInjector({"bad_kind": 0.5})
    with pytest.raises(ValueError):
        a.set_rates({"bad_kind": 0.5})


def test_every_kind_is_drawable():
    inj = FaultInjector({k: 1.0 for k in FAULT_KINDS}, seed=0)
    for k in FAULT_KINDS:
        assert inj.maybe(k)


# --------------------------------------------------------------------------- #
# Injection on the real engine paths (tests/test_faults.py)
# --------------------------------------------------------------------------- #

def test_device_error_raises_from_dispatch(params):
    cfg = EngineConfig(batch_size=8, faults={"device_error": 1.0})
    b = BatchedPredictor(params, SMALL_CFG, config=cfg, device="cpu")
    tok, ctx, mask = _clips()
    with pytest.raises(FaultInjected, match="device_error"):
        b.add(tok, ctx, mask)
        b.drain()


def test_nan_output_corrupts_retired_batch(params):
    cfg = EngineConfig(batch_size=8, faults={"nan_output": 1.0})
    b = BatchedPredictor(params, SMALL_CFG, config=cfg, device="cpu")
    tok, ctx, mask = _clips()
    b.add(tok, ctx, mask)
    out = b.drain()
    assert out.shape == (4,) and np.isnan(out).any()
    b._faults.set_enabled(False)
    b.reset_context_width()
    b.add(tok, ctx, mask)
    assert np.isfinite(b.drain()).all()


def test_corrupt_rt_read_warns_and_cold_encodes(params, table, tmp_path):
    clean = RTCache(params, SMALL_CFG, 16, device="cpu",
                    store_dir=str(tmp_path), store_extra=VOCAB.signature())
    clean.ensure_rows(table)
    assert clean.persist() is not None
    inj = FaultInjector({"corrupt_rt_read": 1.0})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        c2 = RTCache(params, SMALL_CFG, 16, device="cpu",
                     store_dir=str(tmp_path), store_extra=VOCAB.signature(),
                     fault_injector=inj)
    assert any("RT" in str(x.message) or "store" in str(x.message)
               for x in w)
    assert c2.stats.n_rows_loaded == 0
    c2.ensure_rows(table)
    torch.testing.assert_close(clean.table[:clean.n_rows],
                               c2.table[:c2.n_rows], rtol=0, atol=0)


def test_crash_persist_keeps_previous_generation(params, table, tmp_path):
    c1 = RTCache(params, SMALL_CFG, 16, device="cpu",
                 store_dir=str(tmp_path), store_extra=VOCAB.signature())
    c1.ensure_rows(table[: table.shape[0] // 2])
    assert c1.persist() is not None
    inj = FaultInjector({"crash_persist": 1.0})
    c2 = RTCache(params, SMALL_CFG, 16, device="cpu",
                 store_dir=str(tmp_path), store_extra=VOCAB.signature(),
                 fault_injector=inj)
    assert c2.stats.n_rows_loaded == c1.n_rows
    c2.ensure_rows(table)
    with pytest.raises(FaultInjected, match="crash_persist"):
        c2.persist()
    c3 = RTCache(params, SMALL_CFG, 16, device="cpu",
                 store_dir=str(tmp_path), store_extra=VOCAB.signature())
    assert c3.stats.n_rows_loaded == c1.n_rows
    torch.testing.assert_close(c1.table[:c1.n_rows], c3.table[:c1.n_rows],
                               rtol=0, atol=0)


def test_predictor_engine_corrupt_rt_read_cold_encodes(params, tmp_path):
    """``PredictorEngine``'s RT cache consults the engine's injector, as
    ``SimulationEngine``'s and the service's do: a corrupt store read
    warns and cold-encodes to the clean run's totals, where a clean
    engine adopts the store."""
    config = BASE.replace(rt_store_dir=str(tmp_path))
    clean = _engine(params, config)
    clean.submit(_req(0))
    want = clean.flush()[0].total_cycles
    warm = _engine(params, config)
    assert warm.rt_stats.n_rows_loaded > 0
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = _engine(params, config.replace(
            faults={"corrupt_rt_read": 1.0}))
    assert eng.rt_stats.n_rows_loaded == 0
    assert any("store" in str(x.message) or "RT" in str(x.message)
               for x in w)
    eng.submit(_req(0))
    assert eng.flush()[0].total_cycles == want
    assert eng.rt_stats.n_rows_encoded > 0
    assert eng._stack.cache._faults is eng._stack.faults
    assert eng._stack.faults.stats() == {"corrupt_rt_read": 1}


def test_engine_config_faults_reach_the_engine(params, tmp_path):
    """``EngineConfig.faults`` runs in the port: one injector per engine,
    shared by its RT cache (a corrupt store read cold-encodes) and its
    predictor (nan_output reaches the per-benchmark totals)."""
    sim = dict(interval_size=1_000, warmup=100, max_checkpoints=1,
               batch_size=16, rt_store_dir=str(tmp_path))
    names = list(progen.TABLE_II)[:1]
    clean = SimulationEngine(params, SMALL_CFG, VOCAB, EngineConfig(**sim),
                             device="cpu")
    clean.submit_names(names)
    want = clean.run()[0].predicted_cycles
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        eng = SimulationEngine(params, SMALL_CFG, VOCAB, EngineConfig(
            **sim, faults={"corrupt_rt_read": 1.0, "nan_output": 1.0}),
            device="cpu")
    assert eng._stack.cache._faults is eng._stack.faults
    assert eng.last_rt_stats is None
    eng.submit_names(names)
    r = eng.run()[0]
    assert eng.last_rt_stats.n_rows_loaded == 0      # cold, not adopted
    assert eng.last_rt_stats.n_rows_encoded > 0
    assert np.isnan(r.predicted_cycles) and np.isfinite(want)
    assert eng._stack.faults.stats() == {"corrupt_rt_read": 1,
                                   "nan_output": eng.last_stats.n_batches}


# --------------------------------------------------------------------------- #
# Checkpoint publish crash-safety (tests/test_faults.py)
# --------------------------------------------------------------------------- #

def _state(v=1.0):
    return {"w": np.full((4, 4), v, np.float32)}


def test_crash_before_publish_preserves_latest(tmp_path):
    save(_state(1.0), 1, str(tmp_path))
    assert latest_step(str(tmp_path)) == 1

    def boom():
        raise RuntimeError("simulated death before publish")

    with pytest.raises(RuntimeError):
        save(_state(2.0), 2, str(tmp_path), pre_publish=boom)
    assert latest_step(str(tmp_path)) == 1
    assert not [d for d in os.listdir(tmp_path) if ".tmp" in d]
    got = restore(_state(), 1, str(tmp_path), device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(), _state(1.0)["w"])


def test_latest_scan_ignores_stray_tmp_dirs(tmp_path):
    save(_state(), 3, str(tmp_path))
    (tmp_path / "step_00000009.tmp0-4242-7").mkdir()
    (tmp_path / "LATEST").write_text("9")
    assert latest_step(str(tmp_path)) == 3


def test_concurrent_saves_last_writer_wins(tmp_path):
    errs = []

    def write(v):
        try:
            save(_state(float(v)), 5, str(tmp_path))
        except Exception as exc:                   # pragma: no cover
            errs.append(exc)

    threads = [threading.Thread(target=write, args=(v,)) for v in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    assert latest_step(str(tmp_path)) == 5
    got = restore(_state(), 5, str(tmp_path), device="cpu")["w"].numpy()
    assert float(got[0, 0]) in {float(v) for v in range(6)}
    assert (got == got[0, 0]).all()
    assert read_manifest(5, str(tmp_path))["step"] == 5
    assert not [d for d in os.listdir(tmp_path) if ".tmp" in d]


# --------------------------------------------------------------------------- #
# Thread safety of what the serving threads touch
# --------------------------------------------------------------------------- #

def test_two_threads_loading_a_stale_library_build_it_once(monkeypatch):
    builds = []

    def fake_build(names):
        builds.append(list(names))
        time.sleep(0.2)                 # a slow nvcc: the other thread waits
        return {}

    class FakeLib:
        capsim_cuda_error_string = type("F", (), {})()

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: FakeLib())
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        build.load("flash_attention"))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert builds == [["flash_attention"]]
    assert len(got) == 2 and got[0] is got[1]


def test_service_flush_thread_builds_no_autograd_graph(params, monkeypatch):
    """Grad mode is per thread: a flush on a fresh thread would record a
    graph for parameters that require grad; the service's threads run
    under inference mode, so none is built."""
    from repro_torch.core import predictor as pred_mod

    def requiring(tree):
        if isinstance(tree, dict):
            return {k: requiring(v) for k, v in tree.items()}
        return tree.detach().clone().requires_grad_(True)
    grad_params = requiring(params)
    seen = []
    inner = pred_mod.forward_cached_fused

    def recording(*a, **kw):
        out = inner(*a, **kw)
        seen.append((threading.current_thread().name,
                     torch.is_inference_mode_enabled(), out.grad_fn))
        return out

    monkeypatch.setattr(pred_mod, "forward_cached_fused", recording)
    plain = []
    th = threading.Thread(target=lambda: plain.append(
        torch.is_grad_enabled()))
    th.start()
    th.join(timeout=30)
    assert plain == [True]              # a fresh thread records graphs
    with _service(grad_params) as svc:
        assert svc.submit(_req(0)).result(timeout=300).ok
    assert seen
    for name, inference, grad_fn in seen:
        assert name.startswith("flush-")
        assert inference and grad_fn is None


def test_rt_cache_rows_from_many_threads_stay_consistent(params, table):
    """Threads growing one cache at once (stragglers and the retry on a
    sibling rung), with more threads than cores and a short switch
    interval: no two rows share an id, and every id gathers its own row's
    RT vector."""
    cache = RTCache(params, SMALL_CFG, 16, capacity=8, device="cpu")
    n_threads = 2 * (os.cpu_count() or 4)
    rng = np.random.default_rng(0)
    parts = [table[rng.permutation(table.shape[0])]
             for _ in range(n_threads)]
    ids = [None] * n_threads

    def fill(k):
        ids[k] = np.concatenate([cache.ensure_rows(parts[k][i:i + 5])
                                 for i in range(0, parts[k].shape[0], 5)])

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=fill, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    uniq = np.unique(table, axis=0)
    assert cache.n_rows == uniq.shape[0] + (0 if (uniq == 0).all(1).any()
                                            else 1)
    want = tp.encode_instructions(params, torch.tensor(table), SMALL_CFG)
    order = {r.tobytes(): i for i, r in enumerate(table)}
    for k in range(n_threads):
        rows = [order[r.tobytes()] for r in parts[k]]
        torch.testing.assert_close(cache.table[torch.from_numpy(ids[k])
                                               .long()],
                                   want[rows], rtol=1e-5, atol=1e-6)
