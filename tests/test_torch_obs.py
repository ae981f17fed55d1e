"""The port's observability layer, ``repro_torch.obs``.

The contracts of ``tests/test_obs.py`` held by the port (thread-safe
counters, Prometheus exposition, the ring, the disabled tracer, the
flight recorder on a real demotion), and what the port adds: a span is
a ``torch.profiler`` user-annotation range on the profiler's own clock
while a profiler records, and no torch call while none does; the
tracer's Chrome export is in epoch microseconds; the service and the
predictor record their spans, the queue wait and the dispatch phases;
the RT cache its index and dedupe spans; each kernel launch on the card
its FLOPs and bytes on its side of the roofline's ridge.  Imports no
JAX.
"""
import json
import sys
import threading
import time
import types
import urllib.request

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
from torch.autograd import profiler as autograd_profiler  # noqa: E402

from repro_torch import obs as obs_mod  # noqa: E402
from repro_torch.configs.capsim import config  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core import predictor as tp  # noqa: E402
from repro_torch.core.engine_config import (EngineConfig,  # noqa: E402
                                            ObservabilityConfig)
from repro_torch.core.rt_cache import RTCache  # noqa: E402
from repro_torch.core.standardize import build_vocab  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.obs import (NULL_SPAN, REGISTRY, MetricsRegistry,  # noqa: E402
                             Observability, Tracer, epoch_ns)
from repro_torch.obs.exporter import serve_metrics  # noqa: E402
from repro_torch.obs.metrics import CounterGroup  # noqa: E402
from repro_torch.serving import (FaultInjector, Request,  # noqa: E402
                                 ServiceSLA, SimulationService)
from repro_torch.serving import service as service_mod  # noqa: E402
from repro_torch.serving.service import ServiceSnapshot  # noqa: E402

VOCAB = build_vocab()
SMALL_CFG = config().replace(d_model=32, head_dim=8, d_ff=64,
                             dtype="float32")


@pytest.fixture(scope="module")
def params():
    return tp.init_params(SMALL_CFG, 0, "cpu")


def _req(i, n=4):
    rng = np.random.RandomState(i)
    tok = rng.randint(0, VOCAB.size, (n, 128, SMALL_CFG.clip_tokens)
                      ).astype(np.int32)
    ctx = rng.randint(0, VOCAB.size, (n, SMALL_CFG.context_tokens)
                      ).astype(np.int32)
    return Request(i, tok, ctx, np.ones((n, 128), np.float32))


# --------------------------------------------------------------------------- #
# Metrics registry
# --------------------------------------------------------------------------- #

def test_counter_gauge_histogram_basics():
    m = MetricsRegistry()
    c = m.counter("c_total", "c", ("k",)).labels(k="a")
    c.inc()
    c.inc(2.5)
    assert m.value("c_total", k="a") == 3.5
    assert m.value("c_total", k="missing") == 0.0
    g = m.gauge("g", "g", ()).labels()
    g.set(7)
    g.dec(3)
    assert m.value("g") == 4
    h = m.histogram("h_seconds", "h", (), buckets=(1.0, 10.0)).labels()
    h.observe(0.5)
    h.observe(5.0)
    h.observe(50.0)
    [(labels, (total, count))] = m.collect("h_seconds")
    assert count == 3 and total == 55.5


def test_counter_negative_inc_rejected():
    m = MetricsRegistry()
    c = m.counter("n_total", "n", ()).labels()
    with pytest.raises(ValueError):
        c.inc(-1)
    group = CounterGroup(c, m.counter("o_total", "o", ()).labels())
    with pytest.raises(ValueError):
        group.inc(1, -1)
    assert m.value("n_total") == 0.0


def test_registration_idempotent_but_kind_checked():
    m = MetricsRegistry()
    f1 = m.counter("x_total", "x", ("a",))
    f2 = m.counter("x_total", "x", ("a",))
    assert f1 is f2
    with pytest.raises(ValueError):
        m.gauge("x_total", "x", ("a",))
    with pytest.raises(ValueError):
        m.counter("x_total", "x", ("b",))


def test_registry_thread_safety():
    """N writers hammering one counter, one histogram and one counter
    group concurrently, with a short switch interval: the final totals
    must be exact (the registry lock is real)."""
    m = MetricsRegistry()
    c = m.counter("race_total", "r", ("w",))
    h = m.histogram("race_seconds", "r", ())
    group = CounterGroup(m.counter("ga_total", "a", ()).labels(),
                         m.counter("gb_total", "b", ()).labels())
    n_threads, n_iter = 8, 2_000
    barrier = threading.Barrier(n_threads)

    def work(w):
        handle = c.labels(w=str(w % 2))       # two shared series
        hh = h.labels()
        barrier.wait()
        for _ in range(n_iter):
            handle.inc()
            hh.observe(1.0)
            group.inc(1.0, 2.0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = (m.value("race_total", w="0")
             + m.value("race_total", w="1"))
    assert total == n_threads * n_iter
    [(_, (hsum, hcount))] = m.collect("race_seconds")
    assert hcount == n_threads * n_iter and hsum == float(hcount)
    assert m.value("ga_total") == n_threads * n_iter
    assert m.value("gb_total") == 2 * n_threads * n_iter


def test_counter_group_needs_one_registry():
    a = MetricsRegistry().counter("a_total", "a", ()).labels()
    b = MetricsRegistry().counter("b_total", "b", ()).labels()
    with pytest.raises(ValueError):
        CounterGroup(a, b)


def test_prometheus_exposition_golden():
    """Exact text-format golden: HELP/TYPE lines, escaped label values,
    cumulative histogram buckets with +Inf, _sum and _count."""
    m = MetricsRegistry()
    m.counter("req_total", 'requests with "quotes"\nand newline',
              ("tier",)).labels(tier="fused").inc(3)
    m.gauge("depth", "queue depth", ()).labels().set(2.5)
    h = m.histogram("lat_seconds", "latency", (),
                    buckets=(0.1, 1.0)).labels()
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    got = m.render_prometheus()
    want = "\n".join([
        '# HELP depth queue depth',
        '# TYPE depth gauge',
        'depth 2.5',
        '# HELP lat_seconds latency',
        '# TYPE lat_seconds histogram',
        'lat_seconds_bucket{le="0.1"} 1',
        'lat_seconds_bucket{le="1"} 2',
        'lat_seconds_bucket{le="+Inf"} 3',
        'lat_seconds_sum 5.55',
        'lat_seconds_count 3',
        '# HELP req_total requests with "quotes"\\nand newline',
        '# TYPE req_total counter',
        'req_total{tier="fused"} 3',
    ]) + "\n"
    assert got == want


def test_snapshot_is_json_roundtrippable():
    m = MetricsRegistry()
    m.counter("a_total", "a", ("x",)).labels(x="1").inc()
    m.histogram("b_seconds", "b", ()).labels().observe(0.2)
    snap = m.snapshot()
    assert json.loads(json.dumps(snap)) == snap


def test_exporter_serves_registry():
    m = MetricsRegistry()
    m.counter("served_total", "s", ()).labels().inc(5)
    server = serve_metrics(m, port=0)
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
        assert "served_total 5" in body
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert r.read() == b"ok\n"
    finally:
        server.shutdown()


# --------------------------------------------------------------------------- #
# Tracer and spans
# --------------------------------------------------------------------------- #

def test_disabled_tracer_is_free():
    """Disabled tracing returns THE null span singleton — no per-call
    allocation, no ring append."""
    tr = Tracer(enabled=False)
    assert tr.span("x") is NULL_SPAN
    assert tr.span("y", args={"a": 1}) is NULL_SPAN
    with tr.span("z") as sp:
        pass
    assert sp.seconds == 0.0
    tr.instant("ev")
    tr.record("pre", 0, 100)
    assert tr.spans() == []


def test_ring_wraparound_keeps_last_n():
    tr = Tracer(ring_size=8, enabled=True)
    for i in range(20):
        tr.record(f"s{i}", start_ns=i * 1000, dur_ns=10)
    spans = tr.spans()
    assert len(spans) == 8
    assert [s.name for s in spans] == [f"s{i}" for i in range(12, 20)]


def test_chrome_export_shape():
    tr = Tracer(enabled=True)
    with tr.span("outer", args={"k": "v"}):
        with tr.span("inner"):
            pass
    tr.instant("mark")
    doc = tr.export_chrome()
    events = doc["traceEvents"]
    names = [e["name"] for e in events]
    assert names == ["inner", "outer", "mark"]   # inner closes first
    outer = events[1]
    assert outer["ph"] == "X" and outer["args"]["k"] == "v"
    assert events[0]["args"]["depth"] == 1       # nested under outer
    assert events[2]["ph"] == "i"
    json.dumps(doc)                              # must be serializable


def test_chrome_export_in_epoch_microseconds():
    """``ts`` is microseconds since the Unix epoch: between two
    ``time.time_ns()`` reads around the span, and an instant's too."""
    tr = Tracer(enabled=True)
    before = time.time_ns()
    time.sleep(0.001)            # the epoch offset is read to within ~1 µs
    with tr.span("work"):
        time.sleep(0.002)
    tr.instant("mark")
    time.sleep(0.001)
    after = time.time_ns()
    work, mark = tr.export_chrome()["traceEvents"]
    for ev in (work, mark):
        assert before / 1e3 <= ev["ts"] <= after / 1e3
    assert work["ts"] + work["dur"] <= after / 1e3
    assert work["dur"] >= 2000.0


def test_obs_span_records_metrics_and_trace(tmp_path):
    obs = Observability.from_config(
        ObservabilityConfig(trace=True, trace_ring=16))
    with obs.span("unit.work", instance="t0") as sp:
        x = sum(range(100))
    assert x == 4950 and sp.seconds > 0
    assert obs.metrics.value("capsim_span_seconds_total",
                             span="unit.work", instance="t0") \
        == pytest.approx(sp.seconds)
    [rec] = [r for r in obs.tracer.spans() if r.name == "unit.work"]
    assert rec.args["instance"] == "t0"
    assert rec.dur_ns * 1e-9 == pytest.approx(sp.seconds)
    out = tmp_path / "trace.json"
    obs.tracer.dump(str(out))
    assert json.loads(out.read_text())["traceEvents"]


def _user_ranges(prof, name):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name() == name and e.is_user_annotation()]


def test_span_is_a_profiler_range_on_its_clock():
    """Under a recording profiler a span is a user-annotation range of
    its name, whose start lies between two ``time.time_ns()`` reads
    around it, and the tracer's record of the span lies there too."""
    obs = Observability(metrics=MetricsRegistry(),
                        tracer=Tracer(enabled=True))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        before = time.time_ns()
        time.sleep(0.001)        # the epoch offset is read to within ~1 µs
        with obs.span("unit.ranged", instance="t2"):
            torch.ones(4).sum()
        time.sleep(0.001)
        after = time.time_ns()
    [ev] = _user_ranges(prof, "unit.ranged")
    assert before <= ev.start_ns() <= after
    assert ev.start_ns() + ev.duration_ns() <= after
    [rec] = obs.tracer.spans()
    assert before <= rec.start_ns and rec.start_ns + rec.dur_ns <= after
    # the range encloses the span's own reading
    assert ev.duration_ns() >= rec.dur_ns


def test_span_without_profiler_makes_no_torch_call(monkeypatch):
    """With no profiler recording a span reads one bool and constructs
    no ``record_function``; under one it constructs one a span."""
    made = []

    class Counting(autograd_profiler.record_function):
        def __init__(self, name, args=None):
            made.append(name)
            super().__init__(name, args)

    monkeypatch.setattr(autograd_profiler, "record_function", Counting)
    assert autograd_profiler._is_profiler_enabled is False
    obs = Observability(metrics=MetricsRegistry())
    for _ in range(3):
        with obs.span("unit.quiet"):
            pass
    with obs_mod.span("unit.quiet.default"):
        pass
    assert made == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("unit.loud"):
            pass
    assert made == ["unit.loud"]


def test_module_span_writes_the_default_registry():
    before = REGISTRY.value("capsim_span_seconds_total",
                            span="unit.module", instance="")
    with obs_mod.span("unit.module") as sp:
        time.sleep(0.001)
    after = REGISTRY.value("capsim_span_seconds_total",
                           span="unit.module", instance="")
    assert after - before == pytest.approx(sp.seconds)
    assert obs_mod.DEFAULT.metrics is REGISTRY


def test_epoch_clock_is_monotonic_and_on_the_epoch():
    before = time.time_ns()
    a = epoch_ns()
    b = epoch_ns()
    after = time.time_ns()
    assert before - 1_000_000 <= a <= b <= after + 1_000_000


def test_train_step_and_flash_backward_are_spans():
    """The train step's parts and the flash backward are spans of the
    names the benchmark's train metrics read."""
    from repro_torch.training.train_loop import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)

    def loss_fn(p, batch):
        return ((p["w"] * batch["x"]) ** 2).mean(), {}

    state = {"params": {"w": torch.ones(4)}}
    tcfg = TrainConfig(base_lr=0.1, total_steps=2)
    state = init_train_state(state["params"], tcfg)
    step = make_train_step(loss_fn, tcfg)
    names = ("train/forward", "train/backward", "train/update",
             "flash_attention_backward")
    before = {n: REGISTRY.collect("capsim_span_seconds", span=n)
              for n in names}
    step(state, {"x": torch.arange(4.0)})
    q = torch.randn(1, 4, 1, 16, requires_grad=True)
    fa_ops.flash_attention_backward(q, q, q, None, torch.ones(1, 4, 1, 16))
    for n in names:
        [(_, (_, count))] = REGISTRY.collect("capsim_span_seconds", span=n)
        was = before[n][0][1][1] if before[n] else 0
        assert count == was + 1, n


# --------------------------------------------------------------------------- #
# The service, the predictor and the RT cache
# --------------------------------------------------------------------------- #

def _series(m, family, **match):
    return {tuple(sorted(labels.items())): v
            for labels, v in m.collect(family, **match)}


def test_service_records_spans_queue_wait_and_phases(params):
    """A CPU service run records every ``service.*`` span, one queue
    wait a served request, and each of the predictor's phases."""
    sla = ServiceSLA(watchdog_s=120.0, check_every=0)
    svc = SimulationService(params, SMALL_CFG,
                            EngineConfig(batch_size=8, rt_cache=False),
                            sla=sla, device="cpu")
    m = svc.obs.metrics
    with svc:
        tickets = [svc.submit(_req(i, n=3 + i)) for i in range(5)]
        results = [t.result(timeout=300) for t in tickets]
        time.sleep(0.1)                      # the worker waits again
    assert all(r.ok for r in results)
    spans = {labels["span"]: v for labels, v in
             m.collect("capsim_span_seconds", instance=svc.instance)}
    for name in ("service.wait", "service.collect", "service.flush",
                 "service.resolve"):
        assert spans[name][1] >= 1, name
    assert spans["service.flush"][1] == spans["service.resolve"][1]
    [(_, (wait_s, n_wait))] = m.collect("capsim_service_queue_wait_seconds",
                                        instance=svc.instance)
    assert n_wait == len(results)
    assert 0.0 <= wait_s <= sum(r.queue_seconds for r in results) + 1e-9
    backend = svc._tiers[-1]._backend
    phases = {labels["span"]: v for labels, v in
              m.collect("capsim_span_seconds", instance=backend.instance)}
    n_batches = backend.stats.n_batches
    assert n_batches >= 1
    for phase in ("batch", "h2d", "launch", "retire", "dispatch"):
        assert phases[f"predict.{phase}"][1] == n_batches, phase
    # a dispatch's three phases lie inside its span
    assert sum(phases[f"predict.{p}"][0] for p in ("batch", "h2d", "launch")) \
        <= phases["predict.dispatch"][0]
    assert not m.collect("capsim_predictor_bucket_occupancy")
    assert not m.collect("capsim_predictor_phase_seconds")


def test_dispatch_pads_with_zero_rows_of_each_dtype():
    """The rows a dispatch pads with (inside its ``predict.batch``
    phase): zeros of each array's dtype appended up to the bucket, the
    real rows unchanged."""
    tok = np.arange(1, 7, dtype=np.int32).reshape(3, 2)
    mask = np.ones((3, 4), np.float32)
    ptok, pmask = engine_mod._pad_rows((tok, mask), 8)
    assert ptok.shape == (8, 2) and pmask.shape == (8, 4)
    assert ptok.dtype == np.int32 and pmask.dtype == np.float32
    np.testing.assert_array_equal(ptok[:3], tok)
    np.testing.assert_array_equal(pmask[:3], mask)
    assert not ptok[3:].any() and not pmask[3:].any()


def test_service_intervals_ignore_wall_clock_steps(params, monkeypatch):
    """``queue_seconds``/``service_seconds`` are monotonic intervals:
    a wall clock stepping back an hour a read moves none of them."""
    stepped = [time.time()]

    def stepping_time():
        stepped[0] -= 3600.0
        return stepped[0]

    monkeypatch.setattr(service_mod, "time", types.SimpleNamespace(
        time=stepping_time, perf_counter=time.perf_counter,
        sleep=time.sleep))
    sla = ServiceSLA(watchdog_s=120.0, check_every=0)
    with SimulationService(params, SMALL_CFG,
                           EngineConfig(batch_size=8, rt_cache=False),
                           sla=sla, device="cpu") as svc:
        res = svc.submit(_req(1)).result(timeout=300)
    assert res.ok
    assert 0.0 <= res.queue_seconds < 300.0
    assert 0.0 < res.service_seconds < 300.0


def test_rt_index_records_index_and_dedupe_spans(params):
    obs = Observability(metrics=MetricsRegistry())
    cache = RTCache(params, SMALL_CFG, device="cpu", obs=obs)
    ids = cache.index_clips(_req(3, n=2).clip_tokens)
    assert ids.shape == (2, 128)
    spans = {labels["span"]: v for labels, v in
             obs.metrics.collect("capsim_span_seconds",
                                 instance=cache.instance)}
    assert spans["rt.index"][1] == 1 and spans["rt.dedupe"][1] == 1
    assert spans["rt.build"][1] == 1
    assert spans["rt.dedupe"][0] <= spans["rt.index"][0]


# --------------------------------------------------------------------------- #
# Kernel costs
# --------------------------------------------------------------------------- #

# (shape args of attention_cost, dtype, FLOPs and bytes counted by hand,
#  the side of the ridge: 989e12 / 3.35e12 = 295.2 FLOP/byte in bf16,
#  67e12 / 3.35e12 = 20 in f32)
BOUND_CASES = [
    # causal-free prefill (1, 4096, 32, 128): 4·32·4096²·128 FLOPs over
    # q, k, v, o of 4096·32·128 bf16 each; 2048 FLOP/byte
    ((1, 4096, 4096, 32, 128, 2, False), torch.bfloat16,
     274877906944.0, 134217728.0, "ops"),
    # the instruction encoder's pass (4096, 16, 4, 32), masked:
    # 4·4096·4·16²·32 FLOPs; 4·(4096·16·4·32)·2 + 4·4096·16 bytes
    ((4096, 16, 16, 4, 32, 2, True), torch.bfloat16,
     536870912.0, 67371008.0, "bytes"),
    # block self-attention (256, 360, 4, 32): 90 FLOP/byte in f32 ...
    ((256, 360, 360, 4, 32, 4, False), torch.float32,
     16986931200.0, 188743680.0, "ops"),
    # ... and 180 in bf16, under the bf16 ridge
    ((256, 360, 360, 4, 32, 2, False), torch.bfloat16,
     16986931200.0, 94371840.0, "bytes"),
]


@pytest.mark.parametrize("args,dtype,flops,nbytes,side", BOUND_CASES)
def test_kernel_cost_bound_labels(args, dtype, flops, nbytes, side):
    assert fa_ops.attention_cost(*args) == (flops, nbytes)
    assert cost.bound(flops, nbytes, dtype) == side
    kernel = f"unit_{args[0]}_{args[5]}"
    dt = str(dtype).removeprefix("torch.")
    cost.launched(kernel, dtype, flops, nbytes)
    cost.launched(kernel, dtype, flops, nbytes)
    assert REGISTRY.value(cost.FLOPS_TOTAL, kernel=kernel, dtype=dt,
                          bound=side) == 2 * flops
    assert REGISTRY.value(cost.BYTES_TOTAL, kernel=kernel, dtype=dt,
                          bound=side) == 2 * nbytes
    other = "bytes" if side == "ops" else "ops"
    assert REGISTRY.value(cost.FLOPS_TOTAL, kernel=kernel, dtype=dt,
                          bound=other) == 0


def test_least_time_from_the_counters_is_the_rooflines():
    """Σ_ops flops/peak + Σ_bytes bytes/bandwidth over the labelled
    counters equals Σ max(flops/peak, bytes/bandwidth) over launches."""
    from repro_torch.launch import roofline
    want = 0.0
    for args, dtype, flops, nbytes, _ in BOUND_CASES:
        cost.launched("unit_least", dtype, flops, nbytes)
        want += max(flops / cost.PEAK_FLOPS[dtype], nbytes / roofline.HBM_BW)
    got = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).removeprefix("torch.")
        got += REGISTRY.value(cost.FLOPS_TOTAL, kernel="unit_least",
                              dtype=dt, bound="ops") / cost.PEAK_FLOPS[dtype]
        got += REGISTRY.value(cost.BYTES_TOTAL, kernel="unit_least",
                              dtype=dt, bound="bytes") / roofline.HBM_BW
    assert got == pytest.approx(want, rel=1e-12)


def test_cpu_and_meta_routes_count_no_launch():
    """Only a launch on the card adds to the registry: the plain
    version on the CPU and the meta route (which reports to
    ``count_kernels``) do not."""
    def counted():
        return sum(v for _, v in REGISTRY.collect(
            cost.FLOPS_TOTAL, kernel="flash_attention"))

    before = counted()
    q = torch.randn(2, 16, 4, 32)
    fa_ops.flash_attention(q, q, q)
    with cost.count_kernels() as costs:
        fa_ops.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    assert costs.calls == {"flash_attention": 1}
    assert costs.flops["flash_attention"] == fa_ops.attention_cost(
        2, 16, 16, 4, 32, 4, False)[0]
    assert counted() == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_launch_counts_its_attention_cost(dtype):
    """On the card a flash launch adds one to the wrapper's launches, and
    the FLOPs and bytes of ``attention_cost`` of its shape on its side of
    the ridge to the registry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    tdt = getattr(torch, dtype)
    B, S, H, D = 64, 16, 4, 32
    q = torch.randn(B, S, H, D, device="cuda", dtype=tdt)
    mask = torch.ones(B, S, device="cuda")
    flops, nbytes = fa_ops.attention_cost(B, S, S, H, D, q.element_size(),
                                          True)
    side = cost.bound(flops, nbytes, tdt)
    before = (fa_ops.flash_attention.launches,
              REGISTRY.value(cost.FLOPS_TOTAL, kernel="flash_attention",
                             dtype=dtype, bound=side),
              REGISTRY.value(cost.BYTES_TOTAL, kernel="flash_attention",
                             dtype=dtype, bound=side))
    fa_ops.flash_attention(q, q, q, kv_mask=mask)
    torch.cuda.synchronize()
    after = (fa_ops.flash_attention.launches,
             REGISTRY.value(cost.FLOPS_TOTAL, kernel="flash_attention",
                            dtype=dtype, bound=side),
             REGISTRY.value(cost.BYTES_TOTAL, kernel="flash_attention",
                            dtype=dtype, bound=side))
    assert (after[0] - before[0], after[1] - before[1],
            after[2] - before[2]) == (1, flops, nbytes)


# --------------------------------------------------------------------------- #
# ServiceSnapshot and the flight recorder on the real degradation path
# --------------------------------------------------------------------------- #

def test_service_snapshot_roundtrip_and_stable_keys(params):
    svc = SimulationService(params, SMALL_CFG, EngineConfig(batch_size=8),
                            sla=ServiceSLA(), device="cpu")
    d = svc.snapshot().to_dict()
    # the frozen key set benches and the CI chaos leg parse
    assert list(d) == [
        "submitted", "statuses", "current_tier", "backoff",
        "healthy_streak", "queued", "queued_clips", "clips_per_s_ewma",
        "n_flushes", "tiers", "faults_fired",
        "abandoned_flush_threads", "abandoned_flush_threads_total"]
    assert list(d["tiers"]) == ["fused_int8", "fused", "rt", "monolithic"]
    assert list(d["tiers"]["rt"]) == [
        "name", "flushes", "clips", "demotions", "promotions",
        "nan_trips", "relerr_trips", "fault_trips", "watchdog_trips",
        "persist_failures"]
    back = ServiceSnapshot.from_dict(json.loads(json.dumps(d)))
    assert back.to_dict() == d
    with pytest.raises(ValueError):
        ServiceSnapshot.from_dict({**d, "bogus": 1})
    assert svc.stats() == svc.snapshot().to_dict()


def test_nan_demotion_writes_consistent_postmortem(params, tmp_path):
    """A forced NaN on the top tier must demote AND dump a postmortem
    whose event ring agrees with the snapshot counters it embeds."""
    flight_dir = tmp_path / "flight"
    config_ = EngineConfig(
        batch_size=8, faults={"nan_output": 1.0},
        observability=ObservabilityConfig(flight_dir=str(flight_dir),
                                          trace=True))
    inj = FaultInjector({"nan_output": 1.0}, seed=3)
    inj.set_enabled(False)
    sla = ServiceSLA(watchdog_s=120.0, promote_after=1, check_every=0)
    with SimulationService(params, SMALL_CFG, config_, sla=sla,
                           fault_injector=inj, device="cpu") as svc:
        svc.prewarm(_req(0, n=2))
        assert svc.submit(_req(1)).result(timeout=300).status == "ok"
        inj.set_enabled(True)                 # every retire goes NaN now
        res = svc.submit(_req(2)).result(timeout=300)
        inj.set_enabled(False)
        assert res.status in ("degraded", "failed")
        snap = svc.snapshot()
    fl = svc.obs.flight
    assert fl is not None and fl.postmortems
    post = json.loads(open(fl.postmortems[-1]).read())
    assert post["schema_version"] == 1
    assert post["reason"].startswith("demote_")
    assert post["metrics"] is not None
    # ledger consistency: transition events vs embedded snapshot counters
    tiers = post["state"]["tiers"]
    names = list(tiers)
    exp_demote = sum(tiers[n]["demotions"] for n in names[:-1])
    ev = [e for e in post["events"] if e["kind"] == "tier_transition"]
    got_demote = sum(1 for e in ev if e["reason"] != "promotion")
    assert got_demote == exp_demote > 0
    # the nan reason made it into both ledgers
    assert any(e["reason"] == "nan" for e in ev)
    assert sum(t["nan_trips"] for t in tiers.values()) > 0
    # the final live snapshot counts at least as many demotions
    live = sum(t["demotions"] for t in snap.tiers.values())
    assert live >= exp_demote
    # the postmortem's spans are on the epoch clock
    assert post["spans"]
    now = time.time_ns()
    assert all(now - 600e9 < s["start_ns"] <= now for s in post["spans"])


def test_faults_counter_lands_in_registry():
    from repro_torch.serving.faults import FAULTS_INJECTED_TOTAL
    before = REGISTRY.value(FAULTS_INJECTED_TOTAL, kind="device_error")
    inj = FaultInjector({"device_error": 1.0}, seed=0)
    assert inj.maybe("device_error")
    after = REGISTRY.value(FAULTS_INJECTED_TOTAL, kind="device_error")
    assert after == before + 1
