"""The readers of the program's own serving counters: the queue wait,
the worker's empty-queue share, the predictor's copy and launch phases,
and the flash kernel's roofline from the work counted at each launch.
Each on a hand-built record; each finds nothing (None) where the
program has no such family, as a program without these counters
records."""
import pytest

from capsim_bench import cost, harness
from capsim_bench.trace import Trace

CELL = harness.load_cell("paper.serve-mono-c3")
NEW = ("queue_wait_ms.serve", "empty_queue_share.serve", "h2d_ms.serve",
       "launch_ms.serve", "flash_counted_roofline.serve")


def _read(name, rec):
    return harness.reader(name)(rec, CELL)


def _counters():
    """The driver's window deltas, the f32 auditor's (predictor1) rows
    of the ``capsim_predictor_*`` families left out as ``serving_rows``
    leaves them."""
    from capsim_bench.drivers.service_closed_loop import serving_rows
    svc, pred = {"instance": "svc0"}, {"instance": "predictor0"}
    audit = {"instance": "predictor1"}
    span = "capsim_span_seconds_total"
    deltas = {
        "capsim_service_queue_wait_seconds": [(svc, (0.6, 40))],
        span: [({"span": "service.wait", **svc}, 3.0),
               ({"span": "service.collect", **svc}, 0.5),
               ({"span": "service.flush", **svc}, 5.5),
               ({"span": "service.resolve", **svc}, 1.0),
               ({"span": "predict.dispatch", **pred}, 7.0)],
        "capsim_span_seconds": [
            ({"span": "predict.batch", **pred}, (1.0, 100)),
            ({"span": "predict.h2d", **pred}, (0.25, 100)),
            ({"span": "predict.launch", **pred}, (0.8, 100)),
            ({"span": "predict.retire", **pred}, (2.0, 100)),
            ({"span": "predict.h2d", **audit}, (0.5, 10)),
            ({"span": "predict.launch", **audit}, (0.9, 10))],
        "capsim_predictor_clips_total": [(pred, 25600.0), (audit, 40.0)],
    }
    return serving_rows(deltas, "predictor1")


def test_queue_wait_is_the_mean_wait_in_ms():
    assert _read("queue_wait_ms.serve", {"counters": _counters()}) \
        == pytest.approx(15.0)


def test_empty_queue_share_is_wait_over_the_worker_spans():
    # 3.0 s of wait over 10.0 s of the four worker spans; predict.* apart
    rec = {"counters": _counters(), "trace": Trace([], {}, {}, 12.0)}
    assert _read("empty_queue_share.serve", rec) == pytest.approx(30.0)


def test_empty_queue_share_clips_the_wait_to_the_traced_window():
    # the counters also hold 100 s of waiting after the traced 10.5 s: the
    # wait counts as the window's 3.5 s outside the other three spans
    counters = _counters()
    counters["capsim_span_seconds_total"].append(
        ({"span": "service.wait", "instance": "svc0"}, 100.0))
    rec = {"counters": counters, "trace": Trace([], {}, {}, 10.5)}
    assert _read("empty_queue_share.serve", rec) \
        == pytest.approx(100.0 * 3.5 / 10.5)


def test_phase_readers_are_the_mean_of_their_phase_in_ms():
    rec = {"counters": _counters()}
    assert _read("h2d_ms.serve", rec) == pytest.approx(2.5)
    assert _read("launch_ms.serve", rec) == pytest.approx(8.0)


def test_phase_readers_leave_out_the_auditor_and_idle_predictors():
    """Only the predictors that counted clips in the window are read: a
    rung that served none adds nothing, and with no serving rung the
    readers find nothing."""
    counters = _counters()
    idle = {"instance": "predictor2"}
    counters["capsim_span_seconds"].append(
        ({"span": "predict.launch", **idle}, (5.0, 1)))
    counters["capsim_predictor_clips_total"].append((idle, 0.0))
    rec = {"counters": counters}
    assert _read("launch_ms.serve", rec) == pytest.approx(8.0)
    counters["capsim_predictor_clips_total"] = [
        (labels, d) for labels, d in counters["capsim_predictor_clips_total"]
        if labels["instance"] != "predictor0"]
    assert _read("h2d_ms.serve", rec) is None


def _flash_rec(extra_dtype_rows=()):
    # bf16 flash: 2e12 FLOPs on the compute side and 6.7e9 bytes on the
    # memory side: 2e12/989e12 + 6.7e9/3.35e12 s of least time
    fl = {"kernel": "flash_attention", "dtype": "bfloat16"}
    flops = [({**fl, "bound": "ops"}, 2e12), ({**fl, "bound": "bytes"}, 1e9)]
    nbytes = [({**fl, "bound": "ops"}, 1e9), ({**fl, "bound": "bytes"}, 6.7e9)]
    for dt in extra_dtype_rows:
        other = {"kernel": "flash_attention", "dtype": dt}
        flops.append(({**other, "bound": "ops"}, 5e13))
        nbytes.append(({**other, "bound": "bytes"}, 5e12))
    weighted = {"kernel": "weighted_attention", "dtype": "bfloat16",
                "bound": "ops"}
    flops.append((weighted, 9e13))
    # 10 ms of bf16 flash on the device, 50 ms of f32 flash and a GEMM
    ops = [("void capsim_fa::fa_fwd_bf16<32, false>(Args)", 0, 4_000_000,
            1),
           ("void capsim_fa::fa_fwd_bf16<32, false>(Args)", 5_000_000,
            11_000_000, 2),
           ("void capsim_fa::fa_fwd_f32<32, false>(Args)", 20_000_000,
            70_000_000, 3),
           ("gemm", 70_000_000, 90_000_000, 4)]
    return {"counters": {"capsim_kernel_flops_total": flops,
                         "capsim_kernel_bytes_total": nbytes},
            "trace": Trace(ops, {}, {}, window_s=0.1)}


def test_counted_roofline_is_least_time_over_the_kernels_device_time():
    least = 2e12 / cost.PEAK_FLOPS["bfloat16"] + 6.7e9 / cost.PEAK_BYTES_PER_S
    assert _read("flash_counted_roofline.serve", _flash_rec()) \
        == pytest.approx(100.0 * least / 10e-3)


def test_counted_roofline_ignores_other_dtypes():
    assert _read("flash_counted_roofline.serve",
                 _flash_rec(("float32",))) \
        == _read("flash_counted_roofline.serve", _flash_rec())


@pytest.mark.parametrize("name", NEW)
def test_each_reader_finds_nothing_without_its_family(name):
    rec = _flash_rec()
    rec["counters"] = {}
    assert _read(name, rec) is None
    assert _read(name, {}) is None


def test_the_new_readers_find_nothing_in_a_parent_record():
    """A record of the program before these counters: the predictor's
    dispatch span and clip counter, no phase spans, no kernel counters,
    no worker spans."""
    rec = {"counters": {
        "capsim_span_seconds_total": [
            ({"span": "predict.dispatch", "instance": "predictor0"}, 7.0)],
        "capsim_span_seconds": [
            ({"span": "predict.dispatch", "instance": "predictor0"},
             (7.0, 30))],
        "capsim_predictor_clips_total": [({"instance": "predictor0"}, 9.0)],
    }, "trace": _flash_rec()["trace"]}
    for name in NEW:
        assert _read(name, rec) is None, name


def test_the_new_metrics_are_listed_for_the_serve_cell_alone():
    names = [m["name"] for m in CELL.per_layer]
    assert all(n in names for n in NEW)
    for cell in ("paper.train-b256", "mc4.train-peer-b32"):
        train = [m["name"] for m in harness.load_cell(cell).per_layer]
        assert not set(NEW) & set(train)
