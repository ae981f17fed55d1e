"""The metric arithmetic: rates over all work and all time, the tail
over all requests, shares from a synthetic trace, counter deltas."""
import math

import pytest

from capsim_bench import harness
from capsim_bench.trace import Trace


def _read(name, rec, cell=None):
    return harness.reader(name)(rec, cell)


def test_serve_rate_is_all_clips_over_the_window():
    rec = {"clips_in_window": 3000, "window_s": 30.0}
    assert _read("serve_clips_per_s", rec) == 100.0


def test_train_rate_is_steps_times_batch_over_the_window():
    rec = {"steps": 45, "batch": 256, "window_s": 30.5}
    assert _read("train_clips_per_s", rec) == pytest.approx(45 * 256 / 30.5)


def test_p95_over_every_request_and_failures_miss_every_limit():
    lat = [i / 1000.0 for i in range(1, 101)]          # 1..100 ms
    assert _read("serve_p95_ms", {"latencies_s": lat}) == pytest.approx(95)
    # six of a hundred failed: the 95th percentile is a failure
    bad = lat[:94] + [math.inf] * 6
    assert _read("serve_p95_ms", {"latencies_s": bad}) == 1e9
    assert harness.percentile([5.0], 95) == 5.0


def _trace():
    # ns: kernels at [0, 10), [5, 20), [40, 50) in a 100 ns window; the
    # host launched them at 1, 2 and 30, inside ranges fwd [0, 3), bwd
    # [25, 35)
    ops = [("void fa_fwd_bf16<32, false>(Args)", 0, 10, 1),
           ("gemm", 5, 20, 2),
           ("void fa_fwd_bf16<32, true>(Args)", 40, 50, 3)]
    return Trace(ops, {1: 1, 2: 2, 3: 30},
                 {"train/forward": [(0, 3)], "train/backward": [(25, 35)]},
                 window_s=100e-9)


def test_busy_is_the_union_of_device_intervals_and_idle_its_rest():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(30e-9)
    assert _read("idle_share.serve", {"trace": tr}) == pytest.approx(70.0)
    assert _read("idle_share.train", {"trace": tr}) == pytest.approx(70.0)
    assert [g[:2] for g in tr.gaps()] == [(20, 40)]


def test_kernels_are_attributed_to_the_range_that_launched_them():
    tr = _trace()
    assert [o[0] for o in tr.kernels_in_range("train/forward")] == [
        "void fa_fwd_bf16<32, false>(Args)", "gemm"]
    assert _read("forward_ms.train", {"trace": tr}) == pytest.approx(25e-6)
    assert _read("backward_ms.train", {"trace": tr}) == pytest.approx(10e-6)


def test_breakdown_lists_device_ops_and_idle_gaps():
    b = _trace().breakdown()
    assert b["device_ops"][0] == ["gemm", pytest.approx(15e-9)]
    assert len(b["idle_gaps"]) == 1 and b["idle_gaps"][0][1] == \
        pytest.approx(20e-9)


def test_readers_find_nothing_without_a_trace():
    for name in ("idle_share.serve", "forward_ms.train", "mfu.serve",
                 "flash_roofline.train", "flush_clips.serve"):
        assert _read(name, {}) is None


def test_counter_deltas_and_the_service_readers():
    from capsim_bench.drivers.service_closed_loop import counter_deltas
    lab = {"instance": "predictor0"}
    before = {"capsim_predictor_clips_total": {"kind": "counter", "values": [
        {"labels": lab, "value": 100.0}]}}
    after = {
        "capsim_predictor_clips_total": {"kind": "counter", "values": [
            {"labels": lab, "value": 1100.0}]},
        "capsim_predictor_pad_rows_total": {"kind": "counter", "values": [
            {"labels": lab, "value": 24.0}]},
        "capsim_service_flush_seconds": {"kind": "histogram", "values": [
            {"labels": {"instance": "svc0", "tier": "monolithic"},
             "sum": 2.0, "count": 4, "buckets": []}]}}
    d = counter_deltas(before, after)
    rec = {"counters": d}
    assert _read("flush_clips.serve", rec) == 250.0
    assert _read("pad_share.serve", rec) == pytest.approx(2400 / 1024)


def test_the_auditor_is_left_out_of_the_serving_rung():
    from capsim_bench.drivers.service_closed_loop import serving_rows
    rung, audit = {"instance": "predictor0"}, {"instance": "predictor1"}
    deltas = {
        "capsim_predictor_clips_total": [(rung, 1000.0), (audit, 4.0)],
        "capsim_predictor_pad_rows_total": [(rung, 24.0), (audit, 4.0)],
        "capsim_service_flush_seconds": [
            ({"instance": "svc0", "tier": "monolithic"}, (2.0, 4))]}
    rec = {"counters": serving_rows(deltas, "predictor1")}
    assert _read("flush_clips.serve", rec) == 250.0
    assert _read("pad_share.serve", rec) == pytest.approx(2400 / 1024)
    assert serving_rows(deltas, None) == deltas


class _Ev:
    def __init__(self, name, dev, start, dur, corr, ann=False):
        self.v = (name, dev, start, dur, corr, ann)

    def name(self):
        return self.v[0]

    def device_type(self):
        return f"DeviceType.{self.v[1]}"

    def start_ns(self):
        return self.v[2]

    def duration_ns(self):
        return self.v[3]

    def correlation_id(self):
        return self.v[4]

    def is_user_annotation(self):
        return self.v[5]


def test_reduce_kineto_events():
    from capsim_bench.trace import reduce_events
    evs = [_Ev("train/forward", "CPU", 0, 100, 1, True),
           _Ev("train/forward", "CUDA", 10, 50, 1, True),   # device copy
           _Ev("aten::mm", "CPU", 5, 20, 1330),             # host op
           _Ev("cudaLaunchKernelExC", "CPU", 6, 2, 1330),
           _Ev("Lazy Function Loading", "CPU", 6, 1, 1331),
           _Ev("gemm", "CUDA", 10, 5, 1330),
           _Ev("Memcpy DtoH (Device -> Pageable)", "CUDA", 20, 3, 1332)]
    tr = reduce_events(evs, 1e-6)
    assert [o[0] for o in tr.ops] == ["gemm",
                                      "Memcpy DtoH (Device -> Pageable)"]
    assert tr.launches == {1330: 6}
    assert tr.ranges == {"train/forward": [(0, 100)]}
    assert [o[0] for o in tr.kernels_in_range("train/forward")] == ["gemm"]
