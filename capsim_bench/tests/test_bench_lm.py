"""The LM train cell (``nemo3.train-s4k-b2``): it loads by name; the
configuration file is the published model but for what ``reduced``
names; the four LM readers
on hand-built records, each finding nothing where the program has no
such span, kernel or counter; the frozen SSD cost against the program's;
and the driver end to end on the CPU at widths a test can hold."""
import time

import pytest

from capsim_bench import cost, harness, lm_cost
from capsim_bench.trace import Trace

LM = "nemo3.train-s4k-b2"
NEW = ("ssd_bwd_ms.lm_train", "moe_ms.lm_train", "ssd_roofline.lm_train",
       "moe_drop_share.lm_train")


def test_the_lm_cell_loads_with_its_metrics():
    lm = harness.load_cell(LM)
    assert lm.kind == "lm_train_loop" and lm.chips == 1
    assert [m["name"] for m in lm.end_to_end] == ["train_clips_per_s",
                                                  "setup_s"]
    assert [m["name"] for m in lm.per_layer] == list(NEW)
    assert set(lm.workload["limits"]) == set(lm.workload["reasons"]) - {
        "loss_gap"}


def test_the_configuration_is_the_published_model_cut_as_it_says():
    import json
    c = harness.load_cell(LM).config
    row = {"num_hidden_layers": 52, "n_routed_experts": 128}
    assert c["published"] == row and sorted(c["reduced"]) == sorted(row)
    assert c["hybrid_override_pattern"][:c["num_hidden_layers"]] == \
        "MEMEM*EMEMEM*E"
    from capsim_bench.drivers.lm_train_loop import arch_config
    from repro_torch.configs import get_config
    cfg = arch_config(c)
    want = get_config("nemotron-3-nano-30b-a3b").replace(
        name=c["name"], num_layers=14, experts_held=16)
    skip = ("shape_names", "skipped_shapes", "skip_reason")   # dry-run's
    assert cfg.replace(**{k: getattr(want, k) for k in skip}) == want
    assert json.dumps(c)                  # a plain JSON object


def _span_trace():
    # 2 steps; 3 kernels in ssd/backward (10 + 20 + 30 us), 2 in lm/moe
    ops = [("k_ssd", 100, 110_000, 1), ("k_ssd", 200_000, 220_000, 2),
           ("k_ssd", 300_000, 330_000, 3), ("k_moe", 400_000, 404_000, 4),
           ("k_moe", 500_000, 506_000, 5), ("other", 600_000, 700_000, 6)]
    launches = {1: 50, 2: 150_000, 3: 290_000, 4: 390_000, 5: 450_000,
                6: 550_000}
    ranges = {"train/forward": [(0, 10), (20, 30)],
              "ssd/backward": [(0, 160_000), (280_000, 295_000)],
              "lm/moe": [(380_000, 460_000)]}
    return Trace(ops, launches, ranges, 1.0)


def _read(name, rec):
    return harness.reader(name)(rec, harness.load_cell(LM))


def test_span_readers_are_device_ms_a_step():
    rec = {"trace": _span_trace()}
    assert _read("ssd_bwd_ms.lm_train", rec) == pytest.approx(
        (0.1099 + 0.02 + 0.03) / 2, rel=1e-6)
    assert _read("moe_ms.lm_train", rec) == pytest.approx(0.01 / 2)
    bare = Trace([("k", 0, 1, 1)], {1: 0}, {"train/forward": [(0, 1)]}, 1.0)
    for name in ("ssd_bwd_ms.lm_train", "moe_ms.lm_train"):
        assert _read(name, {"trace": bare}) is None
        assert _read(name, {}) is None


def test_ssd_roofline_is_the_calls_least_time_over_their_device_time():
    cell = harness.load_cell(LM)
    name = "void capsim_ssd::ssd_{}<__nv_bfloat16, 64>(capsim_ssd::Args)"
    ops = []
    for call in range(3):
        t0 = call * 1_000_000
        for j, k in enumerate(("cb", "chunk_state", "state_pass",
                               "chunk_out")):
            ops.append((name.format(k), t0 + j * 100_000,
                        t0 + j * 100_000 + 50_000, 4 * call + j))
    ops.append(("void capsim_fa::fa_fwd_bf16<128, false>", 0, 999, 99))
    flops, nbytes = lm_cost.cell_ssd_cost(cell.config, cell.traffic, 2)
    least = 3 * cost.least_seconds(flops, nbytes, "bfloat16")
    got = _read("ssd_roofline.lm_train", {"trace": Trace(ops, {}, {}, 1.0)})
    assert got == pytest.approx(100.0 * least / (12 * 50e-6))
    assert _read("ssd_roofline.lm_train",
                 {"trace": Trace(ops[-1:], {}, {}, 1.0)}) is None


def test_moe_drop_share_reads_the_slot_counter():
    rows = [({"outcome": "kept"}, 900.0), ({"outcome": "dropped"}, 100.0)]
    assert _read("moe_drop_share.lm_train",
                 {"counters": {"capsim_moe_slots_total": rows}}) == 10.0
    assert _read("moe_drop_share.lm_train", {"counters": {}}) is None


@pytest.mark.parametrize("G", [1, 8])
def test_frozen_ssd_cost_is_the_programs(G):
    from repro_torch.kernels.ssd.ops import ssd_cost
    for shape in ((2, 4096, 64, 64, 128, 128), (3, 300, 8, 32, 16, 64)):
        assert lm_cost.ssd_cost(*shape, 2, G) == ssd_cost(*shape, 2, G)
    assert lm_cost.ssd_cost(2, 300, 8, 32, 16, 64, 4) == \
        ssd_cost(2, 300, 8, 32, 16, 64, 4)


def test_driver_runs_on_the_cpu_and_holds_the_program_to_the_reference(
        tmp_path):
    """The driver's whole path at small widths in float32: the window,
    the slot counter's deltas, and the output check, whose program
    readings sit far under the fp8 control's."""
    import torch

    from capsim_bench.run import run_cell
    cell = harness.load_cell(LM)
    cell.config.update(hidden_size=64, num_attention_heads=4,
                       num_key_value_heads=2, head_dim=16, mamba_num_heads=8,
                       mamba_head_dim=16, ssm_state_size=16, n_groups=4,
                       chunk_size=16, moe_intermediate_size=32,
                       moe_shared_expert_intermediate_size=48,
                       vocab_size=256, n_routed_experts=2,
                       num_hidden_layers=7, dtype="float32",
                       param_dtype="float32")
    cell.config["deployment"] = dict(cell.config["deployment"],
                                     router_outputs=16, expert_shard=3)
    cell.traffic.update(seq_len=40, batch=2)
    ctx = harness.RunContext(cell=cell, seed=2**31 + 9, seconds=0.5,
                             trace=False, device=torch.device("cpu"),
                             cache=tmp_path, t_start=time.perf_counter(),
                             control=True)
    out, rec = run_cell(ctx)
    assert rec["steps"] > 0 and out["metrics"]["train_clips_per_s"]
    rows = rec["counters"]["capsim_moe_slots_total"]
    assert sum(d for _, d in rows) > 0
    prog = rec["control"]["program_bf16"]
    fp8 = rec["control"]["reference_fp8"]
    half = rec["control"]["fault_half_batch"]
    for k in ("loss_gap", "grad_gap", "change_gap", "logit_gap",
              "grad_diff_gap"):
        assert prog[k] < 1e-4, (k, prog[k])
    assert prog["route_gap"] == 0.0       # float32 chooses as the reference
    assert fp8["grad_gap"] > 100 * prog["grad_gap"]
    assert fp8["logit_gap"] > 100 * prog["logit_gap"]
    assert [c["name"] for c in rec["checks"]] == [
        "logit_gap", "grad_gap", "change_gap", "change_worst_gap",
        "route_gap", "grad_diff_gap"]
    assert half["grad_gap"] > 1e-2 and half["loss_gap"] > 1e-4
    assert half["grad_diff_gap"] > 1e-2
