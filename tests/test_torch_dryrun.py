"""The port's dry-run (``repro_torch.launch.dryrun``) on smoke configs on
the CPU, with no card: a rank of a fake world runs its step on meta
tensors, and what the counters say is held to identities.

- A rank's parameter bytes are the sum of its ``block_bounds`` blocks.
- On a data-only (2, 1) mesh a rank's FLOPs are exactly half the
  meshless step's (every product is linear in the batch rows).
- The collectives rank 0 records on meta in a fake world of 4 ranks,
  (2, 2) under ``LOGICAL_RULES_TRAIN``, are the ones rank 0 of a real
  4-rank gloo run of the same train step records (op, bytes, group,
  direction, in order).
- A causal prefill's flash FLOPs from the meta route are the bound
  formula's (``attention_cost``) once a layer.
- A flash backward replayed from an earlier call's counts counts what
  running it counts.
- The record keeps the reference's keys and ``roofline_report`` reads
  it; a frontend under a sequence-sharded layout is recorded skipped;
  the CLI writes a record for rank 0 of the production mesh."""
import json
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_ranks import spawn, wait  # noqa: E402
from repro_torch.configs import ShapeConfig, get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    attention_cost)
from repro_torch.launch import dryrun as dry  # noqa: E402
from repro_torch.launch import roofline_report as rr  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import block_bounds_tree  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402
from repro_torch.training.train_loop import TrainConfig  # noqa: E402

TRAIN = ShapeConfig("t", 16, 4, "train")
AXES = ("data", "model")


def _cfg(arch="qwen3-4b"):
    return get_smoke_config(arch).replace(capacity_factor=8.0)


def test_rank_parameter_bytes_are_its_blocks():
    cfg = _cfg()
    specs = tfm.model_specs(cfg)
    with dry.fake_world(4):
        mesh = make_mesh((2, 2), AXES, "cpu")
        with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_TRAIN):
            params = tfm.abstract_params(cfg, mesh)
            blocks = block_bounds_tree(specs, mesh, sh.LOGICAL_RULES_TRAIN)
            analysis = dry.measure_cell(cfg, ShapeConfig("p", 16, 4,
                                                         "prefill"),
                                        mesh, sh.LOGICAL_RULES_TRAIN,
                                        TrainConfig())

    def block_bytes(s, b):
        if isinstance(b, dict):
            return sum(block_bytes(s[k], b[k]) for k in b)
        return math.prod(n for _, n in b) * 4      # float32 smoke params
    want = block_bytes(specs, blocks)
    got = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    whole = sum(math.prod(p.shape) * 4 for p in tree_leaves(
        tfm.abstract_params(cfg)))
    assert all(p.device.type == "meta" for p in tree_leaves(params))
    assert got == want < whole
    # the prefill's arguments: those blocks and the rank's batch rows
    assert analysis["memory"]["argument_bytes"] >= want


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_data_only_mesh_halves_the_flops(arch):
    cfg = _cfg(arch)
    whole = dry.measure_cell(cfg, TRAIN, None, None, TrainConfig())
    with dry.fake_world(2):
        mesh = make_mesh((2, 1), AXES, "cpu")
        half = dry.measure_cell(cfg, TRAIN, mesh, sh.LOGICAL_RULES_TRAIN,
                                TrainConfig())
    assert whole["cost"]["flops"] > 0
    assert half["cost"]["flops"] * 2 == whole["cost"]["flops"]
    assert whole["collectives"] == {}
    assert set(half["collectives"]) == {"all-gather", "all-reduce",
                                        "reduce-scatter"}


def test_causal_prefill_flops_match_the_bound_formula():
    cfg = _cfg()
    shape = ShapeConfig("p", 32, 2, "prefill")
    rec = dry.measure_cell(cfg, shape, None, None, TrainConfig())
    want = attention_cost(2, 32, 32, cfg.num_heads, cfg.head_dim, 4, False,
                          True)
    assert rec["kernels"]["flash_attention"] == {
        "calls": cfg.num_layers, "flops": cfg.num_layers * want[0],
        "bytes": cfg.num_layers * want[1]}
    assert rec["cost"]["flops"] > rec["kernels"]["flash_attention"]["flops"]


@pytest.mark.parametrize("remat", [False, True])
def test_replayed_backward_counts_as_the_real_one(monkeypatch, remat):
    """The second layer's flash backward, replayed from the first's
    counts, adds what running it adds: FLOPs, bytes and the peak."""
    cfg = _cfg().replace(remat=remat)
    replayed = dry.measure_cell(cfg, TRAIN, None, None, TrainConfig())
    monkeypatch.setattr(dry._ReplayedBackward, "__call__",
                        lambda self, *a: self.real(*a))
    real = dry.measure_cell(cfg, TRAIN, None, None, TrainConfig())
    assert cfg.num_layers == 2
    assert replayed["cost"] == real["cost"]
    assert replayed["memory"] == real["memory"]


PROGRAM = r"""
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import random_batch
from repro_torch.models import transformer as tfm
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step)
import json
cfg = get_smoke_config("qwen3-4b").replace(capacity_factor=8.0)
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
batch = random_batch(cfg, ShapeConfig("t", 16, 4, "train"), "train",
                     seed=0, device="cpu")
with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_TRAIN):
    state = init_train_state(tfm.init_params(cfg, device="cpu", mesh=mesh),
                             TrainConfig())
    step = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg),
                           TrainConfig())
    with coll.record_collectives() as records:
        step(state, batch)
with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
    json.dump([[r.op, r.nbytes, r.group, r.direction] for r in records], f)
# every rank leaves the group together: a rank that exits while gloo's
# threads still talk to the others can abort at exit
dist.barrier()
dist.destroy_process_group()
"""


def test_recorded_collectives_equal_a_real_gloo_run(tmp_path):
    wait(spawn(PROGRAM, 4, tmp_path, "dry"), timeout=300)
    real = json.loads((tmp_path / "rank0.json").read_text())
    cfg = _cfg()
    with dry.fake_world(4):
        mesh = make_mesh((2, 2), AXES, "cpu")
        with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_TRAIN):
            run, args = dry.step_program(cfg, TRAIN, mesh, TrainConfig())
            with dry.coll.record_collectives() as records:
                run()
    fake = [[r.op, r.nbytes, r.group, r.direction] for r in records]
    assert len(real) > 10
    assert fake == real
    assert {d for *_, d in fake} == {"forward", "backward"}


SMALL = {"num_layers": 1, "d_model": 64, "num_heads": 16,
         "num_kv_heads": 16, "head_dim": 16, "d_ff": 128,
         "vocab_size": 256}


def test_record_keys_report_and_refusals(tmp_path):
    """A production cell at a cut width: the reference's keys, the
    extrapolation from 1 and 2 repeats equal to the full step, the
    report's row; a refused cell and a skipped shape recorded."""
    rec = dry.run_cell("qwen3-4b", "train_4k", False, out_dir=tmp_path,
                       overrides=dict(SMALL, num_layers=3))
    for part in ("scanned", "unrolled_r1", "unrolled_r2"):
        assert set(rec[part]["memory"]) >= {"argument_bytes",
                                            "output_bytes", "temp_bytes"}
        assert set(rec[part]["cost"]) == {"flops", "bytes_accessed"}
    assert rec["extrapolated"]["flops"] == rec["scanned"]["cost"]["flops"]
    assert rec["chips"] == 256 and rec["mesh"] == "pod_16x16"
    saved = json.loads((tmp_path / "qwen3-4b__train_4k__pod_16x16.json"
                        ).read_text())
    assert saved["scanned"]["cost"] == rec["scanned"]["cost"]
    table = rr.report("pod_16x16", results_dir=tmp_path)
    assert "| qwen3-4b | train_4k |" in table
    assert rr.cell_terms(saved)["extrapolated_flops_ratio"] == 1.0
    skipped = dry.run_cell("qwen2-vl-2b", "prefill_32k", False,
                           out_dir=tmp_path, rules_name="sp",
                           overrides={"num_layers": 1}, extrapolate=False)
    assert "frontend under a sequence-sharded layout" in skipped["skipped"]
    assert dry.run_cell("qwen3-4b", "long_500k", False,
                        out_dir=tmp_path)["skipped"]
    assert "skipped: the port refuses it" in rr.report(
        "pod_16x16", results_dir=tmp_path)


def test_cli_writes_rank0_of_the_production_mesh(tmp_path):
    dry.main(["--arch", "olmo-1b", "--shape", "decode_32k",
              "--no-extrapolate", "--out", str(tmp_path),
              "--override", "num_layers=2"])
    rec = json.loads((tmp_path / "olmo-1b__decode_32k__pod_16x16.json"
                      ).read_text())
    assert rec["chips"] == 256 and rec["kind"] == "decode"
    assert rec["scanned"]["memory"]["argument_bytes"] > 0
    assert not torch.distributed.is_initialized()
