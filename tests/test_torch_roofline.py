"""The port's roofline tools (``repro_torch.launch.roofline``,
``dryrun.extrapolate_costs``) and the dry-run's abstract state against
the reference's on the CPU: the
reference's ``tests/test_roofline.py`` cases with the H100 constants,
``parse_collectives`` on the reference's HLO text equal to the
reference's, one ring model (``wire_bytes``) behind the HLO parser and
the port's recorded collectives, ``param_counts``/``model_flops`` equal
to the reference's for every architecture and every one of its shapes,
``extrapolate_costs`` equal on the same inputs, and the abstract
parameters, caches, train state, batches and shardings the reference's
(shapes, dtypes, partition specs) on a (1, 1) mesh."""
import os

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

# the reference's dry-run module sets XLA_FLAGS to force 512 host devices
# when it is imported: bring this process's backend up first and put the
# variable back, so neither this worker nor what it starts sees 512
_FLAGS = os.environ.get("XLA_FLAGS")
jax.devices()
from repro.launch import dryrun as jdry  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

from repro.configs import (ARCH_NAMES as J_ARCHS,  # noqa: E402
                           get_config as j_get_config)
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import predictor as jpred  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import roofline as jrf  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, CAPSIM_SHAPES,  # noqa: E402
                                 LM_SHAPES, get_config, get_smoke_config)
from repro_torch.core import predictor as tpred  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402
from repro_torch.distributed.collectives import Collective  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402

HLO = """
ENTRY %main {
  %ag = bf16[256,4096,128]{2,1,0} all-gather(%x), replica_groups=[16,16]<=[256], dimensions={2}
  %ar = f32[1024,1024]{1,0} all-reduce(%y), replica_groups={{0,1,2,3}}, to_apply=%add
  %rs = bf16[64,512]{1,0} reduce-scatter(%z), replica_groups=[32,8]<=[256], dimensions={0}
  %cp = bf16[8,128]{1,0} collective-permute(%w), source_target_pairs={{0,1}}
  %ags = (bf16[2,2]{1,0}, u32[]) all-gather-start(%v), replica_groups=[1,2]<=[2]
  %agd = bf16[2,2]{1,0} all-gather-done(%ags)
  %a2a = bf16[16,64]{1,0} all-to-all(%u), replica_groups=[64,4]<=[256], dimensions={0}
}
"""


def test_parse_collectives_counts_and_wire():
    colls = rf.parse_collectives(HLO)
    assert colls["all-gather"]["count"] == 2          # plain + -start
    ag_bytes = 256 * 4096 * 128 * 2
    assert abs(colls["all-gather"]["wire_bytes"]
               - (ag_bytes * 15 / 16 + 8 * 1 / 2)) < 16
    ar_bytes = 1024 * 1024 * 4
    assert colls["all-reduce"]["wire_bytes"] == 2 * ar_bytes * 3 / 4
    rs_bytes = 64 * 512 * 2
    assert colls["reduce-scatter"]["wire_bytes"] == rs_bytes * 7
    assert colls["collective-permute"]["wire_bytes"] == 8 * 128 * 2
    assert colls["all-to-all"]["wire_bytes"] == 16 * 64 * 2 * 3 / 4
    assert colls == jrf.parse_collectives(HLO)


def test_recorded_collectives_use_the_same_ring_model():
    """The port's records summed as the parser sums HLO's: the same
    (op, bytes, group) give the same wire bytes."""
    records = [Collective("all-gather", 256 * 4096 * 128 * 2, 16, "forward"),
               Collective("all-reduce", 1024 * 1024 * 4, 4, "backward"),
               Collective("reduce-scatter", 64 * 512 * 2, 8, "backward"),
               # the -start op's result tuple: bf16[2,2] and a u32
               Collective("all-gather", 8 + 4, 2, "forward")]
    got = rf.collectives_from_records(records)
    ref = jrf.parse_collectives(HLO)
    for op in ("all-gather", "all-reduce", "reduce-scatter"):
        assert got[op] == ref[op], op
    with pytest.raises(ValueError):
        rf.wire_bytes("broadcast", 8, 2)


def test_roofline_terms_h100():
    t = rf.roofline_terms(989e12, 3.35e12 * 2, 450e9 * 0.5)
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert abs(t["memory_s"] - 2.0) < 1e-9
    assert abs(t["collective_s"] - 0.5) < 1e-9
    assert t["dominant"] == "memory_s"
    assert abs(t["roofline_fraction"] - 2.0 / 3.5) < 1e-12
    f32 = rf.roofline_terms(67e12, 0.0, 0.0, "float32")
    assert abs(f32["compute_s"] - 1.0) < 1e-9
    assert (rf.PEAK_FLOPS_BF16, rf.PEAK_FLOPS_F32, rf.HBM_BW,
            rf.NVLINK_BW) == (989e12, 67e12, 3.35e12, 450e9)


def test_scale_collectives_matches_reference():
    colls = rf.parse_collectives(HLO)
    assert rf.scale_collectives(colls, 36) == jrf.scale_collectives(colls,
                                                                    36)


def test_extrapolate_costs_linear_and_equal_to_reference():
    def cell(flops, b, ag, ar=None):
        c = {"cost": {"flops": flops, "bytes_accessed": b},
             "collectives": {"all-gather": {
                 "count": 1, "bytes": ag, "wire_bytes": ag * 0.9}}}
        if ar is not None:
            c["collectives"]["all-reduce"] = {"count": 2, "bytes": ar,
                                              "wire_bytes": ar * 1.5}
        return c
    out = tdry.extrapolate_costs(cell(15, 150, 1.0), cell(20, 200, 2.0), 48)
    assert out["flops"] == 10 + 5 * 48
    assert out["bytes_accessed"] == 100 + 50 * 48
    assert abs(out["collectives"]["all-gather"]["wire_bytes"]
               - (0.0 + 0.9 * 48)) < 1e-9
    for a, b in ((cell(15, 150, 1.0), cell(20, 200, 2.0, 3.0)),
                 (cell(7, None, 1.0, 2.0), cell(9, 1.0, 2.0))):
        assert tdry.extrapolate_costs(a, b, 61) == \
            jdry.extrapolate_costs(a, b, 61)


def test_arch_names_are_the_references():
    assert set(ARCH_NAMES) == set(J_ARCHS)


@pytest.mark.parametrize("arch", sorted(ARCH_NAMES))
def test_param_counts_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert rf.param_counts(cfg) == jrf.param_counts(jcfg)
    assert tuple(cfg.shape_names) == tuple(jcfg.shape_names)
    assert tuple(cfg.skipped_shapes) == tuple(jcfg.skipped_shapes)
    for name, shape in cfg.shapes().items():
        jshape = jcfg.shapes()[name]
        assert (shape.seq_len, shape.global_batch, shape.kind) == \
            (jshape.seq_len, jshape.global_batch, jshape.kind)
        assert rf.model_flops(cfg, shape, shape.kind) == \
            jrf.model_flops(jcfg, jshape, jshape.kind), name


def test_model_flops_yardsticks():
    cfg = get_config("olmo-1b")
    total, active = rf.param_counts(cfg)
    assert total == active
    f_train = rf.model_flops(cfg, LM_SHAPES["train_4k"], "train")
    f_pre = rf.model_flops(cfg, LM_SHAPES["prefill_32k"], "prefill")
    assert abs(f_train / (6 * active * 256 * 4096) - 1) < 1e-9
    assert abs(f_pre / (2 * active * 32 * 32768) - 1) < 1e-9
    t2, a2 = rf.param_counts(get_config("kimi-k2-1t-a32b"))
    assert a2 < t2 / 5
    cap = get_config("capsim")
    assert rf.is_predictor(cap) and not rf.is_predictor(cfg)
    assert rf.model_flops(cap, CAPSIM_SHAPES["train_clips"], "train") > 0


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _flat(tree).items()}


@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-1.5-large-398b",
                                  "musicgen-large"])
@pytest.mark.parametrize("optimizer", ["sgdm", "adamw", "adafactor"])
def test_abstract_state_matches_reference(arch, optimizer):
    """Meta parameters, caches and train state: the reference's shapes and
    dtypes leaf by leaf (a jax int32 scalar is the port's int32 step)."""
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    tcfg = ttl.TrainConfig(optimizer=optimizer, compress_grads=True)
    jtcfg = jtl.TrainConfig(optimizer=optimizer, compress_grads=True)
    got = ttl.abstract_train_state(ttfm.abstract_params(cfg), tcfg)
    ref = jtl.abstract_train_state(jtfm.abstract_params(jcfg), jtcfg)
    assert all(t.device.type == "meta" for t in _flat(got).values())
    assert _shapes(got) == _shapes(ref)
    assert _shapes(ttfm.abstract_cache(cfg, 2, 64)) == \
        _shapes(jtfm.abstract_cache(jcfg, 2, 64))


@pytest.mark.parametrize("arch,kind", [("capsim", "train"),
                                       ("capsim", "prefill"),
                                       ("qwen2-vl-2b", "train"),
                                       ("musicgen-large", "decode")])
def test_batches_and_shardings_match_reference(arch, kind):
    """``input_specs``' shapes (ids int64 in the port), and the partition
    specs of ``batch_shardings`` and of the parameters (the predictor's
    under its own rules) on a (1, 1) mesh."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    shape = next(s for s in cfg.shapes().values() if s.kind == kind) \
        if arch == "capsim" else LM_SHAPES["train_4k" if kind == "train"
                                           else "decode_32k"]
    got = tspecs.input_specs(cfg, shape, kind)
    ref = jspecs.input_specs(jcfg, jcfg.shapes()[shape.name], kind)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert all(v.device.type == "meta" for v in got.values())
    rules = "LOGICAL_RULES_PREDICTOR" if arch == "capsim" \
        else "LOGICAL_RULES_TRAIN"
    tmesh, jmesh = make_mesh((1, 1), ("data", "model"), "cpu"), \
        make_test_mesh()
    tb = tspecs.batch_shardings(got, tmesh, getattr(tsh, rules))
    jb = jspecs.batch_shardings(ref, jmesh, getattr(jsh, rules))
    assert {k: tuple(v.spec) for k, v in tb.items()} == \
        {k: tuple(v.spec) for k, v in jb.items()}
    if arch == "capsim":
        tp = _flat(tpred.param_shardings(cfg, tmesh,
                                         tsh.LOGICAL_RULES_PREDICTOR))
        jp = _flat(jpred.param_shardings(jcfg, jmesh,
                                         jsh.LOGICAL_RULES_PREDICTOR))
        assert {k: tuple(v.spec) for k, v in tp.items()} == \
            {k: tuple(v.spec) for k, v in jp.items()}
        assert _shapes(tpred.abstract_params(cfg)) == \
            _shapes(jpred.abstract_params(jcfg))
