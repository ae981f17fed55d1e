"""The port's logical-axis rules (``repro_torch/distributed/sharding.py``)
against the reference's (``repro/distributed/sharding.py``): every table
entry by entry; ``axis_rules`` on every logical name of every table,
alone and in the specs the models use, on meshes of ("data", "model")
and ("pod", "data", "model"), compared with the reference's
``PartitionSpec`` as tuples; the seven cases of ``tests/test_sharding.py``;
``fit_spec``, ``layout``, the specs every parameter and cache carries,
and a rank's block of the counter-hash init."""
import itertools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_test_mesh  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.layers import ParamSpec  # noqa: E402

TABLES = ("LOGICAL_RULES_TRAIN", "LOGICAL_RULES_DECODE",
          "LOGICAL_RULES_DECODE_LONG", "LOGICAL_RULES_TRAIN_ZERO3",
          "LOGICAL_RULES_TRAIN_FSDP", "LOGICAL_RULES_PREFILL_SP",
          "LOGICAL_RULES_PREDICTOR")
AXES = (("data", "model"), ("pod", "data", "model"))
ARCHS = ("qwen3-4b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b",
         "musicgen-large")


def _jmesh(names):
    devs = np.array(jax.devices()[:1]).reshape((1,) * len(names))
    return JMesh(devs, names)


def _tmesh(names, shape=None, coords=None):
    """A port mesh without a process group: rules and blocks only."""
    shape = shape or (1,) * len(names)
    return Mesh(tuple(shape), tuple(names), torch.device("cpu"),
                tuple(coords or (0,) * len(names)), {})


def _names(table):
    return [name for name, _ in table]


@pytest.mark.parametrize("table", TABLES)
def test_tables_entry_by_entry(table):
    assert getattr(tsh, table) == getattr(jsh, table)
    assert tsh._norm([("a", "x"), ("b", None), ("c", ["y", "z"])]) == \
        jsh._norm([("a", "x"), ("b", None), ("c", ["y", "z"])])


@pytest.mark.parametrize("table, names", list(itertools.product(TABLES,
                                                                 AXES)))
def test_axis_rules_every_name(table, names):
    """Each logical name alone, every ordered pair (a mesh axis is used
    once per spec), and None, as the reference resolves them."""
    jr, tr = getattr(jsh, table), getattr(tsh, table)
    jm, tm = _jmesh(names), _tmesh(names)
    logical = _names(jr) + ["unknown"]
    for name in logical:
        assert tuple(tsh.axis_rules((name,), tr, tm)) == \
            tuple(jsh.axis_rules((name,), jr, jm)), name
    for a, b in itertools.permutations(_names(jr), 2):
        assert tuple(tsh.axis_rules((a, None, b), tr, tm)) == \
            tuple(jsh.axis_rules((a, None, b), jr, jm)), (a, b)
    # without a mesh no axis is dropped
    for name in logical:
        assert tuple(tsh.axis_rules((name,), tr)) == \
            tuple(jsh.axis_rules((name,), jr)), name


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("table", ("LOGICAL_RULES_TRAIN",
                                   "LOGICAL_RULES_DECODE",
                                   "LOGICAL_RULES_PREFILL_SP"))
def test_param_and_cache_shardings_are_the_references(arch, table):
    """``param_shardings``/``cache_shardings`` at full width: every leaf's
    spec the reference's ``NamedSharding`` spec."""
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    jm, tm = _jmesh(AXES[1]), _tmesh(AXES[1])
    jr, tr = getattr(jsh, table), getattr(tsh, table)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{prefix}/{k}").items()}
        return {prefix: tuple(tree.spec)}
    for jtree, ttree in (
            (jt.param_shardings(jc, jm, jr), tt.param_shardings(tc, tm, tr)),
            (jt.cache_shardings(jc, 4, 1024, jm, jr),
             tt.cache_shardings(tc, 4, 1024, tm, tr))):
        assert flat(ttree) == flat(jtree)


# ---- the seven cases of tests/test_sharding.py ---------------------------- #

MESH2, MESH3 = _tmesh(AXES[0]), _tmesh(AXES[1])


def test_train_rules_mapping():
    spec = tsh.axis_rules(("batch", "act_seq", "act_embed"),
                          rules=tsh.LOGICAL_RULES_TRAIN, mesh=MESH3)
    assert spec == tsh.P(("pod", "data"), None, None)
    assert tuple(spec) == tuple(JP(("pod", "data"), None, None))
    spec = tsh.axis_rules(("embed", "mlp"), rules=tsh.LOGICAL_RULES_TRAIN,
                          mesh=MESH3)
    assert spec == tsh.P("data", "model")


def test_missing_mesh_axis_dropped():
    spec = tsh.axis_rules(("batch",), rules=tsh.LOGICAL_RULES_TRAIN,
                          mesh=MESH2)
    assert spec == tsh.P("data")


def test_axis_used_once_per_spec():
    spec = tsh.axis_rules(("qkv", "mlp"), rules=tsh.LOGICAL_RULES_TRAIN,
                          mesh=MESH2)
    assert spec == tsh.P("model", None)


def test_decode_rules_shard_cache_seq():
    spec = tsh.axis_rules(("cache_batch", "cache_seq"),
                          rules=tsh.LOGICAL_RULES_DECODE, mesh=MESH3)
    assert spec == tsh.P(("pod", "data"), "model")
    spec = tsh.axis_rules(("cache_batch", "cache_seq"),
                          rules=tsh.LOGICAL_RULES_DECODE_LONG, mesh=MESH3)
    assert spec == tsh.P(None, ("pod", "data", "model"))


def test_predictor_rules_pure_dp():
    spec = tsh.axis_rules(("batch", None, None),
                          rules=tsh.LOGICAL_RULES_PREDICTOR, mesh=MESH3)
    assert spec == tsh.P(("pod", "data", "model"), None, None)
    spec = tsh.axis_rules(("embed", "qkv"),
                          rules=tsh.LOGICAL_RULES_PREDICTOR, mesh=MESH3)
    assert spec == tsh.P(None, None)


def test_vocab_padding_only_when_needed():
    mamba = tcfgs.get_config("mamba2-780m")
    assert mamba.vocab_size == 50280
    assert tt.padded_vocab(mamba) == 50288
    qwen = tcfgs.get_config("qwen3-4b")
    assert tt.padded_vocab(qwen) == qwen.vocab_size
    specs = tt.model_specs(mamba)
    assert specs["embed"].shape[0] == 50288
    assert specs["unembed"].shape[1] == 50288


def test_padded_logits_masked():
    cfg = tcfgs.get_smoke_config("mamba2-780m").replace(vocab_size=250)
    params = tt.init_params(cfg, seed=0, device="cpu")
    logits, _, _, _ = tt.forward(
        params, {"tokens": torch.zeros(2, 8, dtype=torch.long)}, cfg,
        "train")
    assert logits.shape[-1] == 256
    assert (logits[..., 250:] <= -1e29).all()


# ---- the port's own: the context, fit, layout, shard_logical, blocks ------ #

def test_context_and_logical_sharding():
    assert tsh.current_mesh() is None and tsh.current_rules() is None
    mesh = make_test_mesh("cpu")
    with tsh.use_mesh_and_rules(mesh, tsh.LOGICAL_RULES_DECODE):
        assert tsh.current_mesh() is mesh
        assert tsh.current_rules() == tsh.LOGICAL_RULES_DECODE
        s = tsh.logical_sharding(("cache_batch", "cache_seq"))
        assert s.mesh is mesh and s.spec == ("data", "model")
        x = torch.zeros(2, 3)
        assert tsh.shard_logical(x, "batch", None) is x
        with pytest.raises(ValueError):
            tsh.shard_logical(x, "batch")
    assert tsh.current_mesh() is None
    with pytest.raises(ValueError):
        tsh.logical_sharding(("batch",))


def test_fit_and_layout_drop_what_does_not_divide():
    mesh = _tmesh(("data", "model"), (2, 4))
    assert tsh.fit_spec(tsh.P(("data", "model"), "model"), (8, 6),
                        mesh) == (("data", "model"), None)
    with tsh.use_mesh_and_rules(mesh, tsh.LOGICAL_RULES_PREFILL_SP):
        assert tsh.layout(4, 32) == tsh.Layout(("data",), ("model",), ())
        assert tsh.layout(3, 30, 64) == tsh.Layout((), (), ("model",))
    with tsh.use_mesh_and_rules(mesh, tsh.LOGICAL_RULES_DECODE_LONG):
        assert tsh.layout(1, 1, 64) == tsh.Layout((), (), ("data", "model"))
    with tsh.use_mesh_and_rules(mesh, tsh.LOGICAL_RULES_TRAIN_FSDP):
        assert tsh.layout(8, 16) == tsh.Layout(("data", "model"), (), ())
    # axes of size 1 split nothing: one device's layout
    with tsh.use_mesh_and_rules(make_test_mesh("cpu"),
                                tsh.LOGICAL_RULES_PREFILL_SP):
        assert tsh.layout(4, 32, 64) == tsh.Layout()
    assert tsh.layout(4, 32) == tsh.Layout()


def test_mesh_index_is_row_major_and_blocks_tile_the_array():
    shape, names = (2, 2, 4), ("pod", "data", "model")
    x = np.arange(4 * 8 * 16).reshape(4, 8, 16)
    spec = (("pod", "data"), None, "model")
    blocks = {}
    for coords in itertools.product(*(range(n) for n in shape)):
        mesh = _tmesh(names, shape, coords)
        assert mesh.index(("pod", "data", "model")) == \
            (coords[0] * 2 + coords[1]) * 4 + coords[2]
        assert mesh.index(("model", "pod")) == coords[0] * 4 + coords[2]
        blocks[coords] = tsh.take_spec_block(x, spec, mesh)
    for (p, d, m), b in blocks.items():
        assert b.shape == (1, 8, 4)
        np.testing.assert_array_equal(b, x[p * 2 + d:p * 2 + d + 1, :,
                                           m * 4:m * 4 + 4])


def test_a_mesh_larger_than_the_world_raises():
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 8 ranks"):
        make_mesh((2, 4), ("data", "model"), "cpu")
    mesh = make_test_mesh("cpu")
    assert mesh.size(("data", "model")) == 1 and mesh.group("model") is None


@pytest.mark.parametrize("coords", [(0, 0), (1, 2), (1, 3)])
def test_rank_init_draws_its_block_of_the_whole_draw(coords):
    """``init_params(mesh=...)`` under ``LOGICAL_RULES_TRAIN``: every
    leaf is the bits of the rank's block of the whole draw by its
    ``param_shardings`` spec (the experts (E/n_model, d/n_data, f), the
    attention and FFN weights split over 'data' and 'model'), marked
    with the axes that split it; without rules it raises."""
    cfg = tcfgs.get_smoke_config("llama4-maverick-400b-a17b")
    mesh = _tmesh(("data", "model"), (2, 4), coords)
    whole = tt.init_params(cfg, seed=3, device="cpu")
    with tsh.use_mesh_and_rules(mesh, tsh.LOGICAL_RULES_TRAIN):
        mine = tt.init_params(cfg, seed=3, device="cpu", mesh=mesh)
        shardings = tt.param_shardings(cfg, mesh, tsh.LOGICAL_RULES_TRAIN)
    flat_w, flat_m, flat_s = (dict(_leaves(t)) for t in
                              (whole, mine, shardings))
    for key, w in flat_w.items():
        dims = tsh.split_dims(w.shape, flat_s[key].spec, mesh)
        assert tsh.split_of(flat_m[key]) == dims, key
        assert torch.equal(flat_m[key], tsh.take_dims_block(w, dims, mesh))
    assert mine["blocks"]["i1"]["ffn"]["w_up"].shape == (1, 1, 32, 64)
    assert mine["blocks"]["i0"]["mixer"]["wq"].shape == (1, 32, 16)
    assert isinstance(tt.model_specs(cfg)["embed"], ParamSpec)
    with pytest.raises(ValueError, match="use_mesh_and_rules"):
        tt.init_params(cfg, seed=3, device="cpu", mesh=mesh)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b", "qwen3-4b"])
def test_serve_lm_under_the_test_mesh_gives_the_meshless_tokens(
        arch, capsys, monkeypatch):
    """``serve_lm`` runs under ``make_test_mesh()`` and
    ``LOGICAL_RULES_DECODE``, as the reference's: the same tokens as
    with no mesh."""
    import argparse
    import contextlib

    from repro_torch.launch import serve
    args = argparse.Namespace(arch=arch, device="cpu", decode_steps=4)
    serve.serve_lm(args)
    meshed = capsys.readouterr().out.split("tokens ")[-1]
    monkeypatch.setattr(tsh, "use_mesh_and_rules",
                        lambda mesh, rules: contextlib.nullcontext())
    serve.serve_lm(args)
    assert capsys.readouterr().out.split("tokens ")[-1] == meshed
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_test_mesh()
