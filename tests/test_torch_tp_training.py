"""Training with GSPMD's weight layouts in the port, 'model' > 1
included: 8 gloo ranks of a (2, 4) ("data", "model") mesh holding the
rank's parameter blocks, against the reference partitioned by XLA on an
8-device JAX CPU mesh (``jax.jit`` with the parameters'
``param_shardings`` and, for the train step, ``launch/dryrun``'s state
shardings) and against the port's own meshless run on the same seeded
numpy parameters and batches:

  - ``loss_fn`` and every gradient leaf (gathered to whole) of
    qwen3-4b, mamba2-780m, llama4-maverick and jamba at smoke size under
    ``LOGICAL_RULES_TRAIN`` (FSDP rows over 'data', tensor and expert
    parallelism over 'model'), and of qwen3-4b and llama4 under
    ``LOGICAL_RULES_TRAIN_FSDP`` (rows over ('data', 'model'), the batch
    over all 8 ranks): loss <= 1e-5 relative, each gradient <= 1e-4
    relative norm (the training port's gates), against the reference's
    partitioned ``jax.grad`` and the port's meshless gradients (the
    reference's MoE under FSDP rules is a pinned fault,
    ``test_torch_multidevice.py``, so llama4 there is held to the
    meshless gradients only; the MoE capacity factor is 8 so no token
    drops on either side);
  - three steps of ``make_train_step`` for qwen3-4b with sgdm, adamw and
    adafactor at the paper's learning rate 1e-3, int8 compression and
    clipping on (a clip of 0.5 that binds): each step's loss <= 1e-5 and gradients <= 1e-4, against the
    reference and the port's meshless steps, sgdm's parameters after
    the steps <= 1e-4; every rank's gathered state identical; and the
    clipped, compressed update of one set of gradients on the rank's
    blocks, gathered, against the update of the whole leaves (<= 1e-6);
  - the adamw run's (2, 4) state checkpointed (gathered to whole leaves,
    rank 0 writing) and restored on an (8, 1) mesh and without one:
    bitwise the state before the save;
  - under ``collectives.regather_saved`` (as the train step runs the
    loss on a mesh) a forward keeps none of the FSDP rows it gathered
    alive for the backward, which gathers them again: the same gradient
    bits as without it;
  - ``all_gather`` and ``all_reduce``'s gradients against the meshless
    gradient of the sum of the ranks' losses.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402

from _torch_ranks import SRC, flat, spawn, wait  # noqa: E402

REF_LOSS, REF_GRAD = 1e-5, 1e-4
B, S, STEPS = 8, 16, 3
MODELS = {"qwen3-4b": "qwen3-4b", "mamba2": "mamba2-780m",
          "llama4": "llama4-maverick-400b-a17b",
          "jamba": "jamba-1.5-large-398b"}
# (model, rules, held to the reference's partitioned run)
GRAD_CASES = [(m, "LOGICAL_RULES_TRAIN", True) for m in MODELS] + [
    ("qwen3-4b", "LOGICAL_RULES_TRAIN_FSDP", True),
    ("llama4", "LOGICAL_RULES_TRAIN_FSDP", False)]
OPTIMIZERS = ("sgdm", "adamw", "adafactor")

COMMON = r"""
def cfg_of(arch):
    return get_smoke_config(arch).replace(capacity_factor=8.0)


def tcfg_of(opt):
    return TrainConfig(optimizer=opt, base_lr=1e-3, grad_clip=0.5,
                       compress_grads=True, warmup_steps=0, total_steps=0)
"""

JAX_PROGRAM = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from repro.configs import get_smoke_config
from repro.distributed import sharding as sh
from repro.launch.dryrun import _state_shardings
from repro.launch.mesh import make_mesh_compat
from repro.launch.specs import batch_shardings
from repro.models import transformer as tfm
from repro.training.train_loop import (TrainConfig, init_train_state,
                                       make_train_step)
""" + COMMON + r"""
out_dir = sys.argv[1]
spec = json.loads(sys.argv[2])
inp = np.load(os.path.join(out_dir, "inputs.npz"))
mesh = make_mesh_compat((2, 4), ("data", "model"))
res = {}


def tree(prefix):
    t = {}
    for key in inp.files:
        if key.startswith(prefix + "/"):
            node, parts = t, key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(inp[key])
    return t


def put(tree_, prefix):
    for path, v in jax.tree_util.tree_flatten_with_path(tree_)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        res[f"{prefix}/{key}"] = v


for name, rules_name, _ in spec["grads"]:
    cfg = cfg_of(spec["models"][name])
    rules = getattr(sh, rules_name)
    params, batch = tree(f"{name}/params"), tree(f"{name}/batch0")
    with sh.use_mesh_and_rules(mesh, rules), mesh:
        psh = tfm.param_shardings(cfg, mesh, rules)
        bsh = batch_shardings(batch, mesh, rules)
        (loss, _), g = jax.jit(
            jax.value_and_grad(lambda p, b: tfm.loss_fn(p, b, cfg),
                               has_aux=True),
            in_shardings=(psh, bsh))(params, batch)
    res[f"{name}/{rules_name}/loss"] = loss
    put(g, f"{name}/{rules_name}/grads")

cfg = cfg_of("qwen3-4b")
rules = sh.LOGICAL_RULES_TRAIN
for opt in spec["optimizers"]:
    tcfg = tcfg_of(opt)
    with sh.use_mesh_and_rules(mesh, rules), mesh:
        state = init_train_state(tree("qwen3-4b/params"), tcfg)
        ssh = _state_shardings(cfg, tcfg, mesh, rules)
        bsh = batch_shardings(tree("qwen3-4b/batch0"), mesh, rules)
        step = jax.jit(make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg),
                                       tcfg), in_shardings=(ssh, bsh))
        grad = jax.jit(jax.grad(lambda p, b: tfm.loss_fn(p, b, cfg)[0]),
                       in_shardings=(ssh["params"], bsh))
        for i in range(int(inp["steps"])):
            state = jax.device_put(state, ssh)
            put(grad(state["params"], tree(f"qwen3-4b/batch{i}")),
                f"train/{opt}/grads{i}")
            state, m = step(state, tree(f"qwen3-4b/batch{i}"))
            res[f"train/{opt}/loss{i}"] = m["loss"]
    put(state["params"], f"train/{opt}/params")
np.savez(os.path.join(out_dir, "ref.npz"),
         **{k: np.asarray(v) for k, v in res.items()})
print("REFERENCE DONE")
"""

PORT_PROGRAM = r"""
import json
from repro_torch.checkpoint.ckpt import CheckpointManager, restore
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import params_from_numpy
from repro_torch.training.optimizer import tree_leaves, tree_map
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_grad_fn, make_train_step)
""" + COMMON + r"""
spec = json.loads(os.environ["SPEC"])
inp = np.load(os.path.join(OUT, "inputs.npz"))
mesh = make_mesh((2, 4), ("data", "model"), "cpu")
res = {}


def batch(name, i):
    return {k.split("/")[-1]: torch.from_numpy(inp[k])
            for k in inp.files if k.startswith(f"{name}/batch{i}/")}


def flat_t(tree, prefix):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat_t(v, f"{prefix}/{k}").items()}
    return {prefix: tree.detach().numpy()}


def loss_of(cfg):
    return lambda p, b: tfm.loss_fn(p, b, cfg)


# ---- loss and gradients ------------------------------------------------- #
for name, rules_name, _ in spec["grads"]:
    cfg = cfg_of(spec["models"][name])
    rules = getattr(sh, rules_name)
    whole = params_from_numpy(load_tree(inp, f"{name}/params"), "cpu")
    tcfg = TrainConfig()
    with sh.use_mesh_and_rules(mesh, rules):
        params = sh.shard_tree(whole, tfm.param_shardings(cfg, mesh, rules))
        loss, _, grads = make_grad_fn(loss_of(cfg), tcfg)(params,
                                                          batch(name, 0))
        grads = sh.gather_tree(sh.inherit_marks(grads, params))
    res[f"{name}/{rules_name}/loss"] = loss.item()
    res.update(flat_t(grads, f"{name}/{rules_name}/grads"))
    if RANK == 0:
        loss, _, grads = make_grad_fn(loss_of(cfg), tcfg)(whole,
                                                          batch(name, 0))
        res[f"{name}/{rules_name}/meshless_loss"] = loss.item()
        res.update(flat_t(grads, f"{name}/{rules_name}/meshless_grads"))

# ---- the gathered rows a forward keeps for its backward ----------------- #
import contextlib
import weakref
made = []
gather_param = coll.gather_param


def spy(w, mesh_, gathers):
    out = gather_param(w, mesh_, gathers)
    if out is not w:
        made.append(weakref.ref(out))
    return out


coll.gather_param = spy
for name, rules_name, _ in spec["grads"]:
    cfg = cfg_of(spec["models"][name])
    rules = getattr(sh, rules_name)
    whole = params_from_numpy(load_tree(inp, f"{name}/params"), "cpu")
    with sh.use_mesh_and_rules(mesh, rules):
        params = sh.shard_tree(whole, tfm.param_shardings(cfg, mesh, rules))
        for regather in (False, True):
            made.clear()
            with torch.enable_grad(), (coll.regather_saved() if regather
                                       else contextlib.nullcontext()):
                live = sh.inherit_marks(tree_map(
                    lambda p: p.detach().requires_grad_(True), params),
                    params)
                loss, _ = loss_of(cfg)(live, batch(name, 0))
            key = f"{name}/{rules_name}/regather{int(regather)}"
            res[f"{key}/kept"] = np.array(
                [sum(r() is not None for r in made), len(made)])
            grads = torch.autograd.grad(loss, tree_leaves(live),
                                        allow_unused=True)
            res.update({f"{key}/grads/{i}": g.numpy()
                        for i, g in enumerate(grads) if g is not None})
coll.gather_param = gather_param

# ---- three train steps; the adamw state checkpointed -------------------- #
cfg = cfg_of("qwen3-4b")
whole = params_from_numpy(load_tree(inp, "qwen3-4b/params"), "cpu")
ckpt_dir = os.path.join(OUT, "ckpt")
for opt in spec["optimizers"]:
    tcfg = tcfg_of(opt)
    step = make_train_step(loss_of(cfg), tcfg)
    grad_fn = make_grad_fn(loss_of(cfg), tcfg)
    with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_TRAIN):
        state = init_train_state(sh.shard_tree(whole, tfm.param_shardings(
            cfg, mesh, sh.LOGICAL_RULES_TRAIN)), tcfg)
        for i in range(int(inp["steps"])):
            g = grad_fn(state["params"], batch("qwen3-4b", i))[2]
            res.update(flat_t(sh.gather_tree(sh.inherit_marks(
                g, state["params"])), f"train/{opt}/grads{i}"))
            state, m = step(state, batch("qwen3-4b", i))
            res[f"train/{opt}/loss{i}"] = m["loss"].item()
        res[f"train/{opt}/clipped"] = m["grad_norm"].item() > 0.5
        gathered = sh.gather_tree(state)
        if opt == "adamw":
            ckpt = CheckpointManager(ckpt_dir, writer=RANK == 0)
            ckpt.save(state, 3)
            ckpt.wait()
            dist.barrier()
            back = restore(state, 3, ckpt_dir, device="cpu")
            res["ckpt/same_mesh"] = all(
                torch.equal(a, b) and sh.split_of(a) == sh.split_of(b)
                for a, b in zip(tree_leaves(back), tree_leaves(state)))
    res.update(flat_t(gathered["params"], f"train/{opt}/params"))
    if RANK == 0:
        one = init_train_state(whole, tcfg)
        for i in range(int(inp["steps"])):
            g = grad_fn(one["params"], batch("qwen3-4b", i))[2]
            res.update(flat_t(g, f"train/{opt}/meshless_grads{i}"))
            one, m = step(one, batch("qwen3-4b", i))
            res[f"train/{opt}/meshless_loss{i}"] = m["loss"].item()
        res.update(flat_t(one["params"], f"train/{opt}/meshless_params"))
    if opt == "adamw":
        res.update(flat_t(gathered, "ckpt/saved"))

# the update on the same gradients: blocks against whole leaves
from repro_torch.distributed.compression import compress_decompress
from repro_torch.training.train_loop import _clip_by_global_norm
rng = np.random.RandomState(7)
g_whole = tree_map(lambda p: torch.from_numpy(
    rng.randn(*p.shape).astype(np.float32)), whole)


def update(params, grads, opt):
    tcfg = tcfg_of(opt)
    state = init_train_state(params, tcfg)
    grads, _ = _clip_by_global_norm(sh.inherit_marks(grads, params),
                                    tcfg.grad_clip)
    grads, _ = compress_decompress(grads, state["err_fb"])
    new, _ = tcfg.make_optimizer().update(grads, state["opt"], params,
                                          tcfg.base_lr)
    return new


for opt in spec["optimizers"]:
    want = update(whole, g_whole, opt)
    with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_TRAIN):
        params = sh.shard_tree(whole, tfm.param_shardings(
            cfg, mesh, sh.LOGICAL_RULES_TRAIN))
        grads = tree_map(lambda g, p: sh.take_dims_block(g, sh.split_of(p),
                                                         mesh), g_whole,
                         params)
        got = sh.gather_tree(sh.inherit_marks(update(params, grads, opt),
                                             params))
    res.update(flat_t(got, f"update/{opt}/sharded"))
    res.update(flat_t(want, f"update/{opt}/whole"))

# the (2, 4) checkpoint on an (8, 1) mesh and on none
mesh81 = make_mesh((8, 1), ("data", "model"), "cpu")
tcfg = tcfg_of("adamw")
with sh.use_mesh_and_rules(mesh81, sh.LOGICAL_RULES_TRAIN):
    like = init_train_state(tfm.init_params(cfg, seed=0, device="cpu",
                                            mesh=mesh81), tcfg)
    back = restore(like, 3, ckpt_dir, device="cpu")
    res["ckpt/81_wq_shape"] = np.array(
        back["params"]["blocks"]["i0"]["mixer"]["wq"].shape)
    res.update(flat_t(sh.gather_tree(back), "ckpt/81"))
res.update(flat_t(restore(init_train_state(whole, tcfg), 3, ckpt_dir,
                          device="cpu"), "ckpt/11"))

# ---- a collective's gradient ------------------------------------------- #
xs = [torch.from_numpy(np.random.RandomState(r).randn(3)) for r in range(8)]
cs = [torch.from_numpy(np.random.RandomState(20 + r).randn(24))
      for r in range(8)]


def rank_loss(x, r, gather, reduce_):
    full = gather(x)
    return (full * cs[r]).square().sum() + reduce_(x.square()).prod() * \
        (r + 1)


x = xs[RANK].clone().requires_grad_(True)
rank_loss(x, RANK, lambda t: coll.all_gather(t, mesh, ("data", "model"), 0),
          lambda t: coll.all_reduce(t, mesh, ("model",))).backward()
res["coll/grad"] = x.grad.numpy()
live = [t.clone().requires_grad_(True) for t in xs]
total = sum(rank_loss(live[r], r, lambda t: torch.cat(live),
                      lambda t, r=r: sum(live[4 * (r // 4) + j].square()
                                         for j in range(4)))
            for r in range(8))
total.backward()
res["coll/meshless_grad"] = live[RANK].grad.numpy()
np.savez(os.path.join(OUT, f"port.rank{RANK}.npz"), **res)
"""


def _lm_batch(rng, vocab):
    tok = rng.randint(0, vocab, (B, S + 1))
    return {"tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32),
            "loss_mask": (rng.uniform(size=(B, S)) < 0.9).astype(
                np.float32)}


def _inputs():
    rng = np.random.RandomState(0)
    out = {"steps": np.array(STEPS)}
    for i, (name, arch) in enumerate(MODELS.items()):
        jc = jcfgs.get_smoke_config(arch)
        out.update(flat(jax.tree.map(np.asarray, jt.init_params(
            jc, jax.random.PRNGKey(i))), f"{name}/params"))
        for j in range(STEPS if name == "qwen3-4b" else 1):
            out.update(flat(_lm_batch(rng, jc.vocab_size),
                            f"{name}/batch{j}"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, [each rank's port outputs])."""
    import json
    out = tmp_path_factory.mktemp("tp_training")
    np.savez(out / "inputs.npz", **_inputs())
    spec = json.dumps({"models": MODELS, "grads": GRAD_CASES,
                       "optimizers": OPTIMIZERS})
    ref = subprocess.Popen(
        [sys.executable, "-c", JAX_PROGRAM, str(out), spec],
        env={**os.environ, "PYTHONPATH": SRC}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    os.environ["SPEC"] = spec
    try:
        ranks = spawn(PORT_PROGRAM, 8, out, "tp_training")
    finally:
        del os.environ["SPEC"]
    wait(ranks)
    text = ref.communicate(timeout=400)[0]
    assert "REFERENCE DONE" in text, text[-4000:]
    return (np.load(out / "ref.npz"),
            [np.load(out / f"port.rank{r}.npz") for r in range(8)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tree(res, prefix):
    return {k[len(prefix):]: res[k] for k in res.files
            if k.startswith(prefix + "/")}


@pytest.mark.parametrize("name, rules, vs_ref", GRAD_CASES)
def test_loss_and_every_gradient_leaf(runs, name, rules, vs_ref):
    ref, port = runs
    p0 = port[0]
    key = f"{name}/{rules}"
    wants = [(p0[f"{key}/meshless_loss"], _tree(p0, f"{key}/meshless_grads"))]
    if vs_ref:
        wants.append((ref[f"{key}/loss"], _tree(ref, f"{key}/grads")))
    grads = _tree(p0, f"{key}/grads")
    for loss, want in wants:
        np.testing.assert_allclose(p0[f"{key}/loss"], loss, rtol=REF_LOSS)
        assert grads.keys() == want.keys() and grads
        for leaf, g in grads.items():
            assert _rel(g, want[leaf]) <= REF_GRAD, (leaf, _rel(g, want[leaf]))
    for p in port[1:]:
        assert p[f"{key}/loss"] == p0[f"{key}/loss"]
        for leaf, g in _tree(p, f"{key}/grads").items():
            np.testing.assert_array_equal(g, grads[leaf], err_msg=leaf)


@pytest.mark.parametrize("name, rules, vs_ref", GRAD_CASES)
def test_gathered_rows_are_gathered_again_for_the_backward(runs, name, rules,
                                                          vs_ref):
    """Under ``regather_saved`` (the train step's) a forward keeps none
    of the parameters it gathered (FSDP rows) alive for its backward,
    where without it the saved ones stay whole; the gradients are the
    same bits."""
    _, port = runs
    for p in port:
        key = f"{name}/{rules}/regather"
        kept0, made0 = p[f"{key}0/kept"]
        kept1, made1 = p[f"{key}1/kept"]
        assert made0 == made1 > 0 and kept0 > 0 and kept1 == 0, (
            kept0, made0, kept1, made1)
        g0, g1 = _tree(p, f"{key}0/grads"), _tree(p, f"{key}1/grads")
        assert g0.keys() == g1.keys() and g0
        for leaf, g in g1.items():
            np.testing.assert_array_equal(g, g0[leaf], err_msg=leaf)


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_three_steps_with_compression_and_clipping(runs, opt):
    """Each step's loss and every gradient leaf (before clipping and
    compression) against the reference's and the port's meshless run;
    SGD momentum's parameters after the steps too.  (AdamW's and
    Adafactor's parameters are held through the gradients and
    ``test_the_update_of_blocks_is_the_update_of_whole_leaves``: their
    per-element normalization turns an int8 code that a last-bit
    difference rounds the other way into a visible step, so the three
    runs' parameters part in a few elements, the reference's from the
    port's meshless run as much as the sharded run's.)"""
    ref, port = runs
    p0 = port[0]
    assert bool(p0[f"train/{opt}/clipped"])
    for i in range(STEPS):
        for want in (ref[f"train/{opt}/loss{i}"],
                     p0[f"train/{opt}/meshless_loss{i}"]):
            np.testing.assert_allclose(p0[f"train/{opt}/loss{i}"], want,
                                       rtol=REF_LOSS)
        got = _tree(p0, f"train/{opt}/grads{i}")
        for want in (_tree(ref, f"train/{opt}/grads{i}"),
                     _tree(p0, f"train/{opt}/meshless_grads{i}")):
            assert got.keys() == want.keys() and got
            for leaf, v in got.items():
                assert _rel(v, want[leaf]) <= REF_GRAD, (
                    i, leaf, _rel(v, want[leaf]))
    got = _tree(p0, f"train/{opt}/params")
    if opt == "sgdm":
        for want in (_tree(ref, f"train/{opt}/params"),
                     _tree(p0, f"train/{opt}/meshless_params")):
            assert got.keys() == want.keys() and got
            for leaf, v in got.items():
                assert _rel(v, want[leaf]) <= REF_GRAD, (
                    leaf, _rel(v, want[leaf]))
    for p in port[1:]:
        for leaf, v in _tree(p, f"train/{opt}/params").items():
            np.testing.assert_array_equal(v, got[leaf], err_msg=leaf)


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_the_update_of_blocks_is_the_update_of_whole_leaves(runs, opt):
    """Clipping (a global norm over the blocks), int8 compression (the
    whole tensor's max|g|) and the optimizer (Adafactor's row and column
    means and update RMS over the blocks) on the rank's blocks of one
    set of gradients, gathered: the update of the whole leaves, to f32
    rounding."""
    _, port = runs
    for p in port:
        got = _tree(p, f"update/{opt}/sharded")
        want = _tree(p, f"update/{opt}/whole")
        assert got.keys() == want.keys() and got
        for leaf, v in got.items():
            assert _rel(v, want[leaf]) <= 1e-6, (leaf, _rel(v, want[leaf]))


@pytest.mark.parametrize("where", ["same_mesh", "81", "11"])
def test_a_sharded_checkpoint_restores_bitwise(runs, where):
    _, port = runs
    for p in port:
        saved = _tree(p, "ckpt/saved")
        if where == "same_mesh":
            assert bool(p["ckpt/same_mesh"])
            continue
        got = _tree(p, f"ckpt/{where}")
        assert got.keys() == saved.keys() and got
        for leaf, v in got.items():
            np.testing.assert_array_equal(v, saved[leaf], err_msg=leaf)
    if where == "81":
        # qwen3-4b's wq (2, 64, 64): its d_model rows over 8 ranks
        assert tuple(port[0]["ckpt/81_wq_shape"]) == (2, 8, 64)


def test_collective_gradients_are_the_meshless_ones(runs):
    _, port = runs
    for p in port:
        np.testing.assert_allclose(p["coll/grad"], p["coll/meshless_grad"],
                                   rtol=1e-12, atol=1e-12)
