"""Data-parallel training in the port (``training/train_loop.py`` under a
mesh, ``distributed/fault_tolerance.rescale_state``,
``launch/train.py`` in a cluster environment) on gloo ranks of an (n,
1) ("data", "model") mesh on the CPU:

  - the CAPSim predictor (``LOGICAL_RULES_PREDICTOR``, SGD momentum) and
    smoke-size qwen3-4b and llama4 (``LOGICAL_RULES_TRAIN``, AdamW) at 2
    and 4 ranks against 1 rank, from one init over 3 global batches:
    losses <= 1e-6 relative, parameters after 3 steps <= 1e-5 relative
    (llama4's capacity factor raised to 8 so that no token drops: the
    capacity is per device, so where it binds a DP split routes other
    tokens, as the reference's does);
  - the 2-rank loss and gradients against the reference's on a (2, 1)
    JAX mesh with the batch sharded over 'data' (loss <= 1e-5, each
    gradient leaf <= 1e-4 relative norm: the training port's gates);
  - a batch of 3 that does not divide over the ranks runs whole on every
    rank and equals 1 rank's step;
  - ``rescale_state``: a 2-rank run checkpointed at step 2 (rank 0
    writes) resumes at 1, 2 and 4 ranks; the next 3 steps match the
    unbroken 2-rank run within 1e-6, bitwise at 2;
  - ``launch/train.py`` under ``torchrun --standalone --nproc-per-node
    2`` on the CPU: rank 0 alone prints and writes, and its last
    checkpoint equals a 1-rank run's.

Each world size's program runs once per module (``tests/_torch_ranks.py``).
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
from repro.core import predictor as jp  # noqa: E402
from repro.models import transformer as jt  # noqa: E402

from _torch_ranks import SRC, flat, spawn, wait  # noqa: E402

LOSS_REL, PARAM_REL, RESUME_TOL = 1e-6, 1e-5, 1e-6
REF_LOSS, REF_GRAD = 1e-5, 1e-4
MODELS = ("capsim", "qwen3-4b", "llama4-maverick-400b-a17b")
STEPS, B, B_ODD, S = 3, 8, 3, 16

PORT_PROGRAM = r"""
from repro_torch.checkpoint.ckpt import CheckpointManager, restore
from repro_torch.configs import get_smoke_config
from repro_torch.configs.capsim import smoke_config as capsim_smoke
from repro_torch.core import predictor
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.fault_tolerance import rescale_state
from repro_torch.launch.mesh import make_mesh, make_test_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import params_from_numpy
from repro_torch.training.optimizer import tree_map
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_grad_fn, make_train_step)

inp = np.load(os.path.join(OUT, "inputs.npz"))
mesh = (make_mesh((WORLD, 1), ("data", "model"), "cpu") if WORLD > 1
        else make_test_mesh("cpu"))
res = {}
CAPSIM = capsim_smoke()


def model(name):
    if name == "capsim":
        return (lambda p, b: predictor.mape_loss(p, b, CAPSIM),
                TrainConfig(optimizer="sgdm", base_lr=1e-2),
                sh.LOGICAL_RULES_PREDICTOR)
    cfg = get_smoke_config(name).replace(capacity_factor=8.0)
    return (lambda p, b: tfm.loss_fn(p, b, cfg),
            TrainConfig(optimizer="adamw", base_lr=1e-2),
            sh.LOGICAL_RULES_TRAIN)


def batch(name, i):
    return {k.split("/")[-1]: torch.from_numpy(inp[k])
            for k in inp.files if k.startswith(f"{name}/batch{i}/")}


def flat_t(tree, prefix):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat_t(v, f"{prefix}/{k}").items()}
    return {prefix: tree.detach().numpy()}


for name in ("capsim", "qwen3-4b", "llama4-maverick-400b-a17b"):
    loss_fn, tcfg, rules = model(name)
    params = params_from_numpy(load_tree(inp, f"{name}/params"), "cpu")
    with sh.use_mesh_and_rules(mesh, rules):
        loss, _, grads = make_grad_fn(loss_fn, tcfg)(params, batch(name, 0))
        res[f"{name}/grad_loss"] = loss.item()
        res.update(flat_t(grads, f"{name}/grads"))
        step = make_train_step(loss_fn, tcfg)
        state = init_train_state(params, tcfg)
        for i in range(3):
            state, m = step(state, batch(name, i))
            res[f"{name}/loss{i}"] = m["loss"].item()
        res.update(flat_t(state["params"], f"{name}/params"))
        # a batch of 3 rows: whole on every rank
        state, m = step(init_train_state(params, tcfg), batch(name, "odd"))
        res[f"{name}/odd_loss"] = m["loss"].item()
        res.update(flat_t(state["params"], f"{name}/odd_params"))

# elastic restart: checkpointed by the 2-rank run at step 2
loss_fn, tcfg, rules = model("capsim")
params = params_from_numpy(load_tree(inp, "capsim/params"), "cpu")
ckpt_dir = os.path.join(OUT, "ckpt")
with sh.use_mesh_and_rules(mesh, rules):
    step = make_train_step(loss_fn, tcfg)
    state = init_train_state(params, tcfg)
    if os.environ["PHASE"] == "first":
        for i in range(2):
            state, _ = step(state, batch("capsim", i))
        ckpt = CheckpointManager(ckpt_dir, writer=RANK == 0)
        ckpt.save(state, 2)
        ckpt.wait()
        for i in range(2, 5):
            state, _ = step(state, batch("capsim", i))
        res.update(flat_t(state["params"], "unbroken"))
        dist.barrier()
    host = restore(state, 2, ckpt_dir, device="cpu")
    state = rescale_state(host, tree_map(
        lambda a: sh.NamedSharding(mesh, sh.P()), host))
    for i in range(2, 5):
        state, _ = step(state, batch("capsim", i))
    res.update(flat_t(state["params"], "resumed"))
    res["resumed_step"] = int(state["step"])
np.savez(os.path.join(OUT, f"world{WORLD}.rank{RANK}.npz"), **res)
"""

JAX_PROGRAM = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import get_config, get_smoke_config
from repro.core import predictor
from repro.distributed import sharding as sh
from repro.launch.mesh import make_mesh_compat
from repro.models import transformer as tfm

out_dir = sys.argv[1]
inp = np.load(os.path.join(out_dir, "inputs.npz"))
mesh = make_mesh_compat((2, 1), ("data", "model"))
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


capsim = get_config("capsim").replace(
    d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
    vocab_size=256, clip_tokens=16, context_tokens=36, dtype="float32")
for name, rules, loss in (
        ("capsim", sh.LOGICAL_RULES_PREDICTOR,
         lambda p, b: predictor.mape_loss(p, b, capsim)),
        ("qwen3-4b", sh.LOGICAL_RULES_TRAIN,
         lambda p, b: tfm.loss_fn(p, b, get_smoke_config("qwen3-4b")))):
    params = tree(f"{name}/params")
    batch = {k: jax.device_put(v, NamedSharding(mesh, P("data")))
             for k, v in tree(f"{name}/batch0").items()}
    with sh.use_mesh_and_rules(mesh, rules), mesh:
        (l, _), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params, batch)
    res[f"{name}/loss"] = l
    for path, v in jax.tree_util.tree_flatten_with_path(g)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        res[f"{name}/grads/{key}"] = v
np.savez(os.path.join(out_dir, "ref.npz"),
         **{k: np.asarray(v) for k, v in res.items()})
print("REFERENCE DONE")
"""


def _capsim_batch(rng, n):
    V, T, L, M = 256, 16, 24, 36
    tok = rng.randint(1, V, (n, L, T)).astype(np.int32)
    lens = rng.randint(2, T + 1, (n, L))
    tok[np.arange(T) >= lens[..., None]] = 0
    return {"clip_tokens": tok,
            "context_tokens": rng.randint(1, V, (n, M)).astype(np.int32),
            "clip_mask": np.ones((n, L), np.float32),
            "time": rng.uniform(50.0, 500.0, n).astype(np.float32)}


def _lm_batch(rng, n, vocab):
    tok = rng.randint(0, vocab, (n, S + 1))
    return {"tokens": tok[:, :-1].astype(np.int64),
            "labels": tok[:, 1:].astype(np.int64),
            "loss_mask": np.ones((n, S), np.float32)}


def _inputs():
    rng = np.random.RandomState(0)
    jcap = jcfgs.get_config("capsim").replace(
        d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
        vocab_size=256, clip_tokens=16, context_tokens=36, dtype="float32")
    out = flat(jax.tree.map(np.asarray, jp.init_params(
        jcap, jax.random.PRNGKey(0))), "capsim/params")
    for i in range(5):
        out.update(flat(_capsim_batch(rng, B), f"capsim/batch{i}"))
    out.update(flat(_capsim_batch(rng, B_ODD), "capsim/batchodd"))
    for j, arch in enumerate(MODELS[1:]):
        jc = jcfgs.get_smoke_config(arch)
        out.update(flat(jax.tree.map(np.asarray, jt.init_params(
            jc, jax.random.PRNGKey(j + 1))), f"{arch}/params"))
        for i in range(STEPS):
            out.update(flat(_lm_batch(rng, 4, jc.vocab_size),
                            f"{arch}/batch{i}"))
        out.update(flat(_lm_batch(rng, B_ODD, jc.vocab_size),
                        f"{arch}/batchodd"))
    return out


def _run(out, world, phase):
    os.environ["PHASE"] = phase
    try:
        return spawn(PORT_PROGRAM, world, out, f"world{world}")
    finally:
        del os.environ["PHASE"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world size: rank 0's outputs}, the reference's, and every rank's
    outputs at 4."""
    out = tmp_path_factory.mktemp("dp")
    np.savez(out / "inputs.npz", **_inputs())
    ref = subprocess.Popen([sys.executable, "-c", JAX_PROGRAM, str(out)],
                           env={**os.environ, "PYTHONPATH": SRC},
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    wait(_run(out, 2, "first"))
    procs = _run(out, 1, "resume") + _run(out, 4, "resume")
    wait(procs)
    text = ref.communicate(timeout=300)[0]
    assert "REFERENCE DONE" in text, text[-4000:]
    worlds = {n: np.load(out / f"world{n}.rank0.npz") for n in (1, 2, 4)}
    return worlds, np.load(out / "ref.npz"), [
        np.load(out / f"world4.rank{r}.npz") for r in range(4)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _params(res, prefix):
    return {k: res[k] for k in res.files if k.startswith(prefix + "/")}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", MODELS)
def test_data_parallel_steps_equal_one_rank(runs, name, world):
    worlds, _, _ = runs
    one, many = worlds[1], worlds[world]
    for i in range(STEPS):
        np.testing.assert_allclose(many[f"{name}/loss{i}"],
                                   one[f"{name}/loss{i}"], rtol=LOSS_REL)
    p1 = _params(one, f"{name}/params")
    for k, v in _params(many, f"{name}/params").items():
        assert _rel(v, p1[k]) <= PARAM_REL, k


def test_every_rank_holds_the_same_state(runs):
    _, _, ranks = runs
    for r in ranks[1:]:
        for k in ranks[0].files:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("name", MODELS[:2])
def test_two_ranks_match_the_reference_mesh(runs, name):
    worlds, ref, _ = runs
    two = worlds[2]
    np.testing.assert_allclose(two[f"{name}/grad_loss"], ref[f"{name}/loss"],
                               rtol=REF_LOSS)
    grads = _params(two, f"{name}/grads")
    assert grads
    for k, v in grads.items():
        assert _rel(v, ref[k]) <= REF_GRAD, k


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", MODELS[:2])
def test_an_indivisible_batch_runs_whole_on_every_rank(runs, name, world):
    worlds, _, _ = runs
    one, many = worlds[1], worlds[world]
    np.testing.assert_allclose(many[f"{name}/odd_loss"],
                               one[f"{name}/odd_loss"], rtol=LOSS_REL)
    p1 = _params(one, f"{name}/odd_params")
    for k, v in _params(many, f"{name}/odd_params").items():
        assert _rel(v, p1[k]) <= PARAM_REL, k


@pytest.mark.parametrize("world", [1, 2, 4])
def test_rescale_state_resumes_a_two_rank_checkpoint(runs, world):
    worlds, _, _ = runs
    unbroken = _params(worlds[2], "unbroken")
    resumed = _params(worlds[world], "resumed")
    assert int(worlds[world]["resumed_step"]) == 5
    assert len(resumed) == len(unbroken) > 0
    for k, v in resumed.items():
        want = unbroken["unbroken" + k[len("resumed"):]]
        if world == 2:
            np.testing.assert_array_equal(v, want, err_msg=k)
        else:
            np.testing.assert_allclose(v, want, rtol=RESUME_TOL,
                                       atol=RESUME_TOL, err_msg=k)


def test_a_checkpoint_manager_that_does_not_write(tmp_path):
    from repro_torch.checkpoint.ckpt import CheckpointManager
    state = {"w": torch.ones(3), "step": torch.zeros((), dtype=torch.int32)}
    for name, writer in (("r1", False), ("r0", True)):
        ckpt = CheckpointManager(str(tmp_path / name), writer=writer)
        ckpt.save(state, 1)
        ckpt.wait()
        assert (tmp_path / name).exists() == writer


def test_launcher_under_torchrun_two_ranks(tmp_path):
    """``torchrun --standalone --nproc-per-node 2`` (a free port of its
    own): rank 0 prints and writes; the last checkpoint's parameters
    equal a 1-rank run's within 1e-5."""
    from repro_torch.checkpoint import ckpt as ckpt_mod
    args = ["-m", "repro_torch.launch.train", "--device", "cpu", "--smoke",
            "--steps", "4", "--batch-size", "8", "--n-benchmarks", "3",
            "--save-every", "2", "--interval-size", "2000"]
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2"] + args + ["--ckpt-dir",
                                            str(tmp_path / "two")],
        env=env, capture_output=True, text=True, timeout=300)
    assert two.returncode == 0, two.stdout[-3000:] + two.stderr[-3000:]
    one = subprocess.run([sys.executable] + args + [
        "--ckpt-dir", str(tmp_path / "one")], env=env, capture_output=True,
        text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    assert two.stdout.count("trained to step 4") == 1
    assert ckpt_mod.latest_step(str(tmp_path / "two")) == 4
    entries = ckpt_mod.read_manifest(4, str(tmp_path / "two"))["entries"]
    assert entries.keys() == ckpt_mod.read_manifest(
        4, str(tmp_path / "one"))["entries"].keys()
    for key, entry in entries.items():
        a = np.load(tmp_path / "two" / "step_00000004" / entry["file"])
        b = np.load(tmp_path / "one" / "step_00000004" / entry["file"])
        if a.dtype.kind == "f":
            assert _rel(a, b) <= PARAM_REL, key
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["capsim", "llama4-maverick-400b-a17b"])
def test_launcher_at_world_size_one_is_the_meshless_run(tmp_path,
                                                         monkeypatch, arch):
    """Without a cluster environment the launcher runs under the
    reference's ``make_test_mesh()``: its state is bitwise the run with
    no mesh at all (llama4's MoE layer takes the expert-parallel path
    over one shard)."""
    import contextlib

    from repro_torch.launch import train as train_mod
    from repro_torch.training.optimizer import tree_leaves
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    args = ["--device", "cpu", "--smoke", "--steps", "3", "--arch", arch,
            "--batch-size", "8", "--n-benchmarks", "3", "--seq-len", "16",
            "--interval-size", "2000"]
    meshed = train_mod.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    monkeypatch.setattr(train_mod, "use_mesh_and_rules",
                        lambda mesh, rules: contextlib.nullcontext())
    bare = train_mod.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert int(meshed["step"]) == int(bare["step"]) == 3
    for a, b in zip(tree_leaves(meshed), tree_leaves(bare)):
        assert torch.equal(a, b)
