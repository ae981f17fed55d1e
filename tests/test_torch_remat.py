"""Activation rematerialization (``cfg.remat``) in the port on the CPU: a
train step's gradients with remat on equal those with it off, bit for
bit, where the backward recomputes each encoder layer (CAPSim) or each
super-block (the LM zoo) instead of keeping its activations.  The
recompute runs the same operations on the same inputs, so every
gradient leaf is bitwise; no leaf needed a tolerance.

Cases: the CAPSim smoke predictor single-core (M = 36) and at the
multicore context width (M = 369), with and without context; qwen3-4b
and jamba (attention, SSM and MoE layers in one super-block of 8) at
smoke size with no mesh; and two gloo ranks (``tests/_torch_ranks.py``)
under ``LOGICAL_RULES_TRAIN_FSDP`` on a (2, 1) mesh (the FSDP rows
gathered again in the recompute, under ``collectives.regather_saved``)
and under ``LOGICAL_RULES_TRAIN`` with 'model' = 2 on (1, 2) (the
row-parallel sums run again), each rank's gradient blocks compared, also
with the backward run on a thread of its own (where the autograd engine
runs it on the card: the recompute must bring the forward's mesh, rules
and layout along)."""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from _torch_ranks import spawn, wait  # noqa: E402
from repro_torch.configs import capsim as port_capsim  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import predictor as tp  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch.specs import random_batch  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402
from repro_torch.training.train_loop import value_and_grad  # noqa: E402


def _capsim_batch(rng, cfg, M, B=4, L=12):
    V, T = cfg.vocab_size, cfg.clip_tokens
    tok = rng.randint(1, V, (B, L, T)).astype(np.int64)
    lens = rng.randint(1, T + 1, (B, L))
    tok[np.arange(T) >= lens[..., None]] = 0
    mask = np.ones((B, L), np.float32)
    mask[-1, 7:] = 0.0
    tok[mask == 0] = 0
    return {"clip_tokens": torch.from_numpy(tok),
            "context_tokens": torch.from_numpy(
                rng.randint(1, V, (B, M)).astype(np.int64)),
            "clip_mask": torch.from_numpy(mask),
            "time": torch.from_numpy(rng.uniform(50, 400, (B,)
                                                 ).astype(np.float32))}


def _grads(loss_fn, params, batch):
    (loss, _), grads = value_and_grad(loss_fn, params, batch)
    return loss, tree_leaves(grads)


def _assert_bitwise(a, b):
    (la, ga), (lb, gb) = a, b
    assert torch.equal(la, lb)
    assert len(ga) == len(gb)
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("M,use_context", [(36, True), (369, True),
                                           (36, False)])
def test_capsim_gradients_bitwise(M, use_context):
    cfg = port_capsim.smoke_config()
    assert cfg.remat is False and port_capsim.config().remat is True
    params = tp.init_params(cfg, seed=0, device="cpu")
    batch = _capsim_batch(np.random.RandomState(M), cfg, M)
    runs = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        runs[remat] = _grads(
            lambda p, b: tp.mape_loss(p, b, c, use_context), params, batch)
    _assert_bitwise(runs[False], runs[True])


def test_capsim_remat_recomputes_the_attention():
    """The backward's recompute calls the attention wrapper once more per
    layer (on the card: one more flash launch each); inference is
    unchanged."""
    cfg = port_capsim.smoke_config()
    params = tp.init_params(cfg, seed=0, device="cpu")
    batch = _capsim_batch(np.random.RandomState(3), cfg, 36)
    calls = []
    plain = fa_ops.flash_attention_plain

    def counting(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)
    fa_ops.flash_attention_plain = counting
    try:
        n = {}
        for remat in (False, True):
            calls.clear()
            _grads(lambda p, b: tp.mape_loss(p, b, cfg.replace(
                remat=remat)), params, batch)
            n[remat] = len(calls)
        calls.clear()
        with torch.no_grad():
            tp.predict_step(params, batch, cfg.replace(remat=True))
        n["inference"] = len(calls)
    finally:
        fa_ops.flash_attention_plain = plain
    # 4 instruction-encoder + 8 block-encoder attentions a forward
    assert n == {False: 12, True: 24, "inference": 12}


@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-1.5-large-398b"])
def test_zoo_gradients_bitwise(arch, monkeypatch):
    """Bitwise, and the backward ran every layer a second time."""
    cfg = get_smoke_config(arch).replace(capacity_factor=8.0)
    params = tfm.init_params(cfg, seed=0, device="cpu")
    batch = random_batch(cfg, ShapeConfig("t", 16, 2, "train"), "train",
                         seed=1, device="cpu")
    calls = []
    block = tfm._block_forward

    def counting(*a, **kw):
        calls.append(1)
        return block(*a, **kw)
    monkeypatch.setattr(tfm, "_block_forward", counting)
    runs, layers = {}, {}
    for remat in (False, True):
        calls.clear()
        runs[remat] = _grads(lambda p, b: tfm.loss_fn(p, b, cfg.replace(
            remat=remat)), params, batch)
        layers[remat] = len(calls)
    _assert_bitwise(runs[False], runs[True])
    assert layers == {False: cfg.num_layers, True: 2 * cfg.num_layers}


PROGRAM = r"""
import json
import threading
from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import random_batch
from repro_torch.models import transformer as tfm
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import TrainConfig, make_grad_fn

grad = torch.autograd.grad


def grad_on_a_thread(*a, **kw):
    # the backward on a thread of its own, with no mesh, rules or layout
    # active there, as the autograd engine runs it on the card
    out = {}
    t = threading.Thread(target=lambda: out.update(g=grad(*a, **kw)))
    t.start()
    t.join()
    return out["g"]


res = {}
for tag, shape, rules_name, arch in json.loads(os.environ["CASES"]):
    cfg = get_smoke_config(arch).replace(capacity_factor=8.0)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    batch = random_batch(cfg, ShapeConfig("t", 16, 4, "train"), "train",
                         seed=2, device="cpu")
    with sh.use_mesh_and_rules(mesh, getattr(sh, rules_name)):
        params = tfm.init_params(cfg, seed=0, device="cpu", mesh=mesh)
        for remat in (0, 1, 2):        # 2: the backward on a thread
            c = cfg.replace(remat=bool(remat))
            torch.autograd.grad = grad_on_a_thread if remat == 2 else grad
            loss, _, grads = make_grad_fn(
                lambda p, b: tfm.loss_fn(p, b, c), TrainConfig())(params,
                                                                  batch)
            torch.autograd.grad = grad
            res[f"{tag}/{remat}/loss"] = loss.numpy()
            for i, g in enumerate(tree_leaves(grads)):
                res[f"{tag}/{remat}/g{i}"] = g.numpy()
np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **res)
# every rank leaves the group together: a rank that exits while gloo's
# threads still talk to the others can abort at exit
dist.barrier()
dist.destroy_process_group()
"""
RANK_CASES = [("fsdp", (2, 1), "LOGICAL_RULES_TRAIN_FSDP", "qwen3-4b"),
              ("tp", (1, 2), "LOGICAL_RULES_TRAIN", "qwen3-4b"),
              ("tp_jamba", (1, 2), "LOGICAL_RULES_TRAIN",
               "jamba-1.5-large-398b")]


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("remat_ranks")
    os.environ["CASES"] = json.dumps(RANK_CASES)
    try:
        wait(spawn(PROGRAM, 2, out, "remat"), timeout=400)
    finally:
        del os.environ["CASES"]
    return [np.load(out / f"rank{r}.npz") for r in range(2)]


@pytest.mark.parametrize("tag", [c[0] for c in RANK_CASES])
def test_two_ranks_gradients_bitwise(rank_runs, tag):
    for res in rank_runs:
        keys = sorted(k[len(f"{tag}/0/"):] for k in res.files
                      if k.startswith(f"{tag}/0/"))
        assert len(keys) > 2
        for k in keys:
            a = res[f"{tag}/0/{k}"]
            for remat in (1, 2):
                b = res[f"{tag}/{remat}/{k}"]
                assert a.shape == b.shape and np.array_equal(a, b), \
                    (remat, k)


def test_remat_is_a_config_field_of_every_arch():
    from repro_torch.configs import ARCH_NAMES, get_config
    for name in ARCH_NAMES:
        assert get_config(name).remat is True
        assert get_smoke_config(name).remat is False
        assert "remat" in {f.name for f in dataclasses.fields(
            type(get_config(name)))}
