"""The reference against the port's plain path (its CPU route) at a
small width: the forward, the MAPE loss and its gradient, and SGD-momentum
steps with clipping and the warm-up schedule."""
import numpy as np
import pytest
import torch

from capsim_bench import compare, inputs
from capsim_bench.drivers.service_closed_loop import arch_config
from capsim_bench.reference import capsim as ref

C = dict(name="small", d_model=32, num_heads=2, head_dim=16, d_ff=64,
         n_inst_layers=4, n_block_layers=4, vocab_size=512, clip_tokens=16,
         clip_len=128, context_tokens=360, n_cores=1, peer_channels=False,
         param_dtype="float32", remat=False)
SCHED = dict(base_lr=0.05, warmup_steps=1, total_steps=10, grad_clip=1.0,
             momentum=0.9)


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    t = {"programs": ["503.bwaves", "505.mcf"], "interval": 2000,
         "warmup": 200, "checkpoints": 1}
    d = inputs.train_set(t, C, tmp_path_factory.mktemp("inputs"))
    n = 12
    return {"clip_tokens": torch.from_numpy(d["clip_tokens"][:n].astype(
                np.int32)),
            "context_tokens": torch.from_numpy(
                d["context_tokens"][:n].astype(np.int32)),
            "clip_mask": torch.from_numpy(d["clip_mask"][:n].astype(
                np.float32)),
            "time": torch.from_numpy(d["time"][:n])}


def test_forward_is_the_ports(batch):
    from repro_torch.core import predictor
    p = ref.make_params(C, 3, "cpu")
    want = ref.forward(p, batch["clip_tokens"], batch["context_tokens"],
                       batch["clip_mask"], C)
    got = predictor.forward(p, batch, arch_config(C, "float32"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_loss_and_gradient_are_the_ports(batch):
    from repro_torch.core import predictor
    from repro_torch.training import train_loop
    p = ref.make_params(C, 4, "cpu")
    cfg = arch_config(C, "float32")
    (loss, _), grads = train_loop.value_and_grad(
        lambda q, b: predictor.mape_loss(q, b, cfg), p, batch)
    want_loss, want = ref.mape_grads(p, batch, C)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    for (k, g), (_, w) in zip(ref.leaves(grads), ref.leaves(want)):
        assert float((g - w).norm() / w.norm()) < 1e-4, k


def test_sgd_momentum_steps_are_the_ports(batch):
    from repro_torch.core import predictor
    from repro_torch.training import train_loop
    p = ref.make_params(C, 5, "cpu")
    cfg = arch_config(C, "float32")
    tcfg = train_loop.TrainConfig(optimizer="sgdm", **SCHED)
    step = train_loop.make_train_step(
        lambda q, b: predictor.mape_loss(q, b, cfg), tcfg)
    state = train_loop.init_train_state(p, tcfg)
    halves = [{k: v[:6] for k, v in batch.items()},
              {k: v[6:] for k, v in batch.items()}]
    losses = []
    for i, b in enumerate(halves):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if i == 0:
            mu = state["opt"]["mu"]
    want_l, want_g, want_p = ref.sgdm_steps(p, halves, C, SCHED)
    r = compare.train_readings(
        {"losses": losses, "grad": compare.leaf_norms(ref.leaves(mu)),
         "change": compare.leaf_norms(
             (k, a - b) for (k, a), (_, b) in zip(
                 ref.leaves(state["params"]), ref.leaves(p)))},
        {"losses": want_l, "grad": compare.leaf_norms(ref.leaves(want_g)),
         "change": compare.leaf_norms(
             (k, a - b) for (k, a), (_, b) in zip(ref.leaves(want_p),
                                                  ref.leaves(p)))})
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-4
    assert r["change_gap"] < 1e-4


def test_weights_follow_the_seed():
    a = ref.make_params(C, 7, "cpu")
    b = ref.make_params(C, 7, "cpu")
    c = ref.make_params(C, 8, "cpu")
    for (_, x), (_, y), (_, z) in zip(ref.leaves(a), ref.leaves(b),
                                      ref.leaves(c)):
        assert torch.equal(x, y) and not torch.equal(x, z)
