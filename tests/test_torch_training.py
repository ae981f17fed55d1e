"""The port's training machinery against the JAX reference on the CPU:
the counterpart of each case of ``tests/test_training.py`` on the same
quadratic loss (optimizers, microbatching, clipping, compression with
error feedback, checkpoints, the crash-restart loop, straggler
detection, signal handling), each optimizer's step and the LR schedule
against the reference's numbers, and the microbatch aux fault of the
reference (pinned) beside the port's accumulation of any aux keys."""
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import signal  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import compression as jcomp  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import schedule as jsched  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.checkpoint.ckpt import (CheckpointManager,  # noqa: E402
                                         latest_step, restore, save)
from repro_torch.distributed.compression import (  # noqa: E402
    compress_decompress, init_error_feedback, quantize)
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    ResilientTrainer, StragglerMonitor, timed_step)
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import schedule as tsched  # noqa: E402
from repro_torch.training.train_loop import (TrainConfig,  # noqa: E402
                                             init_train_state,
                                             make_train_step)


def _quadratic_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = ((pred - batch["y"]) ** 2).mean()
    zero = torch.zeros(())
    return loss, {"ce": loss, "lb": zero, "z": zero}


def _data():
    rng = np.random.RandomState(0)
    x = rng.randn(8, 3).astype(np.float32)
    w_true = np.array([[1.0], [-2.0], [0.5]], np.float32)
    return x, x @ w_true + 0.3


def _setup(optimizer="sgdm", **kw):
    tcfg = TrainConfig(optimizer=optimizer, base_lr=0.05, warmup_steps=0,
                       total_steps=100, **kw)
    params = {"w": torch.zeros(3, 1), "b": torch.zeros(1)}
    state = init_train_state(params, tcfg)
    step = make_train_step(_quadratic_loss, tcfg)
    x, y = _data()
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    return tcfg, state, step, batch


def _leaves(tree):
    return topt.tree_leaves(tree)


def test_sgd_converges():
    _, state, step, batch = _setup()
    for _ in range(150):
        state, m = step(state, batch)
    assert float(m["loss"]) < 1e-2


def test_adamw_state_and_convergence():
    _, state, step, batch = _setup("adamw")
    assert "nu" in state["opt"]
    for _ in range(150):
        state, m = step(state, batch)
    assert float(m["loss"]) < 5e-2


def test_adafactor_converges():
    _, state, step, batch = _setup("adafactor")
    assert set(state["opt"]["v"]["w"]) == {"vr", "vc"}
    assert set(state["opt"]["v"]["b"]) == {"v"}
    for _ in range(150):
        state, m = step(state, batch)
    assert float(m["loss"]) < 5e-2


@pytest.mark.parametrize("name,kw", [
    ("sgdm", {}), ("sgdm", {"weight_decay": 0.01}),
    ("sgdm", {"state_dtype": "bfloat16"}), ("adamw", {}),
    ("adafactor", {})])
def test_one_update_matches_reference(name, kw):
    """Three updates of each optimizer from the same parameters and
    gradients, a 2-D and a 1-D leaf, in f32 and bf16 parameters: <= 1e-6
    from ``jax`` ``opt.update`` (bitwise where the arithmetic is the
    same ops)."""
    rng = np.random.RandomState(1)
    for dt in ("float32", "bfloat16"):
        p = {"w": rng.randn(4, 5).astype(np.float32),
             "b": rng.randn(5).astype(np.float32)}
        jo, to = jopt.get_optimizer(name, **kw), topt.get_optimizer(name, **kw)
        jp = jax.tree.map(lambda a: jnp.asarray(a, dt), p)
        tp = topt.tree_map(
            lambda a: torch.from_numpy(a).to(getattr(torch, dt)), p)
        js, ts = jo.init(jp), to.init(tp)
        for i in range(3):
            g = {"w": rng.randn(4, 5).astype(np.float32),
                 "b": rng.randn(5).astype(np.float32)}
            lr = 1e-2 * (i + 1)
            jp, js = jo.update(jax.tree.map(lambda a: jnp.asarray(a, dt), g),
                               js, jp, jnp.float32(lr))
            tp, ts = to.update(topt.tree_map(
                lambda a: torch.from_numpy(a).to(getattr(torch, dt)), g),
                ts, tp, torch.tensor(lr, dtype=torch.float32))
        for a, b in zip(jax.tree_util.tree_leaves((jp, js)),
                        _leaves({"p": tp, "s": ts})):
            a = np.asarray(jnp.asarray(a, jnp.float32))
            b = b.float().numpy()
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_schedule_matches_reference():
    for steps in (0, 1, 7, 20, 55, 100, 140):
        for sched in ((jsched.warmup_cosine(1e-3, 20, 100),
                       tsched.warmup_cosine(1e-3, 20, 100)),
                      (jsched.warmup_cosine(0.05, 0, 100),
                       tsched.warmup_cosine(0.05, 0, 100)),
                      (jsched.constant(3e-4), tsched.constant(3e-4))):
            a = float(sched[0](jnp.int32(steps)))
            b = sched[1](torch.tensor(steps, dtype=torch.int32))
            assert b.dtype == torch.float32
            np.testing.assert_allclose(float(b), a, rtol=1e-6)


def test_train_steps_match_reference():
    """Five steps of the whole train step (clip, schedule with warm-up,
    update) from the same state: <= 1e-6 from the reference's."""
    kw = dict(base_lr=0.05, warmup_steps=2, total_steps=10, grad_clip=0.5)
    x, y = _data()
    for opt in ("sgdm", "adamw", "adafactor"):
        jt = jtl.TrainConfig(optimizer=opt, **kw)
        tt = TrainConfig(optimizer=opt, **kw)
        js = jtl.init_train_state({"w": jnp.zeros((3, 1)),
                                   "b": jnp.zeros((1,))}, jt)
        ts = init_train_state({"w": torch.zeros(3, 1), "b": torch.zeros(1)},
                              tt)
        jstep = jax.jit(jtl.make_train_step(_jax_quadratic, jt))
        tstep = make_train_step(_quadratic_loss, tt)
        jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
        for _ in range(5):
            js, jm = jstep(js, jb)
            ts, tm = tstep(ts, tb)
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-6, atol=1e-7)
        for k in ("w", "b"):
            np.testing.assert_allclose(ts["params"][k].numpy(),
                                       np.asarray(js["params"][k]),
                                       rtol=1e-6, atol=1e-7)
        assert int(ts["step"]) == int(js["step"]) == 5


def _jax_quadratic(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = jnp.mean((pred - batch["y"]) ** 2)
    return loss, {"ce": loss, "lb": jnp.zeros(()), "z": jnp.zeros(())}


def test_microbatch_equivalence():
    """Gradient accumulation over 4 microbatches == single big batch."""
    _, s1, step1, batch = _setup()
    tcfg4 = TrainConfig(optimizer="sgdm", base_lr=0.05, warmup_steps=0,
                        total_steps=100, microbatches=4)
    s4 = init_train_state({"w": torch.zeros(3, 1), "b": torch.zeros(1)},
                          tcfg4)
    step4 = make_train_step(_quadratic_loss, tcfg4)
    s1b, m1 = step1(s1, batch)
    s4b, m4 = step4(s4, batch)
    np.testing.assert_allclose(s1b["params"]["w"].numpy(),
                               s4b["params"]["w"].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)


def _mape_like_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    fact = batch["y"].abs().clamp(min=1.0)
    mape = ((pred - fact).abs() / fact).mean()
    return mape, {"mape": mape}


def test_reference_microbatching_refuses_other_aux_keys():
    """Pinned fault of the reference, which stays as it is: its
    microbatch scan seeds the aux sums with the LM zoo's keys
    (``train_loop.py:123-125``), so a loss whose aux is ``{"mape"}``
    (``predictor.mape_loss``) fails with ``microbatches > 1``."""
    def jloss(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        fact = jnp.maximum(jnp.abs(batch["y"]), 1.0)
        mape = jnp.mean(jnp.abs(pred - fact) / fact)
        return mape, {"mape": mape}
    x, y = _data()
    tcfg = jtl.TrainConfig(optimizer="sgdm", microbatches=2)
    state = jtl.init_train_state({"w": jnp.zeros((3, 1)),
                                  "b": jnp.zeros((1,))}, tcfg)
    step = jtl.make_train_step(jloss, tcfg)
    with pytest.raises(ValueError, match="Dict key mismatch"):
        step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)})


def test_port_microbatching_accumulates_any_aux():
    """The port sums whatever aux the loss returns: 2 microbatches of a
    MAPE loss give the mean of the two halves' MAPEs, and the update of
    the averaged gradient, as one JAX step per half averaged by hand."""
    x, y = _data()
    tcfg = TrainConfig(optimizer="sgdm", base_lr=0.05, warmup_steps=0,
                       total_steps=100, microbatches=2, grad_clip=1e9)
    state = init_train_state({"w": torch.zeros(3, 1), "b": torch.zeros(1)},
                             tcfg)
    new, m = make_train_step(_mape_like_loss, tcfg)(
        state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    assert set(m) == {"loss", "grad_norm", "lr", "mape"}
    halves, grads = [], []
    for lo in (0, 4):
        p = {"w": torch.zeros(3, 1, requires_grad=True),
             "b": torch.zeros(1, requires_grad=True)}
        loss, aux = _mape_like_loss(p, {"x": torch.from_numpy(x[lo:lo + 4]),
                                        "y": torch.from_numpy(y[lo:lo + 4])})
        halves.append(float(aux["mape"].detach()))
        grads.append(torch.autograd.grad(loss, [p["w"], p["b"]]))
    np.testing.assert_allclose(float(m["mape"]), np.mean(halves), rtol=1e-6)
    np.testing.assert_allclose(float(m["loss"]), np.mean(halves), rtol=1e-6)
    lr = float(m["lr"])
    for key, i in (("w", 0), ("b", 1)):
        g = (grads[0][i] + grads[1][i]) * 0.5
        np.testing.assert_allclose(new["params"][key].numpy(),
                                   (-lr * g).numpy(), rtol=1e-6, atol=1e-8)


def test_grad_clipping_bounds_update():
    tcfg = TrainConfig(optimizer="sgdm", base_lr=1.0, grad_clip=1e-3,
                       warmup_steps=0, total_steps=10)
    state = init_train_state({"w": torch.zeros(3, 1), "b": torch.zeros(1)},
                             tcfg)
    step = make_train_step(_quadratic_loss, tcfg)
    batch = {"x": torch.ones(4, 3) * 100, "y": torch.ones(4, 1) * 1e6}
    state, m = step(state, batch)
    upd = float(state["params"]["w"].abs().max())
    assert upd <= 1.1e-3 * tcfg.base_lr * 10  # clipped global norm


def test_compression_error_feedback():
    """int8 quantization with error feedback: deq + residual == g exactly,
    residual bounded by half a quantization step, the residual consumed
    on the next step, and the int8 codes and both outputs bitwise the
    reference's (``torch.round`` rounds half to even, as ``jnp.round``)."""
    g = {"w": torch.from_numpy(
        np.linspace(-1, 1, 64).reshape(8, 8).astype(np.float32))}
    err = init_error_feedback(g)
    cg, new_err = compress_decompress(g, err)
    np.testing.assert_allclose(cg["w"].numpy() + new_err["w"].numpy(),
                               g["w"].numpy(), rtol=0, atol=1e-6)
    scale = float(g["w"].abs().max()) / 127.0
    assert float(new_err["w"].abs().max()) <= scale / 2 + 1e-6
    cg2, err2 = compress_decompress(g, new_err)
    np.testing.assert_allclose(cg2["w"].numpy() + err2["w"].numpy(),
                               g["w"].numpy() + new_err["w"].numpy(),
                               rtol=0, atol=1e-6)
    # bitwise the reference's, on values that land on .5 steps too
    rng = np.random.RandomState(2)
    ties = (np.arange(-127, 128, 0.5) / 127.0).astype(np.float32)
    for arr in (rng.randn(5, 7).astype(np.float32) * 3, ties,
                rng.randn(33).astype(np.float32) * 1e-3):
        e = rng.randn(*arr.shape).astype(np.float32) * 1e-2
        j_out = jcomp.compress_decompress({"g": jnp.asarray(arr)},
                                          {"g": jnp.asarray(e)})
        t_out = compress_decompress({"g": torch.from_numpy(arr)},
                                    {"g": torch.from_numpy(e)})
        for a, b in zip(j_out, t_out):
            np.testing.assert_array_equal(b["g"].numpy(), np.asarray(a["g"]))
        q, s = quantize(torch.from_numpy(arr) + torch.from_numpy(e), (),
                        None)
        jg = jnp.asarray(arr) + jnp.asarray(e)
        js = jnp.maximum(jnp.max(jnp.abs(jg)) / 127.0, 1e-12)
        jq = jnp.clip(jnp.round(jg / js), -127, 127).astype(jnp.int8)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_checkpoint_roundtrip(tmp_path):
    _, state, step, batch = _setup()
    state, _ = step(state, batch)
    save(state, 1, str(tmp_path))
    assert latest_step(str(tmp_path)) == 1
    restored = restore(state, 1, str(tmp_path), device="cpu")
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_resilient_trainer_resumes(tmp_path):
    tcfg, state, step, batch = _setup()

    def make_trainer():
        return ResilientTrainer(
            step_fn=step, ckpt=CheckpointManager(str(tmp_path), keep=2),
            save_every=5)

    def batches(n):
        for _ in range(n):
            yield batch

    # first run: 7 steps -> checkpoints at 5 and (drain) 7
    s1, n1 = make_trainer().run(state, batches(7), total_steps=7)
    assert n1 == 7 and latest_step(str(tmp_path)) == 7
    # a restart restores the saved state bitwise before its first step
    restored, at = CheckpointManager(str(tmp_path)).restore_latest(
        state, device="cpu")
    assert at == 7
    for a, b in zip(_leaves(s1), _leaves(restored)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # second run resumes from 7 and continues to 12
    s2, n2 = make_trainer().run(state, batches(50), total_steps=12,
                                state_like=state)
    assert n2 == 12 and int(s2["step"]) == 12
    # loss keeps improving across the restart
    _, m1 = step(s1, batch)
    _, m2 = step(s2, batch)
    assert float(m2["loss"]) <= float(m1["loss"])


def test_async_save_copies_state_to_host_first(tmp_path):
    """The async save's thread writes the state as it was at ``save``:
    a state changed afterwards does not reach the checkpoint."""
    _, state, step, batch = _setup()
    state, _ = step(state, batch)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(state, 1)
    before = state["params"]["w"].clone()
    state["params"]["w"].add_(1.0)
    restored, at = mgr.restore_latest(state, device="cpu")
    assert at == 1
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  before.numpy())


def test_checkpoint_gc_keeps_k(tmp_path):
    _, state, step, batch = _setup()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(state, s)
    mgr.wait()
    steps = sorted(int(d.name[5:]) for d in tmp_path.iterdir()
                   if d.name.startswith("step_"))
    assert steps == [3, 4]


def test_straggler_monitor():
    mon = StragglerMonitor(n_hosts=4)
    for _ in range(10):
        for h, t in enumerate([1.0, 1.05, 0.95, 2.5]):
            mon.record(h, t)
    assert mon.stragglers() == [3]
    w = mon.rebalance()
    assert w[3] < 0.6 and abs(float(w.sum()) - 4.0) < 1e-6
    _, state, step, batch = _setup()
    state, m, seconds = timed_step(step)(state, batch)
    assert seconds > 0 and int(state["step"]) == 1


def test_signal_handlers_chain_and_restore(tmp_path):
    _, state, step, batch = _setup()
    trainer = ResilientTrainer(
        step_fn=step, ckpt=CheckpointManager(str(tmp_path), keep=2))
    seen = []
    prev_term = signal.getsignal(signal.SIGTERM)
    prev_int = signal.getsignal(signal.SIGINT)
    signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        trainer.install_signal_handler()
        trainer.install_signal_handler()          # idempotent
        # SIGTERM: preemption flagged AND the launcher's hook still ran
        signal.raise_signal(signal.SIGTERM)
        assert trainer._preempted and seen == [signal.SIGTERM]
        # SIGINT is preemption too: a drain, not KeyboardInterrupt
        trainer._preempted = False
        signal.raise_signal(signal.SIGINT)
        assert trainer._preempted
        trainer.uninstall_signal_handler()
        # pre-install handlers are back (ours for TERM, python's for INT)
        signal.raise_signal(signal.SIGTERM)
        assert seen == [signal.SIGTERM, signal.SIGTERM]
        assert signal.getsignal(signal.SIGINT) is prev_int
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)


def test_preemption_drains_and_run_restores_handlers(tmp_path):
    _, state, step, batch = _setup()
    trainer = ResilientTrainer(
        step_fn=step, ckpt=CheckpointManager(str(tmp_path), keep=2),
        save_every=1000)                          # only the drain saves
    prev_int = signal.getsignal(signal.SIGINT)

    def batches():
        yield batch
        yield batch
        signal.raise_signal(signal.SIGINT)        # preempt mid-run
        yield batch
        yield batch

    _, n = trainer.run(state, batches(), total_steps=100)
    # the third step saw the flag: loop broke, drain checkpoint landed
    assert n == 2
    assert latest_step(str(tmp_path)) == 2
    # run() uninstalled its handlers on the way out
    assert signal.getsignal(signal.SIGINT) is prev_int
    assert not trainer._prev_handlers
