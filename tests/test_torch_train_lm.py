"""The LM zoo's training loss in the port against the JAX reference on the
CPU: ``loss_fn`` and the gradient of every parameter leaf, one model of
each family at smoke size (a dense decoder, an MoE model with nonzero
load-balance and z losses, the hybrid, Mamba2, the frontend model and
the codebook model), the plain SSD scan's gradients where the decay
overflows a naive ``exp``, the train batch bitwise the reference's, the
padded-vocab logits under anomaly detection, and the launcher.
Parameters come from JAX ``init_params`` through the bridge with the
norm scales redrawn nonzero; batches from the reference's
``random_batch``.  The reference runs its training default: chunked XLA
attention and the chunked SSD scan (``attn_impl``/``ssm_impl``
``"chunked"``)."""
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.kernels.ssd import ops as tssd  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

ARCHS = ("qwen3-4b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b",
         "mamba2-780m", "qwen2-vl-2b", "musicgen-large")
B, S = 2, 40        # positions, the frontend's 8 embeddings among them
# f32: the loss <= 1e-5 relative, each gradient leaf <= 1e-4 relative
# norm; the SSD scan's gradients <= 1e-4 max abs over max |ref|
LOSS_REL, GRAD_REL, SSD_GRAD_REL = 1e-5, 1e-4, 1e-4


def _cfgs(arch, **kw):
    jc = jcfgs.get_smoke_config(arch).replace(
        dtype="float32", param_dtype="float32", attn_impl="chunked",
        ssm_impl="chunked", **kw)
    tc = tcfgs.get_smoke_config(arch).replace(
        dtype="float32", param_dtype="float32", **kw)
    return jc, tc


def _redraw_norms(tree, rng):
    """Every norm scale redrawn in [-0.5, 0.5): the init's zeros act as
    1 + 0."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _redraw_norms(v, rng)
        elif k in ("scale", "q_norm", "k_norm", "gate_norm"):
            tree[k] = rng.uniform(-0.5, 0.5, v.shape).astype(v.dtype)


def _params(jc, seed=0):
    np_params = jax.tree.map(np.asarray,
                             jt.init_params(jc, jax.random.PRNGKey(seed)))
    _redraw_norms(np_params, np.random.RandomState(seed + 1))
    return (jax.tree.map(jnp.asarray, np_params),
            tlayers.params_from_numpy(np_params, "cpu"))


def _train_batch(jc, seed=0):
    """The reference's train batch, and the port's from the same seed
    (checked bitwise in ``test_random_train_batch_bitwise_reference``)."""
    shape = jcfgs.ShapeConfig("train", S, B, "train")
    jb = jspecs.random_batch(jc, shape, "train", seed=seed)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    tb = {k: v.long() if v.dtype == torch.int32 else v
          for k, v in tb.items()}
    return jb, tb


def _flat_j(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat_t(v, name) if isinstance(v, dict)
                   else {name: v.detach().float().numpy()})
    return out


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    jc, tc = _cfgs(arch)
    jparams, params = _params(jc)
    jb, tb = _train_batch(jc)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jt.loss_fn(p, jb, jc), has_aux=True)(jparams)
    (tl, taux), tg = ttl.value_and_grad(
        lambda p, b: tt.loss_fn(p, b, tc), params, tb)
    assert set(taux) == set(jaux) == {"ce", "lb", "z"}
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl)), arch
    for k in ("ce", "lb", "z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=LOSS_REL, atol=1e-7)
    if tc.num_experts:
        assert float(taux["lb"]) > 0 and float(taux["z"]) > 0
    fj, ft = _flat_j(jg), _flat_t(tg)
    assert fj.keys() == ft.keys()
    for name, g in fj.items():
        assert np.all(np.isfinite(ft[name])), (arch, name)
        err = _rel_norm(ft[name], g)
        assert err <= GRAD_REL, (arch, name, err)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b"])
def test_moe_routing_is_the_references_in_training(arch, monkeypatch):
    """The gradient comparison above holds only on the same routing: at
    every MoE layer of the train batch the port's top-k experts are the
    reference's (its meshless path, its layer loop unrolled so that the
    choices can be read), with no flip."""
    jc, tc = _cfgs(arch)
    jc = jc.replace(scan_layers=False)
    jparams, params = _params(jc)
    jb, tb = _train_batch(jc)
    seen_j, seen_t = [], []
    run_j, own_top_k = jmoe._run_local_nomesh, tmoe.top_k

    def record_j(p, xf, cfg):
        probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], -1)
        seen_j.append(np.asarray(jax.lax.top_k(
            probs, cfg.experts_per_token)[1]))
        return run_j(p, xf, cfg)

    def record_t(probs, k):
        out = own_top_k(probs, k)
        seen_t.append(out[1].numpy().copy())
        return out
    monkeypatch.setattr(jmoe, "_run_local_nomesh", record_j)
    monkeypatch.setattr(tmoe, "top_k", record_t)
    jt.loss_fn(jparams, jb, jc)
    tt.loss_fn(params, tb, tc)
    n_moe = sum(f == "moe" for _, f in tc.pattern()) * tc.num_repeats
    assert len(seen_t) == len(seen_j) == n_moe > 0
    for layer, (a, b) in enumerate(zip(seen_t, seen_j)):
        flips = int((a != b).any(-1).sum())
        assert flips == 0, (arch, layer, flips)


def test_ssd_plain_gradients_finite_where_exp_overflows():
    """A decay whose within-chunk sum passes ~88, where exp(seg_i -
    seg_j) above the diagonal overflows: the repaired plain scan's
    gradients are finite and <= 1e-4 of the reference's ``ssd_chunked``,
    run in f32 and run in f64; an exp taken before the mask gives NaN
    there.  A's gradient sums every step's decay: the f32 reference's
    own cumsum (the port's is f64, ``kernels/ssd/ops.py``) leaves it
    1.6e-4 from the reference's f64 run, where the port's is 1.5e-7, so
    A is held to the f64 run and to being closer to it than the f32
    reference."""
    rng = np.random.RandomState(5)
    Bt, L, H, P, N, chunk = 2, 64, 3, 8, 16, 32
    x = rng.randn(Bt, L, H, P).astype(np.float32)
    dt = rng.uniform(0.5, 1.5, (Bt, L, H)).astype(np.float32)
    Bm = rng.randn(Bt, L, N).astype(np.float32)
    Cm = rng.randn(Bt, L, N).astype(np.float32)
    A = -rng.uniform(4.0, 8.0, H).astype(np.float32)
    gy = rng.randn(Bt, L, H, P).astype(np.float32)
    gs = rng.randn(Bt, H, P, N).astype(np.float32)
    assert float((dt[:, :chunk].sum(1) * -A).min()) > 88

    def ref_grads(dtype):
        def loss(*a):
            y, st = jmamba.ssd_chunked(
                *a, chunk=chunk, init_state=jnp.zeros((Bt, H, P, N), dtype))
            return jnp.sum(y * gy.astype(dtype)) + jnp.sum(
                st * gs.astype(dtype))
        return [np.asarray(g, np.float64) for g in jax.grad(
            loss, argnums=(0, 1, 2, 3, 4))(
                *(jnp.asarray(a.astype(dtype)) for a in (x, dt, Bm, Cm, A)))]
    ref32 = ref_grads(np.float32)
    with jax.enable_x64():
        ref64 = ref_grads(np.float64)
    ins = [torch.from_numpy(a) for a in (x, dt, Bm, Cm, A)]
    got = tssd.ssd_scan_backward(*ins, chunk, torch.from_numpy(gy),
                                 torch.from_numpy(gs))

    def err(a, b):
        return float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))
    for a, r32, r64, what in zip(got, ref32, ref64, ("x", "dt", "B", "C",
                                                     "A")):
        a = a.numpy().astype(np.float64)
        assert np.all(np.isfinite(a)), what
        assert err(a, r64) <= SSD_GRAD_REL, (what, err(a, r64))
        if what == "A":
            assert err(a, r64) < err(r32, r64), (err(a, r64),
                                                 err(r32, r64))
        else:
            assert err(a, r32) <= SSD_GRAD_REL, (what, err(a, r32))
    # the forward is the one it was: exp(-inf) is the 0 the mask gave
    q = chunk
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    diff = torch.tensor([[0.0, 200.0], [-3.0, 0.0]]).expand(q // 2, q // 2,
                                                            2, 2)
    diff = diff.permute(0, 2, 1, 3).reshape(q, q)
    masked = torch.exp(diff.masked_fill(~causal, float("-inf")))
    assert torch.equal(masked, torch.where(causal, torch.exp(diff), 0.0))
    # the counter-case: exp first, mask after, gives NaN gradients
    d = diff.clone().requires_grad_(True)
    torch.where(causal, torch.exp(d), 0.0).sum().backward()
    assert torch.isnan(d.grad).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_random_train_batch_bitwise_reference(arch):
    jc, tc = _cfgs(arch)
    for seed in (0, 3):
        shape = jcfgs.ShapeConfig("train", S, B, "train")
        jb = jspecs.random_batch(jc, shape, "train", seed=seed)
        tb = tspecs.random_batch(tc, tcfgs.ShapeConfig("train", S, B,
                                                       "train"),
                                 "train", seed=seed, device="cpu")
        assert list(tb) == list(jb)
        for k, v in jb.items():
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(v))
        shapes = tspecs.lm_batch_shapes(tc, tcfgs.ShapeConfig(
            "train", S, B, "train"), "train")
        C = (tc.num_codebooks,) if tc.num_codebooks > 1 else ()
        assert shapes["labels"][0] == (B, S) + C
        assert shapes["loss_mask"][0] == (B, S)
        assert float(tb["loss_mask"].min()) == 1.0


def test_padded_vocab_logits_are_safe_under_autograd():
    """A vocab that is not a multiple of 16 pads the logits with -1e30
    columns, written in place: with anomaly detection on, the backward
    runs, the padded columns get no gradient, and the loss and gradients
    match the reference's."""
    jc, tc = _cfgs("qwen3-4b", vocab_size=250)
    assert tt.padded_vocab(tc) == 256
    jparams, params = _params(jc)
    jb, tb = _train_batch(jc)
    (jl, _), jg = jax.value_and_grad(lambda p: jt.loss_fn(p, jb, jc),
                                     has_aux=True)(jparams)
    with torch.autograd.detect_anomaly():
        (tl, _), tg = ttl.value_and_grad(
            lambda p, b: tt.loss_fn(p, b, tc), params, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert torch.all(tg["unembed"][:, 250:] == 0)
    for name, g in _flat_j(jg).items():
        assert _rel_norm(_flat_t(tg)[name], g) <= GRAD_REL, name


def test_launcher_trains_an_lm_on_the_cpu(tmp_path, capsys):
    tlaunch.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                  "--steps", "3", "--seq-len", "32", "--batch-size", "2",
                  "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "trained to step 3" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--arch", "qwen3-4b", "--smoke", "--steps", "1",
                          "--ckpt-dir", str(tmp_path / "card")])


def test_adamw_steps_lower_the_loss_on_one_batch():
    """Three AdamW train steps on one batch (the launcher's optimizer):
    the loss falls, and the state's step counts them."""
    _, tc = _cfgs("mamba2-780m")
    params = tt.init_params(tc, seed=0, device="cpu")
    batch = tspecs.random_batch(tc, tcfgs.ShapeConfig("t", 32, 2, "train"),
                                "train", device="cpu")
    tcfg = ttl.TrainConfig(optimizer="adamw", base_lr=1e-2, warmup_steps=0,
                           total_steps=3)
    state = ttl.init_train_state(params, tcfg)
    step = ttl.make_train_step(lambda p, b: tt.loss_fn(p, b, tc), tcfg)
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[2] < losses[0] and int(state["step"]) == 3
