"""The port's CAPSim training path against the JAX reference on the CPU:
``mape_loss`` and its gradients, the train step over three SGD-momentum
steps (with context and without), ``flash_attention_backward`` against
the custom VJP of the reference's flash attention at the predictor's
three attention shapes and a causal window, the backward kernels' plain
version against autograd in f32 and in bf16 (with its rounding points,
GQA and a query offset), the multicore training set bitwise, and the
launcher.  Parameters come from JAX ``init_params``
through the bridge with the norm scales and biases redrawn nonzero;
batches from a numpy seed.  The reference runs its training default,
``attn_impl="chunked"`` (XLA attention), for the model; the kernel
comparison runs its Pallas kernel in interpret mode.

Rows whose keys are all masked differ between the two (ROADMAP
"Pinned"): the all-<PAD> instructions of a clip shorter than L_clip
encode to zeros in the port and to a uniform average of V in the
reference's XLA path.  Such rows feed only the cross-attention, whose
``clip_mask`` masks them, so the loss and every gradient agree; the
batches here carry such a clip."""
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import capsim as jax_capsim  # noqa: E402
from repro.core import predictor as jp  # noqa: E402
from repro.core.standardize import build_vocab as jax_vocab  # noqa: E402
from repro.data import multicore_dataset as jmd  # noqa: E402
from repro.kernels.flash_attention import ops as jfa  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.configs import capsim as port_capsim  # noqa: E402
from repro_torch.core import predictor as tp  # noqa: E402
from repro_torch.core.standardize import build_vocab  # noqa: E402
from repro_torch.data import multicore_dataset as tmd  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

JCFG = jax_capsim.smoke_config().replace(attn_impl="chunked")
TCFG = port_capsim.smoke_config()
# f32: the loss <= 1e-5 relative; each gradient leaf and each
# parameter after 3 steps <= 1e-4 (relative norm / max abs); the flash
# backward <= 1e-5 max abs over max |ref|
LOSS_REL, GRAD_REL, PARAM_ABS, FLASH_GRAD_REL = 1e-5, 1e-4, 1e-4, 1e-5


def _redraw(tree, rng):
    """Norm scales and biases (zeros at init) redrawn in [-0.5, 0.5)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _redraw(v, rng)
        elif k.startswith("norm") or k in ("final_norm", "b1", "b2"):
            tree[k] = rng.uniform(-0.5, 0.5, v.shape).astype(v.dtype)
    return tree


@pytest.fixture(scope="module")
def np_params():
    p = jax.tree.map(np.asarray, jp.init_params(JCFG, jax.random.PRNGKey(0)))
    p = {k: dict(v) if isinstance(v, dict) else v for k, v in p.items()}
    return _redraw(p, np.random.RandomState(1))


def _batch(rng, B=4, L=24, M=36):
    """Clips with <PAD> tails; the last clip is 6 instructions short
    (its last rows all-<PAD>: keyless rows in the encoder)."""
    V, T = TCFG.vocab_size, TCFG.clip_tokens
    tok = rng.randint(1, V, (B, L, T)).astype(np.int32)
    lens = rng.randint(2, T + 1, (B, L))
    tok[np.arange(T) >= lens[..., None]] = 0
    mask = np.ones((B, L), np.float32)
    mask[-1, L - 6:] = 0.0
    tok[mask == 0] = 0
    return {"clip_tokens": tok,
            "context_tokens": rng.randint(1, V, (B, M)).astype(np.int32),
            "clip_mask": mask,
            "time": rng.uniform(50.0, 500.0, B).astype(np.float32)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat_j(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat_t(v, name) if isinstance(v, dict)
                   else {name: v.detach().numpy()})
    return out


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("use_context", [True, False])
def test_mape_loss_and_gradients_match_reference(np_params, use_context):
    """Eq 11 and its gradient with respect to every parameter leaf; every
    leaf's gradient is nonzero on both sides."""
    batch = _batch(np.random.RandomState(2))
    jparams = jax.tree.map(jnp.asarray, np_params)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jp.mape_loss(p, _jb(batch), JCFG, use_context),
        has_aux=True)(jparams)
    params = tp.params_from_numpy(np_params, device="cpu")
    (tl, taux), tg = ttl.value_and_grad(
        lambda p, b: tp.mape_loss(p, b, TCFG, use_context), params,
        _tb(batch))
    assert set(taux) == set(jaux) == {"mape"}
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    fj, ft = _flat_j(jg), _flat_t(tg)
    assert fj.keys() == ft.keys()
    for name, g in fj.items():
        assert np.any(g != 0) and np.any(ft[name] != 0), name
        assert np.all(np.isfinite(ft[name])), name
        assert _rel_norm(ft[name], g) <= GRAD_REL, (name,
                                                    _rel_norm(ft[name], g))


@pytest.mark.parametrize("use_context", [True, False])
def test_three_sgdm_steps_match_reference(np_params, use_context):
    """``make_train_step`` with the paper's SGD momentum from the same
    parameters over the same 3 batches: every parameter <= 1e-4 of the
    reference's, and the metrics agree.  The rate is raised (0.05, with
    warm-up and clipping in play) so that 3 steps move the parameters
    well past the tolerance."""
    kw = dict(optimizer="sgdm", base_lr=0.05, warmup_steps=1, total_steps=3)
    jt, tt = jtl.TrainConfig(**kw), ttl.TrainConfig(**kw)
    jstep = jax.jit(jtl.make_train_step(
        lambda p, b: jp.mape_loss(p, b, JCFG, use_context), jt))
    tstep = ttl.make_train_step(
        lambda p, b: tp.mape_loss(p, b, TCFG, use_context), tt)
    js = jtl.init_train_state(jax.tree.map(jnp.asarray, np_params), jt)
    ts = ttl.init_train_state(tp.params_from_numpy(np_params, "cpu"), tt)
    rng = np.random.RandomState(3)
    for _ in range(3):
        b = _batch(rng)
        js, jm = jstep(js, _jb(b))
        ts, tm = tstep(ts, _tb(b))
        for k in ("loss", "grad_norm", "lr", "mape"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5)
    fj, ft = _flat_j(js["params"]), _flat_t(ts["params"])
    moved = 0
    for name, p in fj.items():
        assert float(np.max(np.abs(ft[name] - p))) <= PARAM_ABS, name
        moved += float(np.max(np.abs(p - _flat_j(np_params)[name]))) > \
            10 * PARAM_ABS
    assert moved >= len(fj) // 2          # the steps moved most leaves


def _fa_case(rng, B, Sq, Skv, H, D, masked):
    q, k, v, g = (rng.randn(B, S, H, D).astype(np.float32)
                  for S in (Sq, Skv, Skv, Sq))
    m = None
    if masked:
        m = (rng.rand(B, Skv) > 0.3).astype(np.float32)
        m[0, :] = 0.0                     # a batch row with no valid key
    return q, k, v, g, m


# the predictor's three attention shapes at full width (4 heads x 32):
# the instruction encoder over L_token = 16 with the <PAD> mask, the
# block encoder's self-attention over M = 360 context rows, its
# cross-attention into L_clip = 128 instructions under clip_mask; and a
# causal window with a key mask
FA_GRAD_CASES = [
    ("inst", (64, 16, 16, 4, 32, True), False, 0),
    ("block_self", (2, 360, 360, 4, 32, False), False, 0),
    ("block_cross", (2, 360, 128, 4, 32, True), False, 0),
    ("causal_window", (2, 100, 130, 2, 32, True), True, 40),
]


@pytest.mark.parametrize("name,shape,causal,window", FA_GRAD_CASES,
                         ids=[c[0] for c in FA_GRAD_CASES])
def test_flash_backward_matches_reference_vjp(name, shape, causal, window):
    q, k, v, g, m = _fa_case(np.random.RandomState(4), *shape)

    def jf(q_, k_, v_):
        return jfa.flash_attention(
            q_, k_, v_, causal=causal, window=window,
            kv_mask=None if m is None else jnp.asarray(m), interpret=True)
    _, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    got = tfa.flash_attention_backward(
        *(torch.from_numpy(x) for x in (q, k, v)),
        None if m is None else torch.from_numpy(m), torch.from_numpy(g),
        causal, window)
    for a, b, what in zip(got, ref, "qkv"):
        b = np.asarray(b)
        assert np.all(np.isfinite(a.numpy())), what
        err = float(np.max(np.abs(a.numpy() - b))) / float(np.max(np.abs(b)))
        assert err <= FLASH_GRAD_REL, (name, what, err)


# the plain backward from the forward's output and log-sum-exp: the cases
# above and the other head dims the f32 backward kernel takes (112 pads
# to 128 on the card; the plain version is width-blind)
FA_LSE_CASES = FA_GRAD_CASES + [
    ("d16_masked", (3, 40, 70, 2, 16, True), False, 0),
    ("d64_causal", (2, 70, 70, 2, 64, False), True, 0),
    ("d112_cross", (2, 33, 65, 1, 112, True), False, 0),
]


def _fa_torch_case(name, shape):
    q, k, v, g, m = (None if x is None else torch.from_numpy(x)
                     for x in _fa_case(np.random.RandomState(5), *shape))
    return q, k, v, g, m


@pytest.mark.parametrize("name,shape,causal,window", FA_LSE_CASES,
                         ids=[c[0] for c in FA_LSE_CASES])
def test_flash_backward_plain_matches_autograd(name, shape, causal, window):
    """``flash_attention_backward_plain`` (from o, lse and Δ) against
    autograd through ``flash_attention_plain``, the recompute the card's
    f32 route no longer takes."""
    q, k, v, g, m = _fa_torch_case(name, shape)
    kw = dict(causal=causal, window=window, kv_mask=m)
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = torch.autograd.grad(tfa.flash_attention_plain(*qkv, **kw), qkv, g)
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = tfa.flash_attention_backward_plain(q, k, v, o, lse, g, m, causal,
                                             window)
    for a, b, what in zip(got, ref, "qkv"):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert bool(torch.isfinite(a).all()), (name, what)
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= FLASH_GRAD_REL, (name, what, err)


@pytest.mark.parametrize("name,shape,causal,window", FA_LSE_CASES,
                         ids=[c[0] for c in FA_LSE_CASES])
def test_flash_plain_lse_matches_logsumexp(name, shape, causal, window):
    """The plain log-sum-exp (the kernels' tiled m + log l) is
    ``torch.logsumexp`` of the scaled scores over the live keys, and +inf
    on a row with none."""
    q, k, v, _, m = _fa_torch_case(name, shape)
    o, lse = tfa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                       kv_mask=m, return_lse=True)
    assert torch.equal(o, tfa.flash_attention_plain(
        q, k, v, causal=causal, window=window, kv_mask=m))
    live = tfa.live_pairs(q, k, causal, window, m)
    s = tfa.scores_plain(q, k).masked_fill(~live, -torch.inf)
    ref = torch.logsumexp(s, dim=-1)
    keyless = ~live.any(-1)
    assert lse.shape == ref.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert bool(torch.isposinf(lse[keyless]).all())
    torch.testing.assert_close(lse[~keyless], ref[~keyless], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name,shape,causal,window",
                         [c for c in FA_LSE_CASES if c[1][-1] is True],
                         ids=[c[0] for c in FA_LSE_CASES if c[1][-1]])
def test_flash_backward_plain_masked_rows_and_keys(name, shape, causal,
                                                   window):
    """A row with every key masked (batch row 0) gets zero dq and no NaN,
    and masked keys get zero dk and dv."""
    q, k, v, g, m = _fa_torch_case(name, shape)
    o, lse = tfa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                       kv_mask=m, return_lse=True)
    dq, dk, dv = tfa.flash_attention_backward_plain(q, k, v, o, lse, g, m,
                                                    causal, window)
    assert all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
    assert bool((m[0] == 0).all()) and bool((dq[0] == 0).all())
    off = m == 0
    assert bool(off.any()) and bool((dk[off] == 0).all()) \
        and bool((dv[off] == 0).all())
    assert bool(dq[1:].abs().max() > 0) and bool(dk[~off].abs().max() > 0)


# the bf16 backward kernels' cases: every case above, a causal GQA case
# at D = 128 with each KV head repeated for 2 query heads (as
# ``models/attention.py`` repeats them), and a query offset (Sq < Skv)
FA_BF16_CASES = [c + (1,) for c in FA_LSE_CASES] + [
    ("gqa_causal_d128", (2, 96, 96, 4, 128, False), True, 0, 2),
    ("q_offset", (2, 40, 100, 2, 64, True), True, 0, 1),
]
# bf16 keeps 8 significant bits (one rounding moves a value by up to
# 2^-9 relative); the plain backward rounds P and dS where the kernels
# do, autograd through the plain forward rounds dP and the outputs'
# sums elsewhere, so the two differ by a few roundings: <= 7.6e-3 on
# these cases (the bf16 autograd's own gap to f32 is <= 5.2e-3)
FLASH_BF16_GRAD_REL = 2e-2


@pytest.mark.parametrize("name,shape,causal,window,groups", FA_BF16_CASES,
                         ids=[c[0] for c in FA_BF16_CASES])
def test_flash_backward_plain_bf16_matches_autograd(name, shape, causal,
                                                    window, groups):
    """In bfloat16, ``flash_attention_backward_plain`` (P rounded before
    dv, dS before dq and dk) against autograd through
    ``flash_attention_plain`` in bfloat16, the KV heads' gradients summed
    over the query heads that share them; finite, the keyless row's dq
    and the masked keys' dk, dv exactly 0."""
    q, k, v, g, m = _fa_torch_case(name, shape)
    H = q.shape[2]
    q, g = q.bfloat16(), g.bfloat16()
    k, v = (x[:, :, :H // groups].bfloat16() for x in (k, v))
    kw = dict(causal=causal, window=window, kv_mask=m)

    def rep(x):
        return x.repeat_interleave(groups, dim=2)
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = torch.autograd.grad(tfa.flash_attention_plain(
        qkv[0], rep(qkv[1]), rep(qkv[2]), **kw), qkv, g)
    o, lse = tfa.flash_attention_plain(q, rep(k), rep(v), return_lse=True,
                                       **kw)
    dq, dk, dv = tfa.flash_attention_backward_plain(q, rep(k), rep(v), o, lse,
                                                    g, m, causal, window)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    if m is not None:
        off = m == 0
        assert bool((dq[0] == 0).all()) and bool((dk[off] == 0).all()) \
            and bool((dv[off] == 0).all())
    got = (dq,) + tuple(x.float().unflatten(2, (H // groups, groups)).sum(3)
                        for x in (dk, dv))
    for a, b, what in zip(got, ref, "qkv"):
        assert a.shape == b.shape, what
        assert bool(torch.isfinite(a).all()), (name, what)
        err = float((a.float() - b.float()).abs().max()
                    / b.float().abs().max())
        assert err <= FLASH_BF16_GRAD_REL, (name, what, err)


def _datasets_equal(a, b):
    return (np.array_equal(a.clip_tokens, b.clip_tokens)
            and np.array_equal(a.context_tokens, b.context_tokens)
            and np.array_equal(a.clip_mask, b.clip_mask)
            and np.array_equal(a.time, b.time)
            and a.bench_names == b.bench_names)


@pytest.mark.parametrize("n_cores,peer", [(1, False), (2, False),
                                          (2, True)])
def test_multicore_dataset_bitwise_reference(n_cores, peer):
    kw = dict(interval_size=1_200, warmup=150, max_checkpoints=2, l_min=32,
              l_clip=40, l_token=16, threshold=20, coef=0.2,
              n_cores=n_cores, peer_channels=peer)
    names = ["mt.stream", "mt.mix"]
    got = tmd.build_multicore_dataset(names, tmd.MulticoreBuildConfig(**kw),
                                      build_vocab())
    ref = jmd.build_multicore_dataset(names, jmd.MulticoreBuildConfig(**kw),
                                      jax_vocab())
    assert len(got) > 0 and got.context_len == ref.context_len
    assert _datasets_equal(got, ref)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu``,
    single-core and ``--multicore 2``; without ``--device cpu`` it asks
    for the card and raises here."""
    common = ["--smoke", "--device", "cpu", "--steps", "5",
              "--batch-size", "8", "--save-every", "2"]
    tlaunch.main(common + ["--ckpt-dir", str(tmp_path / "single"),
                           "--n-benchmarks", "3"])
    out = capsys.readouterr().out
    assert "trained to step 5" in out and "validation MAPE" in out
    tlaunch.main(common + ["--ckpt-dir", str(tmp_path / "mc"),
                           "--multicore", "2", "--n-benchmarks", "2",
                           "--interval-size", "2000"])
    out = capsys.readouterr().out
    assert "trained to step 5" in out and "held-out eval MAPE" in out
    assert "context width 369" in out
    # a restart resumes at the saved step and stops there
    tlaunch.main(common + ["--ckpt-dir", str(tmp_path / "single"),
                           "--n-benchmarks", "3"])
    assert "trained to step 5" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--smoke", "--steps", "1",
                          "--ckpt-dir", str(tmp_path / "card")])


def test_tree_helpers_walk_in_reference_order(np_params):
    """The port's leaves come in ``jax.tree_util``'s order, so the global
    norm sums in the same order."""
    params = tp.params_from_numpy(np_params, device="cpu")
    names = list(_flat_j(np_params))
    leaves = topt.tree_leaves(params)
    flat = _flat_t(params)
    assert len(leaves) == len(names)
    for name, leaf in zip(names, leaves):
        np.testing.assert_array_equal(leaf.numpy(), flat[name])
