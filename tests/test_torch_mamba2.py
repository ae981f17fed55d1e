"""The port's Mamba2 LM path against the JAX reference on the CPU: the
configs, specs and init rule, the mixer (prefill and decode), the whole
prefill + decode steps, the greedy ``generate`` loop and the launcher.
Parameters come from JAX ``init_params`` through the bridge; token
batches from the same numpy seed on both sides."""
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import argparse  # noqa: E402
import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCH = "mamba2-780m"
B, S = 2, 40                     # 40 = 2 chunks of 16 + a padded third


def _cfgs(dtype="float32", **kw):
    jc = jcfgs.get_smoke_config(ARCH).replace(
        dtype=dtype, param_dtype=dtype, **kw)
    tc = tcfgs.get_smoke_config(ARCH).replace(dtype=dtype, param_dtype=dtype,
                                              **kw)
    return jc, tc


def _params(jc, seed=0):
    """JAX init_params, with A_log, D and dt_bias redrawn (the reference
    inits them to ones and zeros; random values exercise more of the
    mixer), as (JAX tree, port tree) holding the same numbers."""
    np_params = jax.tree.map(np.asarray,
                             jt.init_params(jc, jax.random.PRNGKey(seed)))
    mixer = np_params["blocks"]["i0"]["mixer"]
    rng = np.random.RandomState(seed + 1)
    for name, lo, hi in (("A_log", -1.0, 1.0), ("D", 0.5, 1.5),
                         ("dt_bias", -1.0, 0.5)):
        mixer[name] = rng.uniform(lo, hi, mixer[name].shape).astype(
            np.float32)
    return (jax.tree.map(jnp.asarray, np_params),
            tlayers.params_from_numpy(np_params, "cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _rel_norm(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tokens(cfg, shape, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, shape)


# --------------------------------------------------------------------- #
# configs, specs, init
# --------------------------------------------------------------------- #

def test_configs_match_the_reference():
    port_fields = {f.name for f in dataclasses.fields(tcfgs.ArchConfig)}
    for getter in ("get_config", "get_smoke_config"):
        jc = getattr(jcfgs, getter)(ARCH)
        tc = getattr(tcfgs, getter)(ARCH)
        for name in port_fields:
            assert getattr(tc, name) == getattr(jc, name), (getter, name)
        assert tc.pattern() == jc.pattern() == (("ssm", "none"),)
        assert tc.num_repeats == jc.num_repeats
    assert tcfgs.LM_SHAPES == {k: tcfgs.ShapeConfig(*dataclasses.astuple(v))
                               for k, v in jcfgs.LM_SHAPES.items()}
    assert tcfgs.get_config("capsim").name == "capsim"


def _refuse_train_batch():
    """Ported in item 7: the train kind builds, with labels and the loss
    mask."""
    shapes = tspecs.lm_batch_shapes(tcfgs.get_smoke_config(ARCH),
                                    tcfgs.ShapeConfig("t", 8, 2, "train"),
                                    "train")
    assert shapes["labels"] == ((2, 8), np.int32)
    assert shapes["loss_mask"] == ((2, 8), np.float32)


def _refuse_mesh_shape():
    """Ported in item 6a: ``EngineConfig(mesh_shape=(2,))`` builds an
    engine on the CPU, its two shards sharing it."""
    from repro_torch.configs.capsim import smoke_config
    from repro_torch.core import predictor
    from repro_torch.core.engine import SimulationEngine
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.core.standardize import build_vocab
    cfg = smoke_config()
    eng = SimulationEngine(predictor.init_params(cfg, device="cpu"), cfg,
                           build_vocab(), EngineConfig(mesh_shape=(2,)),
                           device="cpu")
    assert eng.mesh.n_shards == 2


@pytest.mark.parametrize("refused, item", [(_refuse_train_batch, None),
                                           (_refuse_mesh_shape, None)],
                         ids=["train-batch", "mesh_shape"])
def test_unported_archs_name_their_roadmap_item(refused, item):
    """Every arch of the zoo resolves; what the port still refuses names
    its ROADMAP port-queue item.  Training batches (item 7) and the
    CAPSim data mesh (item 6a) are ported and build.  An unknown arch is
    a KeyError."""
    if item is None:
        refused()
    else:
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            refused()
    for name in tcfgs.ARCH_NAMES:
        assert tcfgs.get_smoke_config(name).name == name
    with pytest.raises(KeyError):
        tcfgs.get_config("no-such-arch")


def test_full_width_specs_match_the_reference():
    """model_specs and cache_specs at mamba2-780m's full width (48
    layers, d_model 1536, N 128, vocab 50280 -> 50288); no allocation."""
    tc, jc = tcfgs.get_config(ARCH), jcfgs.get_config(ARCH)
    assert tt.padded_vocab(tc) == jt.padded_vocab(jc) == 50288

    def flat(tree, is_spec, prefix=""):
        out = {}
        for k, v in tree.items():
            if is_spec(v):
                out[prefix + k] = v
            else:
                out.update(flat(v, is_spec, prefix + k + "/"))
        return out
    for tspec, jspec in ((tt.model_specs(tc), jt.model_specs(jc)),
                         (tt.cache_specs(tc, 4, 4096),
                          jt.cache_specs(jc, 4, 4096))):
        tf = flat(tspec, lambda v: isinstance(v, tlayers.ParamSpec))
        jf = flat(jspec, lambda v: isinstance(v, jlayers.ParamSpec))
        assert tf.keys() == jf.keys()
        for k in tf:
            assert tf[k].shape == jf[k].shape, k
            assert tf[k].std == jf[k].std and tf[k].dtype == jf[k].dtype, k
    n = sum(int(np.prod(s.shape)) for s in flat(
        tt.model_specs(tc), lambda v: isinstance(v, tlayers.ParamSpec)
    ).values())
    assert 850e6 < n < 860e6


def test_init_params_follows_the_spec_rule():
    """std < 0 -> ones (A_log, D), std == 0 -> zeros, std > 0 -> normal;
    the same seed gives the same parameters."""
    _, tc = _cfgs()
    p = tt.init_params(tc, seed=3, device="cpu")
    m = p["blocks"]["i0"]["mixer"]
    assert torch.equal(m["A_log"], torch.ones_like(m["A_log"]))
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    assert float(m["dt_bias"].abs().max()) == 0.0
    assert float(m["gate_norm"].abs().max()) == 0.0
    assert m["A_log"].dtype == torch.float32
    std = float(m["wx"].std())
    assert 0.8 / np.sqrt(tc.d_model) < std < 1.2 / np.sqrt(tc.d_model)
    again = tt.init_params(tc, seed=3, device="cpu")
    for a, b in zip(jax.tree.leaves(tlayers.params_to_numpy(p)),
                    jax.tree.leaves(tlayers.params_to_numpy(again))):
        np.testing.assert_array_equal(a, b)
    # the reference's init gives the same constants
    jm_params = jt.init_params(_cfgs()[0], jax.random.PRNGKey(0))
    np.testing.assert_array_equal(
        np.asarray(jm_params["blocks"]["i0"]["mixer"]["A_log"]),
        m["A_log"].numpy())


def test_bridge_round_trips_the_reference_tree():
    jc, _ = _cfgs("bfloat16")
    jparams = jt.init_params(jc, jax.random.PRNGKey(1))
    port = tlayers.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    assert port["embed"].dtype == torch.bfloat16
    assert port["blocks"]["i0"]["mixer"]["A_log"].dtype == torch.float32
    back = tlayers.params_to_numpy(port)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_random_batch_draws_the_reference_tokens():
    jc, tc = _cfgs()
    for kind, shape in (("prefill", tcfgs.ShapeConfig("p", 32, 2,
                                                      "prefill")),
                        ("decode", tcfgs.ShapeConfig("d", 32, 3, "decode"))):
        jshape = jcfgs.ShapeConfig(*dataclasses.astuple(shape))
        tb = tspecs.random_batch(tc, shape, kind, seed=4, device="cpu")
        jb = jspecs.random_batch(jc, jshape, kind, seed=4)
        assert tb.keys() == jb.keys() == {"tokens"}
        np.testing.assert_array_equal(tb["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))


# --------------------------------------------------------------------- #
# the mixer and the model
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("ssm_impl", ["pallas", "chunked"])
def test_ssm_forward_prefill_then_decode_matches_jax(ssm_impl):
    jc, tc = _cfgs()
    jc = jc.replace(ssm_impl=ssm_impl)
    jparams, tparams = _params(jc)
    jmix = jax.tree.map(lambda a: a[0], jparams["blocks"]["i0"]["mixer"])
    tmix = {k: v[0] for k, v in tparams["blocks"]["i0"]["mixer"].items()}
    rng = np.random.RandomState(2)
    x = rng.randn(B, S + 1, tc.d_model).astype(np.float32)
    jy, jcache = jm.ssm_forward(jmix, jnp.asarray(x[:, :S]), jc, "prefill")
    ty, tcache = tm.ssm_forward(tmix, torch.from_numpy(x[:, :S]), tc,
                                "prefill")
    assert np.max(np.abs(_np(ty) - _np(jy))) < 1e-4
    for k in ("conv_x", "conv_B", "conv_C", "state"):
        assert np.max(np.abs(_np(tcache[k]) - _np(jcache[k]))) < 1e-4, k
    jy1, jcache1 = jm.ssm_forward(jmix, jnp.asarray(x[:, S:]), jc, "decode",
                                  jcache)
    ty1, tcache1 = tm.ssm_forward(tmix, torch.from_numpy(x[:, S:]), tc,
                                  "decode", tcache)
    assert np.max(np.abs(_np(ty1) - _np(jy1))) < 1e-4
    assert np.max(np.abs(_np(tcache1["state"])
                         - _np(jcache1["state"]))) < 1e-4


@pytest.mark.parametrize("ssm_impl, dtype", [("pallas", "float32"),
                                             ("chunked", "float32"),
                                             ("pallas", "bfloat16")])
def test_prefill_and_decode_steps_match_jax(ssm_impl, dtype):
    """Logits of prefill_step and two decode_steps.  f32: <=1e-4 max abs
    and <=1e-5 relative norm (JAX's own two paths differ by 3e-7..3e-6
    here).  bf16: <=3e-2 relative norm against the Pallas path (JAX's own
    bf16 chunked and Pallas paths differ by 1.9%, bf16 vs f32 by 1.5%)."""
    jc, tc = _cfgs(dtype, vocab_size=250)
    jc = jc.replace(ssm_impl=ssm_impl)
    jparams, tparams = _params(jc)
    tok = _tokens(tc, (B, S + 2))
    jl, jcache = jt.prefill_step(jparams, {"tokens": jnp.asarray(
        tok[:, :S], jnp.int32)}, jc)
    tl, tcache = tt.prefill_step(tparams, {"tokens": torch.from_numpy(
        tok[:, :S])}, tc)
    steps = [(tl, jl)]
    for i in range(2):
        step = tok[:, S + i: S + i + 1]
        jl, jcache = jt.decode_step(jparams, {"tokens": jnp.asarray(
            step, jnp.int32)}, jc, jcache, S + i)
        tl, tcache = tt.decode_step(tparams, {"tokens": torch.from_numpy(
            step)}, tc, tcache, S + i)
        steps.append((tl, jl))
    for tl, jl in steps:
        assert tl.dtype == getattr(torch, dtype)
        assert tl.shape[-1] == 256
        # padded vocab columns hold -1e30 (in the logits' dtype) on both
        # sides
        neg = torch.tensor(-1e30, dtype=tl.dtype)
        assert bool((tl[..., 250:] == neg).all())
        np.testing.assert_array_equal(_np(jl[..., 250:]),
                                      _np(tl[..., 250:]))
        live_t, live_j = tl[..., :250], jl[..., :250]
        if dtype == "float32":
            assert np.max(np.abs(_np(live_t) - _np(live_j))) < 1e-4
            assert _rel_norm(live_t, live_j) < 1e-5
        else:
            assert _rel_norm(live_t, live_j) < 3e-2


def test_bf16_gap_grows_with_depth_as_in_jax():
    """At 12 layers with the reference's own init, bf16 vs f32 logits
    drift apart by several percent in both packages (random weights
    amplify rounding layer after layer); the port's gap stays within 2x
    of JAX's, and its f32 logits match JAX's."""
    L, seq = 12, 40
    jc, tc = (c.replace(num_layers=L) for c in _cfgs())
    jc = jc.replace(ssm_impl="pallas")
    tok = _tokens(tc, (B, seq))
    last = {}
    for dtype in ("float32", "bfloat16"):
        jd = jc.replace(dtype=dtype, param_dtype=dtype)
        td = tc.replace(dtype=dtype, param_dtype=dtype)
        jp = jt.init_params(jd, jax.random.PRNGKey(0))
        tp = tlayers.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        jl, _ = jt.prefill_step(jp, {"tokens": jnp.asarray(tok, jnp.int32)},
                                jd)
        tl, _ = tt.prefill_step(tp, {"tokens": torch.from_numpy(tok)}, td)
        last[dtype] = (tl[:, -1], jl[:, -1])
    gap_port = _rel_norm(last["bfloat16"][0], last["float32"][0])
    gap_jax = _rel_norm(last["bfloat16"][1], last["float32"][1])
    print(f"{L} layers: bf16 vs f32 relative norm, port {gap_port:.3e}, "
          f"JAX {gap_jax:.3e}")
    assert _rel_norm(*last["float32"]) < 1e-5
    assert 0.01 < gap_jax and gap_port < 2 * gap_jax


def _xla_cpu_silu(x):
    """silu as XLA's CPU backend expands ``jax.nn.silu``: x·(1/(exp(-x)+1))
    with a rounding to x's dtype after every op (F.silu rounds once)."""
    return x * (1 / (torch.exp(-x) + 1))


def test_bf16_logits_differ_from_jax_only_by_silu_rounding(monkeypatch):
    """12 layers, the same bridged bf16 weights, the last row's logits.
    The port's one systematic rounding difference from JAX on the CPU is
    silu in bf16 (once in the port, four times in XLA's expansion).  With
    that made equal, the port's bf16 logits lie within half of JAX's own
    bf16-vs-f32 gap of JAX's (its unrolled layer loop: the same op
    sequence).  What is left is single-ulp flips of f32 accumulation
    order, which the random weights amplify layer after layer, as they
    amplify JAX's scanned-vs-unrolled difference."""
    rng = np.random.RandomState(9)
    v = rng.randn(4096).astype(np.float32) * 3
    np.testing.assert_array_equal(
        _np(_xla_cpu_silu(torch.from_numpy(v).bfloat16())),
        _np(jax.nn.silu(jnp.asarray(v, jnp.bfloat16))))
    L, seq = 12, 40
    jc, tc = (c.replace(num_layers=L) for c in _cfgs())
    jc = jc.replace(ssm_impl="pallas")
    tok = _tokens(tc, (B, seq))
    jtok, ttok = ({"tokens": jnp.asarray(tok, jnp.int32)},
                  {"tokens": torch.from_numpy(tok)})
    jp32 = jt.init_params(jc, jax.random.PRNGKey(0))
    j32 = jt.prefill_step(jp32, jtok, jc)[0][:, -1]
    jb, tb = (c.replace(dtype="bfloat16", param_dtype="bfloat16")
              for c in (jc, tc))
    jp = jt.init_params(jb, jax.random.PRNGKey(0))
    tp = tlayers.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    j_scan = jt.prefill_step(jp, jtok, jb)[0][:, -1]
    j_unrolled = jt.prefill_step(jp, jtok, jb.replace(scan_layers=False)
                                 )[0][:, -1]
    port = tt.prefill_step(tp, ttok, tb)[0][:, -1]
    monkeypatch.setattr(tm.F, "silu", _xla_cpu_silu)
    port_xla_silu = tt.prefill_step(tp, ttok, tb)[0][:, -1]
    gap_jax = _rel_norm(j_scan, j32)
    d_jax = _rel_norm(j_scan, j_unrolled)
    d_port = _rel_norm(port, j_scan)
    d_silu = _rel_norm(port_xla_silu, j_unrolled)
    # each layer fed JAX's input: what is left per layer
    xj = jt._embed_tokens(jp, jtok["tokens"], jb)
    per_layer = []
    for r in range(L):
        bj = jax.tree.map(lambda a: a[r], jp["blocks"])["i0"]
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
        yt, *_ = tt._block_forward(tt._index(tp["blocks"], r)["i0"], xt, tb,
                                  "prefill", None)
        xj = jt._block_forward(bj, xj, None, jb, "ssm", "none", "prefill",
                               None, None)[0]
        per_layer.append(_rel_norm(yt, xj))
    print(f"{L} layers bf16: JAX vs its f32 {gap_jax:.3e}, JAX scanned vs "
          f"unrolled {d_jax:.3e}, port vs JAX {d_port:.3e}, port with "
          f"XLA's silu rounding vs JAX unrolled {d_silu:.3e}, per layer "
          f"fed JAX's input <= {max(per_layer):.3e}")
    assert d_silu < 0.5 * gap_jax
    assert max(per_layer) < 1e-3


def test_generate_reproduces_the_reference_greedy_tokens():
    """The reference serve_lm loop (B=2, a 32-token prompt from
    random_batch seed 0, greedy decode) and the port's generate, with
    the same parameters, emit the same tokens."""
    jc, tc = _cfgs()
    jc = jc.replace(ssm_impl="pallas")
    jparams, tparams = _params(jc)
    steps = 6
    jb = jspecs.random_batch(jc, jcfgs.ShapeConfig("p", 32, 2, "prefill"),
                             "prefill")
    logits, caches = jt.prefill_step(jparams, jb, jc)
    tok = jnp.argmax(logits[:, -1:], -1)
    ref = [tok]
    for i in range(steps):
        logits, caches = jt.decode_step(jparams, {"tokens": tok}, jc,
                                        caches, jnp.int32(32 + i))
        tok = jnp.argmax(logits[:, -1:], -1)
        ref.append(tok)
    ref = np.concatenate([np.asarray(t) for t in ref], axis=1)
    tb = tspecs.random_batch(tc, tcfgs.ShapeConfig("p", 32, 2, "prefill"),
                             "prefill", device="cpu")
    gen = tserve.generate(tparams, tc, tb, steps, device="cpu")
    assert gen.tokens.shape == (2, steps + 1)
    assert gen.logits.shape == (2, steps + 1, 256)
    np.testing.assert_array_equal(gen.tokens.numpy(), ref)
    assert gen.prefill_seconds > 0 and gen.decode_seconds > 0


def test_prefill_then_decode_matches_a_longer_prefill():
    """Decoding one token after a prefill of S tokens gives the last row
    of a prefill over S + 1 tokens (the cache carries the whole state)."""
    _, tc = _cfgs()
    tparams = tt.init_params(tc, seed=1, device="cpu")
    tok = torch.from_numpy(_tokens(tc, (B, S + 1), seed=5))
    full, _ = tt.prefill_step(tparams, {"tokens": tok}, tc)
    _, cache = tt.prefill_step(tparams, {"tokens": tok[:, :S]}, tc)
    step, _ = tt.decode_step(tparams, {"tokens": tok[:, S:]}, tc, cache, S)
    assert _rel_norm(step[:, 0], full[:, -1]) < 1e-5


@pytest.mark.parametrize("prompt", [1, 2, 5])
def test_short_prefill_equals_decoding_from_init_cache(prompt):
    """init_cache gives the zero caches a prompt starts from (its specs'
    shapes and dtypes), and decoding a prompt token by token from it
    equals a prefill over the prompt, also below the conv width (the
    reference's prefill fails at 1 token and misaligns at 2)."""
    _, tc = _cfgs()
    tparams = tt.init_params(tc, seed=2, device="cpu")
    cache = tt.init_cache(tc, B, 64, device="cpu")
    tok = torch.from_numpy(_tokens(tc, (B, prompt), seed=6))
    pre, pre_cache = tt.prefill_step(tparams, {"tokens": tok}, tc)
    for k, v in cache["i0"].items():
        assert v.shape == pre_cache["i0"][k].shape, k
        assert v.dtype == pre_cache["i0"][k].dtype, k
        assert float(v.abs().max()) == 0.0
    steps = []
    for t in range(prompt):
        step, cache = tt.decode_step(tparams, {"tokens": tok[:, t:t + 1]},
                                     tc, cache, t)
        steps.append(step)
    assert _rel_norm(torch.cat(steps, dim=1), pre) < 1e-5


@pytest.mark.parametrize("nonparametric", [False, True])
def test_norm_matches_jax(nonparametric):
    _, tc = _cfgs()
    tc = tc.replace(nonparametric_norm=nonparametric)
    rng = np.random.RandomState(8)
    x = rng.randn(3, 5, tc.d_model).astype(np.float32) * 2 + 0.5
    params = {"scale": rng.randn(tc.d_model).astype(np.float32) * 0.1}
    spec = tlayers.norm_spec(tc)
    assert spec.keys() == jlayers.norm_spec(tc).keys()
    params = {k: params[k] for k in spec}
    ty = tlayers.norm(torch.from_numpy(x),
                      {k: torch.from_numpy(v) for k, v in params.items()},
                      tc)
    jy = jlayers.norm(jnp.asarray(x),
                      {k: jnp.asarray(v) for k, v in params.items()}, tc)
    assert np.max(np.abs(_np(ty) - _np(jy))) < 1e-5


def test_lm_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, tc = _cfgs()
    params = tt.init_params(tc, device="cpu")
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long)}
    for call in (lambda: tt.init_params(tc),
                 lambda: tt.init_cache(tc, 1, 4),
                 lambda: tserve.generate(params, tc, batch, 1),
                 lambda: tspecs.random_batch(
                     tc, tcfgs.ShapeConfig("p", 4, 1, "prefill"), "prefill"),
                 lambda: tserve.serve_lm(argparse.Namespace(
                     arch=ARCH, device="cuda", decode_steps=1))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_serve_lm_runs_on_the_cpu(capsys):
    tserve.serve_lm(argparse.Namespace(arch=ARCH, device="cpu",
                                       decode_steps=2))
    out = capsys.readouterr().out
    assert out.startswith(f"{ARCH}: prefill 32 tokens")
