"""The port's frontend and codebook models of the LM zoo (qwen2-vl-2b:
a vision frontend stub and M-RoPE over three position streams;
musicgen-large: an audio frontend stub and 4 parallel codebooks) against
the JAX reference on the CPU: the configs and specs, the batches, M-RoPE
with three different position streams, prefill + decode steps, the
greedy ``generate`` loop and the launcher.  Parameters come from JAX
``init_params`` through the bridge, with the norm scales redrawn nonzero;
batches from the same numpy seed on both sides.  The reference runs as
its own tests run it on the CPU: ``attn_impl="pallas"`` (the Pallas
kernel in interpret mode) and ``"chunked"``, its default.

The reference's ``random_batch`` gives the three M-RoPE streams the same
``arange``, where M-RoPE equals plain RoPE, so a wrong section would pass
on it: the parity cases here feed three different streams."""
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ("qwen2-vl-2b", "musicgen-large")
B, S_TOK = 2, 24            # + the smoke configs' 8 frontend embeddings
# the roadmap's tolerances: f32 logits <= 1e-4 max abs, bf16 <= 3e-2
# relative norm; M-RoPE itself <= 1e-6 max abs
LOGITS_F32_ABS, LOGITS_BF16_REL, ROPE_ABS = 1e-4, 3e-2, 1e-6
# fields of the reference's ArchConfig the port leaves out
LEFT_OUT = {"attn_chunk"}


def _cfgs(arch, dtype="float32", attn_impl="pallas", **kw):
    jc = jcfgs.get_smoke_config(arch).replace(
        dtype=dtype, param_dtype=dtype, attn_impl=attn_impl, **kw)
    tc = tcfgs.get_smoke_config(arch).replace(dtype=dtype, param_dtype=dtype,
                                              **kw)
    return jc, tc


def _redraw_norms(tree, rng):
    """Every norm scale redrawn in [-0.5, 0.5): the init's zeros act as
    1 + 0."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _redraw_norms(v, rng)
        elif k == "scale":
            tree[k] = rng.uniform(-0.5, 0.5, v.shape).astype(v.dtype)


def _params(jc, seed=0):
    """JAX init_params with the norm scales redrawn, as (JAX tree, port
    tree) holding the same numbers."""
    np_params = jax.tree.map(lambda a: np.asarray(a),
                             jt.init_params(jc, jax.random.PRNGKey(seed)))
    _redraw_norms(np_params, np.random.RandomState(seed + 1))
    return (jax.tree.map(jnp.asarray, np_params),
            tlayers.params_from_numpy(np_params, "cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _max_abs(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


def _rel_norm(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _batch(cfg, n_tok, seed=0):
    """A prefill batch as numpy arrays: tokens (B, n_tok[, C]), the
    frontend's embeddings and, for M-RoPE, three different position
    streams (a permutation of the positions each, so no two agree)."""
    rng = np.random.RandomState(seed)
    C = cfg.num_codebooks
    out = {"tokens": rng.randint(0, cfg.vocab_size,
                                 (B, n_tok) + ((C,) if C > 1 else ()))}
    F = cfg.frontend_len if cfg.frontend != "none" else 0
    if F:
        out["frontend"] = rng.randn(B, F, cfg.d_model).astype(np.float32)
    if cfg.mrope_sections:
        out["positions"] = np.stack([np.stack([rng.permutation(F + n_tok)
                                               for _ in range(B)])
                                     for _ in range(3)])
    return out


def _to_jax(batch):
    return {k: jnp.asarray(v, jnp.float32 if v.dtype == np.float32
                           else jnp.int32) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_place(jc, caches, batch, prompt, max_seq):
    """The reference serve_lm's placement (launch/serve.py:250-257) of a
    prefill's caches into init_cache(max_seq)."""
    full = jt.init_cache(jc, batch, max_seq)

    def put(dst, src):
        if src.ndim >= 3 and src.shape[2] == prompt:
            return jax.lax.dynamic_update_slice_in_dim(
                dst, src.astype(dst.dtype), 0, axis=2)
        return src.astype(dst.dtype)
    return jax.tree_util.tree_map(put, full, caches)


def _flat(tree, is_spec, prefix=""):
    out = {}
    for k, v in tree.items():
        if is_spec(v):
            out[prefix + k] = v
        else:
            out.update(_flat(v, is_spec, prefix + k + "/"))
    return out


# --------------------------------------------------------------------- #
# configs, specs, batches, the bridge
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    """Field by field, less the XLA knobs the port leaves out; the
    port's fields are the reference's, less those it names as left out,
    and those NemotronH brought, at their defaults."""
    port_fields = {f.name for f in dataclasses.fields(tcfgs.ArchConfig)
                   } - set(tcfgs.PORT_ONLY_FIELDS)
    ref_fields = {f.name for f in dataclasses.fields(jcfgs.ArchConfig)}
    assert port_fields < ref_fields and not port_fields & LEFT_OUT
    assert not set(tcfgs.PORT_ONLY_FIELDS) & ref_fields
    for getter in ("get_config", "get_smoke_config"):
        jc = getattr(jcfgs, getter)(arch)
        tc = getattr(tcfgs, getter)(arch)
        for name in port_fields:
            assert getattr(tc, name) == getattr(jc, name), (getter, name)
        assert tcfgs.port_only_at_defaults(tc), getter
        assert tc.pattern() == jc.pattern() == (("attn", "dense"),)
    assert arch in tcfgs.ARCH_NAMES


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_specs_match_the_reference(arch):
    """model_specs and cache_specs at full width, shapes, std and dtype
    leaf by leaf; no allocation."""
    tc, jc = tcfgs.get_config(arch), jcfgs.get_config(arch)
    for tspec, jspec in ((tt.model_specs(tc), jt.model_specs(jc)),
                         (tt.cache_specs(tc, 4, 4112),
                          jt.cache_specs(jc, 4, 4112))):
        tf = _flat(tspec, lambda v: isinstance(v, tlayers.ParamSpec))
        jf = _flat(jspec, lambda v: isinstance(v, jlayers.ParamSpec))
        assert tf.keys() == jf.keys()
        for k in tf:
            assert tf[k].shape == jf[k].shape, k
            assert tf[k].std == jf[k].std and tf[k].dtype == jf[k].dtype, k
    specs = tt.model_specs(tc)
    if arch == "musicgen-large":
        assert specs["embed"].shape == (4, 2048, 2048)
        assert specs["unembed"].shape == (4, 2048, 2048)
        assert specs["embed"].std == specs["unembed"].std == 1 / math.sqrt(2048)
    else:
        assert specs["blocks"]["i0"]["mixer"]["wk"].shape == (28, 1536, 256)
        assert specs["embed"].shape == (151936, 1536)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_match_the_reference(arch, kind):
    """lm_batch_shapes names the reference's keys and shapes, and
    random_batch draws its arrays bit for bit (tokens, then the frontend's
    randn, then the positions' draw, replaced by arange)."""
    jc, tc = _cfgs(arch)
    shape = tcfgs.ShapeConfig("s", 32, 3, kind)
    jshape = jcfgs.ShapeConfig(*dataclasses.astuple(shape))
    tshapes = tspecs.lm_batch_shapes(tc, shape, kind)
    jshapes = jspecs.lm_batch_shapes(jc, jshape, kind)
    assert list(tshapes) == list(jshapes)
    for k, (shp, dt) in tshapes.items():
        assert shp == jshapes[k].shape and dt == jshapes[k].dtype, k
    tb = tspecs.random_batch(tc, shape, kind, seed=5, device="cpu")
    jb = jspecs.random_batch(jc, jshape, kind, seed=5)
    assert list(tb) == list(jb)
    for k in tb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                      err_msg=k)
    if kind == "prefill":
        expect = {"tokens", "frontend"} | (
            {"positions"} if arch == "qwen2-vl-2b" else set())
        assert set(tb) == expect
        assert tb["frontend"].shape == (3, 8, 64)
        assert tb["tokens"].shape[1] == 32 - 8
    C = tc.num_codebooks
    assert tb["tokens"].shape[-1] == C if C > 1 else tb["tokens"].ndim == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_reference_init_bitwise(arch, dtype):
    """A JAX-initialised tree of the smoke config (musicgen's (C, V, d)
    and (C, d, V) tables among it) through params_from_numpy and back,
    bit for bit."""
    jc, _ = _cfgs(arch, dtype)
    jparams = jt.init_params(jc, jax.random.PRNGKey(3))
    port = tlayers.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    back = tlayers.params_to_numpy(port)
    jflat = _flat(jparams, lambda v: not isinstance(v, dict))
    tflat = _flat(back, lambda v: not isinstance(v, dict))
    assert tflat.keys() == jflat.keys()
    for k, a in tflat.items():
        np.testing.assert_array_equal(a, np.asarray(jflat[k], np.float32),
                                      err_msg=k)
    if arch == "musicgen-large":
        assert port["embed"].shape == (4, 128, 64)
        assert port["unembed"].shape == (4, 64, 128)
        assert port["embed"].dtype == getattr(torch, dtype)


# --------------------------------------------------------------------- #
# M-RoPE
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("swap", [False, True])
def test_mrope_with_three_distinct_streams_matches_the_reference(swap):
    """Sections (4, 2, 2) over head dim 16 and three different random
    position streams: the port's apply_rope against the reference's
    within 1e-6.  With two streams swapped on the port's side the result
    must differ, so this case tells a section error from a pass."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 9, 3, 16).astype(np.float32)
    pos = rng.randint(0, 500, (3, 2, 9))
    assert all((pos[i] != pos[j]).any() for i, j in ((0, 1), (1, 2), (0, 2)))
    jy = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, (4, 2, 2))
    tpos = pos[[1, 0, 2]] if swap else pos
    ty = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(tpos),
                            1e6, (4, 2, 2))
    err = _max_abs(ty, jy)
    if swap:
        assert err > 1e-2, err
    else:
        assert err <= ROPE_ABS, err


def test_mrope_prefill_needs_its_positions():
    """An M-RoPE prefill without (3, B, S) positions is refused, as the
    reference's apply_rope asserts; decode makes its own (3, B, 1)."""
    _, tc = _cfgs("qwen2-vl-2b")
    params = tt.init_params(tc, seed=0, device="cpu")
    batch = _to_torch(_batch(tc, 5))
    del batch["positions"]
    with pytest.raises(ValueError, match="M-RoPE needs"):
        tt.prefill_step(params, batch, tc)


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("attn_impl, dtype", [("pallas", "float32"),
                                              ("chunked", "float32"),
                                              ("pallas", "bfloat16")])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch, attn_impl, dtype):
    """Logits of prefill_step (8 frontend embeddings + 24 tokens; qwen2-vl
    with three different position streams) and 4 decode steps against
    the placed caches (musicgen: 4 codebooks a step, (B, S, 4, V)
    logits).  f32 <= 1e-4 max abs; bf16 <= 3e-2 relative norm, printed
    beside JAX's own bf16-vs-f32 gap."""
    jc, tc = _cfgs(arch, dtype, attn_impl)
    jparams, tparams = _params(jc)
    steps = 4
    pre = _batch(tc, S_TOK)
    S = tc.frontend_len + S_TOK
    C = tc.num_codebooks
    dec = np.random.RandomState(9).randint(
        0, tc.vocab_size, (steps, B, 1) + ((C,) if C > 1 else ()))
    jl, jcache = jt.prefill_step(jparams, _to_jax(pre), jc)
    tl, tcache = tt.prefill_step(tparams, _to_torch(pre), tc)
    assert tl.shape == (B, S) + ((C,) if C > 1 else ()) + (tc.vocab_size,)
    jcache = _jax_place(jc, jcache, B, S, S + steps)
    tcache = tt.place_caches(tc, tcache, S + steps)
    pairs = [(tl, jl)]
    for i in range(steps):
        jl, jcache = jt.decode_step(jparams, {"tokens": jnp.asarray(
            dec[i], jnp.int32)}, jc, jcache, jnp.int32(S + i))
        tl, tcache = tt.decode_step(tparams, {"tokens": torch.from_numpy(
            dec[i])}, tc, tcache, S + i)
        pairs.append((tl, jl))
    for tl, jl in pairs:
        assert tl.dtype == getattr(torch, dtype)
        if dtype == "float32":
            assert _max_abs(tl, jl) <= LOGITS_F32_ABS
        else:
            assert _rel_norm(tl, jl) <= LOGITS_BF16_REL
    if dtype == "bfloat16":
        j32 = jc.replace(dtype="float32", param_dtype="float32")
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                            if a.dtype == jnp.bfloat16 else a, jparams)
        l32, _ = jt.prefill_step(jp32, _to_jax(pre), j32)
        print(f"{arch} bf16 prefill logits: port vs JAX "
              f"{_rel_norm(pairs[0][0], pairs[0][1]):.3e}; JAX bf16 vs its "
              f"f32 {_rel_norm(pairs[0][1], l32):.3e}")


@pytest.mark.parametrize("arch", ARCHS + ("all-three",))
def test_prefill_then_decode_matches_a_longer_prefill(arch):
    """Decoding one token after a prefill (frontend + tokens) gives the
    last row of a prefill one token longer, its caches placed into one
    more position.  With M-RoPE the prefills' streams differ and the last
    position is the decode position in all three; "all-three" is
    musicgen's smoke config with qwen2-vl's M-RoPE sections (frontend,
    codebooks and M-RoPE on at once)."""
    name = "musicgen-large" if arch == "all-three" else arch
    kw = {"mrope_sections": (4, 2, 2)} if arch == "all-three" else {}
    _, tc = _cfgs(name, **kw)
    tparams = tt.init_params(tc, seed=1, device="cpu")
    long = _batch(tc, S_TOK + 1, seed=5)
    S = tc.frontend_len + S_TOK
    if tc.mrope_sections:
        long["positions"][:, :, S] = S       # the decode step's position
    short = dict(long, tokens=long["tokens"][:, :S_TOK])
    if "positions" in long:
        short["positions"] = long["positions"][:, :, :S]
    full, _ = tt.prefill_step(tparams, _to_torch(long), tc)
    _, cache = tt.prefill_step(tparams, _to_torch(short), tc)
    cache = tt.place_caches(tc, cache, S + 1)
    step, _ = tt.decode_step(tparams, {"tokens": torch.from_numpy(
        long["tokens"][:, S_TOK:])}, tc, cache, S)
    assert step.shape[1] == 1 and full.shape[1] == S + 1
    assert _rel_norm(step[:, 0], full[:, -1]) < 1e-5


def test_generate_gives_the_reference_serve_lm_tokens():
    """qwen2-vl: the reference serve_lm loop (B=2, random_batch seed 0 of
    32 positions: 8 frontend embeddings + 24 tokens, arange positions;
    the caches placed into init_cache(64); greedy decode at 32 + i with
    (3, B, 1) positions) and the port's generate, with the same
    parameters, emit the same tokens."""
    jc, tc = _cfgs("qwen2-vl-2b", attn_impl="chunked")
    jparams, tparams = _params(jc)
    steps = 6
    jb = jspecs.random_batch(jc, jcfgs.ShapeConfig("p", 32, 2, "prefill"),
                             "prefill")
    logits, caches = jt.prefill_step(jparams, jb, jc)
    caches = _jax_place(jc, caches, 2, 32, 64)
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


def test_generate_feeds_each_codebook_its_argmax():
    """musicgen: a JAX loop of prefill_step and decode_step fed each
    codebook's argmax, (B, 1, C), and the port's generate emit the same
    (B, 1 + steps, C) tokens.  The reference's serve_lm cannot run this
    model: it broadcasts the (B, 1, C) argmax to (B, 1, C, 1)."""
    jc, tc = _cfgs("musicgen-large", attn_impl="chunked")
    jparams, tparams = _params(jc)
    steps = 5
    jb = jspecs.random_batch(jc, jcfgs.ShapeConfig("p", 32, 2, "prefill"),
                             "prefill")
    logits, caches = jt.prefill_step(jparams, jb, jc)
    assert logits.shape == (2, 32, 4, 128)
    caches = _jax_place(jc, caches, 2, 32, 32 + steps)
    tok = jnp.argmax(logits[:, -1:], -1)
    ref = [tok]
    for i in range(steps):
        logits, caches = jt.decode_step(jparams, {"tokens": tok}, jc,
                                        caches, jnp.int32(32 + i))
        tok = jnp.argmax(logits[:, -1:], -1)
        ref.append(tok)
    ref = np.concatenate([np.asarray(t) for t in ref], axis=1)
    assert ref.shape == (2, steps + 1, 4)
    tb = tspecs.random_batch(tc, tcfgs.ShapeConfig("p", 32, 2, "prefill"),
                             "prefill", device="cpu")
    gen = tserve.generate(tparams, tc, tb, steps, device="cpu")
    assert gen.logits.shape == (2, steps + 1, 4, 128)
    np.testing.assert_array_equal(gen.tokens.numpy(), ref)
    with pytest.raises(ValueError, match="Cannot broadcast"):
        jserve.serve_lm(argparse.Namespace(arch="musicgen-large",
                                           decode_steps=1))


def test_serve_lm_runs_on_the_cpu(capsys, monkeypatch):
    """``serve --arch qwen2-vl-2b --device cpu`` and ``--arch
    musicgen-large`` (the CLI): 32 prefill positions, the first 8 the
    frontend's; musicgen prints 4 codebooks a token."""
    for arch in ARCHS:
        monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch,
                                          "--device", "cpu",
                                          "--decode-steps", "2"])
        tserve.main()
        out = capsys.readouterr().out
        assert out.startswith(f"{arch}: prefill 32 tokens (the first 8 "
                              "frontend embeddings")
        assert ("4 codebooks a token" in out) == (arch == "musicgen-large")


def test_tied_codebook_logits_match_jax():
    """Codebooks with tied embeddings (no zoo config sets both; the
    reference's einsum ``bsd,cvd->bscv``): the prefill's (B, S, C, V)
    logits against JAX's, f32 <= 1e-4 max abs."""
    jc, tc = _cfgs("musicgen-large", attn_impl="chunked",
                   tie_embeddings=True)
    jparams, tparams = _params(jc)
    assert "unembed" not in tparams and tparams["embed"].shape == (4, 128, 64)
    pre = _batch(tc, S_TOK)
    jl, _ = jt.prefill_step(jparams, _to_jax(pre), jc)
    tl, _ = tt.prefill_step(tparams, _to_torch(pre), tc)
    assert tl.shape == (B, tc.frontend_len + S_TOK, 4, 128)
    assert _max_abs(tl, jl) <= LOGITS_F32_ABS
