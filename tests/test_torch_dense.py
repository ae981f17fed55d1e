"""The port's dense decoder path of the LM zoo (olmo-1b, qwen3-4b,
internlm2-20b, nemotron-4-15b) against the JAX reference on the CPU: the
configs and specs, the building blocks (activations, RoPE), the attention
mixer (prefill through causal flash attention, decode against the KV
cache), the whole prefill + decode steps, the greedy ``generate`` loop
with its cache placement, and the launcher.  Parameters come from JAX
``init_params`` through the bridge, with the norm scales redrawn nonzero
(they init to zeros, where a wrong norm would not show); token batches
and activations from the same numpy seed on both sides.  The reference
runs as its own tests run it on the CPU: ``attn_impl="pallas"`` (the
Pallas kernel in interpret mode, the path the port's kernel replaces)
and ``"chunked"``, its default."""
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.kernels.flash_attention import ops as jfa  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ("olmo-1b", "qwen3-4b", "internlm2-20b", "nemotron-4-15b")
B, S = 2, 40
# f32: the attention mixer <= 1e-5 relative (max abs over max |ref|),
# logits <= 1e-4 max abs.  bf16: the Mamba2 bf16 gate, <= 3e-2 relative
# norm on the logits.  The reference's bf16 attention rounds p to bf16
# and multiplies p·v in bf16 (attention.py:80-81); the port's kernel
# rounds p to bf16 and accumulates p·v in f32, and its FFN's silu rounds
# once where XLA's expansion rounds after every op.
ATTN_F32_REL, LOGITS_F32_ABS, LOGITS_BF16_REL = 1e-5, 1e-4, 3e-2


def _cfgs(arch, dtype="float32", attn_impl="pallas", **kw):
    jc = jcfgs.get_smoke_config(arch).replace(
        dtype=dtype, param_dtype=dtype, attn_impl=attn_impl, **kw)
    tc = tcfgs.get_smoke_config(arch).replace(dtype=dtype, param_dtype=dtype,
                                              **kw)
    return jc, tc


def _redraw_norms(tree, rng):
    """Every norm scale (norm1/norm2/final_norm 'scale', q_norm, k_norm)
    redrawn in [-0.5, 0.5): the init's zeros act as 1 + 0."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _redraw_norms(v, rng)
        elif k in ("scale", "q_norm", "k_norm"):
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


def _rel(a, b):
    return _max_abs(a, b) / float(np.max(np.abs(_np(b))))


def _rel_norm(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tokens(cfg, shape, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, shape)


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
# configs, specs, batches
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    port_fields = {f.name for f in dataclasses.fields(tcfgs.ArchConfig)
                   } - set(tcfgs.PORT_ONLY_FIELDS)
    for getter in ("get_config", "get_smoke_config"):
        jc = getattr(jcfgs, getter)(arch)
        tc = getattr(tcfgs, getter)(arch)
        for name in port_fields:
            assert getattr(tc, name) == getattr(jc, name), (getter, name)
        assert tcfgs.port_only_at_defaults(tc), getter
        assert tc.pattern() == jc.pattern() == (("attn", "dense"),)
        assert tc.num_repeats == jc.num_repeats
    assert arch in tcfgs.ARCH_NAMES


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_specs_match_the_reference(arch):
    """model_specs and cache_specs at the config's full width (qwen3-4b:
    q width 32 x 128 = 4096 != d_model 2560); shapes only, no
    allocation."""
    tc, jc = tcfgs.get_config(arch), jcfgs.get_config(arch)
    assert tt.padded_vocab(tc) == jt.padded_vocab(jc)
    for tspec, jspec in ((tt.model_specs(tc), jt.model_specs(jc)),
                         (tt.cache_specs(tc, 4, 4112),
                          jt.cache_specs(jc, 4, 4112))):
        tf = _flat(tspec, lambda v: isinstance(v, tlayers.ParamSpec))
        jf = _flat(jspec, lambda v: isinstance(v, jlayers.ParamSpec))
        assert tf.keys() == jf.keys()
        for k in tf:
            assert tf[k].shape == jf[k].shape, k
            assert tf[k].std == jf[k].std and tf[k].dtype == jf[k].dtype, k
    if arch == "qwen3-4b":
        mixer = tt.model_specs(tc)["blocks"]["i0"]["mixer"]
        assert mixer["wq"].shape == (36, 2560, 4096)
        assert mixer["wk"].shape == (36, 2560, 1024)
        assert mixer["q_norm"].shape == (36, 128)
        assert tt.cache_specs(tc, 4, 4112)["i0"]["k"].shape == \
            (36, 4, 4112, 8, 128)


def test_moe_ffn_is_refused_naming_its_roadmap_item():
    """The MoE FFN is ported (item 1b): a dense config given experts
    builds MoE specs.  The frontend and codebook models (item 1c) are
    ported too: both configs load."""
    _, tc = _cfgs("qwen3-4b")
    specs = tt.model_specs(tc.replace(num_experts=4, experts_per_token=1))
    assert specs["blocks"]["i0"]["ffn"]["router"].shape == (2, 64, 4)
    for name in ("qwen2-vl-2b", "musicgen-large"):
        assert tcfgs.get_smoke_config(name).name == name
        assert tcfgs.get_config(name).frontend != "none"


def test_random_batch_and_bridge_match_the_reference():
    """random_batch draws the reference's tokens for a dense config, and
    the bridge carries a bf16 dense tree (qk norms in f32) unchanged."""
    jc, tc = _cfgs("qwen3-4b", "bfloat16")
    shape = tcfgs.ShapeConfig("p", 32, 2, "prefill")
    tb = tspecs.random_batch(tc, shape, "prefill", seed=4, device="cpu")
    jb = jspecs.random_batch(jc, jcfgs.ShapeConfig(*dataclasses.astuple(
        shape)), "prefill", seed=4)
    assert tb.keys() == jb.keys() == {"tokens"}
    np.testing.assert_array_equal(tb["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
    jparams = jt.init_params(jc, jax.random.PRNGKey(1))
    port = tlayers.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    mixer = port["blocks"]["i0"]["mixer"]
    assert mixer["wq"].dtype == torch.bfloat16
    assert mixer["q_norm"].dtype == torch.float32
    for a, b in zip(jax.tree.leaves(tlayers.params_to_numpy(port)),
                    jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


# --------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["squared_relu", "gelu", "silu", "swiglu"])
def test_activation_matches_jax(kind):
    x = np.random.RandomState(3).randn(4096).astype(np.float32) * 4
    ty = tlayers.activation(torch.from_numpy(x), kind)
    jy = jlayers.activation(jnp.asarray(x), kind)
    assert _max_abs(ty, jy) <= 1e-6
    with pytest.raises(ValueError):
        tlayers.activation(torch.from_numpy(x), "relu6")


@pytest.mark.parametrize("mrope", [(), (2, 3, 3)])
def test_apply_rope_matches_jax(mrope):
    """Plain RoPE at qwen3's theta and M-RoPE sections (t, h, w) over
    head_dim 16, positions up to 300: <= 1e-6 max abs."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    if mrope:
        pos = rng.randint(0, 300, (3, 2, 7))
    else:
        pos = rng.randint(0, 300, (2, 7))
    for theta in (10_000.0, 1_000_000.0):
        ty = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta, mrope)
        jy = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                                mrope)
        assert _max_abs(ty, jy) <= 1e-6
    xb = torch.from_numpy(x).bfloat16()
    assert tlayers.apply_rope(xb, torch.from_numpy(pos), 1e4,
                              mrope).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_attention_matches_jax_flash(dtype):
    """The port's prefill route (KV heads repeated, causal flash
    attention: the kernel's plain version here) against the reference's
    repeat + Pallas kernel in interpret mode, at head dim 128 with 4
    query heads over 2 KV heads and a length off the kernels' tiles.
    f32 <= 1e-5 relative; bf16 <= 2e-2 max abs (the kernel checks'
    bf16 tolerance: bf16 output ulps at |o| ~ 1)."""
    rng = np.random.RandomState(5)
    q = rng.randn(2, 37, 4, 128).astype(np.float32)
    k = rng.randn(2, 37, 2, 128).astype(np.float32)
    v = rng.randn(2, 37, 2, 128).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    to = tattn.causal_attention(*(torch.from_numpy(a).to(tdt)
                                  for a in (q, k, v)))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    jo = jfa.flash_attention(jq, jnp.repeat(jk, 2, axis=2),
                             jnp.repeat(jv, 2, axis=2), causal=True)
    assert to.dtype == tdt and to.shape == (2, 37, 4, 128)
    if dtype == "float32":
        assert _rel(to, jo) <= ATTN_F32_REL
    else:
        assert _max_abs(to, jo) <= 2e-2


# --------------------------------------------------------------------- #
# the attention mixer
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("attn_impl", ["pallas", "chunked"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "olmo-1b"])
def test_attention_forward_matches_jax(arch, attn_impl):
    """One layer's mixer: prefill over S tokens (GQA with qk_norm for
    qwen3, MHA for olmo), then decode at cache_pos S, S+1, S+2 against
    the placed cache; outputs and caches f32 <= 1e-5 relative."""
    jc, tc = _cfgs(arch, attn_impl=attn_impl)
    jparams, tparams = _params(jc)
    jmix = jax.tree.map(lambda a: a[0], jparams["blocks"]["i0"]["mixer"])
    tmix = {k: v[0] for k, v in tparams["blocks"]["i0"]["mixer"].items()}
    if tc.qk_norm:
        assert float(tmix["q_norm"].abs().min()) > 0
    rng = np.random.RandomState(2)
    x = rng.randn(B, S + 3, tc.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    jy, jcache = jattn.attention_forward(jmix, jnp.asarray(x[:, :S]),
                                         jnp.asarray(pos), jc, "prefill")
    ty, tcache = tattn.attention_forward(tmix, torch.from_numpy(x[:, :S]),
                                         torch.from_numpy(pos), tc,
                                         "prefill")
    assert _rel(ty, jy) <= ATTN_F32_REL
    max_seq = S + 3
    jk = jnp.zeros((B, max_seq, tc.num_kv_heads, tc.head_dim))
    for n in ("k", "v"):
        assert tcache[n].shape == (B, S, tc.num_kv_heads, tc.head_dim)
        assert _rel(tcache[n], jcache[n]) <= ATTN_F32_REL
        jcache[n] = jax.lax.dynamic_update_slice_in_dim(jk, jcache[n], 0, 1)
        tcache[n] = torch.cat([tcache[n], torch.zeros(
            B, 3, tc.num_kv_heads, tc.head_dim)], dim=1)
    for i in range(3):
        p = S + i
        xi = x[:, p:p + 1]
        jy, jcache = jattn.attention_forward(
            jmix, jnp.asarray(xi), jnp.full((B, 1), p, jnp.int32), jc,
            "decode", jcache, jnp.int32(p))
        ty, same = tattn.attention_forward(
            tmix, torch.from_numpy(xi), torch.full((B, 1), p), tc,
            "decode", tcache, p)
        assert same is tcache                  # written in place
        assert _rel(ty, jy) <= ATTN_F32_REL, p
        assert _rel(tcache["k"], jcache["k"]) <= ATTN_F32_REL, p
    with pytest.raises(ValueError, match="outside the cache"):
        tattn.attention_forward(tmix, torch.from_numpy(x[:, :1]),
                                torch.full((B, 1), max_seq), tc, "decode",
                                tcache, max_seq)


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("attn_impl, dtype", [("pallas", "float32"),
                                              ("chunked", "float32"),
                                              ("pallas", "bfloat16")])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch, attn_impl, dtype):
    """Logits of prefill_step and 4 decode_steps against the placed
    caches.  f32: <= 1e-4 max abs.  bf16: <= 3e-2 relative norm (the
    Mamba2 bf16 gate), printed beside JAX's own bf16-vs-f32 gap."""
    jc, tc = _cfgs(arch, dtype, attn_impl, vocab_size=250)
    jparams, tparams = _params(jc)
    steps = 4
    tok = _tokens(tc, (B, S + steps))
    jl, jcache = jt.prefill_step(jparams, {"tokens": jnp.asarray(
        tok[:, :S], jnp.int32)}, jc)
    tl, tcache = tt.prefill_step(tparams, {"tokens": torch.from_numpy(
        tok[:, :S])}, tc)
    jcache = _jax_place(jc, jcache, B, S, S + steps)
    tcache = tt.place_caches(tc, tcache, S + steps)
    pairs = [(tl, jl)]
    for i in range(steps):
        step = tok[:, S + i: S + i + 1]
        jl, jcache = jt.decode_step(jparams, {"tokens": jnp.asarray(
            step, jnp.int32)}, jc, jcache, jnp.int32(S + i))
        tl, tcache = tt.decode_step(tparams, {"tokens": torch.from_numpy(
            step)}, tc, tcache, S + i)
        pairs.append((tl, jl))
    for tl, jl in pairs:
        assert tl.dtype == getattr(torch, dtype)
        assert tl.shape[-1] == 256
        neg = torch.tensor(-1e30, dtype=tl.dtype)
        assert bool((tl[..., 250:] == neg).all())
        live_t, live_j = tl[..., :250], jl[..., :250]
        if dtype == "float32":
            assert _max_abs(live_t, live_j) <= LOGITS_F32_ABS
        else:
            assert _rel_norm(live_t, live_j) <= LOGITS_BF16_REL
    if dtype == "bfloat16":
        j32 = jc.replace(dtype="float32", param_dtype="float32")
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                            if a.dtype == jnp.bfloat16 else a, jparams)
        l32, _ = jt.prefill_step(jp32, {"tokens": jnp.asarray(
            tok[:, :S], jnp.int32)}, j32)
        port = tt.prefill_step(tparams, {"tokens": torch.from_numpy(
            tok[:, :S])}, tc)[0][..., :250]
        jax16 = pairs[0][1][..., :250]
        print(f"{arch} bf16 prefill logits: port vs JAX "
              f"{_rel_norm(port, jax16):.3e} (max abs "
              f"{_max_abs(port, jax16):.3e}); JAX bf16 vs its f32 "
              f"{_rel_norm(jax16, l32[..., :250]):.3e}")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_reproduces_the_reference_greedy_tokens(arch):
    """The reference serve_lm loop (B=2, a 32-token prompt from
    random_batch seed 0, the prefill caches placed into init_cache(64),
    greedy decode) and the port's generate, with the same parameters,
    emit the same tokens."""
    jc, tc = _cfgs(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_a_longer_prefill(arch):
    """Decoding one token after a prefill of S tokens (its cache placed
    into S + 1 positions) gives the last row of a prefill over S + 1
    tokens; an unplaced cache has no room and is refused."""
    _, tc = _cfgs(arch)
    tparams = tt.init_params(tc, seed=1, device="cpu")
    tok = torch.from_numpy(_tokens(tc, (B, S + 1), seed=5))
    full, _ = tt.prefill_step(tparams, {"tokens": tok}, tc)
    _, cache = tt.prefill_step(tparams, {"tokens": tok[:, :S]}, tc)
    with pytest.raises(ValueError, match="outside the cache"):
        tt.decode_step(tparams, {"tokens": tok[:, S:]}, tc, cache, S)
    cache = tt.place_caches(tc, cache, S + 1)
    step, _ = tt.decode_step(tparams, {"tokens": tok[:, S:]}, tc, cache, S)
    assert _rel_norm(step[:, 0], full[:, -1]) < 1e-5


def test_init_cache_and_placement():
    """init_cache gives zero (R, B, max_seq, KV, Dh) k/v in the config's
    dtype; place_caches puts a prefill's k/v at [0, S) of such a cache
    and refuses a prefill longer than the cache."""
    _, tc = _cfgs("qwen3-4b", "bfloat16")
    cache = tt.init_cache(tc, B, 48, device="cpu")
    k = cache["i0"]["k"]
    assert k.shape == (2, B, 48, 2, 16) and k.dtype == torch.bfloat16
    assert float(k.abs().max()) == 0.0
    src = {"i0": {n: torch.randn(2, B, S, 2, 16).bfloat16()
                  for n in ("k", "v")}}
    placed = tt.place_caches(tc, src, 48)
    for n in ("k", "v"):
        assert placed["i0"][n].shape == k.shape
        assert torch.equal(placed["i0"][n][:, :, :S], src["i0"][n])
        assert float(placed["i0"][n][:, :, S:].abs().max()) == 0.0
    with pytest.raises(ValueError, match="does not fit"):
        tt.place_caches(tc, src, S - 1)


def test_serve_lm_runs_on_the_cpu(capsys, monkeypatch):
    """``serve --arch qwen3-4b --device cpu`` (the CLI), and every dense
    name through serve_lm."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen3-4b",
                                      "--device", "cpu"])
    tserve.main()
    assert capsys.readouterr().out.startswith("qwen3-4b: prefill 32 tokens")
    for arch in ARCHS:
        tserve.serve_lm(argparse.Namespace(arch=arch, device="cpu",
                                           decode_steps=2))
        out = capsys.readouterr().out
        assert out.startswith(f"{arch}: prefill 32 tokens")
