"""The port's predictor against the JAX reference on the CPU: the
parameter bridge, the primitives, every forward entry point and int8
quantization.  Parameters come from JAX ``init_params`` through the
bridge; inputs from a numpy seed.  The JAX side resolves attention to its
Pallas kernel (interpret mode), whose contract the port's kernels keep."""
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
from repro.core import quant as jquant  # noqa: E402
from repro.core.standardize import dedupe_context_tokens  # noqa: E402
from repro.models.layers import rms_norm as jax_rms_norm  # noqa: E402
from repro_torch.configs import capsim as port_capsim  # noqa: E402
from repro_torch.core import predictor as tp  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402

JCFG = jax_capsim.smoke_config().replace(attn_impl="pallas")
TCFG = port_capsim.smoke_config()


@pytest.fixture(scope="module")
def jparams():
    return jp.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return tp.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))


def _tokens(rng, shape, vocab, pad_rows=()):
    """Token rows with <PAD> tails; rows in ``pad_rows`` are all-<PAD>."""
    tok = rng.integers(1, vocab, shape).astype(np.int32)
    lens = rng.integers(2, shape[-1] + 1, shape[:-1])
    tok[np.arange(shape[-1]) >= lens[..., None]] = 0
    for r in pad_rows:
        tok[r] = 0
    return tok


def _batch(rng, cfg, B=4, L=24, masked_tail=6):
    tok = _tokens(rng, (B, L, cfg.clip_tokens), cfg.vocab_size)
    mask = np.ones((B, L), np.float32)
    mask[-1, L - masked_tail:] = 0.0              # a clip shorter than L
    tok[mask == 0] = 0
    ctx = rng.integers(1, cfg.vocab_size, (B, cfg.context_tokens)).astype(
        np.int32)
    return {"clip_tokens": tok, "context_tokens": ctx, "clip_mask": mask}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_bridge_round_trip_is_bitwise(jparams, params):
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    back = tp.params_to_numpy(params)
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_j.keys() == flat_b.keys()
    for path, a in flat_j.items():
        b = flat_b[path]
        assert b.dtype == np.asarray(a).dtype and b.shape == a.shape, path
        np.testing.assert_array_equal(b, np.asarray(a))
    # the port's own init has the reference's tree, shapes and dtypes
    own = tp.params_to_numpy(tp.init_params(TCFG, seed=0, device="cpu"))
    flat_o = dict(jax.tree_util.tree_flatten_with_path(own)[0])
    assert flat_o.keys() == flat_j.keys()
    for path, a in flat_j.items():
        assert flat_o[path].shape == a.shape, path
    # dense weights keep (d_in, d_out) with the leading layer axis
    assert params["block"]["cross_wk"].shape == (
        4, TCFG.d_model, TCFG.num_heads * TCFG.head_dim)


def test_primitives_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    s = rng.standard_normal(32).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(s))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tp._sinusoidal(128, 128, torch.float32).numpy(),
        np.asarray(jp._sinusoidal(128, 128, jnp.float32)),
        rtol=1e-5, atol=1e-5)
    h = rng.standard_normal(1000).astype(np.float32) * 4
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(h),
                                 approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(h))), rtol=1e-6, atol=1e-6)


def test_encode_instructions_matches_reference(jparams, params):
    rng = np.random.default_rng(1)
    rows = _tokens(rng, (40, TCFG.clip_tokens), TCFG.vocab_size,
                   pad_rows=(0,))
    out = tp.encode_instructions(params, torch.from_numpy(rows), TCFG)
    ref = np.asarray(jp.encode_instructions(jparams, jnp.asarray(rows),
                                            JCFG))
    assert out.shape == (40, TCFG.d_model)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    # against the XLA path only real rows agree: an all-<PAD> row has no
    # valid key, which the kernels zero and XLA averages uniformly
    chunked = np.asarray(jp.encode_instructions(
        jparams, jnp.asarray(rows), JCFG.replace(attn_impl="chunked")))
    np.testing.assert_allclose(out.numpy()[1:], chunked[1:], rtol=1e-5,
                               atol=1e-5)
    assert np.abs(out.numpy()[0] - chunked[0]).max() > 1e-4


def test_forward_and_forward_cached_match_reference(jparams, params):
    rng = np.random.default_rng(2)
    b = _batch(rng, TCFG)
    out = tp.forward(params, _tb(b), TCFG).numpy()
    ref = np.asarray(jp.forward(jparams, _jb(b), JCFG))
    assert _rel(out, ref) < 1e-5
    ablate = tp.forward(params, _tb(b), TCFG, use_context=False).numpy()
    assert _rel(ablate, np.asarray(jp.forward(jparams, _jb(b), JCFG,
                                              use_context=False))) < 1e-5

    rows = _tokens(rng, (48, TCFG.clip_tokens), TCFG.vocab_size,
                   pad_rows=(0,))
    table = tp.encode_instructions(params, torch.from_numpy(rows), TCFG)
    jtable = jp.encode_instructions(jparams, jnp.asarray(rows), JCFG)
    idx = rng.integers(1, 48, b["clip_mask"].shape).astype(np.int32)
    idx[b["clip_mask"] == 0] = 0                 # masked slots: pad row
    cb = {"rt_idx": idx, "context_tokens": b["context_tokens"],
          "clip_mask": b["clip_mask"]}
    out = tp.forward_cached(params, table, _tb(cb), TCFG).numpy()
    ref = np.asarray(jp.forward_cached(jparams, jtable, _jb(cb), JCFG))
    assert _rel(out, ref) < 1e-5
    # the XLA path's different pad row never reaches the prediction:
    # masked slots are masked keys of the cross-attention
    chunked = np.asarray(jp.forward_cached(
        jparams, jtable, _jb(cb), JCFG.replace(attn_impl="chunked")))
    assert _rel(out, chunked) < 1e-5
    garbage = table.clone()
    garbage[0] = 1e3
    assert _rel(tp.forward_cached(params, garbage, _tb(cb), TCFG).numpy(),
                out) < 1e-6


def test_fully_masked_drain_rows_stay_masked(params):
    """A padded drain row (zero tokens, zero mask) has no valid
    cross-attention key; it must not disturb the real rows."""
    rng = np.random.default_rng(3)
    b = _batch(rng, TCFG, B=3)
    padded = {k: np.concatenate([v, np.zeros_like(v[:2])])
              for k, v in b.items()}
    real = tp.forward(params, _tb(b), TCFG).numpy()
    both = tp.forward(params, _tb(padded), TCFG).numpy()
    np.testing.assert_allclose(both[:3], real, rtol=1e-6)
    assert np.isfinite(both).all()


def test_fused_step_matches_reference(jparams, params):
    rng = np.random.default_rng(4)
    rows = _tokens(rng, (64, TCFG.clip_tokens), TCFG.vocab_size,
                   pad_rows=(0,))
    table = tp.encode_instructions(params, torch.from_numpy(rows), TCFG)
    jtable = jp.encode_instructions(jparams, jnp.asarray(rows), JCFG)
    B, L = 6, 20
    mask = (rng.uniform(size=(B, L)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    idx = np.where(mask > 0, rng.integers(1, 64, (B, L)), 0).astype(
        np.int32)
    ctx = rng.integers(1, 40, (B, TCFG.context_tokens)).astype(np.int32)
    uniq, counts = dedupe_context_tokens(ctx)
    fb = {"rt_idx": idx, "ctx_uniq": uniq, "ctx_count": counts,
          "clip_mask": mask}
    plan = tp.serving_plan(params, table, TCFG)
    jplan = jp.serving_plan(jparams, jtable, JCFG)
    for key in ("cross_kt", "cross_vt"):
        np.testing.assert_allclose(plan[key].numpy(),
                                   np.asarray(jplan[key]), rtol=1e-5,
                                   atol=1e-5)
    out = tp.forward_cached_fused(params, plan, _tb(fb), TCFG).numpy()
    ref = np.asarray(jp.forward_cached_fused(jparams, jplan, _jb(fb), JCFG))
    assert _rel(out, ref) < 1e-3
    # and against the port's own unfused step on the un-deduped batch
    unfused = tp.forward_cached(
        params, table, _tb({"rt_idx": idx, "context_tokens": ctx,
                            "clip_mask": mask}), TCFG).numpy()
    assert _rel(out, unfused) < 1e-3


def test_bf16_forward_within_reference_gate(jparams, params):
    rng = np.random.default_rng(5)
    b = _batch(rng, TCFG)
    f32 = tp.forward(params, _tb(b), TCFG).numpy()
    cfg16 = tp.inference_config(TCFG, "bf16")
    assert cfg16.dtype == "bfloat16"
    out = tp.forward(params, _tb(b), cfg16)
    assert out.dtype == torch.float32
    ref = np.asarray(jp.forward(jparams, _jb(b),
                                jp.inference_config(JCFG, "bf16")))
    assert _rel(out.numpy(), f32) < 2e-2
    assert _rel(out.numpy(), ref) < 2e-2
    with pytest.raises(ValueError):
        tp.inference_config(TCFG, "fp8")


def test_int8_quantize_dequant_is_bitwise(jparams):
    rng = np.random.default_rng(6)
    for shape in ((24, 16), (4, 32, 64), (16,)):
        w = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(
            tquant.quantize_dequant(torch.from_numpy(w)).numpy(),
            np.asarray(jquant.quantize_dequant(jnp.asarray(w))))
    z = np.zeros((8, 4), np.float32)
    assert not tquant.quantize_dequant(torch.from_numpy(z)).any()
    q_port = tp.params_to_numpy(tquant.quantize_dequant_params(
        tp.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")))
    q_ref = jax.tree.map(np.asarray, jquant.quantize_dequant_params(jparams))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(q_ref)[0],
            jax.tree_util.tree_flatten_with_path(q_port)[0]):
        np.testing.assert_array_equal(b, a, err_msg=str(path))


def test_full_width_forward_matches_reference():
    """One forward at the paper's width (E=128, 4 heads, M=360), B=2."""
    jcfg = jax_capsim.config().replace(dtype="float32", attn_impl="pallas")
    tcfg = port_capsim.config().replace(dtype="float32")
    assert (tcfg.d_model, tcfg.num_heads, tcfg.head_dim, tcfg.d_ff,
            tcfg.vocab_size, tcfg.context_tokens) == (
        jcfg.d_model, jcfg.num_heads, jcfg.head_dim, jcfg.d_ff,
        jcfg.vocab_size, jcfg.context_tokens) == (128, 4, 32, 512, 512, 360)
    jparams = jp.init_params(jcfg, jax.random.PRNGKey(1))
    params = tp.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(7)
    b = _batch(rng, tcfg, B=2, L=128, masked_tail=28)
    out = tp.forward(params, _tb(b), tcfg).numpy()
    ref = np.asarray(jax.jit(lambda p, x: jp.forward(p, x, jcfg))(
        jparams, _jb(b)))
    assert out.shape == (2,) and np.isfinite(out).all()
    assert _rel(out, ref) < 1e-5


def test_init_params_without_a_card_needs_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.init_params(TCFG)
    a = tp.init_params(TCFG, seed=3, device="cpu")
    b = tp.init_params(TCFG, seed=3, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"],
                           tp.init_params(TCFG, 4, "cpu")["embed"])
    assert not a["inst"]["norm1"].any()
