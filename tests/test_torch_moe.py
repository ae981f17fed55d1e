"""The port's MoE and hybrid models of the LM zoo (kimi-k2-1t-a32b,
llama4-maverick-400b-a17b, jamba-1.5-large-398b) against the JAX
reference on the CPU: the configs and full-width specs, the MoE FFN
(routing, capacity drops, the three activations, the auxiliary losses)
against the reference's meshless path, the whole prefill + decode steps,
the greedy ``generate`` loop with jamba's hybrid caches, and the
launcher.  Parameters come from JAX ``init_params`` through the bridge,
with the norm scales redrawn nonzero; token batches and activations from
the same numpy seed on both sides.  The reference runs as its own tests
run it on the CPU: ``attn_impl``/``ssm_impl`` ``"pallas"`` (the Pallas
kernels in interpret mode, the path the port's kernels replace) and
``"chunked"``, its default; its MoE takes the meshless path, which its
own multi-device test holds equal to the expert-parallel one."""
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
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ("llama4-maverick-400b-a17b", "kimi-k2-1t-a32b",
         "jamba-1.5-large-398b")
B, S = 2, 40
# the MoE FFN in f32: y <= 1e-5 relative (max abs over max |ref|), the
# losses <= 1e-6 relative; the model: logits <= 1e-4 max abs in f32,
# <= 3e-2 relative norm in bf16 (the dense and Mamba2 bf16 gate)
MOE_F32_REL, LOSS_REL = 1e-5, 1e-6
LOGITS_F32_ABS, LOGITS_BF16_REL = 1e-4, 3e-2


def _cfgs(arch, dtype="float32", impl="pallas", **kw):
    jc = jcfgs.get_smoke_config(arch).replace(
        dtype=dtype, param_dtype=dtype, attn_impl=impl, ssm_impl=impl, **kw)
    tc = tcfgs.get_smoke_config(arch).replace(dtype=dtype, param_dtype=dtype,
                                              **kw)
    return jc, tc


def _redraw(tree, rng):
    """Every norm scale redrawn in [-0.5, 0.5) (the init's zeros act as
    1 + 0), and the SSM mixers' A_log, D and dt_bias (ones and zeros at
    init) redrawn as the Mamba2 tests draw them."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _redraw(v, rng)
        elif k in ("scale", "q_norm", "k_norm", "gate_norm"):
            tree[k] = rng.uniform(-0.5, 0.5, v.shape).astype(v.dtype)
        elif k in ("A_log", "D", "dt_bias"):
            lo, hi = {"A_log": (-1.0, 1.0), "D": (0.5, 1.5),
                      "dt_bias": (-1.0, 0.5)}[k]
            tree[k] = rng.uniform(lo, hi, v.shape).astype(v.dtype)


def _params(jc, seed=0):
    """JAX init_params with the redraws above, as (JAX tree, port tree)
    holding the same numbers."""
    np_params = jax.tree.map(np.asarray,
                             jt.init_params(jc, jax.random.PRNGKey(seed)))
    _redraw(np_params, np.random.RandomState(seed + 1))
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


def _flat(tree, is_spec, prefix=""):
    out = {}
    for k, v in tree.items():
        if is_spec(v):
            out[prefix + k] = v
        else:
            out.update(_flat(v, is_spec, prefix + k + "/"))
    return out


def _jax_place(jc, caches, batch, prompt, max_seq):
    """The reference serve_lm's placement (launch/serve.py:250-257) of a
    prefill's caches into init_cache(max_seq): the attention k/v at
    [0, prompt), the SSM caches as they are."""
    full = jt.init_cache(jc, batch, max_seq)

    def put(dst, src):
        if src.ndim >= 3 and src.shape[2] == prompt:
            return jax.lax.dynamic_update_slice_in_dim(
                dst, src.astype(dst.dtype), 0, axis=2)
        return src.astype(dst.dtype)
    return jax.tree_util.tree_map(put, full, caches)


def _jax_routing(xf, router, k, cap):
    """The reference's meshless routing, ``moe.py:174-181`` as written:
    (idx, pos, keep)."""
    E = router.shape[1]
    t = xf.shape[0]
    scores = xf.astype(jnp.float32) @ router
    probs = jax.nn.softmax(scores, -1)
    _, idx = jax.lax.top_k(probs, k)
    oh = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(t * k, E)
    pos = (jnp.cumsum(oh, 0) - oh)
    pos = jnp.sum(pos * oh, -1).reshape(t, k)
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < cap)


def _record_routing(monkeypatch):
    """Route every MoE call of the port a second time, before it runs,
    and keep (tokens' shape, Routing) in call order."""
    seen = []
    run = tmoe.moe_forward

    def recorded(params, x, cfg):
        seen.append((x.shape, tmoe.route(
            params["router"], x.reshape(-1, x.shape[-1]),
            cfg.experts_per_token, cfg.capacity_factor)))
        return run(params, x, cfg)
    monkeypatch.setattr(tmoe, "moe_forward", recorded)
    return seen


# --------------------------------------------------------------------- #
# configs and specs
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    port_fields = {f.name for f in dataclasses.fields(tcfgs.ArchConfig)}
    assert {"experts_per_token", "capacity_factor"} <= port_fields
    for getter in ("get_config", "get_smoke_config"):
        jc = getattr(jcfgs, getter)(arch)
        tc = getattr(tcfgs, getter)(arch)
        for name in port_fields:
            assert getattr(tc, name) == getattr(jc, name), (getter, name)
        assert tc.pattern() == jc.pattern()
        assert tc.num_repeats == jc.num_repeats
    assert "moe" in {f for _, f in tcfgs.get_config(arch).pattern()}
    assert arch in tcfgs.ARCH_NAMES


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_specs_match_the_reference(arch):
    """model_specs and cache_specs at the config's full width: shapes,
    std and dtype (the router in f32); no allocation."""
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
    blocks = tt.model_specs(tc)["blocks"]
    moe = [j for j, (_, f) in enumerate(tc.pattern()) if f == "moe"]
    ffn = blocks[f"i{moe[0]}"]["ffn"]
    R, E, d, f = tc.num_repeats, tc.num_experts, tc.d_model, tc.d_ff
    assert ffn["router"].shape == (R, d, E)
    assert ffn["router"].dtype == "float32"
    assert ffn["w_up"].shape == ffn["w_gate"].shape == (R, E, d, f)
    assert ffn["w_down"].shape == (R, E, f, d)
    if arch == "jamba-1.5-large-398b":
        caches = tt.cache_specs(tc, 4, 4112)
        assert caches["i4"]["k"].shape == (9, 4, 4112, 8, 128)
        assert caches["i0"]["state"].shape == (9, 4, 256, 64, 128)
        assert caches["i0"]["state"].dtype == "float32"


def test_capacity_matches_the_reference():
    for t, k, E in ((16384, 1, 128), (16384, 8, 384), (16384, 2, 4),
                    (4, 8, 384), (600, 1, 8), (48, 2, 16), (1, 1, 4)):
        for cf in (1.25, 1.0, 2.0):
            assert tmoe.capacity(t, k, E, cf) == jmoe._capacity(t, k, E, cf)


# --------------------------------------------------------------------- #
# the MoE FFN
# --------------------------------------------------------------------- #

def _moe_inputs(E, k, act, dtype, skew, seed=0, T=48, d=32, f=24):
    """(cfg, numpy params, numpy x) for one MoE FFN; ``skew`` adds a bias
    direction that x shares and expert 3's router column follows, so
    expert 3 takes most tokens and overflows its capacity."""
    rng = np.random.RandomState(seed)
    cfg = tcfgs.get_smoke_config("kimi-k2-1t-a32b").replace(
        d_model=d, d_ff=f, num_experts=E, experts_per_token=k,
        activation=act, dtype=dtype, param_dtype=dtype)
    x = rng.randn(T, d).astype(np.float32)
    router = (rng.randn(d, E) / np.sqrt(d)).astype(np.float32)
    if skew:
        u = np.ones(d, np.float32) / np.sqrt(d)
        x += 2.0 * u
        router[:, 3] += 1.5 * u
    params = {"router": router,
              "w_gate": (rng.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
              "w_up": (rng.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
              "w_down": (rng.randn(E, f, d) / np.sqrt(f)).astype(np.float32)}
    return cfg, params, x


def _both(params, x, dtype):
    """The numpy params and x as (JAX, port) in ``dtype`` (the router
    stays f32)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {n: jnp.asarray(a, jnp.float32 if n == "router" else jdt)
          for n, a in params.items()}
    tp = {n: torch.from_numpy(a).to(torch.float32 if n == "router" else tdt)
          for n, a in params.items()}
    return (jp, jnp.asarray(x, jdt)), (tp, torch.from_numpy(x).to(tdt))


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_routing_is_bitwise_the_reference(k, skew):
    """Top-k indices, positions and the keep mask, from the same f32
    scores, equal the reference's bit for bit; the skewed router
    overflows an expert's capacity."""
    cfg, params, x = _moe_inputs(16, k, "swiglu", "float32", skew)
    cap = tmoe.capacity(x.shape[0], k, 16, cfg.capacity_factor)
    idx, pos, keep = _jax_routing(jnp.asarray(x),
                                  jnp.asarray(params["router"]), k, cap)
    r = tmoe.route(torch.from_numpy(params["router"]), torch.from_numpy(x),
                   k, cfg.capacity_factor)
    assert r.cap == cap
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if skew:                        # expert 3 overflows its capacity
        assert not keep[idx == 3].all()
    gates = r.gates.sum(-1)
    assert float((gates - 1).abs().max()) < 1e-6


def test_routing_breaks_ties_to_the_lower_expert():
    """Equal probabilities go to the lower expert first, as lax.top_k."""
    x = torch.zeros(4, 8)
    router = torch.zeros(8, 6)
    r = tmoe.route(router, x, 3, 1.25)
    idx, pos, keep = _jax_routing(jnp.zeros((4, 8)), jnp.zeros((8, 6)), 3,
                                  r.cap)
    assert r.idx.tolist() == [[0, 1, 2]] * 4
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("act", ["swiglu", "squared_relu", "gelu"])
def test_moe_forward_matches_jax_f32(act, k):
    """y, lb and z against the reference's meshless path, with an expert
    over its capacity: y <= 1e-5 relative, the losses <= 1e-6."""
    cfg, params, x = _moe_inputs(16, k, act, "float32", skew=True)
    (jp, jx), (tp, tx) = _both(params, x, "float32")
    jy, jlb, jz = jmoe.moe_forward(jp, jx.reshape(2, 24, -1), cfg)
    ty, tlb, tz = tmoe.moe_forward(tp, tx.reshape(2, 24, -1), cfg)
    assert ty.shape == (2, 24, cfg.d_model) and ty.dtype == torch.float32
    assert _rel(ty, jy) <= MOE_F32_REL
    assert abs(float(tlb) - float(jlb)) <= LOSS_REL * abs(float(jlb))
    assert abs(float(tz) - float(jz)) <= LOSS_REL * abs(float(jz))
    # a dropped (token, slot) contributes nothing: a token whose every
    # slot is dropped gets zeros on both sides
    r = tmoe.route(tp["router"], tx, k, cfg.capacity_factor)
    none = ~r.keep.any(-1)
    if bool(none.any()):
        assert float(ty.reshape(-1, cfg.d_model)[none].abs().max()) == 0.0


@pytest.mark.parametrize("act", ["swiglu", "squared_relu", "gelu"])
def test_moe_forward_bf16_gap_is_within_jax_own(act):
    """bf16 (activations and experts; the router f32): the port's y vs
    JAX's, beside JAX's own bf16-vs-f32 gap (printed with -s).  The
    routing is computed from the same bf16 inputs on both sides, so the
    experts' outputs part only by bf16 rounding: <= 3e-2 relative norm."""
    cfg, params, x = _moe_inputs(16, 2, act, "bfloat16", skew=True)
    (jp, jx), (tp, tx) = _both(params, x, "bfloat16")
    jy, jlb, _ = jmoe.moe_forward(jp, jx.reshape(2, 24, -1), cfg)
    ty, tlb, _ = tmoe.moe_forward(tp, tx.reshape(2, 24, -1), cfg)
    assert ty.dtype == torch.bfloat16
    jp32 = {n: jnp.asarray(a, jnp.float32) for n, a in jp.items()}
    j32, _, _ = jmoe.moe_forward(jp32, jnp.asarray(jx, jnp.float32).reshape(
        2, 24, -1),
                                 cfg.replace(dtype="float32"))
    gap_port, gap_jax = _rel_norm(ty, jy), _rel_norm(jy, j32)
    print(f"moe {act} bf16: port vs JAX {gap_port:.3e}; JAX bf16 vs its "
          f"f32 {gap_jax:.3e}")
    assert gap_port <= LOGITS_BF16_REL
    assert abs(float(tlb) - float(jlb)) <= LOSS_REL * abs(float(jlb))


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #

def _record_jax_routing(monkeypatch):
    """The top-k experts of every MoE call of the reference (its meshless
    path, outside a scan), in call order."""
    seen = []
    run = jmoe._run_local_nomesh

    def recorded(params, xf, cfg):
        probs = jax.nn.softmax(xf.astype(jnp.float32) @ params["router"], -1)
        seen.append(np.asarray(jax.lax.top_k(probs,
                                             cfg.experts_per_token)[1]))
        return run(params, xf, cfg)
    monkeypatch.setattr(jmoe, "_run_local_nomesh", recorded)
    return seen


def _xla_cpu_silu(x):
    """silu as XLA's CPU backend expands ``jax.nn.silu``: x·(1/(exp(-x)+1))
    with a rounding to x's dtype after every op (F.silu rounds once)."""
    return x * (1 / (torch.exp(-x) + 1))


def _force_routing(monkeypatch, chosen):
    """The port's top-k replaced, call by call, by the experts in
    ``chosen`` (their probabilities as the gates); returns, per call, the
    number of tokens the port's own top-k had routed otherwise."""
    own_top_k, flips = tmoe.top_k, []

    def forced(probs, k):
        idx = torch.from_numpy(np.array(chosen[len(flips)])).long()
        flips.append(int((own_top_k(probs, k)[1] != idx).any(-1).sum()))
        return probs.gather(1, idx), idx
    monkeypatch.setattr(tmoe, "top_k", forced)
    return flips


@pytest.mark.parametrize("impl, dtype", [("pallas", "float32"),
                                         ("chunked", "float32"),
                                         ("pallas", "bfloat16")])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch, impl, dtype, monkeypatch):
    """Logits of prefill_step and 2 decode_steps against the placed
    caches (jamba: the attention KV cache placed, the SSM states as they
    are), and the summed MoE losses of the prefill.  f32: <= 1e-4 max
    abs.  bf16: <= 3e-2 relative norm, printed beside JAX's own
    bf16-vs-f32 gap.  In bf16 the packages part by rounding: XLA rounds
    silu after each of its four ops where the port rounds once (the
    Mamba2 tests' finding), and random weights amplify that over jamba's
    8 layers to ~5% of the logits; it also moves the router's inputs
    enough to flip near ties, and one flipped token takes another
    expert's whole output.  So the bf16 case gives the port XLA's silu
    rounding and JAX's routing choices (from JAX's unrolled layer loop,
    where they can be read), and prints how many tokens the port's own
    top-k would have routed otherwise; the choice itself is held bitwise
    to the reference in ``test_routing_is_bitwise_the_reference``, and
    in f32 here."""
    jc, tc = _cfgs(arch, dtype, impl, vocab_size=250)
    jparams, tparams = _params(jc)
    steps = 2
    tok = _tokens(tc, (B, S + steps))
    if dtype == "bfloat16":
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                            if a.dtype == jnp.bfloat16 else a, jparams)
        l32, _ = jt.prefill_step(jp32, {"tokens": jnp.asarray(
            tok[:, :S], jnp.int32)}, jc.replace(dtype="float32",
                                                 param_dtype="float32"))
        jc = jc.replace(scan_layers=False)
        chosen = _record_jax_routing(monkeypatch)
    jl, jcache, jlb, jz = jt.forward(jparams, {"tokens": jnp.asarray(
        tok[:, :S], jnp.int32)}, jc, "prefill")
    ref = [jl]
    jcache = _jax_place(jc, jcache, B, S, S + steps)
    for i in range(steps):
        jl, jcache = jt.decode_step(jparams, {"tokens": jnp.asarray(
            tok[:, S + i: S + i + 1], jnp.int32)}, jc, jcache,
            jnp.int32(S + i))
        ref.append(jl)
    if dtype == "bfloat16":
        flips = _force_routing(monkeypatch, chosen)
        monkeypatch.setattr(torch.nn.functional, "silu", _xla_cpu_silu)
    tl, tcache, tlb, tz = tt.forward(tparams, {"tokens": torch.from_numpy(
        tok[:, :S])}, tc, "prefill")
    assert tlb.dtype == tz.dtype == torch.float32
    if dtype == "float32":
        assert abs(float(tlb) - float(jlb)) <= 1e-5 * abs(float(jlb))
        assert abs(float(tz) - float(jz)) <= 1e-5 * abs(float(jz))
    out = [tl]
    tcache = tt.place_caches(tc, tcache, S + steps)
    for i in range(steps):
        tl, tcache = tt.decode_step(tparams, {"tokens": torch.from_numpy(
            tok[:, S + i: S + i + 1])}, tc, tcache, S + i)
        out.append(tl)
    for tl, jl in zip(out, ref):
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
        assert len(flips) == len(chosen)
        jax16 = ref[0][..., :250]
        print(f"{arch} bf16 prefill logits: port vs JAX "
              f"{_rel_norm(out[0][..., :250], jax16):.3e} on JAX's routing "
              f"(tokens the port would route otherwise, per MoE call: "
              f"{flips}); JAX bf16 vs its f32 "
              f"{_rel_norm(jax16, l32[..., :250]):.3e}")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_reproduces_the_reference_greedy_tokens(arch):
    """The reference serve_lm loop (B=2, a 32-token prompt from
    random_batch seed 0, the prefill caches placed into init_cache(36),
    greedy decode) and the port's generate, with the same parameters,
    emit the same tokens."""
    jc, tc = _cfgs(arch, impl="chunked")
    jparams, tparams = _params(jc)
    steps = 4
    jb = jspecs.random_batch(jc, jcfgs.ShapeConfig("p", 32, 2, "prefill"),
                             "prefill")
    logits, caches = jt.prefill_step(jparams, jb, jc)
    caches = _jax_place(jc, caches, 2, 32, 32 + steps)
    tok = jnp.argmax(logits[:, -1:], -1)
    ref = [tok]
    for i in range(steps):
        logits, caches = jt.decode_step(jparams, {"tokens": tok}, jc,
                                        caches, jnp.int32(32 + i))
        tok = jnp.argmax(logits[:, -1:], -1)
        ref.append(tok)
    ref = np.concatenate([np.asarray(t) for t in ref], axis=1)
    tb = {"tokens": torch.from_numpy(np.asarray(jb["tokens"], np.int64))}
    gen = tserve.generate(tparams, tc, tb, steps, device="cpu")
    assert gen.tokens.shape == (2, steps + 1)
    np.testing.assert_array_equal(gen.tokens.numpy(), ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_a_longer_prefill(arch, monkeypatch):
    """Decoding one token after a prefill of S tokens gives the last row
    of a prefill over S + 1 tokens, for every batch entry that neither
    prefill dropped a token of (a drop depends on the batch: the
    capacity counts every token of the call).  The decode step routes B
    tokens, under its capacity of 8."""
    _, tc = _cfgs(arch)
    tparams = tt.init_params(tc, seed=1, device="cpu")
    Bp = 4
    tok = torch.from_numpy(_tokens(tc, (Bp, S + 1), seed=5))
    seen = _record_routing(monkeypatch)
    full, _ = tt.prefill_step(tparams, {"tokens": tok}, tc)
    _, cache = tt.prefill_step(tparams, {"tokens": tok[:, :S]}, tc)
    cache = tt.place_caches(tc, cache, S + 1)
    n_moe = len(seen) // 2
    step, _ = tt.decode_step(tparams, {"tokens": tok[:, S:]}, tc, cache, S)
    assert len(seen) == 3 * n_moe and n_moe >= 1
    assert all(bool(r.keep.all()) for _, r in seen[2 * n_moe:])
    clean = torch.ones(Bp, dtype=torch.bool)
    for shape, r in seen[:2 * n_moe]:
        clean &= r.keep.reshape(shape[0], shape[1], -1).all(-1).all(-1)
    print(f"{arch}: {int(clean.sum())} of {Bp} entries without a drop")
    assert bool(clean.any())
    assert _rel_norm(step[clean, 0], full[clean, -1]) < 1e-5


def test_bf16_stays_bf16_through_jambas_stack(monkeypatch):
    """The regression the reference guards (tests/test_arch_smoke.py:77):
    bf16 activations must stay bf16 through every layer of jamba's
    super-block, the SSD carry and the MoE FFN included; the SSM state is
    f32 by its spec, the conv and KV caches bf16, and the placed prefill
    caches have init_cache's tree (KV cache and SSM states together)."""
    _, tc = _cfgs("jamba-1.5-large-398b", "bfloat16")
    params = tt.init_params(tc, seed=0, device="cpu")
    dtypes = []
    block = tt._block_forward

    def watched(*a, **kw):
        out = block(*a, **kw)
        dtypes.append(out[0].dtype)
        return out
    monkeypatch.setattr(tt, "_block_forward", watched)
    tok = torch.from_numpy(_tokens(tc, (B, S)))
    logits, caches, lb, z = tt.forward(params, {"tokens": tok}, tc,
                                       "prefill")
    assert dtypes == [torch.bfloat16] * tc.num_layers
    assert logits.dtype == torch.bfloat16
    assert caches["i4"]["k"].dtype == torch.bfloat16
    assert caches["i0"]["conv_x"].dtype == torch.bfloat16
    assert caches["i0"]["state"].dtype == torch.float32
    assert lb.dtype == z.dtype == torch.float32
    assert bool(torch.isfinite(lb)) and float(lb) > 0
    caches = tt.place_caches(tc, caches, S + 1)
    fresh = tt.init_cache(tc, B, S + 1, device="cpu")    # one tree, both
    assert fresh.keys() == caches.keys()
    for j in caches:
        for n, t in caches[j].items():
            assert fresh[j][n].shape == t.shape, (j, n)
            assert fresh[j][n].dtype == t.dtype, (j, n)
    step, caches = tt.decode_step(params, {"tokens": tok[:, :1]}, tc,
                                  caches, S)
    assert step.dtype == torch.bfloat16
    assert caches["i0"]["state"].dtype == torch.float32


def test_bridge_carries_an_moe_tree_unchanged():
    """A bf16 jamba tree (experts bf16, routers and SSM constants f32)
    crosses the bridge and back bit for bit."""
    jc, _ = _cfgs("jamba-1.5-large-398b", "bfloat16")
    jparams = jt.init_params(jc, jax.random.PRNGKey(1))
    port = tlayers.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    ffn = port["blocks"]["i1"]["ffn"]
    assert ffn["w_up"].dtype == torch.bfloat16
    assert ffn["router"].dtype == torch.float32
    assert port["blocks"]["i0"]["mixer"]["A_log"].dtype == torch.float32
    back = tlayers.params_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_seeded_init_draws_distinct_experts():
    """init_from_seed: the spec rule (router f32, zeros, normal·std), the
    same bits for the same seed, other bits for another seed, and every
    expert of a leaf drawn apart from the others."""
    _, tc = _cfgs("kimi-k2-1t-a32b")
    p = tt.init_params(tc, seed=3, device="cpu")
    again = tt.init_params(tc, seed=3, device="cpu")
    other = tt.init_params(tc, seed=4, device="cpu")
    ffn = p["blocks"]["i0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert float(p["blocks"]["i0"]["norm2"]["scale"].abs().max()) == 0.0
    w = ffn["w_up"][0]                                     # (E, d, f)
    std = float(w.std())
    assert 0.9 / np.sqrt(tc.d_model) < std < 1.1 / np.sqrt(tc.d_model)
    assert abs(float(w.mean())) < 0.05 * std
    flat = w.reshape(tc.num_experts, -1)
    corr = torch.corrcoef(flat)
    assert float((corr - torch.eye(tc.num_experts)).abs().max()) < 0.1
    assert not torch.equal(ffn["w_up"], ffn["w_gate"])
    for a, b, c in zip(jax.tree.leaves(tlayers.params_to_numpy(p)),
                       jax.tree.leaves(tlayers.params_to_numpy(again)),
                       jax.tree.leaves(tlayers.params_to_numpy(other))):
        np.testing.assert_array_equal(a, b)
        assert np.array_equal(a, c) == (not a.any() or (a == 1).all())


def test_serve_lm_runs_on_the_cpu(capsys, monkeypatch):
    """``serve --arch llama4-maverick-400b-a17b --device cpu`` (the CLI),
    and the three names through serve_lm."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCHS[0],
                                      "--device", "cpu"])
    tserve.main()
    assert capsys.readouterr().out.startswith(f"{ARCHS[0]}: prefill 32 "
                                              "tokens")
    for arch in ARCHS:
        tserve.serve_lm(argparse.Namespace(arch=arch, device="cpu",
                                           decode_steps=2))
        out = capsys.readouterr().out
        assert out.startswith(f"{arch}: prefill 32 tokens")
