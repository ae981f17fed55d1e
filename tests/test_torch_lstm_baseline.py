"""The port's LSTM baseline (``repro_torch.core.lstm_baseline``) against
``repro.core.lstm_baseline`` on the CPU: the same parameters (the
reference's ``init_params`` through ``params_from_numpy``, the biases
redrawn nonzero) and the same numpy batches.  f32: the forward <= 1e-5
relative, every gradient leaf <= 1e-4 relative norm.  bf16 compute over
f32 parameters (the paper config's mix): each clip within the
reference's bf16 gate, 1% relative (``tests/test_rt_cache.py``'s
bf16-vs-fp32 bound), of the reference's bf16 run.  The batches hold
instructions shorter than L_token, all-<PAD> instructions and clips
masked short, so the carried-through state is exercised."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import capsim as jax_capsim  # noqa: E402
from repro.core import lstm_baseline as jl  # noqa: E402
from repro_torch.configs import capsim as port_capsim  # noqa: E402
from repro_torch.core import lstm_baseline as tl  # noqa: E402
from repro_torch.models.layers import params_from_numpy  # noqa: E402

FWD_REL, GRAD_REL, BF16_REL = 1e-5, 1e-4, 1e-2


def _cfgs(dtype):
    return (jax_capsim.smoke_config().replace(dtype=dtype),
            port_capsim.smoke_config().replace(dtype=dtype))


def _np_params(jcfg):
    p = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.RandomState(4)
    for name in ("tok_lstm", "inst_lstm", "head"):
        p[name] = dict(p[name])
        p[name]["b"] = rng.uniform(-0.5, 0.5, p[name]["b"].shape
                                   ).astype(np.float32)
    return p


def _batch(rng, V, T, B=4, L=12):
    """Instructions of 1..T tokens; the last two clips masked short with
    all-<PAD> instructions past their ends; one all-<PAD> instruction
    inside a live clip."""
    tok = rng.randint(1, V, (B, L, T)).astype(np.int32)
    lens = rng.randint(1, T + 1, (B, L))
    tok[np.arange(T) >= lens[..., None]] = 0
    mask = np.ones((B, L), np.float32)
    mask[-1, 5:] = 0.0
    mask[-2, 9:] = 0.0
    tok[mask == 0] = 0
    tok[0, 3] = 0
    return {"clip_tokens": tok,
            "context_tokens": rng.randint(1, V, (B, 36)).astype(np.int32),
            "clip_mask": mask,
            "time": rng.uniform(50, 400, (B,)).astype(np.float32)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_f32_matches_reference(seed):
    jcfg, tcfg = _cfgs("float32")
    p = _np_params(jcfg)
    b = _batch(np.random.RandomState(seed), tcfg.vocab_size,
               tcfg.clip_tokens)
    ref = np.asarray(jl.forward(jax.tree.map(jnp.asarray, p),
                                jax.tree.map(jnp.asarray, b), jcfg))
    got = tl.forward(params_from_numpy(p, "cpu"),
                     {k: torch.from_numpy(v) for k, v in b.items()}, tcfg)
    assert got.shape == ref.shape == (4,)
    assert _rel(got.numpy(), ref) <= FWD_REL


def test_gradients_f32_match_reference():
    jcfg, tcfg = _cfgs("float32")
    p = _np_params(jcfg)
    b = _batch(np.random.RandomState(2), tcfg.vocab_size, tcfg.clip_tokens)
    (jloss, _), jg = jax.value_and_grad(
        lambda q: jl.mape_loss(q, jax.tree.map(jnp.asarray, b), jcfg),
        has_aux=True)(jax.tree.map(jnp.asarray, p))
    tp = params_from_numpy(p, "cpu")
    leaves = _flat(tp)
    for v in leaves.values():
        v.requires_grad_(True)
    loss, aux = tl.mape_loss(tp, {k: torch.from_numpy(v)
                                  for k, v in b.items()}, tcfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= FWD_REL * abs(float(jloss))
    assert float(aux["mape"].detach()) == float(loss)
    ref = _flat(jax.tree.map(np.asarray, jg))
    for (name, g) in zip(leaves, grads):
        assert _rel(g.numpy(), ref[name]) <= GRAD_REL, name


def test_forward_bf16_within_reference_gate():
    """bf16 compute over f32 parameters: every clip within 1% of the
    reference's bf16 prediction, and each package's bf16 within 1% of
    its f32."""
    jcfg, tcfg = _cfgs("bfloat16")
    jcfg32, tcfg32 = _cfgs("float32")
    p = _np_params(jcfg)
    b = _batch(np.random.RandomState(5), tcfg.vocab_size, tcfg.clip_tokens)
    jb = jax.tree.map(jnp.asarray, b)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    ref = np.asarray(jl.forward(jax.tree.map(jnp.asarray, p), jb, jcfg))
    ref32 = np.asarray(jl.forward(jax.tree.map(jnp.asarray, p), jb, jcfg32))
    tp = params_from_numpy(p, "cpu")
    got = tl.forward(tp, tb, tcfg)
    got32 = tl.forward(tp, tb, tcfg32)
    assert got.dtype == torch.float32
    for a, r in ((got.numpy(), ref), (got.numpy(), got32.numpy()),
                 (ref, ref32)):
        assert np.max(np.abs(a - r) / np.abs(r)) < BF16_REL


def test_masked_steps_carry_state():
    """Appending masked instruction slots (and <PAD> token slots) leaves
    every prediction unchanged, bit for bit."""
    _, tcfg = _cfgs("float32")
    p = tl.init_params(tcfg, seed=1, device="cpu")
    b = _batch(np.random.RandomState(6), tcfg.vocab_size, tcfg.clip_tokens)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    longer = dict(tb)
    longer["clip_tokens"] = torch.cat(
        [tb["clip_tokens"], torch.zeros(4, 3, tcfg.clip_tokens,
                                        dtype=torch.int32)], 1)
    longer["clip_mask"] = torch.cat([tb["clip_mask"], torch.zeros(4, 3)], 1)
    assert torch.equal(tl.forward(p, tb, tcfg), tl.forward(p, longer, tcfg))


def test_specs_and_abstract_params_match_reference():
    jcfg, tcfg = _cfgs("float32")
    ref = _flat(jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                             jl.abstract_params(jcfg)))
    got = _flat(tl.abstract_params(tcfg))
    assert set(got) == set(ref)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == ref[k]
