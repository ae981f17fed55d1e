"""The port's multi-device paths on 8 gloo ranks of a (2, 4) ("data",
"model") mesh against the reference's ``shard_map`` bodies on an
8-device JAX CPU mesh, on the same seeded numpy inputs and parameters:

  - the expert-parallel MoE (``moe.moe_forward`` under
    ``LOGICAL_RULES_TRAIN``) at ``tests/test_multidevice.py``'s capacity
    factor 4.0, and at 1.0 with routing skewed so the per-device
    capacity binds: every device's routing and ``keep`` bitwise the
    reference's, y / lb / z within the reference's own multi-device gate
    (rtol 2e-4, atol 2e-5), and y against the port's meshless path where
    nothing drops;
  - flash-decoding under ``LOGICAL_RULES_DECODE`` and, at B = 1,
    ``_DECODE_LONG`` (the cache's sequence over the whole mesh);
  - sequence-parallel prefill attention, against the reference and
    against the port's meshless ``causal_attention`` (bitwise on the
    CPU: the keys past a shard's last row, which it does not pass, are
    exactly the ones the full causal mask discards, and the plain
    version's key tiles start at key 0 in both);
  - llama4 and jamba at smoke size: a prefill under
    ``LOGICAL_RULES_PREFILL_SP`` (``attn_impl="sp"``: every rank holds a
    (1, 4) slice of the (2, 16) tokens; jamba's SSM layers gather the
    sequence), its caches placed into decode caches of 20 positions, and
    4 decode steps under ``LOGICAL_RULES_DECODE`` with the cache's
    sequence over 'model' and the experts sharded (E/4, d/2, f) on every
    rank: logits within 1e-4 (f32, the zoo's port-vs-JAX gate);
  - the reference's MoE under ``LOGICAL_RULES_TRAIN_FSDP``, pinned
    against its meshless path, and the port's (tokens replicated over
    'model') against its own.

The two programs run once per module, side by side: the reference in a
JAX subprocess with ``--xla_force_host_platform_device_count=8``, the
port on 8 ranks (``tests/_torch_ranks.py``), each writing npz files.
"""
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402

from _torch_ranks import SRC, flat, spawn, wait  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5              # tests/test_multidevice.py's gate
LOGITS_F32_ABS = 1e-4
MODELS = ("llama4-maverick-400b-a17b", "jamba-1.5-large-398b")
B_LM, S_LM, DECODE = 2, 16, 4
MOE_CASES = {"moe_cf4": ("x", 4.0), "moe_cf1": ("x_skew", 1.0)}

JAX_PROGRAM = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config
from repro.distributed import sharding as sh
from repro.launch.mesh import make_mesh_compat
from repro.models import moe as moe_mod
from repro.models import transformer as tfm
from repro.models.attention import flash_decode, sp_prefill_attention

out_dir = sys.argv[1]
inp = np.load(os.path.join(out_dir, "inputs.npz"))
assert len(jax.devices()) == 8
mesh = make_mesh_compat((2, 4), ("data", "model"))
res = {}


def tree(prefix):
    t = {}
    for key in inp.files:
        if key.startswith(prefix + "/"):
            node, parts = t, key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(inp[key])
    return t


def routing(xf, router, k, cap):
    # the routing lines of _moe_local / _run_local_nomesh on one device
    probs = jax.nn.softmax(xf @ router, axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    E = router.shape[1]
    oh = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(-1, E)
    pos = jnp.sum((jnp.cumsum(oh, 0) - oh) * oh, -1).reshape(idx.shape)
    return np.asarray(idx), np.asarray(pos < cap)


moe_params = tree("moe_params")
base = get_smoke_config("llama4-maverick-400b-a17b").replace(
    num_experts=8, experts_per_token=1)
for name, xkey, cf, rules in (("moe_cf4", "x", 4.0, sh.LOGICAL_RULES_TRAIN),
                              ("moe_cf1", "x_skew", 1.0,
                               sh.LOGICAL_RULES_TRAIN),
                              ("moe_fsdp", "x_fsdp", 4.0,
                               sh.LOGICAL_RULES_TRAIN_FSDP)):
    cfg = base.replace(capacity_factor=cf)
    x = jnp.asarray(inp[xkey])
    with sh.use_mesh_and_rules(mesh, rules), mesh:
        y, lb, z = jax.jit(lambda p, a: moe_mod.moe_forward(p, a, cfg))(
            moe_params, x)
    y0, lb0, z0 = moe_mod.moe_forward(moe_params, x, cfg)
    res.update({f"{name}/y": y, f"{name}/lb": lb, f"{name}/z": z,
                f"{name}/y_meshless": y0, f"{name}/lb_meshless": lb0,
                f"{name}/z_meshless": z0})
    B, S, d = x.shape
    t_loc = B * S // 2
    cap = moe_mod._capacity(t_loc, 1, 8, cf)
    xf = x.reshape(-1, d)
    for b in range(2):
        idx, keep = routing(xf[b * t_loc:(b + 1) * t_loc],
                            moe_params["router"], 1, cap)
        res[f"{name}/idx{b}"], res[f"{name}/keep{b}"] = idx, keep

acfg = get_smoke_config("qwen3-4b")
for name, rules in (("decode", sh.LOGICAL_RULES_DECODE),
                    ("decode_long", sh.LOGICAL_RULES_DECODE_LONG)):
    args = [jnp.asarray(inp[f"{name}/{k}"]) for k in ("q", "k", "v")]
    with sh.use_mesh_and_rules(mesh, rules), mesh:
        res[f"{name}/o"] = jax.jit(lambda *a: flash_decode(
            *a, jnp.int32(37), acfg))(*args)

scfg = acfg.replace(num_heads=4, num_kv_heads=2, head_dim=16, attn_chunk=8)
args = [jnp.asarray(inp[f"sp/{k}"]) for k in ("q", "k", "v")]
with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_PREFILL_SP), mesh:
    res["sp/o"] = jax.jit(lambda *a: sp_prefill_attention(*a, scfg))(*args)

for arch in ("llama4-maverick-400b-a17b", "jamba-1.5-large-398b"):
    cfg = get_smoke_config(arch).replace(attn_impl="sp")
    params = tree(f"{arch}/params")
    tok = jnp.asarray(inp[f"{arch}/tokens"])
    B, S = tok.shape
    steps = inp[f"{arch}/decode_tokens"].shape[1]
    with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_PREFILL_SP), mesh:
        logits, caches = jax.jit(lambda p, b: tfm.prefill_step(p, b, cfg))(
            params, {"tokens": tok})
    res[f"{arch}/prefill"] = logits
    full = tfm.init_cache(cfg, B, S + steps)

    def put(dst, src):
        if src.ndim >= 3 and src.shape[2] == S:
            return jax.lax.dynamic_update_slice_in_dim(
                dst, src.astype(dst.dtype), 0, axis=2)
        return src.astype(dst.dtype)
    caches = jax.tree_util.tree_map(put, full, caches)
    with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_DECODE), mesh:
        step = jax.jit(lambda p, b, c, pos: tfm.decode_step(p, b, cfg, c,
                                                            pos))
        for i in range(steps):
            d_tok = jnp.asarray(inp[f"{arch}/decode_tokens"][:, i:i + 1])
            logits, caches = step(params, {"tokens": d_tok}, caches,
                                  jnp.int32(S + i))
            res[f"{arch}/decode{i}"] = logits
np.savez(os.path.join(out_dir, "ref.npz"),
         **{k: np.asarray(v) for k, v in res.items()})
print("REFERENCE DONE")
"""

PORT_PROGRAM = r"""
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.fault_tolerance import rescale_state
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import params_from_numpy

inp = np.load(os.path.join(OUT, "inputs.npz"))
mesh = make_mesh((2, 4), ("data", "model"), "cpu")
res = {}
T = lambda a: torch.from_numpy(np.array(a))


def gather(x, lay):
    x = coll.all_gather(x, mesh, lay.seq, 1)
    return coll.all_gather(x, mesh, lay.batch, 0)


def cut(x, lay):
    x = coll.take_block(x, mesh, lay.batch, 0)
    return coll.take_block(x, mesh, lay.seq, 1)


def placed(np_tree, spec_of):
    # the whole tree on every rank but the leaves spec_of names, which are
    # cut to the rank's block (rescale_state from a host checkpoint)
    whole = params_from_numpy(np_tree, "cpu")

    def shard(t, path=""):
        if isinstance(t, dict):
            return {k: shard(v, f"{path}/{k}") for k, v in t.items()}
        return sh.NamedSharding(mesh, sh.P(*spec_of(path)))
    return rescale_state(whole, shard(whole))


# ---- MoE -------------------------------------------------------------- #
moe_np = load_tree(inp, "moe_params")
experts = placed(moe_np, lambda path: moe_mod.EXPERT_SPECS.get(
    path.strip("/"), ()))
base = get_smoke_config("llama4-maverick-400b-a17b").replace(
    num_experts=8, experts_per_token=1)
seen = []
run_shard = moe_mod.moe_shard


def recorded(*a, **kw):
    p = run_shard(*a, **kw)
    seen.append(p.routing)
    return p


moe_mod.moe_shard = recorded
for name, xkey, cf, rules in (("moe_cf4", "x", 4.0, sh.LOGICAL_RULES_TRAIN),
                              ("moe_cf1", "x_skew", 1.0,
                               sh.LOGICAL_RULES_TRAIN),
                              ("moe_fsdp", "x_fsdp", 4.0,
                               sh.LOGICAL_RULES_TRAIN_FSDP)):
    cfg = base.replace(capacity_factor=cf)
    x = T(inp[xkey])
    seen.clear()
    with sh.use_mesh_and_rules(mesh, rules):
        lay = sh.layout(x.shape[0], x.shape[1])
        with sh.use_layout(lay):
            y, lb, z = moe_mod.moe_forward(experts, cut(x, lay), cfg)
        res[f"{name}/layout_batch"] = np.array(lay.batch)
        res[f"{name}/y"] = gather(y, lay).numpy()
    res[f"{name}/lb"], res[f"{name}/z"] = lb.item(), z.item()
    (r,) = seen
    res[f"{name}/idx"], res[f"{name}/keep"] = r.idx.numpy(), r.keep.numpy()
    seen.clear()
    y0, lb0, z0 = moe_mod.moe_forward(params_from_numpy(moe_np, "cpu"), x,
                                      cfg)
    res[f"{name}/y_meshless"] = y0.numpy()
    res[f"{name}/meshless_keep"] = seen[0].keep.numpy()
moe_mod.moe_shard = run_shard

# ---- flash-decoding --------------------------------------------------- #
for name, rules in (("decode", sh.LOGICAL_RULES_DECODE),
                    ("decode_long", sh.LOGICAL_RULES_DECODE_LONG)):
    q, k, v = (T(inp[f"{name}/{n}"]) for n in ("q", "k", "v"))
    with sh.use_mesh_and_rules(mesh, rules):
        lay = sh.layout(q.shape[0], 1, k.shape[1])
        kv = lambda c: coll.take_block(coll.take_block(c, mesh, lay.batch, 0),
                                       mesh, lay.cache_seq, 1)
        with sh.use_layout(lay):
            o = att.flash_decode(coll.take_block(q, mesh, lay.batch, 0),
                                 kv(k), kv(v), 37)
        res[f"{name}/o"] = coll.all_gather(o, mesh, lay.batch, 0).numpy()
        res[f"{name}/cache_seq"] = np.array(lay.cache_seq)
    res[f"{name}/o_meshless"] = att.decode_attention(q, k, v, 37).numpy()

# ---- sequence-parallel prefill ----------------------------------------- #
q, k, v = (T(inp[f"sp/{n}"]) for n in ("q", "k", "v"))
scfg = get_smoke_config("qwen3-4b").replace(num_heads=4, num_kv_heads=2,
                                            head_dim=16)
with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_PREFILL_SP):
    lay = sh.layout(q.shape[0], q.shape[1])
    with sh.use_layout(lay):
        o = att.sp_prefill_attention(cut(q, lay), cut(k, lay), cut(v, lay),
                                     scfg)
    res["sp/o"] = gather(o, lay).numpy()
    res["sp/seq"] = np.array(lay.seq)
res["sp/o_meshless"] = att.causal_attention(q, k, v).numpy()

# ---- llama4 and jamba: SP prefill, then decode -------------------------- #
for arch in ("llama4-maverick-400b-a17b", "jamba-1.5-large-398b"):
    cfg = get_smoke_config(arch).replace(attn_impl="sp")
    place = tfm.expert_placement(cfg)
    spec_of = lambda path: place.get(path.split("/")[2], {}).get(
        path.split("/")[-1], ()) if "/ffn/" in path else ()
    params = placed(load_tree(inp, f"{arch}/params"), spec_of)
    tok = T(inp[f"{arch}/tokens"]).long()
    d_tok = T(inp[f"{arch}/decode_tokens"]).long()
    B, S = tok.shape
    with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_PREFILL_SP):
        pre = sh.layout(B, S)
        with sh.use_layout(pre):
            logits, caches = tfm.prefill_step(params, {"tokens": cut(tok, pre)},
                                              cfg)
        res[f"{arch}/prefill"] = gather(logits, pre).numpy()
        res[f"{arch}/prefill_layout"] = np.array(pre.batch + pre.seq)
        # a decode cache of S positions split as the prefill's: each
        # rank's prefill slice is its decode block, no copy
        aligned = tfm.place_caches(cfg, caches, S, pre,
                                   sh.Layout(pre.batch, (), pre.seq))
        res[f"{arch}/aligned_is_prefill"] = np.array(all(
            aligned[f"i{j}"][n] is caches[f"i{j}"][n]
            for j, (mixer, _) in enumerate(cfg.pattern()) if mixer == "attn"
            for n in ("k", "v")))
    with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_DECODE):
        dec = sh.layout(B, 1, S + d_tok.shape[1])
        caches = tfm.place_caches(cfg, caches, S + d_tok.shape[1], pre, dec)
        for i in range(d_tok.shape[1]):
            with sh.use_layout(dec):
                logits, caches = tfm.decode_step(
                    params, {"tokens": coll.take_block(
                        d_tok[:, i:i + 1], mesh, dec.batch, 0)},
                    cfg, caches, S + i)
            res[f"{arch}/decode{i}"] = gather(logits, dec).numpy()
        res[f"{arch}/decode_layout"] = np.array(dec.batch + dec.cache_seq)
        res[f"{arch}/expert_shape"] = np.array(
            params["blocks"]["i1"]["ffn"]["w_up"].shape)
np.savez(os.path.join(OUT, f"port.rank{RANK}.npz"), **res)
"""


def _redraw(tree, rng):
    """Norm scales redrawn nonzero and the SSM's A_log, D, dt_bias off
    their constant init (``test_torch_moe.py``'s redraws)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _redraw(v, rng)
        elif k in ("scale", "q_norm", "k_norm", "gate_norm"):
            tree[k] = rng.uniform(-0.5, 0.5, v.shape).astype(v.dtype)
        elif k in ("A_log", "D", "dt_bias"):
            lo, hi = {"A_log": (-1.0, 1.0), "D": (0.5, 1.5),
                      "dt_bias": (-1.0, 0.5)}[k]
            tree[k] = rng.uniform(lo, hi, v.shape).astype(v.dtype)


def _inputs():
    rng = np.random.RandomState(0)
    cfg = jcfgs.get_smoke_config("llama4-maverick-400b-a17b").replace(
        num_experts=8, experts_per_token=1)
    moe_params = jax.tree.map(np.asarray, jlayers.init_from_specs(
        jmoe.moe_specs(cfg), jax.random.PRNGKey(1), "float32"))
    d = cfg.d_model
    out = flat(moe_params, "moe_params")
    out["x"] = rng.randn(4, 8, d).astype(np.float32)
    # skewed: a shared direction that most router columns score low, so
    # a few experts take most tokens and capacity 8 a device binds
    lead = moe_params["router"][:, :2].sum(1)
    out["x_skew"] = (rng.randn(4, 8, d) + 0.6 * lead / np.linalg.norm(lead)
                     * np.sqrt(d)).astype(np.float32)
    out["x_fsdp"] = rng.randn(8, 8, d).astype(np.float32)
    for name, B in (("decode", 4), ("decode_long", 1)):
        # qwen3-4b's smoke heads: 4 query heads over 2 KV heads of 16
        out[f"{name}/q"] = rng.randn(B, 1, 4, 16).astype(np.float32)
        out[f"{name}/k"] = rng.randn(B, 64, 2, 16).astype(np.float32)
        out[f"{name}/v"] = rng.randn(B, 64, 2, 16).astype(np.float32)
    out["sp/q"] = rng.randn(2, 32, 4, 16).astype(np.float32)
    out["sp/k"] = rng.randn(2, 32, 2, 16).astype(np.float32)
    out["sp/v"] = rng.randn(2, 32, 2, 16).astype(np.float32)
    for i, arch in enumerate(MODELS):
        jc = jcfgs.get_smoke_config(arch)
        p = jax.tree.map(np.asarray, jt.init_params(
            jc, jax.random.PRNGKey(i)))
        _redraw(p, np.random.RandomState(10 + i))
        out.update(flat(p, f"{arch}/params"))
        out[f"{arch}/tokens"] = rng.randint(
            0, jc.vocab_size, (B_LM, S_LM)).astype(np.int32)
        out[f"{arch}/decode_tokens"] = rng.randint(
            0, jc.vocab_size, (B_LM, DECODE)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, [each rank's port outputs])."""
    out = tmp_path_factory.mktemp("multidevice")
    np.savez(out / "inputs.npz", **_inputs())
    ref = subprocess.Popen([sys.executable, "-c", JAX_PROGRAM, str(out)],
                           env={**__import__("os").environ,
                                "PYTHONPATH": SRC},
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    ranks = spawn(PORT_PROGRAM, 8, out)
    wait(ranks)
    text = ref.communicate(timeout=400)[0]
    assert "REFERENCE DONE" in text, text[-4000:]
    return (np.load(out / "ref.npz"),
            [np.load(out / f"port.rank{r}.npz") for r in range(8)])


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_expert_parallel_matches_reference(runs, case):
    ref, port = runs
    p0 = port[0]
    assert tuple(p0[f"{case}/layout_batch"]) == ("data",)
    # every rank's routing and keep: its DP block's (data coordinate r // 4)
    for r, p in enumerate(port):
        np.testing.assert_array_equal(p[f"{case}/idx"],
                                      ref[f"{case}/idx{r // 4}"])
        np.testing.assert_array_equal(p[f"{case}/keep"],
                                      ref[f"{case}/keep{r // 4}"])
        np.testing.assert_array_equal(p[f"{case}/y"], p0[f"{case}/y"])
    _close(p0[f"{case}/y"], ref[f"{case}/y"])
    np.testing.assert_allclose(p0[f"{case}/lb"], ref[f"{case}/lb"],
                               rtol=RTOL)
    np.testing.assert_allclose(p0[f"{case}/z"], ref[f"{case}/z"], rtol=RTOL)
    keep = np.concatenate([ref[f"{case}/keep{b}"] for b in range(2)])
    if case == "moe_cf4":
        # nothing drops: the expert-parallel y is the meshless y
        assert keep.all() and p0[f"{case}/meshless_keep"].all()
        _close(p0[f"{case}/y"], p0[f"{case}/y_meshless"])
        _close(ref[f"{case}/y"], ref[f"{case}/y_meshless"])
    else:
        # the per-device capacity binds, and drops other tokens than the
        # meshless path's capacity over all 32 tokens would
        assert not keep.all()
        assert not np.array_equal(keep.ravel(),
                                  p0[f"{case}/meshless_keep"].ravel())
        print(f"{case}: {int((~keep).sum())} of {keep.size} pairs dropped "
              f"at capacity 8 a device; the meshless path drops "
              f"{int((~p0[f'{case}/meshless_keep']).sum())} at its "
              "capacity of all 32 tokens")


@pytest.mark.parametrize("case, axes", [("decode", ("model",)),
                                        ("decode_long", ("data", "model"))])
def test_flash_decode_matches_reference(runs, case, axes):
    ref, port = runs
    for p in port:
        assert tuple(p[f"{case}/cache_seq"]) == axes
        _close(p[f"{case}/o"], ref[f"{case}/o"])
        _close(p[f"{case}/o"], p[f"{case}/o_meshless"])


def test_sp_prefill_attention_matches_reference_and_meshless(runs):
    ref, port = runs
    for p in port:
        assert tuple(p["sp/seq"]) == ("model",)
        _close(p["sp/o"], ref["sp/o"])
        np.testing.assert_array_equal(p["sp/o"], p["sp/o_meshless"])


@pytest.mark.parametrize("arch", MODELS)
def test_sp_prefill_and_sharded_decode_match_reference(runs, arch):
    ref, port = runs
    p0 = port[0]
    assert tuple(p0[f"{arch}/prefill_layout"]) == ("data", "model")
    assert tuple(p0[f"{arch}/decode_layout"]) == ("data", "model")
    assert bool(p0[f"{arch}/aligned_is_prefill"])
    cfg = jcfgs.get_smoke_config(arch)
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert tuple(p0[f"{arch}/expert_shape"]) == (
        cfg.num_repeats, E // 4, d // 2, f)
    for key in [f"{arch}/prefill"] + [f"{arch}/decode{i}"
                                      for i in range(DECODE)]:
        np.testing.assert_allclose(p0[key], ref[key], rtol=0,
                                   atol=LOGITS_F32_ABS, err_msg=key)
        for p in port[1:]:
            np.testing.assert_array_equal(p[key], p0[key])


def test_fsdp_moe_reference_fault_pinned_and_port_right(runs):
    """``LOGICAL_RULES_TRAIN_FSDP`` maps ``batch`` to ('data', 'model'):
    the reference's ``moe_forward`` splits its tokens over 'model' too
    but computes ``t_loc`` over 'data' only and sums y over 'model', so
    its y is not its meshless y (a fault in the reference, which stays
    as it is; ``ROADMAP.md`` pins it).  The port keeps the tokens
    replicated over 'model' inside the layer and gives its meshless y,
    where nothing drops."""
    ref, port = runs
    p0 = port[0]
    assert tuple(p0["moe_fsdp/layout_batch"]) == ("data", "model")
    gap = np.abs(ref["moe_fsdp/y"] - ref["moe_fsdp/y_meshless"]).max()
    print(f"reference FSDP MoE: max |y - meshless y| {gap:.4e} (max |y| "
          f"{np.abs(ref['moe_fsdp/y_meshless']).max():.4e})")
    assert gap > 1e-2, gap
    assert p0["moe_fsdp/meshless_keep"].all()
    _close(p0["moe_fsdp/y"], p0["moe_fsdp/y_meshless"])
    _close(p0["moe_fsdp/y"], ref["moe_fsdp/y_meshless"])
    np.testing.assert_allclose(p0["moe_fsdp/lb"], ref["moe_fsdp/lb_meshless"],
                               rtol=RTOL)
