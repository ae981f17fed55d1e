"""GSPMD's weight layouts made real in the port: the LM zoo's parameters
held as per-rank blocks on 8 gloo ranks of a (2, 4) ("data", "model")
mesh, against the reference partitioned by XLA on an 8-device JAX CPU
mesh (``jax.jit`` with ``in_shardings=param_shardings(cfg, mesh,
rules)``, as ``launch/dryrun.lower_cell`` builds it), on the same
seeded numpy parameters and tokens:

  - ``init_params(mesh=...)`` under each of the seven rule tables: every
    rank's leaves are bitwise its ``take_spec_block`` of the meshless
    draw (the spec fitted), marked with the axes that split them; its
    resident bytes are exactly the sum of its blocks, and less than the
    whole tree's under the six LM tables (``LOGICAL_RULES_PREDICTOR``
    replicates every weight);
  - prefill under ``LOGICAL_RULES_TRAIN`` (FSDP rows over 'data',
    tensor parallelism over 'model') and 4 greedy decode steps under
    ``LOGICAL_RULES_DECODE`` (the cache's sequence over 'model'), the
    caches placed between them, for qwen3-4b, mamba2-780m,
    llama4-maverick and jamba at smoke size, qwen3-4b with 6 query
    heads (H·Dh divides over 'model' = 4, the heads do not), qwen3-4b
    with tied embeddings and a 250-token vocabulary padded to 256 over
    'model' (the lookup in the rank's vocab rows) and musicgen-large's 4
    codebooks ((C, d, V) logits split by vocab, each codebook's argmax
    across the blocks):
    logits within 1e-4 (f32, the zoo's port-vs-JAX gate), greedy tokens
    equal, every rank's gathered outputs identical;
  - ``launch/serve.generate`` with the rank's blocks under
    ``LOGICAL_RULES_DECODE`` and under ``LOGICAL_RULES_TRAIN`` (a whole
    cache sequence: each rank decodes its own query heads): the
    reference's greedy tokens, and its logits within 1e-4.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402

from _torch_ranks import SRC, flat, spawn, wait  # noqa: E402

LOGITS_F32_ABS = 1e-4
B, S, STEPS = 2, 16, 4
# case -> (arch, config overrides)
CASES = {
    "qwen3-4b": ("qwen3-4b", {}),
    "mamba2-780m": ("mamba2-780m", {}),
    "llama4": ("llama4-maverick-400b-a17b", {}),
    "jamba": ("jamba-1.5-large-398b", {}),
    "heads6": ("qwen3-4b", {"num_heads": 6}),
    "tied_v250": ("qwen3-4b", {"vocab_size": 250, "tie_embeddings": True}),
    "musicgen": ("musicgen-large", {}),
}
TABLES = ("LOGICAL_RULES_TRAIN", "LOGICAL_RULES_DECODE",
          "LOGICAL_RULES_DECODE_LONG", "LOGICAL_RULES_TRAIN_ZERO3",
          "LOGICAL_RULES_TRAIN_FSDP", "LOGICAL_RULES_PREFILL_SP",
          "LOGICAL_RULES_PREDICTOR")
GENERATE = ("qwen3-4b", "jamba")

JAX_PROGRAM = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import get_smoke_config
from repro.distributed import sharding as sh
from repro.launch.mesh import make_mesh_compat
from repro.models import transformer as tfm

out_dir = sys.argv[1]
inp = np.load(os.path.join(out_dir, "inputs.npz"))
cases = json.loads(sys.argv[2])
assert len(jax.devices()) == 8
mesh = make_mesh_compat((2, 4), ("data", "model"))
rows = NamedSharding(mesh, P("data"))
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


for case, (arch, over) in cases.items():
    cfg = get_smoke_config(arch).replace(**over)
    params = tree(f"{case}/params")
    tok = jnp.asarray(inp[f"{case}/tokens"])
    Bt, St = tok.shape[:2]
    steps = int(inp["steps"])
    with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_TRAIN), mesh:
        psh = tfm.param_shardings(cfg, mesh, sh.LOGICAL_RULES_TRAIN)
        logits, caches = jax.jit(
            lambda p, b: tfm.prefill_step(p, b, cfg),
            in_shardings=(psh, {"tokens": rows}))(params, {"tokens": tok})
    res[f"{case}/prefill"] = logits
    full = tfm.init_cache(cfg, Bt, St + steps)

    def put(dst, src):
        if src.ndim >= 3 and src.shape[2] == St:
            return jax.lax.dynamic_update_slice_in_dim(
                dst, src.astype(dst.dtype), 0, axis=2)
        return src.astype(dst.dtype)
    caches = jax.tree_util.tree_map(put, full, caches)
    nxt = jnp.argmax(logits[:, -1:], -1)
    res[f"{case}/tokens0"] = nxt
    with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_DECODE), mesh:
        psh = tfm.param_shardings(cfg, mesh, sh.LOGICAL_RULES_DECODE)
        csh = tfm.cache_shardings(cfg, Bt, St + steps, mesh,
                                  sh.LOGICAL_RULES_DECODE)
        step = jax.jit(
            lambda p, b, c, pos: tfm.decode_step(p, b, cfg, c, pos),
            in_shardings=(psh, {"tokens": rows}, csh, None))
        caches = jax.device_put(caches, csh)
        for i in range(steps):
            logits, caches = step(params, {"tokens": jax.device_put(
                nxt, rows)}, caches, jnp.int32(St + i))
            res[f"{case}/decode{i}"] = logits
            nxt = jnp.argmax(logits[:, -1:], -1)
            res[f"{case}/tokens{i + 1}"] = nxt
np.savez(os.path.join(out_dir, "ref.npz"),
         **{k: np.asarray(v) for k, v in res.items()})
print("REFERENCE DONE")
"""

PORT_PROGRAM = r"""
import json
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import params_from_numpy
from repro_torch.training.optimizer import tree_leaves

inp = np.load(os.path.join(OUT, "inputs.npz"))
cases = json.loads(os.environ["CASES"])
mesh = make_mesh((2, 4), ("data", "model"), "cpu")
res = {}
T = lambda a: torch.from_numpy(np.array(a))


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat_t(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


# ---- each rank draws its blocks, under every rule table ---------------- #
for arch in ("llama4-maverick-400b-a17b", "jamba-1.5-large-398b"):
    cfg = get_smoke_config(arch)
    whole = tfm.init_params(cfg, seed=3, device="cpu")
    for table in os.environ["TABLES"].split(","):
        rules = getattr(sh, table)
        with sh.use_mesh_and_rules(mesh, rules):
            mine = tfm.init_params(cfg, seed=3, device="cpu", mesh=mesh)
            specs = flat_t(tfm.param_shardings(cfg, mesh, rules))
        same, spec_bytes = True, 0
        for key, w in flat_t(whole).items():
            dims = sh.split_dims(w.shape, specs[key].spec, mesh)
            block = sh.take_dims_block(w, dims, mesh)
            got = flat_t(mine)[key]
            same &= bool(torch.equal(got, block)) and \
                sh.split_of(got) == dims
            spec_bytes += block.numel() * block.element_size()
        res[f"draw/{arch}/{table}/bitwise"] = same
        res[f"draw/{arch}/{table}/bytes"] = nbytes(mine)
        res[f"draw/{arch}/{table}/spec_bytes"] = spec_bytes
        res[f"draw/{arch}/{table}/whole_bytes"] = nbytes(whole)

# ---- prefill under TRAIN, greedy decode under DECODE -------------------- #
for case, (arch, over) in cases.items():
    cfg = get_smoke_config(arch).replace(**over)
    whole = params_from_numpy(load_tree(inp, f"{case}/params"), "cpu")
    tok = T(inp[f"{case}/tokens"]).long()
    Bt, St = tok.shape[:2]
    steps = int(inp["steps"])
    with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_TRAIN):
        params = sh.shard_tree(whole, tfm.param_shardings(
            cfg, mesh, sh.LOGICAL_RULES_TRAIN))
        res[f"{case}/train_bytes"] = nbytes(params)
        res[f"{case}/whole_bytes"] = nbytes(whole)
        vocab = tfm.vocab_block(cfg)[0]
        pre = sh.layout(Bt, St)
        with sh.use_layout(pre), torch.no_grad():
            logits, caches = tfm.prefill_step(
                params, {"tokens": coll.take_block(tok, mesh, pre.batch, 0)},
                cfg)
        res[f"{case}/vocab_block"] = logits.shape[-1]
        logits = coll.all_gather(coll.all_gather(logits, mesh, vocab, -1),
                                 mesh, pre.batch, 0)
        res[f"{case}/prefill"] = logits.numpy()
    nxt = logits[:, -1:].argmax(-1)
    res[f"{case}/tokens0"] = nxt.numpy()
    with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_DECODE), \
            torch.no_grad():
        params = sh.shard_tree(whole, tfm.param_shardings(
            cfg, mesh, sh.LOGICAL_RULES_DECODE))
        dec = sh.layout(Bt, 1, St + steps)
        caches = tfm.place_caches(cfg, caches, St + steps, pre, dec)
        for i in range(steps):
            with sh.use_layout(dec):
                logits, caches = tfm.decode_step(
                    params, {"tokens": coll.take_block(nxt, mesh, dec.batch,
                                                       0)},
                    cfg, caches, St + i)
            logits = coll.all_gather(coll.all_gather(
                logits, mesh, tfm.vocab_block(cfg)[0], -1), mesh, dec.batch,
                0)
            res[f"{case}/decode{i}"] = logits.numpy()
            nxt = logits[:, -1:].argmax(-1)
            res[f"{case}/tokens{i + 1}"] = nxt.numpy()
        res[f"{case}/layouts"] = np.array(
            [",".join(pre.batch), ",".join(dec.batch),
             ",".join(dec.cache_seq)])
        if case in os.environ["GENERATE"].split(","):
            g = generate(params, cfg, {"tokens": tok}, steps, "cpu")
            res[f"{case}/gen_tokens"] = g.tokens.numpy()
            res[f"{case}/gen_logits"] = g.logits.numpy()
    if case in os.environ["GENERATE"].split(","):
        # under the train rules: FSDP rows, and a decode cache whose
        # sequence is whole, so each rank decodes its own query heads
        with sh.use_mesh_and_rules(mesh, sh.LOGICAL_RULES_TRAIN), \
                torch.no_grad():
            params = sh.shard_tree(whole, tfm.param_shardings(
                cfg, mesh, sh.LOGICAL_RULES_TRAIN))
            g = generate(params, cfg, {"tokens": tok}, steps, "cpu")
        res[f"{case}/gen_train_tokens"] = g.tokens.numpy()
        res[f"{case}/gen_train_logits"] = g.logits.numpy()
np.savez(os.path.join(OUT, f"port.rank{RANK}.npz"), **res)
"""


def _redraw(tree, rng):
    """Norm scales redrawn nonzero and the SSM's A_log, D, dt_bias off
    their constant init (``test_torch_multidevice.py``'s redraws)."""
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
    out = {"steps": np.array(STEPS)}
    for i, (case, (arch, over)) in enumerate(CASES.items()):
        jc = jcfgs.get_smoke_config(arch).replace(**over)
        p = jax.tree.map(np.asarray, jt.init_params(
            jc, jax.random.PRNGKey(i)))
        _redraw(p, np.random.RandomState(10 + i))
        out.update(flat(p, f"{case}/params"))
        books = (jc.num_codebooks,) if jc.num_codebooks > 1 else ()
        out[f"{case}/tokens"] = rng.randint(
            0, jc.vocab_size, (B, S) + books).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, [each rank's port outputs])."""
    import json
    out = tmp_path_factory.mktemp("tp")
    np.savez(out / "inputs.npz", **_inputs())
    cases = json.dumps({k: list(v) for k, v in CASES.items()})
    ref = subprocess.Popen(
        [sys.executable, "-c", JAX_PROGRAM, str(out), cases],
        env={**os.environ, "PYTHONPATH": SRC}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    os.environ.update(CASES=cases, TABLES=",".join(TABLES),
                      GENERATE=",".join(GENERATE))
    try:
        ranks = spawn(PORT_PROGRAM, 8, out, "tp")
    finally:
        for var in ("CASES", "TABLES", "GENERATE"):
            del os.environ[var]
    wait(ranks)
    text = ref.communicate(timeout=400)[0]
    assert "REFERENCE DONE" in text, text[-4000:]
    return (np.load(out / "ref.npz"),
            [np.load(out / f"port.rank{r}.npz") for r in range(8)])


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b"])
def test_each_rank_draws_only_its_blocks(runs, arch, table):
    _, port = runs
    for p in port:
        key = f"draw/{arch}/{table}"
        assert bool(p[f"{key}/bitwise"]), key
        assert int(p[f"{key}/bytes"]) == int(p[f"{key}/spec_bytes"])
        if table == "LOGICAL_RULES_PREDICTOR":
            assert int(p[f"{key}/bytes"]) == int(p[f"{key}/whole_bytes"])
        else:
            assert int(p[f"{key}/bytes"]) < int(p[f"{key}/whole_bytes"])
    if table == "LOGICAL_RULES_TRAIN":
        b = int(port[0][f"draw/{arch}/{table}/bytes"])
        w = int(port[0][f"draw/{arch}/{table}/whole_bytes"])
        print(f"{arch} under {table}: {b} of {w} bytes a rank "
              f"({b / w:.3f})")


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_prefill_and_decode_match_the_partitioned_reference(
        runs, case):
    ref, port = runs
    p0 = port[0]
    assert list(p0[f"{case}/layouts"]) == ["data", "data", "model"]
    # V_pad 256 over 4 (musicgen's 128 per codebook)
    assert int(p0[f"{case}/vocab_block"]) == (32 if case == "musicgen"
                                              else 64)
    assert int(p0[f"{case}/train_bytes"]) < int(p0[f"{case}/whole_bytes"])
    for key in [f"{case}/prefill"] + [f"{case}/decode{i}"
                                      for i in range(STEPS)]:
        np.testing.assert_allclose(p0[key], ref[key], rtol=0,
                                   atol=LOGITS_F32_ABS, err_msg=key)
    for i in range(STEPS + 1):
        np.testing.assert_array_equal(p0[f"{case}/tokens{i}"],
                                      ref[f"{case}/tokens{i}"])
    for p in port[1:]:
        for key in p0.files:
            if key.startswith(case + "/"):
                np.testing.assert_array_equal(p[key], p0[key], err_msg=key)


def test_padded_vocab_columns_never_win(runs):
    """The tied 250-token vocabulary pads to 256: the last vocab block (rank
    'model' = 3) holds the 6 padded columns, masked by their global
    index."""
    ref, port = runs
    logits = port[0]["tied_v250/prefill"]
    assert logits.shape[-1] == 256
    assert (logits[..., 250:] == -1e30).all()
    assert (np.abs(logits[..., :250]) < 1e3).all()
    np.testing.assert_allclose(logits[..., :250], ref["tied_v250/prefill"]
                               [..., :250], rtol=0, atol=LOGITS_F32_ABS)


@pytest.mark.parametrize("rules", ["DECODE", "TRAIN"])
@pytest.mark.parametrize("case", GENERATE)
def test_generate_with_sharded_weights_gives_the_reference_tokens(runs,
                                                                  case,
                                                                  rules):
    ref, port = runs
    key = "gen" if rules == "DECODE" else "gen_train"
    want = np.concatenate([ref[f"{case}/tokens{i}"]
                           for i in range(STEPS + 1)], 1)
    for p in port:
        np.testing.assert_array_equal(p[f"{case}/{key}_tokens"], want)
    got = port[0][f"{case}/{key}_logits"]
    np.testing.assert_allclose(got[:, 0], ref[f"{case}/prefill"][:, -1],
                               rtol=0, atol=LOGITS_F32_ABS)
    for i in range(STEPS):
        np.testing.assert_allclose(got[:, i + 1],
                                   ref[f"{case}/decode{i}"][:, -1], rtol=0,
                                   atol=LOGITS_F32_ABS)
