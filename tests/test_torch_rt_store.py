"""The port's persistent RT store (``RTCache(store_dir=)``,
``checkpoint/ckpt.py``) on the CPU: the reference's
``tests/test_rt_store.py`` contract, case by case, and the key's
framework and device tag.

A fresh cache under the same content key (params bytes + config +
l_token + vocab signature + framework/device) adopts the persisted table
byte for byte with zero re-encode; any key ingredient changing silently
invalidates; a key-matching store that is corrupt warns and falls back
to cold encoding; a store the JAX package wrote is never adopted."""
import glob
import os
import threading
import warnings

import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import predictor as jp  # noqa: E402
from repro.core.rt_cache import RTCache as JaxRTCache  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.capsim import config  # noqa: E402
from repro_torch.core import predictor as tp  # noqa: E402
from repro_torch.core.engine import SimulationEngine  # noqa: E402
from repro_torch.core.engine_config import EngineConfig  # noqa: E402
from repro_torch.core.rt_cache import (RT_STORE_VERSION, RTCache,  # noqa: E402
                                       rt_store_key, store_tag)
from repro_torch.core.standardize import build_vocab  # noqa: E402
from repro_torch.isa import multicore, progen  # noqa: E402

VOCAB = build_vocab()
JCFG = get_config("capsim").replace(d_model=32, head_dim=8, d_ff=64,
                                    dtype="float32")
SMALL_CFG = config().replace(d_model=32, head_dim=8, d_ff=64,
                             dtype="float32")
MIX = ["503.bwaves", "541.leela"]
ENGINE_KW = dict(interval_size=1_500, warmup=200, max_checkpoints=2,
                 l_min=32, l_clip=32, l_token=16, batch_size=16,
                 with_oracle=False)


def _bridge(key):
    return tp.params_from_numpy(
        jax.tree.map(np.asarray, jp.init_params(JCFG, key)), "cpu")


@pytest.fixture(scope="module")
def params():
    return _bridge(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def table():
    cprog = progen.build_benchmark("505.mcf").compiled()
    return cprog.token_table(VOCAB, 16)


def _cache(params, store_dir, cfg=SMALL_CFG, **kw):
    kw.setdefault("store_extra", VOCAB.signature())
    return RTCache(params, cfg, 16, store_dir=str(store_dir), device="cpu",
                   **kw)


def _rows(cache):
    return cache.table[:cache.n_rows]


def test_store_round_trip_byte_identical(params, table, tmp_path):
    c1 = _cache(params, tmp_path)
    ids1 = c1.ensure_rows(table)
    assert c1.stats.n_rows_loaded == 0          # nothing persisted yet
    assert c1.persist() is not None
    assert c1.persist() is None                 # no growth -> no-op

    c2 = _cache(params, tmp_path)
    assert c2.stats.n_rows_loaded == c1.n_rows
    assert c2.stats.store_load_seconds > 0.0
    assert torch.equal(_rows(c1), _rows(c2))    # byte for byte
    ids2 = c2.ensure_rows(table)                # pure lookup
    np.testing.assert_array_equal(ids1, ids2)
    assert c2.stats.n_rows_encoded == 0
    assert c2.stats.n_encode_passes == 0
    snap = c2.stats.freeze()
    assert (snap.n_rows_loaded, snap.n_rows_encoded) == (c1.n_rows, 0)


def test_store_growth_persists_incrementally(params, table, tmp_path):
    c1 = _cache(params, tmp_path)
    c1.ensure_rows(table[: table.shape[0] // 2])
    c1.persist()
    c2 = _cache(params, tmp_path)
    loaded = c2.stats.n_rows_loaded
    assert loaded == c1.n_rows
    c2.ensure_rows(table)                       # second half is new
    assert c2.n_rows > loaded
    assert c2.persist() is not None             # growth -> re-persist
    c3 = _cache(params, tmp_path)
    assert c3.stats.n_rows_loaded == c2.n_rows
    c3.ensure_rows(table)
    assert c3.stats.n_rows_encoded == 0


def test_params_mismatch_invalidates_silently(params, table, tmp_path):
    c1 = _cache(params, tmp_path)
    c1.ensure_rows(table)
    c1.persist()
    other = _bridge(jax.random.PRNGKey(7))
    assert rt_store_key(other, SMALL_CFG, 16) != \
        rt_store_key(params, SMALL_CFG, 16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # silent = no warning
        c2 = _cache(other, tmp_path)
    assert c2.stats.n_rows_loaded == 0
    c2.ensure_rows(table)                       # clean rebuild works
    assert c2.stats.n_rows_encoded > 0
    # the two stores coexist under different keys in one directory
    c1b = _cache(params, tmp_path)
    assert c1b.stats.n_rows_loaded == c1.n_rows


def test_vocab_signature_mismatch_invalidates(params, table, tmp_path):
    c1 = _cache(params, tmp_path)
    c1.ensure_rows(table)
    c1.persist()
    c2 = _cache(params, tmp_path, store_extra="some-other-vocab")
    assert c2.stats.n_rows_loaded == 0


def test_corrupt_store_warns_and_cold_encodes(params, table, tmp_path):
    c1 = _cache(params, tmp_path)
    ids1 = c1.ensure_rows(table)
    c1.persist()
    arrs = glob.glob(str(tmp_path / "*" / "step_*" / "arr_*.npy"))
    assert arrs
    for p in arrs:                              # truncate every array file
        with open(p, "r+b") as fh:
            fh.truncate(os.path.getsize(p) // 2)
    with pytest.warns(UserWarning, match="falling back to cold encode"):
        c2 = _cache(params, tmp_path)
    assert c2.stats.n_rows_loaded == 0 and c2.n_rows == 0
    ids2 = c2.ensure_rows(table)                # cold path still correct
    np.testing.assert_array_equal(ids1, ids2)
    assert torch.equal(_rows(c1), _rows(c2))


def test_corrupt_manifest_warns_and_cold_encodes(params, table, tmp_path):
    c1 = _cache(params, tmp_path)
    c1.ensure_rows(table)
    c1.persist()
    for p in glob.glob(str(tmp_path / "*" / "step_*" / "manifest.*.json")):
        with open(p, "w") as fh:
            fh.write("{ not json")
    with pytest.warns(UserWarning, match="falling back to cold encode"):
        c2 = _cache(params, tmp_path)
    assert c2.stats.n_rows_loaded == 0


def test_tampered_table_values_rejected(params, table, tmp_path):
    """A key-matching store whose table fails validation (non-finite
    values) is not adopted: warn + cold encode."""
    c1 = _cache(params, tmp_path)
    c1.ensure_rows(table)
    c1.persist()
    poisoned = False
    for p in sorted(glob.glob(str(tmp_path / "*" / "step_*" / "arr_*.npy"))):
        a = np.load(p)
        if a.dtype == np.float32:               # the table leaf
            a[0, 0] = np.nan
            np.save(p, a)
            poisoned = True
    assert poisoned
    with pytest.warns(UserWarning, match="falling back to cold encode"):
        c2 = _cache(params, tmp_path)
    assert c2.stats.n_rows_loaded == 0


def test_store_version_mismatch_invalidates(params, table, tmp_path,
                                            monkeypatch):
    c1 = _cache(params, tmp_path)
    c1.ensure_rows(table)
    c1.persist()
    monkeypatch.setattr("repro_torch.core.rt_cache.RT_STORE_VERSION",
                        RT_STORE_VERSION + 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # silent clean rebuild
        c2 = _cache(params, tmp_path)
    assert c2.stats.n_rows_loaded == 0


@pytest.mark.parametrize("multicore_run", [False, True])
def test_engine_restart_bitwise_with_store(params, tmp_path, multicore_run):
    """SimulationEngine round trip through rt_store_dir (``run`` and
    ``run_multicore`` each persist after drain): run 2 loads the
    persisted table, encodes nothing, and reproduces run 1 bitwise."""
    ec = EngineConfig(rt_cache=True, rt_store_dir=str(tmp_path),
                      **ENGINE_KW)

    def run():
        eng = SimulationEngine.from_config(params, SMALL_CFG, VOCAB, ec,
                                           device="cpu")
        if multicore_run:
            res = eng.run_multicore(
                [multicore.build_multicore_benchmark(k, 2)
                 for k in ("mt.mix", "mt.counter")])
            return [c for r in res for c in r.cores], eng
        eng.submit_names(MIX)
        return eng.run(), eng

    res1, eng1 = run()
    assert eng1.last_rt_stats.n_rows_encoded > 0
    assert eng1.last_rt_stats.n_rows_loaded == 0
    res2, eng2 = run()
    st = eng2.last_rt_stats
    assert st.n_rows_loaded == eng1.last_rt_stats.n_rows_encoded
    assert st.n_rows_encoded == 0               # pure store service
    for a, b in zip(res1, res2):
        assert a.name == b.name
        assert a.predicted_cycles == b.predicted_cycles     # bitwise


def test_store_key_sensitivity(params):
    base = rt_store_key(params, SMALL_CFG, 16, extra="v")
    assert base == rt_store_key(params, SMALL_CFG, 16, extra="v")
    assert base != rt_store_key(params, SMALL_CFG, 32, extra="v")
    assert base != rt_store_key(params, SMALL_CFG, 16, extra="w")
    assert base != rt_store_key(
        params, SMALL_CFG.replace(dtype="bfloat16"), 16, extra="v")
    bumped = dict(params)
    bumped["embed"] = params["embed"] + 1e-3
    assert base != rt_store_key(bumped, SMALL_CFG, 16, extra="v")
    # bfloat16 parameters hash by their raw bits: one ulp moves the key
    p16 = {"w": torch.ones(4, dtype=torch.bfloat16)}
    q16 = {"w": torch.ones(4, dtype=torch.bfloat16)}
    q16["w"].view(torch.int16)[0] += 1
    assert rt_store_key(p16, SMALL_CFG) != rt_store_key(q16, SMALL_CFG)


def test_store_key_tags_framework_and_device(params, tmp_path,
                                              monkeypatch):
    """C1/C2: the tag after the vocab signature names the framework and
    the device, so a CPU-encoded table and a card-encoded one (which
    differ in the last bits) never share a store path."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    cpu, cuda = store_tag("cpu"), store_tag(torch.device("cuda", 0))
    assert cpu == "repro_torch/cpu"
    assert cuda == "repro_torch/cuda/NVIDIA H100 80GB HBM3"
    sig = VOCAB.signature()
    assert rt_store_key(params, SMALL_CFG, 16, f"{sig}\n{cpu}") != \
        rt_store_key(params, SMALL_CFG, 16, f"{sig}\n{cuda}")
    # the cache keys its store path on its own device's tag
    assert _cache(params, tmp_path)._store_key == \
        rt_store_key(params, SMALL_CFG, 16, f"{sig}\n{cpu}")


def test_store_written_by_jax_is_not_adopted(params, table, tmp_path):
    """C1: the JAX RTCache persists its table (same bridged parameters,
    same l_token and vocab signature) into the same directory; the port
    adopts none of it, encodes cold into a store path of its own, and a
    second port cache adopts the port's table, not JAX's."""
    jparams = jp.init_params(JCFG, jax.random.PRNGKey(0))
    jc = JaxRTCache(jparams, JCFG, 16, store_dir=str(tmp_path),
                    store_extra=VOCAB.signature())
    jc.ensure_rows(table)
    jax_path = jc.persist()
    assert jax_path is not None
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # not adopted, not a fault
        c1 = _cache(params, tmp_path)
    assert c1.stats.n_rows_loaded == 0
    c1.ensure_rows(table)
    assert c1.stats.n_rows_encoded == jc.stats.n_rows_encoded
    port_path = c1.persist()
    assert port_path.parent != jax_path.parent
    assert sorted(os.listdir(tmp_path)) == sorted(
        [port_path.parent.name, jax_path.parent.name])
    c2 = _cache(params, tmp_path)
    assert c2.stats.n_rows_loaded == c1.n_rows
    assert torch.equal(_rows(c2), _rows(c1))


def test_bf16_table_round_trips_bit_exact(params, table, tmp_path):
    cfg = SMALL_CFG.replace(dtype="bfloat16")
    c1 = _cache(params, tmp_path, cfg)
    c1.ensure_rows(table)
    assert c1.table.dtype == torch.bfloat16
    c1.persist()
    manifest = ckpt.read_manifest(0, str(c1._store_path))
    assert manifest["entries"]["table"]["dtype"] == "bfloat16"
    c2 = _cache(params, tmp_path, cfg)
    assert c2.stats.n_rows_loaded == c1.n_rows
    assert c2.table.dtype == torch.bfloat16
    assert torch.equal(_rows(c2).view(torch.int16),
                       _rows(c1).view(torch.int16))
    c2.ensure_rows(table)
    assert c2.stats.n_rows_encoded == 0
    # an fp32 cache of the same params is another key
    assert _cache(params, tmp_path).stats.n_rows_loaded == 0


def test_checkpoint_tree_round_trip_and_atomic_layout(tmp_path):
    """ckpt.save/restore over nested dicts of tensors and arrays: values,
    dtypes (bfloat16 by its bits) and the device the caller names; a
    stray tmp dir and a dangling LATEST are never picked up."""
    g = torch.Generator().manual_seed(0)
    state = {"a": {"w": torch.randn(3, 5, generator=g).bfloat16(),
                   "b": torch.arange(4, dtype=torch.int32)},
             "c": np.linspace(0, 1, 7).astype(np.float64)}
    ckpt.save(state, 3, str(tmp_path), metadata={"k": 1})
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert ckpt.read_manifest(3, str(tmp_path))["metadata"] == {"k": 1}
    out = ckpt.restore(state, 3, str(tmp_path), device="cpu")
    assert out["a"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["a"]["w"].view(torch.int16),
                       state["a"]["w"].view(torch.int16))
    assert torch.equal(out["a"]["b"], state["a"]["b"])
    np.testing.assert_array_equal(out["c"].numpy(), state["c"])
    with pytest.raises(ValueError, match="tree mismatch"):
        ckpt.restore({"a": None}, 3, str(tmp_path), device="cpu")
    (tmp_path / "step_00000009.tmp0-1-2").mkdir()
    (tmp_path / "LATEST").write_text("7")       # points at nothing
    assert ckpt.latest_step(str(tmp_path)) == 3
    with pytest.raises(RuntimeError, match="pre-publish crash"):
        def crash():
            raise RuntimeError("pre-publish crash")
        ckpt.save(state, 4, str(tmp_path), pre_publish=crash)
    assert not (tmp_path / "step_00000004").exists()
    assert not glob.glob(str(tmp_path / "step_00000004.tmp*"))


def test_concurrent_persist_last_writer_wins(params, table, tmp_path):
    """Two caches under the same key race grow+persist rounds against
    one store dir: no crash on the rename collision, and the published
    store is always one writer's complete table."""
    n = table.shape[0]
    rows_a, rows_b = table[: 2 * n // 3], table[n // 3:]
    gate = threading.Barrier(2)
    caches, errs = {}, []

    def run(name, rows):
        try:
            c = _cache(params, tmp_path)
            caches[name] = c
            m = rows.shape[0]
            for k in range(1, 6):
                c.ensure_rows(rows[: max(1, k * m // 5)])
                gate.wait(timeout=60)       # maximize publish overlap
                c.persist()
        except Exception as exc:            # pragma: no cover
            errs.append(exc)

    threads = [threading.Thread(target=run, args=("a", rows_a)),
               threading.Thread(target=run, args=("b", rows_b))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errs

    c3 = _cache(params, tmp_path)
    assert c3.stats.n_rows_loaded in {caches["a"].n_rows,
                                      caches["b"].n_rows}
    assert bool(torch.isfinite(_rows(c3)).all())
    # serving the full row set from it equals a cold cache bitwise
    ids3 = c3.ensure_rows(table)
    cold = RTCache(params, SMALL_CFG, 16, device="cpu")
    ids_cold = cold.ensure_rows(table)
    assert torch.equal(c3.table[torch.from_numpy(ids3).long()],
                       cold.table[torch.from_numpy(ids_cold).long()])


def test_two_engines_share_store_dir(params, tmp_path):
    """Two engines run (and persist) concurrently into one rt_store_dir;
    a third engine then loads whichever generation won and still
    reproduces both engines' results bitwise."""
    ec = EngineConfig(rt_store_dir=str(tmp_path), **ENGINE_KW)
    results, errs = {}, []

    def serve(name, benches):
        try:
            eng = SimulationEngine(params, SMALL_CFG, VOCAB, ec,
                                   device="cpu")
            for rnd, bench in enumerate(benches):   # each run persists
                results[(name, rnd)] = eng.run(
                    [progen.build_benchmark(bench)])[0].predicted_cycles
        except Exception as exc:            # pragma: no cover
            errs.append(exc)

    plans = {"e1": ["503.bwaves", "505.mcf"], "e2": ["541.leela",
                                                      "505.mcf"]}
    threads = [threading.Thread(target=serve, args=item)
               for item in plans.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errs and len(results) == 4

    eng3 = SimulationEngine(params, SMALL_CFG, VOCAB, ec, device="cpu")
    got = eng3.run([progen.build_benchmark(b) for b in
                    ("503.bwaves", "541.leela")])
    assert eng3.last_rt_stats.n_rows_loaded > 0     # adopted a winner
    assert got[0].predicted_cycles == results[("e1", 0)]
    assert got[1].predicted_cycles == results[("e2", 0)]
