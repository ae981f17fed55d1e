"""The port's multicore path against the JAX reference on the CPU.

The host side (``isa/multicore.py``, the multicore oracle, the core-id
context channel) is a copy of the reference's and must agree with it bit
for bit; the engine's per-core predictions must agree with the reference
engine's ``run_multicore`` on the same (bridged) parameters within 1e-4,
and its (benchmark, core) demux must be bitwise the port's own per-core
sequential loop (the reference's ``tests/test_multicore.py`` contract)."""
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import context as jctx  # noqa: E402
from repro.core import predictor as jp  # noqa: E402
from repro.core import standardize as jstd  # noqa: E402
from repro.core.engine import SimulationEngine as JaxEngine  # noqa: E402
from repro.core.engine_config import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.isa import compiled as jcompiled  # noqa: E402
from repro.isa import funcsim as jfuncsim  # noqa: E402
from repro.isa import multicore as jmc  # noqa: E402
from repro.isa import progen as jprogen  # noqa: E402
from repro.isa import timing as jtiming  # noqa: E402
from repro.isa.isa import Instruction as JI  # noqa: E402
from repro_torch.configs.capsim import config  # noqa: E402
from repro_torch.core import context as tctx  # noqa: E402
from repro_torch.core import predictor as tp  # noqa: E402
from repro_torch.core import standardize as tstd  # noqa: E402
from repro_torch.core.engine import BatchedPredictor, SimulationEngine  # noqa: E402
from repro_torch.core.engine_config import EngineConfig  # noqa: E402
from repro_torch.core.simulate import capsim_simulate_multicore  # noqa: E402
from repro_torch.isa import compiled as tcompiled  # noqa: E402
from repro_torch.isa import funcsim as tfuncsim  # noqa: E402
from repro_torch.isa import multicore as tmc  # noqa: E402
from repro_torch.isa import progen as tprogen  # noqa: E402
from repro_torch.isa import timing as ttiming  # noqa: E402
from repro_torch.isa.isa import Instruction as TI  # noqa: E402

JV, TV = jstd.build_vocab(), tstd.build_vocab()
# the reference tests' SMALL_CFG (4 heads of 8)
JCFG = get_config("capsim").replace(d_model=32, head_dim=8, d_ff=64,
                                    dtype="float32")
TCFG = config().replace(d_model=32, head_dim=8, d_ff=64, dtype="float32")
SIM_KW = dict(interval_size=1_200, warmup=150, max_checkpoints=2,
              l_min=32, l_clip=32, l_token=16, batch_size=16,
              with_oracle=True)
KINDS = list(tmc.MULTICORE_NAMES)


@pytest.fixture(scope="module")
def jparams():
    return jp.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return tp.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _assert_traces_equal(a, b, what):
    for col in ("pc", "ea", "taken", "snapshots"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col),
                                      err_msg=f"{what} {col}")


def _rel(a, b):
    return abs(a - b) / abs(b)


# --------------------------------------------------------------------------- #
# Host side: bitwise the reference
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_cores,quantum,order", [
    (1, 64, None), (4, 64, None), (4, 48, [3, 1, 0, 2]), (3, 7, None)])
def test_run_multicore_is_bitwise_the_reference(kind, n_cores, quantum,
                                                order):
    """Per-core pc/ea/taken/snapshot columns, the (core, n) schedule and
    the final shared memory, across resumed quanta, a non-dividing
    snapshot stride and a permuted visit order."""
    jb = jmc.build_multicore_benchmark(kind, n_cores)
    tb = tmc.build_multicore_benchmark(kind, n_cores)
    assert (jb.name, jb.n_cores, jb.ckp_num) == (tb.name, tb.n_cores,
                                                 tb.ckp_num)
    jst, tst = jb.fresh_states(), tb.fresh_states()
    for _ in range(2):                         # a resumed second interval
        jt = jmc.run_multicore(jb.compiled(), 1_500, jst, snapshot_every=100,
                               quantum=quantum, core_order=order)
        tt = tmc.run_multicore(tb.compiled(), 1_500, tst, snapshot_every=100,
                               quantum=quantum, core_order=order)
        assert jt.schedule == tt.schedule
        assert len(jt) == len(tt)
        for c in range(n_cores):
            _assert_traces_equal(jt.cores[c], tt.cores[c], f"{kind} c{c}")
        assert jst[0].mem == tst[0].mem
        assert [s.iregs for s in jst] == [s.iregs for s in tst]
        # the multicore oracle over the interleave
        jo = jtiming.simulate_multicore(jt.cores, jt.schedule)
        to = ttiming.simulate_multicore(tt.cores, tt.schedule)
        for a, b in zip(jo, to):
            np.testing.assert_array_equal(a, b)
        assert jtiming.total_cycles_multicore(jt.cores, jt.schedule) == \
            ttiming.total_cycles_multicore(tt.cores, tt.schedule)


@pytest.mark.parametrize("kind", KINDS)
def test_n1_is_run_compiled_and_oracle_is_simulate_columnar(kind):
    """The port's own N=1 anchors, as the reference holds its own: one
    core through the quantum scheduler == one run_compiled call, and the
    multicore oracle == simulate_columnar."""
    mb = tmc.build_multicore_benchmark(kind, 1)
    mt = tmc.run_multicore(mb.compiled(), 2_000, mb.fresh_states(),
                           snapshot_every=100, quantum=48)
    ref, _ = tfuncsim.run_compiled(
        tmc.build_multicore_benchmark(kind, 1).compiled()[0], 2_000,
        mb.fresh_states()[0], snapshot_every=100)
    _assert_traces_equal(mt.cores[0], ref, kind)
    np.testing.assert_array_equal(
        ttiming.simulate_multicore(mt.cores, mt.schedule)[0],
        ttiming.simulate_columnar(ref))


@pytest.mark.parametrize("order", [None, [1, 0]])
def test_shared_memory_conflict_visibility_as_the_reference(order):
    """A store in core 0's quantum and core 1's loads of it: the same
    registers, memory and traces in both packages, in either order."""
    addr = 0x9000

    def progs(I, compile_program):
        writer = compile_program([
            I("addi", dsts=("R3",), imm=addr),
            I("addi", dsts=("R4",), imm=42),
            I("std", srcs=("R4",), mem_base="R3", mem_offset=0),
            I("nop"),
            I("b", target=3)])
        reader = compile_program([
            I("addi", dsts=("R3",), imm=addr),
            I("ld", dsts=("R5",), mem_base="R3", mem_offset=0),
            I("b", target=1)])
        return [writer, reader]

    out = []
    for I, comp, fs, mc in ((JI, jcompiled.compile_program, jfuncsim, jmc),
                            (TI, tcompiled.compile_program, tfuncsim, tmc)):
        mem = {}
        states = [fs.CompiledState(iregs=[0] * 40, fregs=[0.0] * 32,
                                   mem=mem) for _ in range(2)]
        mt = mc.run_multicore(progs(I, comp), 8, states, quantum=4,
                              core_order=order)
        out.append((mt, states, mem))
    (jt, js, jm), (tt, ts, tm) = out
    assert jm == tm and tm[addr >> 3] == 42
    assert [s.iregs for s in js] == [s.iregs for s in ts]
    assert ts[1].iregs[tcompiled.IREG_SLOT["R5"]] == 42
    assert jt.schedule == tt.schedule
    for a, b in zip(jt.cores, tt.cores):
        _assert_traces_equal(a, b, "conflict")


def test_shared_counter_and_contention_as_the_reference():
    """mt.counter's shared counter and mt.chase's LLC/bus contention: the
    same numbers in both packages, and the reference's invariants hold
    in the port (cross-core writes visible, contention slows a core)."""
    counters = []
    for n in (4, 1):
        vals = []
        for mc, pg in ((jmc, jprogen), (tmc, tprogen)):
            mb = mc.build_multicore_benchmark("mt.counter", n)
            states = mb.fresh_states()
            mc.run_multicore(mb.compiled(), 2_000, states)
            vals.append(states[0].mem[pg.MT_COUNTER_EA >> 3])
        assert vals[0] == vals[1]
        counters.append(vals[1])
    assert counters[1] < counters[0] <= 4 * 2_000
    totals = {}
    for n in (4, 1):
        vals = []
        for mc, tm in ((jmc, jtiming), (tmc, ttiming)):
            mb = mc.build_multicore_benchmark("mt.chase", n)
            mt = mc.run_multicore(mb.compiled(), 1_500, mb.fresh_states())
            vals.append(tm.total_cycles_multicore(mt.cores, mt.schedule))
        assert vals[0] == vals[1]
        totals[n] = vals[1]
    assert max(totals[4]) > totals[1][0]


def test_oracle_rejects_overrunning_schedule():
    mb = tmc.build_multicore_benchmark("mt.stream", 2)
    mt = tmc.run_multicore(mb.compiled(), 500, mb.fresh_states())
    with pytest.raises(AssertionError):
        ttiming.simulate_multicore(mt.cores, mt.schedule + [(0, 1)])


@pytest.mark.parametrize("core_id", [None, 0, 3, 255])
def test_core_id_context_channel_is_the_reference(core_id):
    snaps = np.random.default_rng(5).integers(
        0, 2**63, (8, 40), dtype=np.uint64)
    a = jctx.context_tokens_from_matrix(snaps, JV, core_id=core_id)
    b = tctx.context_tokens_from_matrix(snaps, TV, core_id=core_id)
    np.testing.assert_array_equal(a, b)
    want = (tctx.CONTEXT_LEN if core_id is None
            else tctx.MULTICORE_CONTEXT_LEN)
    assert b.shape == (8, want)
    if core_id is not None:
        np.testing.assert_array_equal(
            b[:, tctx.CONTEXT_LEN:],
            np.broadcast_to(tctx.core_id_tokens(core_id, TV), (8, 9)))


def test_multicore_benchmark_shared_state():
    mb = tmc.build_multicore_benchmark("mt.mix", 3)
    states = mb.fresh_states()
    assert len(states) == 3
    assert all(st.mem is states[0].mem for st in states)
    assert states[0].mem[tprogen.MT_COUNTER_EA >> 3] == 0
    assert [b.name for b in tmc.all_multicore_benchmarks(2)] == KINDS
    with pytest.raises(ValueError):
        tmc.build_multicore_benchmark("mt.nope", 2)
    with pytest.raises(ValueError):
        tmc.build_multicore_benchmark("mt.mix", 0)


# --------------------------------------------------------------------------- #
# Engine
# --------------------------------------------------------------------------- #

def _mbenches(mc):
    return [mc.build_multicore_benchmark("mt.mix", 2),
            mc.build_multicore_benchmark("mt.chase", 3)]


@pytest.fixture(scope="module")
def jax_runs(jparams):
    runs = {}
    for precision, fused in (("fp32", False), ("fp32", True),
                             ("bf16", False)):
        eng = JaxEngine(jparams, JCFG, JV,
                        JaxEngineConfig(precision=precision,
                                        fused_serving=fused, **SIM_KW))
        runs[precision, fused] = eng.run_multicore(_mbenches(jmc))
    return runs


@pytest.fixture(scope="module")
def port_run(params):
    engine = SimulationEngine(params, TCFG, TV, EngineConfig(**SIM_KW),
                              device="cpu")
    return engine.run_multicore(_mbenches(tmc)), engine


@pytest.mark.parametrize("precision,fused,tol", [
    ("fp32", False, 1e-4), ("fp32", True, 1e-3), ("bf16", False, 2e-2)])
def test_engine_per_core_cycles_match_the_reference(params, jax_runs,
                                                    precision, fused, tol):
    eng = SimulationEngine(params, TCFG, TV,
                           EngineConfig(precision=precision,
                                        fused_serving=fused, **SIM_KW),
                           device="cpu")
    res = eng.run_multicore(_mbenches(tmc))
    for a, b in zip(jax_runs[precision, fused], res):
        assert (a.name, a.n_cores, a.n_clips, a.n_instructions) == \
            (b.name, b.n_cores, b.n_clips, b.n_instructions)
        for ca, cb in zip(a.cores, b.cores):
            assert (ca.name, ca.n_clips, ca.n_intervals) == \
                (cb.name, cb.n_clips, cb.n_intervals)
            assert ca.oracle_cycles == cb.oracle_cycles        # bitwise
            assert np.isfinite(cb.predicted_cycles)
            assert _rel(cb.predicted_cycles, ca.predicted_cycles) < tol, \
                (cb.name, precision, fused)


def _sequential_core_reference(mb, params, *, interval_size,
                               max_checkpoints, l_min, l_clip, l_token,
                               batch_size, warmup, with_oracle):
    """Per-(core, checkpoint) monolithic predict loops over the same
    interleaved front-end: the engine demux's bitwise reference."""
    cprogs = mb.compiled()
    tables = [cp.token_table(TV, l_token) for cp in cprogs]
    states = mb.fresh_states()
    if warmup:
        tmc.run_multicore(cprogs, warmup, states)
    totals = [0.0] * mb.n_cores
    clips = [0] * mb.n_cores
    for _ in range(min(mb.ckp_num, max_checkpoints)):
        mtrace = tmc.run_multicore(cprogs, interval_size, states,
                                   snapshot_every=l_min)
        if len(mtrace) == 0:
            break
        for c, trace in enumerate(mtrace.cores):
            if not len(trace):
                continue
            tok, mask = tstd.encode_fixed_clips(tables[c], trace.pc, l_min,
                                                l_clip)
            ctx_all = tctx.context_tokens_from_matrix(trace.snapshots, TV,
                                                      core_id=c)
            rows = np.minimum(np.arange(tok.shape[0]), len(ctx_all) - 1)
            ctx = ctx_all[rows]
            k = tok.shape[0]
            pad = (-k) % batch_size
            tok, ctx, mask = (np.concatenate(
                [x, np.zeros((pad,) + x.shape[1:], x.dtype)])
                for x in (tok, ctx, mask))
            preds = []
            for lo in range(0, tok.shape[0], batch_size):
                batch = {"clip_tokens": torch.from_numpy(
                             tok[lo:lo + batch_size]),
                         "context_tokens": torch.from_numpy(
                             ctx[lo:lo + batch_size]),
                         "clip_mask": torch.from_numpy(
                             mask[lo:lo + batch_size])}
                preds.append(tp.forward(params, batch, TCFG).numpy())
            totals[c] += float(np.concatenate(preds)[:k].sum())
            clips[c] += k
    return totals, clips


def test_engine_demux_bitwise_equals_sequential(params, port_run):
    """(benchmark, core) shards pooled into shared (remainder-padded)
    batches demux back to per-core and summed cycles bitwise equal to
    the per-core sequential loops."""
    results, engine = port_run
    assert engine.last_stats.n_pad > 0        # remainder padding exercised
    for mb, r in zip(_mbenches(tmc), results):
        ref, ref_clips = _sequential_core_reference(mb, params, **SIM_KW)
        assert r.n_cores == mb.n_cores == len(r.cores)
        for c, cr in enumerate(r.cores):
            assert cr.name == f"{mb.name}#c{c}"
            assert cr.n_clips == ref_clips[c]
            assert cr.predicted_cycles == ref[c], (cr.name, c)
        summed = 0.0
        for v in ref:
            summed += v
        assert r.predicted_cycles == summed


def test_engine_clip_conservation(port_run):
    results, engine = port_run
    total = sum(cr.n_clips for r in results for cr in r.cores)
    assert engine.last_stats.n_clips == total
    assert engine.last_stats.n_predicted == total
    for r in results:
        assert r.n_clips == sum(cr.n_clips for cr in r.cores)
        assert r.oracle_cycles == sum(cr.oracle_cycles for cr in r.cores)
        for cr in r.cores:
            assert cr.oracle_cycles > 0 and cr.n_clips > 0


def test_rt_cache_shared_across_cores(params):
    """All cores of one program share a token table, so adding cores
    adds no RT rows: a 4-core run encodes exactly what a 1-core run
    does, and serves more."""
    ec = EngineConfig(**SIM_KW).replace(with_oracle=False)
    stats = []
    for n in (1, 4):
        eng = SimulationEngine(params, TCFG, TV, ec, device="cpu")
        eng.run_multicore([tmc.build_multicore_benchmark("mt.mix", n)])
        stats.append(eng.last_rt_stats)
    assert stats[0].n_rows_encoded == stats[1].n_rows_encoded
    assert stats[1].n_rows_served > stats[0].n_rows_served


def test_pool_refuses_mixed_context_widths(params):
    """Single-core (360) and core-tagged (369) rows cannot share a
    pool: the predictor refuses before any batch reaches a kernel, and
    accepts the other width after an explicit reset of an empty pool."""
    pred = BatchedPredictor(params, TCFG,
                            config=EngineConfig(batch_size=8, rt_cache=False),
                            device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(1, 60, (4, 32, 16)).astype(np.int32)
    mask = np.ones((4, 32), np.float32)
    pred.add(tok, rng.integers(1, 60, (4, 360)).astype(np.int32), mask)
    with pytest.raises(ValueError, match="cannot share one batch pool"):
        pred.add(tok, rng.integers(1, 60, (4, 369)).astype(np.int32), mask)
    with pytest.raises(ValueError):         # no layout has 365 columns
        pred.add(tok, rng.integers(1, 60, (4, 365)).astype(np.int32), mask)
    with pytest.raises(RuntimeError, match="still buffered"):
        pred.reset_context_width()
    assert pred.drain().shape == (4,)
    assert pred.stats.n_batches == 1
    pred.reset_context_width()
    pred.add(tok, rng.integers(1, 60, (4, 369)).astype(np.int32), mask)
    assert pred.drain().shape == (4,)


def test_simulate_multicore_wrapper_quantum_and_peer_channels(params,
                                                              port_run):
    """capsim_simulate_multicore is one run_multicore; the scheduler
    quantum travels as EngineConfig.quantum; peer channels stay
    reserved, as in the reference."""
    results, _ = port_run
    solo = capsim_simulate_multicore(
        tmc.build_multicore_benchmark("mt.mix", 2), params, TCFG, TV,
        EngineConfig(**SIM_KW), device="cpu")
    assert [c.n_clips for c in solo.cores] == \
        [c.n_clips for c in results[0].cores]
    assert [c.oracle_cycles for c in solo.cores] == \
        [c.oracle_cycles for c in results[0].cores]
    ec = EngineConfig(**SIM_KW).replace(quantum=7, max_checkpoints=1)
    mb = [tmc.build_multicore_benchmark("mt.counter", 2)]
    runs = [SimulationEngine(params, TCFG, TV, cfg, device="cpu")
            .run_multicore(mb, **kw)[0]
            for cfg, kw in ((ec, {}), (ec.replace(quantum=None),
                                       {"quantum": 7}),
                            (ec.replace(quantum=None), {}))]
    by_config, by_arg, default = ([c.predicted_cycles for c in r.cores]
                                  for r in runs)
    assert by_config == by_arg
    assert default != by_config
    with pytest.raises(NotImplementedError, match="peer_channels"):
        SimulationEngine(params, TCFG, TV,
                         EngineConfig(multicore=2, peer_channels=True),
                         device="cpu").run_multicore(mb)
