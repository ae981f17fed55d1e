"""The frozen front-end gives the port's tokens and datasets."""
import numpy as np
import pytest

from capsim_bench import inputs

C = {"clip_len": 128, "clip_tokens": 16, "n_cores": 1,
     "peer_channels": False}
PROGRAMS = ["503.bwaves", "505.mcf"]


def test_request_pool_is_the_engines_tokenization(tmp_path):
    from repro_torch.core import context as p_ctx
    from repro_torch.core import standardize as p_std
    from repro_torch.isa import funcsim as p_fs
    from repro_torch.isa import progen as p_pg
    t = {"programs": PROGRAMS, "interval": 3000, "warmup": 300,
         "checkpoints": 2, "l_min": 100}
    pool = inputs.request_pool(t, C, tmp_path)
    vocab = p_std.build_vocab()
    k = 0
    for name in PROGRAMS:
        bench = p_pg.build_benchmark(name)
        cprog = bench.compiled()
        table = cprog.token_table(vocab, 16)
        st = p_pg.fresh_compiled_state(bench)
        _, st = p_fs.run_compiled(cprog, 300, st)
        for _ in range(min(bench.ckp_num, 2)):
            trace, st = p_fs.run_compiled(cprog, 3000, st,
                                          snapshot_every=100)
            tok, mask = p_std.encode_fixed_clips(table, trace.pc, 100, 128)
            ctx = p_ctx.context_tokens_from_matrix(trace.snapshots, vocab)
            ctx = ctx[np.minimum(np.arange(tok.shape[0]), len(ctx) - 1)]
            s = slice(pool["offsets"][k], pool["offsets"][k + 1])
            np.testing.assert_array_equal(pool["clip_tokens"][s], tok)
            np.testing.assert_array_equal(pool["context_tokens"][s], ctx)
            np.testing.assert_array_equal(pool["clip_mask"][s], mask)
            k += 1
    assert k == len(pool["offsets"]) - 1
    # a second call reads the cache and gives the same arrays
    again = inputs.request_pool(t, C, tmp_path)
    np.testing.assert_array_equal(again["clip_tokens"], pool["clip_tokens"])


@pytest.mark.parametrize("cores", [1, 2])
def test_train_set_is_the_ports_dataset(tmp_path, cores):
    from repro_torch.core.standardize import build_vocab
    t = {"programs": PROGRAMS if cores == 1 else ["mt.stream", "mt.chase"],
         "interval": 2000, "warmup": 200, "checkpoints": 1}
    c = dict(C, n_cores=cores, peer_channels=cores > 1)
    got = inputs.train_set(t, c, tmp_path)
    common = dict(interval_size=2000, warmup=200, max_checkpoints=1,
                  l_clip=128, l_token=16)
    if cores == 1:
        from repro_torch.data.dataset import BuildConfig, build_dataset
        ds = build_dataset(t["programs"], BuildConfig(**common),
                           build_vocab())
    else:
        from repro_torch.data.multicore_dataset import (
            MulticoreBuildConfig, build_multicore_dataset)
        ds = build_multicore_dataset(t["programs"], MulticoreBuildConfig(
            n_cores=2, peer_channels=True, **common), build_vocab())
    np.testing.assert_array_equal(got["clip_tokens"], ds.clip_tokens)
    np.testing.assert_array_equal(got["context_tokens"], ds.context_tokens)
    np.testing.assert_array_equal(got["clip_mask"], ds.clip_mask)
    np.testing.assert_array_equal(got["time"], ds.time)
