"""The token-embedding lookup (``kernels/embedding/ops.py``): its paths on
the CPU, on meta and under no_grad, the plain gradient against autograd
through ``table[ids]``, the predictor's gradients through the lookup's
``torch.autograd.Function``, and, on the card (``gpu``-marked, skipped
here), ``csrc/embedding_grad.cu`` against its plain version.  The file
imports no JAX, so its card cases run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_embedding.py
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.configs.capsim import config, smoke_config  # noqa: E402
from repro_torch.core import predictor  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.embedding import ops  # noqa: E402
from repro_torch.obs import REGISTRY  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

V, E = 512, 128

# (name, ids shape, how the ids are drawn)
ID_CASES = [
    ("1d", (37,), "mixed"),
    ("2d", (12, 16), "mixed"),
    ("3d", (3, 8, 16), "mixed"),
    ("all_pad", (9, 16), "pad"),
    ("last_id", (5, 7), "last"),
    ("negative", (4, 6), "negative"),
    ("empty", (0,), "mixed"),
    ("empty_rows", (0, 16), "mixed"),
]


def _ids(shape, kind, dtype, vocab=V, seed=0):
    """Ids of ``shape``: "mixed" as the predictor's token rows (tokens in
    [1, vocab) with <PAD> tails along the last axis), "pad" all <PAD>,
    "last" every id vocab - 1, "negative" ids in [-vocab, vocab)."""
    rng = np.random.RandomState(seed)
    if kind == "pad":
        a = np.zeros(shape, np.int64)
    elif kind == "last":
        a = np.full(shape, vocab - 1, np.int64)
    elif kind == "negative":
        a = rng.randint(-vocab, vocab, shape)
    else:
        a = rng.randint(1, vocab, shape)
        if len(shape) > 1 and a.size:
            T = shape[-1]
            lens = rng.randint(1, T + 1, shape[:-1])
            a[np.arange(T) >= lens[..., None]] = 0
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("case", ID_CASES, ids=lambda c: c[0])
def test_plain_gradient_equals_autograd_through_the_gather(case, dtype):
    _, shape, kind = case
    ids = _ids(shape, kind, dtype)
    table = torch.randn(V, 8, requires_grad=True)
    g = torch.randn(*shape, 8)
    table[ids].backward(g)
    plain = ops.embedding_grad_plain(g, ids, V)
    assert plain.shape == (V, 8)
    assert torch.allclose(plain, table.grad, rtol=1e-6, atol=1e-6)
    # through the lookup's Function, whose backward on the CPU is the plain
    # version
    t2 = table.detach().clone().requires_grad_(True)
    out = ops.embedding_lookup(t2, ids)
    assert type(out.grad_fn).__name__ == "_EmbeddingLookupBackward"
    out.backward(g)
    assert torch.equal(t2.grad, plain)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    """On the CPU the lookup's backward is the plain version: the same
    bits as autograd through ``table[ids]``, no launch, no kernel cost."""
    table = torch.randn(V, E, requires_grad=True)
    ids = _ids((64, 16), "mixed", torch.int32)
    want = torch.autograd.grad(table[ids].sum(), table)[0]
    before = ops.embedding_grad.launches
    with cost.count_kernels() as k:
        out = ops.embedding_lookup(table, ids)
        out.sum().backward()
    assert type(out.grad_fn).__name__ == "_EmbeddingLookupBackward"
    assert torch.equal(out, table.detach()[ids])
    assert torch.equal(table.grad, want)
    assert ops.embedding_grad.launches == before
    assert k.calls == {}


def test_cpu_gradient_in_float64_passes_gradcheck():
    """The plain backward takes the table's dtype: float64 on the CPU
    passes autograd's numerical check."""
    table = torch.randn(20, 3, dtype=torch.float64, requires_grad=True)
    ids = _ids((6, 5), "negative", torch.int64, vocab=20, seed=1)
    assert torch.autograd.gradcheck(
        lambda t: ops.embedding_lookup(t, ids), (table,))


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "frozen"])
def test_without_a_wanted_gradient_the_lookup_is_the_gather(mode, device):
    """With grad mode on and a table that requires grad the lookup is the
    Function (on meta: the card's path, without storage); under no_grad,
    inference_mode, or with a table that wants no gradient, it is
    ``table[ids]`` alone."""
    table = torch.zeros(V, E, device=device, requires_grad=True)
    ids = torch.zeros(32, 16, dtype=torch.int64, device=device)
    assert type(ops.embedding_lookup(table, ids).grad_fn).__name__ == \
        "_EmbeddingLookupBackward"
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "frozen": torch.enable_grad}[mode]
    if mode == "frozen":
        table = table.detach()
    with ctx():
        out = ops.embedding_lookup(table, ids)
    assert out.grad_fn is None and out.shape == (32, 16, E)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
def test_meta_reports_the_cost_and_computes_nothing(dtype):
    table = torch.empty(V, E, device="meta", requires_grad=True)
    ids = torch.empty(4096, 16, dtype=dtype, device="meta")
    before = ops.embedding_grad.launches
    with cost.count_kernels() as k:
        out = ops.embedding_lookup(table, ids)
        assert out.shape == (4096, 16, E) and out.device.type == "meta"
        assert k.calls == {}                 # the forward is the gather
        out.sum().backward()
    n = 4096 * 16
    flops, nbytes = ops.embedding_grad_cost(n, V, E, dtype.itemsize)
    assert k.calls == {"embedding_grad": 1}
    assert k.flops["embedding_grad"] == flops == n * E
    assert k.bytes["embedding_grad"] == nbytes == \
        n * E * 4 + n * dtype.itemsize + V * E * 4
    assert table.grad.shape == (V, E) and table.grad.device.type == "meta"
    assert ops.embedding_grad.launches == before


def test_launch_cost_counts_the_partials():
    least = ops.embedding_grad_cost(1000, V, E, 4)
    launch = ops.embedding_grad_cost(1000, V, E, 4, chunks=3)
    assert launch[0] == least[0]
    assert launch[1] - least[1] == 2 * 3 * V * E * 4


@pytest.mark.parametrize("table, ids, match", [
    ((V, E, torch.bfloat16), ((8,), torch.int64), "float32"),
    ((2, V, E, torch.float32), ((8,), torch.int64), "float32"),
    ((V, E, torch.float32), ((8,), torch.int16), "int32 or int64"),
    ((V, E, torch.float32), ((8,), torch.float32), "int32 or int64"),
], ids=["bf16_table", "3d_table", "int16_ids", "float_ids"])
def test_the_kernel_path_refuses_what_it_does_not_take(table, ids, match):
    *shape, tdt = table
    t = torch.empty(*shape, dtype=tdt, device="meta", requires_grad=True)
    i = torch.empty(*ids[0], dtype=ids[1], device="meta")
    with pytest.raises(ValueError, match=match):
        ops.embedding_lookup(t, i)


def test_the_gradient_refuses_a_mismatched_gradient():
    ids = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="float32"):
        ops.embedding_grad(torch.empty(8, E, dtype=torch.bfloat16,
                                       device="meta"), ids, V)
    with pytest.raises(ValueError, match="ids.shape"):
        ops.embedding_grad(torch.empty(9, E, device="meta"), ids, V)


@pytest.mark.parametrize("n, vocab, width, sms, want", [
    (65536, 512, 128, 132, 99),      # b256's encoder pass, mc4's encoder
    (92160, 512, 128, 132, 99),      # b256's context
    (47232, 512, 128, 132, 99),      # mc4's context
    (1000, 512, 128, 132, 4),        # short: chunks of >= MIN_ROWS rows
    (0, 512, 128, 132, 1),           # empty ids: one chunk of zeros
    (65536, 1500, 72, 132, 44),      # 3 vocabulary tiles x 3 column tiles
    (65536, 200000, 4096, 132, 1),   # more tiles than the card holds
])
def test_chunk_count_fills_the_card_once(n, vocab, width, sms, want):
    assert ops.chunk_count(n, vocab, width, sms) == want


@pytest.mark.parametrize("use_context", [True, False])
def test_mape_loss_gradients_unchanged_through_the_function(monkeypatch,
                                                            use_context):
    """The smoke predictor's gradients with every training gather going
    through ``_EmbeddingLookup`` (as on the card; on the CPU with the plain
    backward) equal autograd through ``table[ids]``."""
    cfg = smoke_config()
    params = predictor.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(3)
    B, L, T, M = 3, 10, cfg.clip_tokens, 12
    batch = {"clip_tokens": _ids((B, L, T), "mixed", torch.int32,
                                 cfg.vocab_size, 4),
             "context_tokens": torch.from_numpy(
                 rng.randint(1, cfg.vocab_size, (B, M)).astype(np.int32)),
             "clip_mask": torch.ones(B, L),
             "time": torch.from_numpy(rng.uniform(50, 500, B).astype(
                 np.float32))}

    def grads():
        (loss, _), g = ttl.value_and_grad(
            lambda p, b: predictor.mape_loss(p, b, cfg, use_context),
            params, batch)
        return loss, g
    calls = []

    def through_function(table, ids):
        out = ops.embedding_lookup(table, ids)
        calls.append((tuple(ids.shape), type(out.grad_fn).__name__))
        return out
    monkeypatch.setattr(predictor, "embedding_lookup", through_function)
    loss_f, got = grads()
    assert calls == [((B * L, T), "_EmbeddingLookupBackward")] + (
        [((B, M), "_EmbeddingLookupBackward")] if use_context else [])
    monkeypatch.setattr(predictor, "embedding_lookup",
                        lambda table, ids: table[ids])
    loss, want = grads()
    assert torch.equal(loss, loss_f)
    assert bool((want["embed"] != 0).any())
    for name in want:
        a, b = got[name], want[name]
        if isinstance(a, dict):
            for k in a:
                assert torch.equal(a[k], b[k]), (name, k)
        else:
            assert torch.equal(a, b), name


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

# f32 sums of the same values in another order: the kernel adds a chunk's
# rows in order (a run of equal ids in a register first) and the chunks'
# partials in order, the plain version (index_add_) in its own order.
# Each error is a few units of f32 rounding of the sum of |values|, so an
# entry is held to 1e-6 of the sum of its |values| (~16 ulps of it).
REL_TOL = 1e-6

CARD_SHAPES = [
    ("encoder_pass_4096x16", (4096, 16)),
    ("context_b256_256x360", (256, 360)),
    ("context_mc4_32x1476", (32, 1476)),
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


def _card_case(shape, dtype, vocab=V, width=E, kind="mixed", seed=0):
    ids = _ids(shape, kind, dtype, vocab, seed).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(*shape, width, device="cuda", generator=gen)
    return g, ids


def _check_against_plain(g, ids, vocab):
    got = ops.embedding_grad(g, ids, vocab)
    want = ops.embedding_grad_plain(g, ids, vocab)
    scale = ops.embedding_grad_plain(g.abs(), ids, vocab)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    over = (got - want).abs() - REL_TOL * scale
    assert float(over.max()) <= 0.0, float(
        ((got - want).abs() / scale.clamp(min=1e-30)).max())
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("case", CARD_SHAPES, ids=lambda c: c[0])
def test_kernel_matches_plain_at_the_cells_shapes(case, dtype):
    _need_card()
    before = ops.embedding_grad.launches
    g, ids = _card_case(case[1], dtype)
    _check_against_plain(g, ids, V)
    assert ops.embedding_grad.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", ID_CASES, ids=lambda c: c[0])
def test_kernel_matches_plain_at_the_edges(case):
    _need_card()
    _, shape, kind = case
    g, ids = _card_case(shape, torch.int64, kind=kind)
    _check_against_plain(g, ids, V)


@pytest.mark.gpu
def test_kernel_gives_the_same_bits_twice():
    _need_card()
    g, ids = _card_case((256, 360), torch.int32)
    a = ops.embedding_grad(g, ids, V)
    b = ops.embedding_grad(g, ids, V)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernel_vocabulary_tiles_and_ragged_columns():
    """A 1500-id table takes three vocabulary tiles (the last one ragged)
    and 72 columns three column tiles (the last one ragged)."""
    _need_card()
    g, ids = _card_case((700, 16), torch.int64, vocab=1500, width=72,
                        kind="negative", seed=2)
    _check_against_plain(g, ids, 1500)


@pytest.mark.gpu
def test_lookup_on_card_trains_through_the_kernel_and_serves_without():
    _need_card()
    table = torch.randn(V, E, device="cuda", requires_grad=True)
    g, ids = _card_case((64, 16), torch.int32)
    before = ops.embedding_grad.launches
    with torch.inference_mode():
        assert torch.equal(ops.embedding_lookup(table, ids),
                           table.detach()[ids])
    assert ops.embedding_grad.launches == before
    out = ops.embedding_lookup(table, ids)
    assert torch.equal(out.detach(), table.detach()[ids])
    out.backward(g)
    assert ops.embedding_grad.launches == before + 1
    want = ops.embedding_grad_plain(g, ids, V)
    scale = ops.embedding_grad_plain(g.abs(), ids, V)
    assert bool(((table.grad - want).abs() <= REL_TOL * scale).all())


@pytest.mark.gpu
@pytest.mark.parametrize("batch, launches", [(256, 9), (32, 2)])
def test_train_step_launches_the_kernel_once_a_gather(batch, launches):
    """The paper model's MAPE gradient at batch 256 gathers in 8 encoder
    passes of 4096 instructions and one context gather (9 launches); at
    batch 32 in one pass and the context (2).  Each launch adds its
    ``embedding_grad_cost`` to the registry's byte-bound cells."""
    _need_card()
    cfg = config().replace(dtype="float32")
    params = predictor.init_params(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(0)
    L, T, M = 128, cfg.clip_tokens, cfg.context_tokens
    b = {"clip_tokens": _ids((batch, L, T), "mixed", torch.int32,
                             cfg.vocab_size),
         "context_tokens": torch.from_numpy(
             rng.randint(1, cfg.vocab_size, (batch, M)).astype(np.int32)),
         "clip_mask": torch.ones(batch, L),
         "time": torch.from_numpy(rng.uniform(50, 500, batch).astype(
             np.float32))}
    b = {k: v.cuda() for k, v in b.items()}

    def counters():
        return (ops.embedding_grad.launches, *(REGISTRY.value(
            name, kernel="embedding_grad", dtype="float32", bound="bytes")
            for name in (cost.FLOPS_TOTAL, cost.BYTES_TOTAL)))
    before = counters()
    _, grads = ttl.value_and_grad(
        lambda p, x: predictor.mape_loss(p, x, cfg), params, b)
    torch.cuda.synchronize()
    sms = ops._sm_count(torch.cuda.current_device())
    want = [ops.embedding_grad_cost(n, cfg.vocab_size, cfg.d_model, 4,
                                    ops.chunk_count(n, cfg.vocab_size,
                                                    cfg.d_model, sms))
            for n in [4096 * T] * (batch * L // 4096) + [batch * M]]
    assert len(want) == launches
    after = counters()
    assert after[0] - before[0] == launches
    assert after[1] - before[1] == sum(f for f, _ in want)
    assert after[2] - before[2] == sum(nb for _, nb in want)
    assert bool(torch.isfinite(grads["embed"]).all())
    assert bool((grads["embed"] != 0).any())
