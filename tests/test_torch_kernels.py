"""The port's attention kernels on the CPU: the plain versions against
the JAX Pallas kernels (interpret mode, as ``tests/test_kernels.py`` runs
them).  The CUDA kernels are held against the plain versions on the card
by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_cases import (FA_CASES, FA_EDGE_CASES, TOL,  # noqa: E402
                          WA_CASES, WA_EDGE_CASES, fa_inputs, wa_inputs)

from repro.kernels.flash_attention.ops import flash_attention as jax_fa  # noqa: E402
from repro.kernels.fused_serving import ops as jax_wa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.fused_serving import ops as wa_ops  # noqa: E402


def _to_torch(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


def _err(a_torch, b_jax):
    return float(np.max(np.abs(a_torch.float().numpy()
                                - np.asarray(b_jax.astype(jnp.float32)))))


@pytest.mark.parametrize("case", FA_CASES + FA_EDGE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(case, dtype):
    _, _, _, _, _, causal, window, _ = case
    q, k, v, m = fa_inputs(case)
    tdt = getattr(torch, dtype)
    out = fa_ops.flash_attention(
        _to_torch(q, tdt), _to_torch(k, tdt), _to_torch(v, tdt),
        causal=causal, window=window,
        kv_mask=None if m is None else torch.from_numpy(m))
    ref = jax_fa(_to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
                 causal=causal, window=window,
                 kv_mask=None if m is None else jnp.asarray(m))
    assert out.dtype == tdt and out.shape == q.shape
    assert _err(out, ref) < TOL[dtype], (case, dtype)


def test_flash_plain_matches_oracle_and_zero_rows():
    q, k, v, m = fa_inputs((2, 16, 16, 4, 32, False, 0, True), seed=3)
    m[1] = 0.0                                   # batch row 1: no valid key
    tq, tk, tv, tm = (torch.from_numpy(x) for x in (q, k, v, m))
    out = fa_ops.flash_attention(tq, tk, tv, kv_mask=tm)
    ref = attention_ref(tq, tk, tv, kv_mask=tm)
    assert float((out - ref).abs().max()) < 2e-5
    assert float(out[1].abs().max()) == 0.0
    jref = jax_fa(*(jnp.asarray(x) for x in (q, k, v)),
                  kv_mask=jnp.asarray(m))
    assert float(np.max(np.abs(np.asarray(jref)[1]))) == 0.0


@pytest.mark.parametrize("case", WA_CASES + WA_EDGE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_plain_matches_pallas(case, dtype):
    q, k, v, w = wa_inputs(case)
    tdt = getattr(torch, dtype)
    out = wa_ops.weighted_attention(_to_torch(q, tdt), _to_torch(k, tdt),
                                    _to_torch(v, tdt), torch.from_numpy(w))
    ref = jax_wa.weighted_attention(_to_jax(q, dtype), _to_jax(k, dtype),
                                    _to_jax(v, dtype), jnp.asarray(w),
                                    impl="pallas", interpret=True)
    assert out.dtype == tdt
    assert _err(out, ref) < TOL[dtype], (case, dtype)


def test_weighted_zero_weight_rows_and_keys():
    q, k, v, w = wa_inputs((3, 16, 24, 4, 8, True), seed=5)
    w[2] = 0.0                                   # all-zero weights -> zeros
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    out = wa_ops.weighted_attention(tq, tk, tv, tw)
    assert float(out[2].abs().max()) == 0.0
    # zero-weight keys == keys sliced away
    cut = wa_ops.weighted_attention(tq, tk[:, :16], tv[:, :16], tw[:, :16])
    assert float((out[:2] - cut[:2]).abs().max()) < 2e-5
    # multiplicity c == c physical copies of the key
    reps = torch.tensor([1, 2, 3, 1] * 4)
    dup = wa_ops.weighted_attention(
        tq[:1], tk[:1, :16].repeat_interleave(reps, 1),
        tv[:1, :16].repeat_interleave(reps, 1),
        torch.ones(1, int(reps.sum())))
    one = wa_ops.weighted_attention(tq[:1], tk[:1, :16], tv[:1, :16],
                                    reps[None].float())
    assert float((dup - one).abs().max()) < 2e-5


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q = torch.zeros(1, 4, 1, 16)
    before = (fa_ops.flash_attention.launches,
              wa_ops.weighted_attention.launches)
    fa_ops.flash_attention(q, q, q)
    wa_ops.weighted_attention(q, q, q, torch.ones(1, 4))
    assert (fa_ops.flash_attention.launches,
            wa_ops.weighted_attention.launches) == before
    # what the CUDA path would refuse: a non-CUDA tensor, a head_dim the
    # kernels are not built for
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_ops.check_attention_args(q, q, q, None, "flash_attention")
    meta = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError):
        fa_ops.flash_attention(meta, meta, meta)



@pytest.mark.parametrize("kind", ["flash", "flash_causal", "weighted"])
def test_head_dim_112_zero_padding_is_exact(kind):
    """The kernels take head dim 112 zero-padded to 128 with the scale of
    112: on the plain versions (whose scale follows D), padding q/k/v
    with ``pad_head_dim`` and rescaling q by sqrt(128/112) gives the
    unpadded result in the first 112 features and zeros after them."""
    rng = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rng.randn(2, s, 3, 112).astype(np.float32))
               for s in (40, 70, 70))
    m = torch.from_numpy((rng.rand(2, 70) > 0.3).astype(np.float32))
    qp, kp, vp = fa_ops.pad_head_dim(q, k, v)
    assert qp.shape[3] == kp.shape[3] == vp.shape[3] == \
        fa_ops.PADDED_HEAD_DIMS[112] == 128
    assert float(qp[..., 112:].abs().max()) == 0.0
    qp = qp * (128 / 112) ** 0.5
    if kind == "weighted":
        w = m * torch.from_numpy(rng.randint(1, 5, (2, 70))).float()
        ref = wa_ops.weighted_attention_plain(q, k, v, w)
        out = wa_ops.weighted_attention_plain(qp, kp, vp, w)
    else:
        causal = kind == "flash_causal"
        ref = fa_ops.flash_attention_plain(q, k, v, causal=causal, kv_mask=m)
        out = fa_ops.flash_attention_plain(qp, kp, vp, causal=causal,
                                           kv_mask=m)
    assert float(out[..., 112:].abs().max()) == 0.0
    np.testing.assert_allclose(out[..., :112].numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-6)
    # the dims the kernels are built for pass through unpadded
    q32 = torch.zeros(1, 4, 2, 32)
    assert all(x is q32 for x in fa_ops.pad_head_dim(q32, q32, q32))


def _arg_cases():
    """(q, k, v, aux) on meta, the device the argument check takes
    without a card: accepted ones and one of each refusal."""
    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    q = t(2, 8, 4, 32)
    kv = t(2, 16, 4, 32)
    w = t(2, 16)
    bf = t(2, 8, 4, 32, dtype=torch.bfloat16)
    wide = t(2, 16, 8, 32)[:, :, :4]                # row stride 256
    return [
        ("taken", q, kv, kv, w), ("taken_no_aux", q, kv, kv, None),
        ("taken_row_strides", q, wide, wide, w),
        ("taken_d112", t(1, 4, 2, 112), t(1, 4, 2, 112),
         t(1, 4, 2, 112), None),
        ("cpu_k", q, torch.empty(2, 16, 4, 32), kv, w),
        ("dtype", bf, kv, kv, w),
        ("f64", t(2, 8, 4, 32, dtype=torch.float64),
         t(2, 16, 4, 32, dtype=torch.float64),
         t(2, 16, 4, 32, dtype=torch.float64), None),
        ("head_dim", t(2, 8, 4, 8), t(2, 16, 4, 8), t(2, 16, 4, 8), None),
        ("rank3", t(8, 4, 32), kv, kv, None),
        ("heads", q, t(2, 16, 2, 32), t(2, 16, 2, 32), w),
        ("batch", q, t(3, 16, 4, 32), t(3, 16, 4, 32), None),
        ("v_shape", q, kv, t(2, 12, 4, 32), None),
        ("head_stride", q, t(2, 16, 32, 4).transpose(2, 3), kv, None),
        ("aux_shape", q, kv, kv, t(2, 8)),
        ("aux_dtype", q, kv, kv, t(2, 16, dtype=torch.bfloat16)),
        ("aux_strided", q, kv, kv, t(16, 2).t()),
    ]


@pytest.mark.parametrize("case", _arg_cases(), ids=lambda c: c[0])
def test_fast_argument_accept_agrees_with_the_full_check(case):
    """The wrappers' fast accept (``_taken``) takes exactly what
    ``check_attention_args`` takes: it only spares the full check's
    attribute reads, never lets through what that check would refuse."""
    name, q, k, v, aux = case
    try:
        fa_ops.check_attention_args(q, k, v, aux, "flash_attention")
        refused = False
    except ValueError:
        refused = True
    assert refused == (not name.startswith("taken"))
    assert fa_ops._taken(q, k, v, aux) == (not refused)
