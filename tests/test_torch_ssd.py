"""The port's SSD scan on the CPU: the plain version (what ``ssd_scan``
runs on a CPU tensor) against the JAX Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it, and against the per-step oracles.  The
CUDA kernel is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread per worker keeps the parallel test
# run from oversubscribing the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_cases import (SSD_CASES, SSD_EDGE_CASES, SSD_TOL,  # noqa: E402
                          scaled_err, ssd_inputs)

from repro.kernels.ssd.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels.ssd import ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_ref  # noqa: E402


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _port_inputs(x, dt, B, C, A, dtype):
    tdt = getattr(torch, dtype)
    return _torch(x, tdt), _torch(dt), _torch(B, tdt), _torch(C, tdt), \
        _torch(A)


def _jax_inputs(x, dt, B, C, A, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return (jnp.asarray(x).astype(jdt), jnp.asarray(dt),
            jnp.asarray(B).astype(jdt), jnp.asarray(C).astype(jdt),
            jnp.asarray(A))


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("case", SSD_CASES + SSD_EDGE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_pallas_and_oracle(case, dtype):
    chunk = case[-1]
    arrs = ssd_inputs(case)
    y, st = ops.ssd_scan(*_port_inputs(*arrs, dtype), chunk=chunk)
    assert y.dtype == getattr(torch, dtype) and y.shape == arrs[0].shape
    assert st.dtype == torch.float32
    assert st.shape == (case[0], case[2], case[3], case[4])
    jin = _jax_inputs(*arrs, dtype)
    yp, sp = jax_ssd_scan(*jin, chunk=chunk)
    yr, sr = jax_ssd_ref(*jin)
    # the reference's own gate against the per-step oracle
    tol = 2e-3 if dtype == "float32" else 1e-1
    assert np.max(np.abs(_np(y) - _np(yr))) < tol, (case, dtype)
    assert np.max(np.abs(_np(st) - _np(sr))) < tol, (case, dtype)
    # against the interpret-mode kernel, scaled by max|y|: at the
    # single-chunk case the Pallas kernel's f32 cumsum is itself 1.3e-5
    # (abs, max|y| 4.5) from the exact recurrence, the port's f64 seg 1.4e-6
    assert scaled_err(_np(y), _np(yp)) < SSD_TOL[dtype], (case, dtype)
    assert scaled_err(_np(st), _np(sp)) < SSD_TOL[dtype], (case, dtype)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_is_closer_to_the_recurrence_than_pallas(case):
    """In f32 the port's plain version stays within 2e-6 (scaled) of the
    exact per-step recurrence, at least as close as the Pallas kernel."""
    chunk = case[-1]
    arrs = ssd_inputs(case)
    y, st = ops.ssd_scan_plain(*_port_inputs(*arrs, "float32"), chunk=chunk)
    jin = _jax_inputs(*arrs, "float32")
    yr, sr = jax_ssd_ref(*jin)
    yp, _ = jax_ssd_scan(*jin, chunk=chunk)
    err = scaled_err(_np(y), _np(yr))
    assert err < 2e-6, (case, err)
    assert err <= max(scaled_err(_np(yp), _np(yr)), 1e-6)
    assert scaled_err(_np(st), _np(sr)) < 2e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_ssd_ref_matches_jax_ref(dtype):
    arrs = ssd_inputs((2, 48, 3, 16, 32, 16), seed=11)
    y, st = ssd_ref(*_port_inputs(*arrs, dtype))
    yj, sj = jax_ssd_ref(*_jax_inputs(*arrs, dtype))
    assert y.dtype == getattr(torch, dtype)
    assert scaled_err(_np(y), _np(yj)) < SSD_TOL[dtype]
    assert scaled_err(_np(st), _np(sj)) < 1e-5


def test_ssd_state_continuation():
    """The cross-chunk recurrence is exact: the final state and y agree
    with the per-step oracle and with a scan in one chunk."""
    case = (1, 64, 2, 16, 32, 16)
    x, dt, B, C, A = (_torch(a) for a in ssd_inputs(case, seed=3))
    A = torch.tensor([-0.5, -1.0])
    y16, st16 = ops.ssd_scan(x, dt, B, C, A, chunk=16)
    y64, st64 = ops.ssd_scan(x, dt, B, C, A, chunk=64)
    yr, sr = ssd_ref(x, dt, B, C, A)
    assert float((st16 - sr).abs().max()) < 1e-5
    assert float((st16 - st64).abs().max()) < 1e-5
    assert float((y16 - y64).abs().max()) < 1e-5
    assert float((y16 - yr).abs().max()) < 1e-5


def test_ssd_large_decay_stays_finite():
    """At dt·|A| large enough that seg reaches -1e4 within a chunk, the
    split form exp(seg_i)/exp(seg_j) is 0/0; the kernel's one exp of the
    difference stays finite and matches the per-step oracle."""
    case = (2, 300, 4, 16, 32, 256)
    x, dt, B, C, A = (_torch(a) for a in ssd_inputs(case, seed=5,
                                                     a_scale=60.0))
    seg = torch.cumsum(dt[0, :256, 0] * A[0], 0)
    assert float(seg[-1]) < -1e3
    split = torch.exp(seg)[:, None] / torch.exp(seg)[None, :]
    assert torch.isnan(split).any()                 # what the split form gives
    y, st = ops.ssd_scan(x, dt, B, C, A, chunk=256)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yr, sr = ssd_ref(x, dt, B, C, A)
    assert scaled_err(y.numpy(), yr.numpy()) < 1e-5
    assert scaled_err(st.numpy(), sr.numpy()) < 1e-5


def test_ssd_all_padding_chunk_leaves_the_state():
    """A chunk whose steps all have dt = 0 and zero x/B/C (what padding
    feeds the kernel) neither decays nor injects: the final state is the
    state after the real steps and that chunk's y is zero."""
    case = (1, 128, 2, 16, 32, 64)
    x, dt, B, C, A = (_torch(a) for a in ssd_inputs(case, seed=9))
    for t in (x, dt, B, C):
        t[:, 64:] = 0.0
    y, st = ops.ssd_scan(x, dt, B, C, A, chunk=64)
    y_half, st_half = ops.ssd_scan(x[:, :64], dt[:, :64], B[:, :64],
                                   C[:, :64], A, chunk=64)
    assert torch.equal(st, st_half)
    assert float(y[:, 64:].abs().max()) == 0.0
    assert torch.equal(y[:, :64], y_half)


def test_ssd_scan_counts_no_launch_on_the_cpu():
    before = ops.ssd_scan.launches
    arrs = ssd_inputs(SSD_CASES[0])
    ops.ssd_scan(*_port_inputs(*arrs, "float32"), chunk=16)
    assert ops.ssd_scan.launches == before
