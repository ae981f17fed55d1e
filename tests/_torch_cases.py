"""Shared attention cases for the port's kernel tests (numpy only, so the
card-only tests can run where JAX is not installed)."""
import numpy as np

FA_CASES = [
    # (B, Sq, Skv, H, D, causal, window, masked) — tests/test_kernels.py
    (2, 128, 128, 4, 64, True, 0, False),
    (1, 100, 100, 2, 32, True, 0, False),     # non-multiple lengths
    (2, 16, 16, 4, 32, False, 0, True),       # instruction-encoder shape
    (1, 360, 128, 4, 32, False, 0, True),     # block-encoder cross shape
    (2, 256, 256, 2, 64, True, 64, False),    # sliding window
    (1, 1, 257, 2, 128, True, 0, False),      # decode-style single query
    (1, 64, 192, 1, 16, True, 0, False),      # Sq != Skv causal (suffix)
]
WA_CASES = [
    # (B, Sq, Skv, H, D, zero_tail) — tests/test_fused_serving.py shapes
    (3, 16, 24, 4, 8, False),
    (2, 33, 47, 4, 8, False),                 # ragged
    (2, 16, 24, 4, 8, True),                  # zero-weight padding keys
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def fa_inputs(case, seed=7):
    B, Sq, Skv, H, D, causal, window, masked = case
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    k = rng.randn(B, Skv, H, D).astype(np.float32)
    v = rng.randn(B, Skv, H, D).astype(np.float32)
    m = None
    if masked:
        m = (rng.rand(B, Skv) > 0.3).astype(np.float32)
        m[:, 0] = 1.0
    return q, k, v, m


def wa_inputs(case, seed=2):
    B, Sq, Skv, H, D, zero_tail = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, H, D)).astype(np.float32)
    w = rng.integers(0, 5, (B, Skv)).astype(np.float32)
    w[:, 0] = 1.0
    if zero_tail:
        w[:, Skv * 2 // 3:] = 0.0
    return q, k, v, w
