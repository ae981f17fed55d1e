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
# The tiled CUDA kernel's edges: 16-row query blocks and 64-key tiles that
# end mid-block, a causal window that ends inside a key tile, a mask that
# empties one whole key tile ("tile") while the others stay live, and
# every head dim
FA_EDGE_CASES = [
    (2, 1, 257, 4, 32, False, 0, True),
    (2, 17, 257, 4, 32, True, 0, True),
    (1, 17, 257, 2, 16, False, 0, False),
    (1, 100, 257, 2, 64, True, 0, False),
    (1, 100, 257, 2, 128, False, 0, True),
    (1, 100, 257, 2, 32, True, 40, False),    # window ends inside a tile
    (2, 100, 257, 2, 32, False, 0, "tile"),
    (2, 40, 200, 2, 16, True, 0, "tile"),
]
WA_CASES = [
    # (B, Sq, Skv, H, D, zero_tail) — tests/test_fused_serving.py shapes
    (3, 16, 24, 4, 8, False),
    (2, 33, 47, 4, 8, False),                 # ragged
    (2, 16, 24, 4, 8, True),                  # zero-weight padding keys
]
# The tiled CUDA kernel's edges (the last field is wa_inputs' kind): U
# deduplicated tokens that are not multiples of 16 or 64, every head dim,
# a 64-key tile whose weights are all 0 ("tile"), and zero-weight keys
# that carry the row's largest score ("max_at_zero"): the row max runs
# over them, so in batch row 0, where they lead by ~200, every live p
# underflows and the row is zeros
WA_EDGE_CASES = [
    (2, 1, 1, 4, 32, False),
    (2, 17, 17, 4, 16, False),
    (2, 65, 65, 2, 64, True),
    (1, 257, 257, 2, 128, False),
    (2, 100, 200, 2, 32, "tile"),
    (3, 40, 70, 2, 32, "max_at_zero"),
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
        if masked == "tile":                  # keys 64-127: one whole tile
            m[:, 64:128] = 0.0
    return q, k, v, m


def wa_inputs(case, seed=2):
    """kind (the case's last field): True zeroes the last third of the
    weights, "tile" keys 64-127, "max_at_zero" every fourth key, whose
    score then leads the row's (by ~5, and by ~200 in batch row 0)."""
    B, Sq, Skv, H, D, kind = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, H, D)).astype(np.float32)
    w = rng.integers(0, 5, (B, Skv)).astype(np.float32)
    w[:, 0] = 1.0
    if kind is True:
        w[:, Skv * 2 // 3:] = 0.0
    elif kind == "tile":
        w[:, 64:128] = 0.0
    elif kind == "max_at_zero":
        zero = np.arange(Skv) % 4 == 1
        w[:, zero] = 0.0
        q[..., 0] = np.abs(q[..., 0]) + 1.0       # scores along feature 0
        k[:, zero, :, 0] = 5.0 * np.sqrt(D)
        k[0, zero, :, 0] = 200.0 * np.sqrt(D)
    return q, k, v, w


SSD_CASES = [
    # (Bt, S, H, P, N, chunk) — tests/test_kernels.py
    (2, 64, 4, 32, 64, 16),
    (1, 128, 2, 64, 128, 64),
    (2, 100, 3, 16, 32, 32),                   # padding path
    (1, 256, 8, 64, 128, 256),                 # single chunk
]
# The chunk-parallel CUDA kernel's edges: many chunks with a ragged last
# one, S shorter than the chunk, and the widest head and state
SSD_EDGE_CASES = [
    (1, 5 * 64 + 17, 2, 32, 64, 64),
    (2, 40, 3, 16, 32, 64),
    (1, 128, 2, 128, 256, 64),
]
# SSD gates, scaled by the output's magnitude (max(1, max|ref|)): the
# kernel and its plain version compute the same f32 chunk arithmetic in
# another summation order (1e-5); bf16 rounds y to 8 mantissa bits (1e-2)
SSD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def ssd_inputs(case, seed=7, a_scale=1.0):
    """x (Bt, S, H, P), dt (Bt, S, H), B/C (Bt, S, N), A (H,) as float32
    numpy, drawn as tests/test_kernels.py draws them; ``a_scale``
    multiplies A (large values give the large-decay case)."""
    Bt, S, H, P, N, _ = case
    rng = np.random.RandomState(seed)
    x = rng.randn(Bt, S, H, P).astype(np.float32) * 0.5
    dt = np.abs(rng.randn(Bt, S, H)).astype(np.float32) * 0.4 + 0.01
    B = rng.randn(Bt, S, N).astype(np.float32) * 0.3
    C = rng.randn(Bt, S, N).astype(np.float32) * 0.3
    A = (-np.abs(rng.randn(H)).astype(np.float32) - 0.1) * a_scale
    return x, dt, B, C, A


def scaled_err(out, ref):
    """max |out - ref| / max(1, max |ref|), in float64."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(out - ref)) / max(1.0, np.max(np.abs(ref))))
