#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, each of which raises on failure (exit code != 0, no result line):

  1. device   the card's name, count and power limit; TF32 off for matmuls
              and cuDNN, so fp32 means fp32.
  2. build    every CUDA kernel from ``src/repro_torch/csrc``, one nvcc per
              source, all started together.
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes and the reference kernel tests' sweeps,
              in float32 (max abs err <= 2e-5) and bfloat16 (<= 2e-2).
  4. timing   each kernel at its path shapes (CUDA events after warm-up):
              kernel, plain version, and one PyTorch library call computing
              the same function (``scaled_dot_product_attention``, timed as
              a yardstick only — the port never calls it), beside the least
              time the card could take (bytes at 3.35 TB/s, operations at
              67 TFLOP/s float32 or 989 TFLOP/s bfloat16, the larger).
  5. engine   ``SimulationEngine.run`` at the paper model's full width
              (E=128, 4 heads, 4+4 layers, M=360) with seeded random
              parameters, on the first 3 Table II benchmarks: unfused and
              fused fp32 (kernel launch counters reset just before each run
              and read just after), bf16, and one benchmark on the CPU
              through the plain versions.  Checks: both kernels launched,
              predictions finite, fused vs unfused <= 1e-3 relative, card vs
              CPU <= 1e-4 relative, equal oracle cycles, bf16 within 1%.

The line before the last is the card's name and power limit from
nvidia-smi; before it, one JSON object ``{"kernels": [...]}``.  The last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
BENCHMARKS = 3
F32_TOL, BF16_TOL = 2e-5, 2e-2
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(B, Sq, Skv, H, D, dtype: str, aux: bool):
    """(ms, "bytes"|"operations"): q/k/v read once, o written once, the
    per-key mask/weights read once; QK^T and PV at 2 FLOPs per MAC."""
    elem = 4 if dtype == "float32" else 2
    nbytes = (2 * B * Sq * H * D + 2 * B * Skv * H * D) * elem \
        + (4 * B * Skv if aux else 0)
    flops = 4.0 * B * H * Sq * Skv * D
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# --------------------------------------------------------------------- #
# kernel cases
# --------------------------------------------------------------------- #

# (label, B, Sq, Skv, H, D, causal, window, mask): the main path's shapes
# at the paper's width (H=4, D=32, batch 256, M=360, L_clip=128, encode
# passes of 32-64 static rows x L_token=16), then the reference kernel
# tests' sweep (tests/test_kernels.py FA_CASES), then a row with no key
FA_PATH = [
    ("inst_encoder", 64, 16, 16, 4, 32, False, 0, "tokens"),
    ("block_self", 256, 360, 360, 4, 32, False, 0, None),
    ("block_cross", 256, 360, 128, 4, 32, False, 0, "clip"),
]
FA_SWEEP = [
    ("sweep", 2, 128, 128, 4, 64, True, 0, None),
    ("sweep", 1, 100, 100, 2, 32, True, 0, None),
    ("sweep", 2, 16, 16, 4, 32, False, 0, "random"),
    ("sweep", 1, 360, 128, 4, 32, False, 0, "random"),
    ("sweep", 2, 256, 256, 2, 64, True, 64, None),
    ("sweep", 1, 1, 257, 2, 128, True, 0, None),
    ("sweep", 1, 64, 192, 1, 16, True, 0, None),
    ("fully_masked_row", 4, 16, 16, 4, 32, False, 0, "empty_row"),
]
# (label, B, Sq, Skv, weights): fused self over U deduped tokens (U from
# the dedup ladder, weights = multiplicities with zero-weight padding
# slots), fused cross from U to L_clip=128 (weights = clip_mask)
WA_PATH = [
    ("fused_self_u64", 256, 64, 64, "counts"),
    ("fused_self_u128", 256, 128, 128, "counts"),
    ("fused_cross_u128", 256, 128, 128, "clip"),
]
WA_EDGE = [
    ("zero_weight_keys", 8, 48, 48, "counts"),
    ("all_zero_row", 8, 32, 32, "empty_row"),
]


def make_qkv(torch, gen, B, Sq, Skv, H, D, dtype):
    def r(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)
    return r(B, Sq, H, D), r(B, Skv, H, D), r(B, Skv, H, D)


def make_aux(torch, gen, kind, B, Skv):
    """Per-key mask/weights, float32 (B, Skv), on the card."""
    if kind is None:
        return None
    if kind == "tokens":                  # <PAD> tail of a token row
        n = torch.randint(2, Skv + 1, (B,), generator=gen)
        w = (torch.arange(Skv)[None] < n[:, None]).float()
    elif kind == "clip":                  # clip_mask: a real prefix of
        # at least half the clip (l_min=100 of l_clip=128 on the path)
        n = torch.randint(Skv // 2, Skv + 1, (B,), generator=gen)
        w = (torch.arange(Skv)[None] < n[:, None]).float()
    elif kind == "random":
        w = (torch.rand(B, Skv, generator=gen) > 0.3).float()
        w[:, 0] = 1.0
    elif kind == "counts":                # multiplicities + zero padding
        w = torch.randint(1, 9, (B, Skv), generator=gen).float()
        n = torch.randint(Skv // 2, Skv + 1, (B,), generator=gen)
        w = w * (torch.arange(Skv)[None] < n[:, None])
    elif kind == "empty_row":
        w = torch.ones(B, Skv)
        w[0] = 0.0
    else:
        raise ValueError(kind)
    return w.to("cuda")


def check_kernels(torch, fa_ops, wa_ops):
    """Every case, both dtypes, kernel vs plain version on the card.
    Returns {kernel: {dtype: max abs err over its cases}}."""
    gen = torch.Generator().manual_seed(0)
    errs = {"flash_attention": {}, "weighted_attention": {}}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        worst = 0.0
        for (label, B, Sq, Skv, H, D, causal, window, kind) in \
                FA_PATH + FA_SWEEP:
            q, k, v = make_qkv(torch, gen, B, Sq, Skv, H, D, tdt)
            m = make_aux(torch, gen, kind, B, Skv)
            out = fa_ops.flash_attention(q, k, v, causal=causal,
                                         window=window, kv_mask=m)
            ref = fa_ops.flash_attention_plain(q, k, v, causal=causal,
                                               window=window, kv_mask=m)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            print(f"kernel flash_attention {label:16s} {dtype:8s} "
                  f"B={B} Sq={Sq} Skv={Skv} H={H} D={D} causal={causal} "
                  f"window={window} mask={kind} max_abs_err={err:.3e}")
            require(err <= tol, f"flash_attention {label} {dtype} err {err}")
            if kind == "empty_row":
                require(float(out[0].float().abs().max()) == 0.0,
                        "flash_attention: a row with no valid key must "
                        "output zeros")
            worst = max(worst, err)
        errs["flash_attention"][dtype] = worst
        worst = 0.0
        for (label, B, Sq, Skv, kind) in WA_PATH + WA_EDGE:
            q, k, v = make_qkv(torch, gen, B, Sq, Skv, 4, 32, tdt)
            w = make_aux(torch, gen, kind, B, Skv)
            out = wa_ops.weighted_attention(q, k, v, w)
            ref = wa_ops.weighted_attention_plain(q, k, v, w)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            print(f"kernel weighted_attention {label:16s} {dtype:8s} "
                  f"B={B} Sq={Sq} Skv={Skv} H=4 D=32 weights={kind} "
                  f"max_abs_err={err:.3e}")
            require(err <= tol,
                    f"weighted_attention {label} {dtype} err {err}")
            if kind == "empty_row":
                require(float(out[0].float().abs().max()) == 0.0,
                        "weighted_attention: all-zero weights must output "
                        "zeros")
            worst = max(worst, err)
        errs["weighted_attention"][dtype] = worst
    # the fused step hands the kernel strided q/k/v views of one QKV matmul
    qkv = torch.randn(256, 64, 384, generator=gen).to("cuda")
    q, k, v = (x.unflatten(-1, (4, 32)) for x in qkv.split(128, dim=-1))
    w = make_aux(torch, gen, "counts", 256, 64)
    err = float((wa_ops.weighted_attention(q, k, v, w)
                 - wa_ops.weighted_attention_plain(q, k, v, w))
                .abs().max())
    print(f"kernel weighted_attention strided_qkv      float32  "
          f"max_abs_err={err:.3e}")
    require(err <= F32_TOL, f"weighted_attention strided views err {err}")
    return errs


def time_kernels(torch, fa_ops, wa_ops):
    """Kernel / plain / library times at the path shapes, both dtypes.
    Returns {kernel: [row, ...]}."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(1)
    rows = {"flash_attention": [], "weighted_attention": []}

    def sdpa_inputs(q, k, v):
        return [x.transpose(1, 2).contiguous() for x in (q, k, v)]

    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for (label, B, Sq, Skv, H, D, _, _, kind) in FA_PATH:
            q, k, v = make_qkv(torch, gen, B, Sq, Skv, H, D, tdt)
            m = make_aux(torch, gen, kind, B, Skv)
            qt, kt, vt = sdpa_inputs(q, k, v)
            lib_mask = None if m is None else (m > 0)[:, None, None, :]
            row = {
                "shape": label, "dtype": dtype,
                "ms": cuda_ms(torch, lambda: fa_ops.flash_attention(
                    q, k, v, kv_mask=m)),
                "plain_ms": cuda_ms(torch, lambda:
                                    fa_ops.flash_attention_plain(
                                        q, k, v, kv_mask=m)),
                "library_ms": cuda_ms(torch, lambda:
                                      F.scaled_dot_product_attention(
                                          qt, kt, vt, attn_mask=lib_mask)),
            }
            row["bound_ms"], row["bound_by"] = bound(B, Sq, Skv, H, D,
                                                     dtype, m is not None)
            rows["flash_attention"].append(row)
        for (label, B, Sq, Skv, kind) in WA_PATH:
            q, k, v = make_qkv(torch, gen, B, Sq, Skv, 4, 32, tdt)
            w = make_aux(torch, gen, kind, B, Skv)
            qt, kt, vt = sdpa_inputs(q, k, v)
            # softmax(s + log w) == w·e^s / Σ w·e^s: the same function
            log_w = torch.log(w)[:, None, None, :].to(tdt)
            row = {
                "shape": label, "dtype": dtype,
                "ms": cuda_ms(torch, lambda: wa_ops.weighted_attention(
                    q, k, v, w)),
                "plain_ms": cuda_ms(torch, lambda:
                                    wa_ops.weighted_attention_plain(
                                        q, k, v, w)),
                "library_ms": cuda_ms(torch, lambda:
                                      F.scaled_dot_product_attention(
                                          qt, kt, vt, attn_mask=log_w)),
            }
            row["bound_ms"], row["bound_by"] = bound(B, Sq, Skv, 4, 32,
                                                     dtype, True)
            rows["weighted_attention"].append(row)
    for name, rs in rows.items():
        for r in rs:
            print(f"time {name} {r['shape']:16s} {r['dtype']:8s} "
                  f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                  f"bound_share={r['bound_ms'] / r['ms']:.3f}")
    return rows


# --------------------------------------------------------------------- #
# engine
# --------------------------------------------------------------------- #

def run_engine(torch, params, cfg, vocab, names, config, device="cuda"):
    from repro_torch.core.engine import SimulationEngine
    engine = SimulationEngine.from_config(params, cfg, vocab, config,
                                          device=device)
    engine.submit_names(names)
    t0 = time.perf_counter()
    results = engine.run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return results, wall, engine


def check_engine(torch, fa_ops, wa_ops):
    from repro_torch.configs.capsim import config
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.isa import progen

    cfg = config()
    vocab = std_mod.build_vocab()
    names = list(progen.TABLE_II)[:BENCHMARKS]
    params = predictor.init_params(cfg, seed=0, device="cuda")
    base = EngineConfig(precision="fp32", interval_size=20_000,
                        max_checkpoints=1, batch_size=256, with_oracle=True)
    print(f"engine config: E={cfg.d_model} heads={cfg.num_heads} "
          f"head_dim={cfg.head_dim} d_ff={cfg.d_ff} M={cfg.context_tokens} "
          f"L_clip={base.l_clip} L_token={base.l_token} batch="
          f"{base.batch_size} interval={base.interval_size} benchmarks="
          f"{names}")

    runs, launches = {}, {}
    for fused in (False, True):
        fa_ops.flash_attention.launches = 0
        wa_ops.weighted_attention.launches = 0
        res, wall, eng = run_engine(torch, params, cfg, vocab, names,
                                    base.replace(fused_serving=fused))
        launches[fused] = (fa_ops.flash_attention.launches,
                           wa_ops.weighted_attention.launches)
        runs[fused] = res
        st, rt = eng.last_stats, eng.last_rt_stats
        n_clips = sum(r.n_clips for r in res)
        print(f"engine fused={fused} fp32: {n_clips} clips in {wall:.3f} s "
              f"= {n_clips / wall:.1f} clips/s (host front-end and oracle "
              f"included); predict {st.predict_seconds:.3f} s, "
              f"{st.n_batches} batches, {st.n_pad} pad rows; rt build "
              f"{rt.build_seconds:.3f} s for {rt.n_rows_encoded} rows in "
              f"{rt.n_encode_passes} passes; launches flash="
              f"{launches[fused][0]} weighted={launches[fused][1]}")
        for r in res:
            print(f"  {r.name:16s} clips={r.n_clips} predicted="
                  f"{r.predicted_cycles!r} oracle={r.oracle_cycles!r}")
    require(launches[False][0] > 0, "unfused run launched no flash kernel")
    require(launches[True][0] > 0, "fused run launched no flash kernel "
            "(RT build)")
    require(launches[True][1] > 0, "fused run launched no weighted kernel")
    for fused, res in runs.items():
        require(all(math.isfinite(r.predicted_cycles) for r in res),
                f"non-finite prediction (fused={fused})")
        require(all(r.n_clips > 0 for r in res), "a benchmark had no clips")
    for a, b in zip(runs[False], runs[True]):
        rel = abs(b.predicted_cycles - a.predicted_cycles) \
            / abs(a.predicted_cycles)
        print(f"fused vs unfused {a.name}: rel {rel:.3e}")
        require(a.oracle_cycles == b.oracle_cycles, "oracle cycles differ")
        require(rel <= 1e-3, f"fused vs unfused {a.name} rel {rel}")

    bf16, _, _ = run_engine(torch, params, cfg, vocab, names,
                            base.replace(precision="bf16"))
    for a, b in zip(runs[False], bf16):
        rel = abs(b.predicted_cycles - a.predicted_cycles) \
            / abs(a.predicted_cycles)
        print(f"bf16 vs fp32 {a.name}: rel {rel:.3e}")
        require(a.oracle_cycles == b.oracle_cycles, "oracle cycles differ")
        require(rel <= 1e-2, f"bf16 vs fp32 {a.name} rel {rel}")

    cpu, cpu_wall, _ = run_engine(torch, params, cfg, vocab, names[:1],
                                  base, device="cpu")
    a, b = runs[False][0], cpu[0]
    rel = abs(b.predicted_cycles - a.predicted_cycles) \
        / abs(a.predicted_cycles)
    print(f"card vs CPU plain path {a.name}: rel {rel:.3e} "
          f"(CPU run {cpu_wall:.1f} s)")
    require(a.oracle_cycles == b.oracle_cycles, "oracle cycles differ")
    require(rel <= 1e-4, f"card vs CPU {a.name} rel {rel}")
    return {"flash_attention": launches[False][0] + launches[True][0],
            "weighted_attention": launches[False][1] + launches[True][1]}


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_serving import ops as wa_ops

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"device: {kind} x{count}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for cuBLAS matmuls and cuDNN (fp32 means fp32)")

    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {sorted(logs) or 'up to date'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        regs = [int(line.split("Used ")[1].split()[0])
                for line in log.splitlines() if "Used " in line]
        spills = [line.strip() for line in log.splitlines()
                  if "spill stores" in line and " 0 bytes spill" not in line]
        print(f"build {name}: {len(regs)} instantiations, registers "
              f"{min(regs)}-{max(regs)}, {len(spills)} with spills")

    errs = check_kernels(torch, fa_ops, wa_ops)
    rows = time_kernels(torch, fa_ops, wa_ops)
    launches = check_engine(torch, fa_ops, wa_ops)

    sources = {"flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:33", "block_self"),
        "weighted_attention": (
        "src/repro_torch/csrc/weighted_attention.cu",
        "src/repro/kernels/fused_serving/kernel.py:33", "fused_self_u128")}
    kernels = []
    for name, (source, replaces, main_shape) in sources.items():
        row = next(r for r in rows[name]
                   if r["shape"] == main_shape and r["dtype"] == "float32")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name]["float32"],
            "max_abs_err_bf16": errs[name]["bfloat16"],
            "shape": f"{main_shape} float32",
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
