#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, each of which raises on failure (exit code != 0, no result line):

  1. device   the card's name, count and power limit; TF32 off for matmuls
              and cuDNN, so fp32 means fp32.
  2. build    every CUDA kernel from ``src/repro_torch/csrc``, one nvcc per
              source, all started together (registers, spills and seconds
              per source); then, from ``cuobjdump``, every kernel
              instantiation's HMMA count, registers and static shared
              memory beside the dynamic shared memory a launch asks for
              (the SSD scan's at the Mamba2 prefill shape): HMMA > 0 in
              every bfloat16 instantiation of flash attention, weighted
              attention and the SSD scan (tensor cores), 0 in every
              float32 one ("not measured" without ``cuobjdump``).
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes (the instruction encoder's passes of
              4096 instructions among them, and, timed beside them, a
              monolithic batch's 32768 in one launch) and the reference
              kernel tests' sweeps,
              in float32 and bfloat16.  Attention: max abs err <= 2e-5 /
              2e-2, exact zeros for a row with no valid key (weighted: all
              weights 0, or zero-weight keys leading every live score by
              ~200, so the row max taken over them underflows every p);
              both also at lengths that are not multiples of 16 or 64,
              every head dim, a whole 64-key tile masked or weighing 0,
              and strided q/k/v views of one fused QKV tensor (100 and 369
              rows); flash at a causal window ending inside a key tile;
              head dim 112 (zero-padded onto the D=128 instantiation) in
              flash, causal or not, and in weighted attention.  SSD scan
              (``SSD_CASES``, many chunks with a ragged last one, S shorter
              than the chunk, P 128 with N 256, the Mamba2 prefill shape, a
              4-chunk state carry, a large-decay case, an all-padding chunk,
              B/C views that break 16-byte alignment): max abs err / max
              |plain| <= 1e-5 / 1e-2 for y, 1e-5 / 1e-4 for the state.
  4. timing   each kernel at its path shapes (the multicore block
              encoder's M=369 among them; CUDA events after warm-up,
              the least of three means of at least 20 back-to-back calls,
              enough to fill ~2 ms for short ones):
              kernel (and, for attention, its device time under
              ``torch.profiler``: the instruction encoder's shape is
              launch-bound, so the event time there is the wrapper's),
              plain version, and, where one PyTorch call computes
              the same function, that call (``scaled_dot_product_attention``
              for attention, timed as a yardstick only — the port never
              calls it; none exists for the SSD scan), beside the least
              time the card could take (bytes at 3.35 TB/s, operations at
              67 TFLOP/s float32 or 989 TFLOP/s bfloat16, the larger); the
              SSD scan's device time per launch of its four kernels.  Then
              each timing gate of this slice, with its verdict: the SSD
              scan's (bf16 <= 2.0 ms, f32 <= 4.5 ms) and weighted
              attention's at U=128 in bf16 (<= 0.10 ms) fail the run; the
              others (weighted bf16 U=64 <= 0.045 ms, weighted f32 below
              the first kernel's times, flash's block-shape device times
              within 5% of the previous body's) are reported.
  5. engine   ``SimulationEngine.run`` at the paper model's full width
              (E=128, 4 heads, 4+4 layers, M=360) with seeded random
              parameters, on the first 3 Table II benchmarks: unfused and
              fused fp32, unfused and fused bf16, the paper model's own
              dtype (kernel launch counters reset just before each run and
              read just after), and one benchmark on the CPU through the
              plain versions.  Checks: both kernels launched, predictions
              finite, fused vs unfused <= 1e-3 relative, card vs CPU <= 1e-4
              relative, equal oracle cycles, each bf16 run within 1% of its
              fp32 twin, and the fused bf16 run's launch counts equal to
              the fused fp32 run's.
  6. multicore ``run_multicore`` at the same width on the multicore suite
              (mt.stream, mt.chase, mt.counter, mt.mix, each on 4 cores;
              context width M=369), one checkpoint each, batch 256:
              unfused and fused in fp32 and bf16 (counters reset before
              each run and read after).  Per run: clips, wall seconds and
              clips/s, predict seconds, batches and pad rows, the launches
              of each kernel (flash > 0 in every run, weighted > 0 exactly
              in the fused ones), per core predicted and oracle cycles;
              the U of every fused batch.  Checks: clips conserved (the
              cores' sum is the predictor's count), fused vs unfused
              <= 1e-3 in fp32, bf16 vs fp32 <= 1% (unfused and fused), card vs CPU (mt.stream)
              <= 1e-4 per core with equal oracle cycles.  Then the weighted
              kernel at each U the fused step reached (self weighted by
              multiplicities summing to 369, cross to 128) against its
              plain version, and timed like phase 4.
  7. rt-store ``rt_store_dir`` in a temporary directory under ``build/``:
              a cold multicore run persists, a restart loads the table
              (rows loaded > 0, none encoded), the tables are bit-exact and
              the restart's per-core predictions bitwise the cold run's,
              in fp32 and in bf16; a store the CPU path wrote into the
              same directory is not adopted by the card, which adopts its
              own (the key names framework and device).
  8. sampling ``EngineConfig.sampling`` (the analytical-ML fusion path) at
              the same width in fp32, batch 256, the README's settings
              (fraction 0.08, 4 strata, 2 clips a stratum at least, 200
              bootstrap resamples): the first 3 Table II benchmarks at up
              to 6 checkpoints (502.gcc has 1; 2600 clips) and the
              multicore suite (3200 clips).  Checks: fraction=1.0 bitwise
              the unsampled card run (single-core unfused and fused, and
              per core), the sampled estimate inside its CI, and on the CPU
              for one benchmark the same sample and estimate and CI within
              1e-4.  Reported per benchmark: clips predicted and
              extrapolated, the CI, the error against the unsampled total,
              and clips/s of both runs.
  9. service  ``SimulationService`` at the same width (the fp32 reference,
              batch 256) over ``build_dataset``'s clips of the first 3
              Table II benchmarks (4 checkpoints, every sliced clip kept)
              in 32 requests, after ``prewarm``.  Healthy burst: every
              ticket ok at fused_int8, clips/s and p50/p99 latency, each
              rung's spot check (64 clips) against the monolithic fp32
              reference within the service's own per-clip tolerance
              (fused_int8 5%, fused 1e-3, rt 1e-6: C2), with the int8
              total reported and held to the port's CPU int8 path
              within 1e-4.
              Chaos (nan_output 0.1, device_error 0.05, slow_flush 0.05,
              watchdog 1 s, one request at a time): every ticket typed, at
              least one demotion, re-promotion and abandoned flush thread
              (all joined after), every served total within its rung's gate
              against a monolithic fp32 replay.  Store: a corrupt read
              cold-encodes to bitwise the same totals, and a crashed
              persist leaves the previous generation loadable and
              bit-exact.  Then the weighted kernel at each U the healthy
              run's fused batches reached (self weighted by multiplicities
              summing to 360), checked and timed like phase 4.
 10. mamba2   the LM zoo's Mamba2-780m at full width (48 layers, d_model
              1536, 48 SSD heads x 64, d_state 128, vocab 50280 padded to
              50288), seeded random parameters: ``generate`` over B=4
              prompts of 4096 tokens + 16 greedy decode steps, in float32
              (TF32 off) and with the parameters in bfloat16 (every launch
              counter reset just before the two runs and read just after:
              48 SSD launches per prefill).  Checks: finite logits, no
              padded token id, card vs CPU on a 2-layer full-width model
              (prompt 511 + 2 decode steps) <= 1e-4 relative, prefill(511)
              + one decode step == prefill(512)'s last row <= 1e-4
              relative; the bf16 vs f32 logits gap, the peak memory of each
              run, and, under ``torch.profiler``, the device-busy time,
              idle share and top kernels of one prefill and one decode step
              in each dtype are reported.
 11. mamba2 bf16 gate: 12 layers at full width, the same seeded bf16
              parameters on the card and through the port's CPU bf16 path,
              a prefill of 2 x 300 tokens: the last row's logits card vs
              CPU within half of the port's bf16-vs-f32 gap (on the CPU),
              and each layer fed the CPU's input within 1e-3.

The line before the last is the card's name and power limit from
nvidia-smi; before it, one JSON object ``{"kernels": [...]}`` (the
attention entries also carry their main shape's bfloat16 numbers as
``*_bf16``).  The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
BENCHMARKS = 3
MULTICORE_CORES, MULTICORE_INTERVAL = 4, 20_000
F32_TOL, BF16_TOL = 2e-5, 2e-2
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
SSD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the final state: in bf16 the operands formed in f32 enter the products
# as hi and lo halves, so the state keeps f32 accuracy (y is rounded to
# bf16 on both sides, so its max error is a bf16 ulp at the largest |y|)
SSD_STATE_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
MAMBA2_BATCH, MAMBA2_PROMPT, MAMBA2_DECODE = 4, 4096, 16
MAMBA2_GATE_LAYERS, MAMBA2_GATE_BATCH, MAMBA2_GATE_PROMPT = 12, 2, 300
# this slice's timing gates (ms, NVIDIA H100 80GB HBM3 at 700 W): the
# weighted-attention kernel's first body (float32: below its times), the
# flash body's block-shape device times (within 5%), the SSD scan's
WA_BF16_GATE = {"fused_self_u64": 0.045, "fused_self_u128": 0.10,
                "fused_cross_u128": 0.10}
WA_F32_FIRST = {"fused_self_u64": 0.0868, "fused_self_u128": 0.2223,
                "fused_cross_u128": 0.2201}
FLASH_DEVICE_BEFORE = {("block_self", "bfloat16"): 0.1335,
                       ("block_cross", "bfloat16"): 0.0671,
                       ("block_self", "float32"): 0.6397,
                       ("block_cross", "float32"): 0.2448}
SSD_GATE = {"bfloat16": 2.0, "float32": 4.5}
# the sampled simulation: the README's CLI settings; Table II gives the
# first two single-core benchmarks >= 6 checkpoints and 502.gcc one
SAMPLING = dict(fraction=0.08, strata=4, min_clips_per_stratum=2,
                bootstrap_resamples=200)
SAMPLING_CHECKPOINTS = 6
# the service: requests; each rung's gate against the monolithic fp32
# reference, per clip (the service's spot-check measure and its own
# tolerances: fused_int8 5%, fused 1e-3, rt 1e-6, with monolithic held to
# rt's); the int8 rung is also held to the port's CPU int8 path; the
# chaos run's faults
SERVICE_REQUESTS, SERVICE_CHECKPOINTS = 32, 4
SERVICE_GATES = {"fused_int8": 0.05, "fused": 1e-3, "rt": 1e-6,
                 "monolithic": 1e-6}
CHAOS_FAULTS = {"nan_output": 0.1, "device_error": 0.05, "slow_flush": 0.05}
CHAOS_SEED = 1


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3,
            rounds: int = 3, window_ms: float = 2.0) -> float:
    """ms per call: CUDA events around back-to-back calls after
    ``warmup``, the least mean of ``rounds`` such runs.  A run makes at
    least ``iters`` calls and, for short calls, enough to fill about
    ``window_ms`` (at most 500), so that the start of a run after a
    synchronisation does not weigh on a call of a few microseconds.
    Where a call's host time exceeds its device time (a launch-bound
    shape), this is the host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once_ms = 1e3 * (time.perf_counter() - t0)
    iters = max(iters, min(500, math.ceil(window_ms / max(once_ms, 1e-3))))
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of one launch of the port's own kernel (names in
    the ``capsim_*`` namespaces; ``fn`` launches one), from
    ``torch.profiler``, averaged over the launches it recorded: at a
    launch-bound shape the host clock of ``cuda_ms`` times the wrapper,
    this the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a capture that records no device event at all is the profiler's
    # fault, not the kernel's: take another, at most twice
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ours = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "capsim" in e.key]
        launches = sum(e.count for e in ours)
        if launches:
            break
        print("device_ms: the profiler recorded no kernel of the port; "
              "capturing again")
    require(launches > 0, "the profiler saw no kernel of the port")
    return sum(e.self_device_time_total for e in ours) / launches / 1e3


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


KERNEL_NAMES = r"(ssd_chunk_state|ssd_chunk_out|ssd_state_pass|ssd_cb|" \
    r"fa_fwd_bf16|fa_fwd_f32)"


def kernel_label(mangled: str):
    """(label, dtype or None, template ints) of a port kernel's mangled
    name, e.g. ("ssd_chunk_out<bf16, 64>", "bf16", [64])."""
    kind = re.search(KERNEL_NAMES, mangled)
    if kind is None:
        return None
    name = kind.group(1)
    dtype = ("bf16" if "13__nv_bfloat16" in mangled or name == "fa_fwd_bf16"
             else "f32" if name == "fa_fwd_f32" or re.search(
                 r"\d" + name + r"If", mangled) else None)
    ints = [int(v) for v in re.findall(r"Li(\d+)E", mangled)]
    flags = re.findall(r"Lb([01])E", mangled)
    args = ([dtype] if name.startswith("ssd") and dtype else []) + \
        [str(v) for v in ints] + \
        [{"0": "flash", "1": "weighted"}[f] for f in flags]
    return f"{name}<{', '.join(args)}>" if args else name, dtype, ints


def sass_pipes(torch, build, fa_ops, ssd_ops):
    """Each kernel instantiation's HMMA count (``cuobjdump -sass``),
    registers and static shared memory (``-res-usage``), and the dynamic
    shared memory a launch asks for (the SSD scan's at the Mamba2 prefill
    shape).  bfloat16 must run on the tensor cores (HMMA > 0), float32 on
    the FMA pipes (HMMA == 0)."""
    if build.cuobjdump() is None:
        print("sass: cuobjdump not found; HMMA counts and static shared "
              "memory not measured")
        return
    _, _, _, P, N, q, _, _ = SSD_PATH[1:]
    ssd_smem = {dt: ssd_ops.shared_bytes(getattr(torch, name), P, N, q)
                for dt, name in (("f32", "float32"), ("bf16", "bfloat16"))}
    ssd_slot = {"ssd_cb": 0, "ssd_chunk_state": 1, "ssd_state_pass": 2,
                "ssd_chunk_out": 3}
    for lib in ("flash_attention", "weighted_attention", "ssd"):
        path = build.library_path(lib)
        hmma = {k: v["HMMA"] for k, v in build.sass_opcodes(path).items()}
        usage = build.resource_usage(path)
        seen = set()
        for name, count in sorted(hmma.items()):
            found = kernel_label(name)
            if found is None:
                continue
            label, dtype, ints = found
            regs, static = usage.get(name, ("not measured", "not measured"))
            base = label.split("<")[0]
            if base.startswith("fa_fwd"):
                tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
                dyn = fa_ops.shared_bytes(tdt, ints[0])
                seen.add((dtype, ints[0]))
            elif base == "ssd_state_pass":
                dyn = 0
            elif not ints or ints[0] == P:
                dyn = ssd_smem[dtype][ssd_slot[base]]
            else:
                dyn = "- (not at the path shape)"
            seen.add(label)
            print(f"sass {lib} {label}: HMMA {count}, registers {regs}, "
                  f"static shared {static} B, dynamic shared {dyn} B")
            if dtype == "bf16":
                require(count > 0, f"{lib} {label} has no HMMA: not on the "
                        "tensor cores")
            else:
                require(count == 0, f"{lib} {label} has {count} HMMA: f32 "
                        "must stay on the FMA pipes")
        if lib != "ssd":
            want = {(k, d) for k in ("bf16", "f32") for d in fa_ops.HEAD_DIMS}
            require(want <= seen, f"{lib} instantiations in the SASS: "
                    f"{sorted(x for x in seen if isinstance(x, tuple))}")
            flag = "weighted" if lib == "weighted_attention" else "flash"
            require(all(flag in x for x in seen if isinstance(x, str)),
                    f"{lib} holds the other attention variant")
        else:
            require(any("ssd_chunk_out<bf16" in x for x in seen)
                    and any("ssd_chunk_out<f32" in x for x in seen),
                    "ssd: both dtypes' instantiations in the SASS")


# --------------------------------------------------------------------- #
# kernel cases
# --------------------------------------------------------------------- #

# (label, B, Sq, Skv, H, D, causal, window, mask): the main path's shapes
# at the paper's width (H=4, D=32, batch 256, M=360, L_clip=128, encode
# passes of 32-64 static rows x L_token=16), then the reference kernel
# tests' sweep (tests/test_kernels.py FA_CASES), then a row with no key
FA_PATH = [
    ("inst_encoder", 64, 16, 16, 4, 32, False, 0, "tokens"),
    # since the C2 repair the card runs the instruction encoder in passes
    # of exactly predictor.ENCODE_CHUNK = 4096 instructions: the RT
    # build's and the monolithic rung's shape
    ("inst_encoder_4096", 4096, 16, 16, 4, 32, False, 0, "tokens"),
    # a monolithic batch's instruction rows (256 x 128) in one launch,
    # the shape before the C2 repair, timed beside the passes
    ("inst_encoder_32768", 32768, 16, 16, 4, 32, False, 0, "tokens"),
    ("block_self", 256, 360, 360, 4, 32, False, 0, None),
    ("block_cross", 256, 360, 128, 4, 32, False, 0, "clip"),
    # the multicore path: each core's context carries its core-id channel,
    # M = 369 (369 mod 64 = 49 keys in the last tile)
    ("block_self_m369", 256, 369, 369, 4, 32, False, 0, None),
    ("block_cross_m369", 256, 369, 128, 4, 32, False, 0, "clip"),
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
    # the tiled kernel's edges: 16-row query blocks and 64-key tiles that
    # end mid-block, a causal window that ends inside a key tile, a mask
    # that empties one whole key tile while the others stay live, and
    # every head dim in both dtypes
    ("q1_kv257", 2, 1, 257, 4, 32, False, 0, "random"),
    ("q17_kv257", 2, 17, 257, 4, 32, True, 0, "random"),
    ("q17_kv257", 1, 17, 257, 2, 16, False, 0, None),
    ("q100_kv257", 2, 100, 257, 2, 64, True, 0, None),
    ("q100_kv257", 1, 100, 257, 2, 128, False, 0, "random"),
    ("window_in_tile", 2, 100, 257, 2, 32, True, 40, None),
    ("window_in_tile", 1, 33, 257, 2, 128, True, 50, "random"),
    ("empty_key_tile", 2, 100, 257, 2, 32, False, 0, "empty_tile"),
    ("empty_key_tile", 2, 70, 200, 2, 16, False, 0, "empty_tile"),
    ("empty_key_tile", 2, 40, 300, 2, 64, True, 0, "empty_tile"),
    # head_dim 112 runs zero-padded on the D=128 instantiation
    ("d112", 2, 100, 257, 2, 112, False, 0, "random"),
    ("d112_causal", 2, 100, 257, 2, 112, True, 0, None),
    ("d112_window", 1, 33, 257, 2, 112, True, 50, "random"),
]
# (label, B, Sq, Skv, H, D, weights): fused self over U deduped tokens (U
# from the dedup ladder, weights = multiplicities with zero-weight padding
# slots), fused cross from U to L_clip=128 (weights = clip_mask)
WA_PATH = [
    ("fused_self_u64", 256, 64, 64, 4, 32, "counts"),
    ("fused_self_u128", 256, 128, 128, 4, 32, "counts"),
    ("fused_cross_u128", 256, 128, 128, 4, 32, "clip"),
]
# the tiled kernel's edges: U not a multiple of 16 or 64, every head dim,
# a whole 64-key tile of zero weights, and zero-weight keys that lead
# every live score (the row max runs over them: by ~200 in batch row 0,
# which must then be zeros)
WA_EDGE = [
    ("zero_weight_keys", 8, 48, 48, 4, 32, "counts"),
    ("all_zero_row", 8, 32, 32, 4, 32, "empty_row"),
    ("u1", 4, 1, 1, 4, 32, "counts"),
    ("u17_d16", 4, 17, 17, 4, 16, "counts"),
    ("u65_d64", 4, 65, 65, 2, 64, "counts"),
    ("u257_d128", 2, 257, 257, 2, 128, "counts"),
    ("empty_key_tile", 4, 100, 200, 2, 32, "counts_empty_tile"),
    ("max_at_zero", 4, 40, 70, 2, 32, "max_at_zero"),
    ("u100_d112", 4, 100, 100, 2, 112, "counts"),
    ("u257_d112", 2, 257, 257, 2, 112, "counts_empty_tile"),
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
    elif kind in ("random", "empty_tile"):
        w = (torch.rand(B, Skv, generator=gen) > 0.3).float()
        w[:, 0] = 1.0
        if kind == "empty_tile":          # keys 64-127: one whole tile
            w[:, 64:128] = 0.0
    elif kind in ("counts", "counts_empty_tile", "max_at_zero"):
        # multiplicities + zero padding
        w = torch.randint(1, 9, (B, Skv), generator=gen).float()
        n = torch.randint(Skv // 2, Skv + 1, (B,), generator=gen)
        w = w * (torch.arange(Skv)[None] < n[:, None])
        if kind == "counts_empty_tile":   # keys 64-127: one whole tile
            w[:, 64:128] = 0.0
        if kind == "max_at_zero":         # every fourth key weighs 0
            w[:, torch.arange(Skv) % 4 == 1] = 0.0
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
        for (label, B, Sq, Skv, H, D, kind) in WA_PATH + WA_EDGE:
            q, k, v = make_qkv(torch, gen, B, Sq, Skv, H, D, tdt)
            w = make_aux(torch, gen, kind, B, Skv)
            if kind == "max_at_zero":     # zero-weight keys lead the scores
                zero = (torch.arange(Skv) % 4 == 1).to(w.device)
                q[..., 0] = q[..., 0].abs() + 1.0
                k[:, zero, :, 0] = 5.0 * math.sqrt(D)
                k[0, zero, :, 0] = 200.0 * math.sqrt(D)
            out = wa_ops.weighted_attention(q, k, v, w)
            ref = wa_ops.weighted_attention_plain(q, k, v, w)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            print(f"kernel weighted_attention {label:16s} {dtype:8s} "
                  f"B={B} Sq={Sq} Skv={Skv} H={H} D={D} weights={kind} "
                  f"max_abs_err={err:.3e}")
            require(err <= tol,
                    f"weighted_attention {label} {dtype} err {err}")
            if kind in ("empty_row", "max_at_zero"):
                require(float(out[0].float().abs().max()) == 0.0,
                        f"weighted_attention {label}: batch row 0 must "
                        "output zeros")
            if kind == "max_at_zero":
                require(float(out[1:].float().abs().max()) > 0.0,
                        "weighted_attention max_at_zero: rows 1.. are live")
            worst = max(worst, err)
        errs["weighted_attention"][dtype] = worst
    # the fused step hands the weighted kernel strided q/k/v views of one
    # QKV matmul; flash attention gets the same kind of views; both dtypes,
    # every tile edge: 100 rows over 100 keys (ragged 16-row and 64-key
    # tiles)
    for dtype in ("float32", "bfloat16"):
        qkv = torch.randn(8, 100, 384, generator=gen).to("cuda",
                                                         getattr(torch, dtype))
        q, k, v = (x.unflatten(-1, (4, 32)) for x in qkv.split(128, dim=-1))
        w = make_aux(torch, gen, "counts", 8, 100)
        err = float((wa_ops.weighted_attention(q, k, v, w).float()
                     - wa_ops.weighted_attention_plain(q, k, v, w).float())
                    .abs().max())
        print(f"kernel weighted_attention strided_qkv      {dtype:8s} "
              f"B=8 Sq=Skv=100 H=4 D=32 weights=counts max_abs_err="
              f"{err:.3e}")
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        require(err <= tol, f"weighted_attention strided views {dtype} "
                f"err {err}")
        errs["weighted_attention"][dtype] = max(
            errs["weighted_attention"][dtype], err)
    # (and at the multicore context width, 369 rows)
    for dtype, S in (("float32", 100), ("bfloat16", 100), ("float32", 369),
                     ("bfloat16", 369)):
        qkv = torch.randn(8, S, 384, generator=gen).to("cuda",
                                                       getattr(torch, dtype))
        q, k, v = (x.unflatten(-1, (4, 32)) for x in qkv.split(128, dim=-1))
        m = make_aux(torch, gen, "random", 8, S)
        for causal in (False, True):
            out = fa_ops.flash_attention(q, k, v, causal=causal, kv_mask=m)
            ref = fa_ops.flash_attention_plain(q, k, v, causal=causal,
                                               kv_mask=m)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            print(f"kernel flash_attention strided_qkv      {dtype:8s} "
                  f"B=8 Sq=Skv={S} H=4 D=32 causal={causal} mask=random "
                  f"max_abs_err={err:.3e}")
            tol = F32_TOL if dtype == "float32" else BF16_TOL
            require(err <= tol, f"flash_attention strided views {dtype} "
                    f"err {err}")
            errs["flash_attention"][dtype] = max(
                errs["flash_attention"][dtype], err)
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
                "device_ms": device_ms(torch, lambda: fa_ops.flash_attention(
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
        for (label, B, Sq, Skv, _, _, kind) in WA_PATH:
            q, k, v = make_qkv(torch, gen, B, Sq, Skv, 4, 32, tdt)
            w = make_aux(torch, gen, kind, B, Skv)
            qt, kt, vt = sdpa_inputs(q, k, v)
            # softmax(s + log w) == w·e^s / Σ w·e^s: the same function
            log_w = torch.log(w)[:, None, None, :].to(tdt)
            row = {
                "shape": label, "dtype": dtype,
                "ms": cuda_ms(torch, lambda: wa_ops.weighted_attention(
                    q, k, v, w)),
                "device_ms": device_ms(torch, lambda:
                                       wa_ops.weighted_attention(q, k, v, w)),
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
                  f"kernel_ms={r['ms']:.4f} "
                  f"device_ms={r['device_ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                  f"bound_share={r['bound_ms'] / r['ms']:.3f}")
    return rows


def gate(what: str, value: float, limit: float, enforced: bool) -> None:
    """Print a timing gate's verdict; an enforced gate that is missed
    fails the run."""
    ok = value <= limit
    print(f"gate {what}: {value:.4f} ms <= {limit:.4f} ms "
          f"{'met' if ok else 'MISSED'}"
          f"{'' if enforced else ' (reported, not enforced)'}")
    if enforced:
        require(ok, f"timing gate {what}: {value} > {limit}")


def check_gates(rows) -> None:
    """This slice's timing gates on the rows of time_kernels/time_ssd."""
    for r in rows["weighted_attention"]:
        if r["dtype"] == "bfloat16":
            limit = WA_BF16_GATE[r["shape"]]
            gate(f"weighted {r['shape']} bf16 kernel_ms", r["ms"], limit,
                 limit >= 0.10)
        else:
            gate(f"weighted {r['shape']} f32 kernel_ms below the first "
                 "body's", r["ms"], WA_F32_FIRST[r["shape"]], False)
    for r in rows["flash_attention"]:
        before = FLASH_DEVICE_BEFORE.get((r["shape"], r["dtype"]))
        if before is not None:
            gate(f"flash {r['shape']} {r['dtype']} device_ms within 5%",
                 r["device_ms"], 1.05 * before, False)
    for r in rows["ssd"]:
        gate(f"ssd {r['shape']} {r['dtype']} kernel_ms", r["ms"],
             SSD_GATE[r["dtype"]], True)


# --------------------------------------------------------------------- #
# SSD scan
# --------------------------------------------------------------------- #

# (label, Bt, S, H, P, N, chunk, a_scale, pad_chunk): the reference kernel
# tests' sweep (tests/test_kernels.py SSD_CASES: padding S=100, a single
# chunk), the Mamba2-780m prefill shape, a 4-chunk state carry, dt·|A|
# large enough that seg reaches -1e4 (the split exp form gives 0/0), and
# an all-padding chunk (dt = x = B = C = 0 over the second chunk)
SSD_PATH = ("mamba2_prefill", 4, 4096, 48, 64, 128, 256, 1.0, False)
SSD_CHECKS = [
    ("sweep", 2, 64, 4, 32, 64, 16, 1.0, False),
    ("sweep", 1, 128, 2, 64, 128, 64, 1.0, False),
    ("sweep_padding", 2, 100, 3, 16, 32, 32, 1.0, False),
    ("sweep_one_chunk", 1, 256, 8, 64, 128, 256, 1.0, False),
    SSD_PATH,
    ("state_carry", 2, 1024, 8, 64, 128, 256, 1.0, False),
    ("large_decay", 2, 300, 4, 64, 128, 256, 60.0, False),
    ("padding_chunk", 1, 512, 4, 64, 128, 256, 1.0, True),
    # the chunk-parallel kernel's edges: many chunks with a ragged last
    # one, S shorter than the chunk, the widest head and state, and B/C
    # views one element off 16 bytes (the plain-copy path)
    ("many_chunks_ragged", 1, 5 * 64 + 17, 2, 32, 64, 64, 1.0, False),
    ("s_below_chunk", 2, 40, 3, 16, 32, 64, 1.0, False),
    ("p128_n256", 1, 128, 2, 128, 256, 64, 1.0, False),
    ("unaligned_bc", 2, 300, 4, 64, 20, 128, 1.0, False),
]


def ssd_inputs(torch, gen, Bt, S, H, P, N, dtype, a_scale=1.0,
               pad_chunk=0):
    """x, dt, B, C, A on the card, drawn as the reference tests draw
    them; ``pad_chunk`` > 0 zeroes every step from that index on."""
    x = torch.randn(Bt, S, H, P, generator=gen) * 0.5
    dt = torch.randn(Bt, S, H, generator=gen).abs() * 0.4 + 0.01
    B = torch.randn(Bt, S, N, generator=gen) * 0.3
    C = torch.randn(Bt, S, N, generator=gen) * 0.3
    A = (-torch.randn(H, generator=gen).abs() - 0.1) * a_scale
    if pad_chunk:
        for t in (x, dt, B, C):
            t[:, pad_chunk:] = 0.0
    return (x.to("cuda", dtype), dt.cuda(), B.to("cuda", dtype),
            C.to("cuda", dtype), A.cuda())


def rel_err(out, ref) -> float:
    """max |out - ref| / max |ref|."""
    return float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def check_ssd(torch, ssd_ops):
    """Every SSD case, both dtypes, kernel vs plain version on the card.
    Returns {dtype: max abs err over the cases}."""
    gen = torch.Generator().manual_seed(2)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        worst = 0.0
        for (label, Bt, S, H, P, N, q, a_scale, pad) in SSD_CHECKS:
            args = ssd_inputs(torch, gen, Bt, S, H, P, N, tdt, a_scale,
                              q if pad else 0)
            if label == "unaligned_bc":   # rows N + 1 apart, one element in
                x, dt, B, C, A = args
                B, C = (torch.nn.functional.pad(t, (1, 0))[..., 1:]
                        for t in (B, C))
                args = (x, dt, B, C, A)
            y, st = ssd_ops.ssd_scan(*args, chunk=q)
            yp, sp = ssd_ops.ssd_scan_plain(*args, chunk=q)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(y.float()).all()
                         and torch.isfinite(st).all()),
                    f"ssd {label} {dtype}: non-finite output")
            ey, es = rel_err(y, yp), rel_err(st, sp)
            abs_err = float(max((y.float() - yp.float()).abs().max(),
                                (st - sp).abs().max()))
            extra = ""
            if label == "state_carry":     # one 1024-step chunk, same state
                _, st1 = ssd_ops.ssd_scan(*args, chunk=S)
                torch.cuda.synchronize()
                extra = f" vs_one_chunk_state={rel_err(st1, st):.3e}"
                require(rel_err(st1, st) <= SSD_TOL[dtype],
                        f"ssd state carry {dtype}: chunked vs one chunk")
            if label == "padding_chunk":   # the empty chunk leaves the state
                _, st1 = ssd_ops.ssd_scan(*(a[:, :q] if a.dim() > 1 else a
                                            for a in args), chunk=q)
                torch.cuda.synchronize()
                require(torch.equal(st1, st), f"ssd {dtype}: an all-padding "
                        "chunk changed the state")
            print(f"kernel ssd {label:16s} {dtype:8s} Bt={Bt} S={S} H={H} "
                  f"P={P} N={N} chunk={q} A_scale={a_scale} rel_err_y="
                  f"{ey:.3e} rel_err_state={es:.3e} max_abs_err="
                  f"{abs_err:.3e}{extra}")
            require(ey <= SSD_TOL[dtype] and es <= SSD_STATE_TOL[dtype],
                    f"ssd {label} {dtype}: rel err y {ey} state {es}")
            worst = max(worst, abs_err)
        errs[dtype] = worst
    return errs


def ssd_bound(Bt, S, H, P, N, q, dtype: str):
    """(ms, "bytes"|"operations") for the work the function needs.  Per
    chunk of L real steps (the last one ragged) and batch row, C·Bᵀ over
    the causal half once, L(L+1)/2 pairs of N MACs, since B and C are
    shared by every head; per head the decayed causal product with x·dt,
    L(L+1)/2 pairs of P MACs, and L·N·P MACs each for the carried state's
    output and the state update.  Bytes: x read and y written, B/C, dt
    and A read, the f32 state written once."""
    elem = 4 if dtype == "float32" else 2
    lens = [min(q, S - t) for t in range(0, S, q)]
    flops = float(Bt) * sum(L * (L + 1) * N for L in lens) \
        + float(Bt * H) * sum(L * (L + 1) * P + 4 * L * N * P for L in lens)
    nbytes = (2 * Bt * S * H * P + 2 * Bt * S * N) * elem \
        + 4 * (Bt * S * H + H + Bt * H * P * N)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_breakdown(torch, fn, iters: int = 5):
    """Device ms per call of each port kernel ``fn`` launches (names in
    the ``capsim_*`` namespaces), from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a capture that records no device event at all is the profiler's
    # fault, not the kernels': take another, at most twice (as device_ms)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and "capsim" in e.key:
                name = re.sub(r"\(capsim_ssd::Args.*", "", e.key)
                out[name.replace("capsim_ssd::", "").replace("void ", "")] \
                    = e.self_device_time_total / iters / 1e3
        if out:
            break
        print("device_breakdown: the profiler recorded no kernel of the "
              "port; capturing again")
    require(bool(out), "the profiler saw no kernel of the port")
    return out


def time_ssd(torch, ssd_ops):
    """Kernel / plain times at the Mamba2 prefill shape, both dtypes."""
    gen = torch.Generator().manual_seed(3)
    label, Bt, S, H, P, N, q, _, _ = SSD_PATH
    rows = []
    for dtype in ("float32", "bfloat16"):
        args = ssd_inputs(torch, gen, Bt, S, H, P, N, getattr(torch, dtype))
        row = {"shape": label, "dtype": dtype,
               "ms": cuda_ms(torch, lambda: ssd_ops.ssd_scan(*args, chunk=q),
                             iters=10, warmup=2),
               "plain_ms": cuda_ms(torch, lambda: ssd_ops.ssd_scan_plain(
                   *args, chunk=q), iters=3, warmup=1, rounds=1),
               "library_ms": None}
        parts = device_breakdown(torch, lambda: ssd_ops.ssd_scan(*args,
                                                                chunk=q))
        row["device_ms"] = sum(parts.values())
        row["bound_ms"], row["bound_by"] = ssd_bound(Bt, S, H, P, N, q,
                                                     dtype)
        rows.append(row)
        print(f"time ssd {label:16s} {dtype:8s} kernel_ms={row['ms']:.4f} "
              f"device_ms={row['device_ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms=none "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"bound_share={row['bound_ms'] / row['ms']:.4f}; device ms "
              "per kernel: " + "; ".join(f"{k} {v:.4f}"
                                         for k, v in parts.items()))
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

    # bf16, the paper model's own dtype: unfused (flash) and fused (the
    # weighted kernel's bf16 instantiation on the engine path)
    for fused in (False, True):
        fa_ops.flash_attention.launches = 0
        wa_ops.weighted_attention.launches = 0
        bf16, wall, eng = run_engine(
            torch, params, cfg, vocab, names,
            base.replace(precision="bf16", fused_serving=fused))
        counts = (fa_ops.flash_attention.launches,
                  wa_ops.weighted_attention.launches)
        st = eng.last_stats
        n_clips = sum(r.n_clips for r in bf16)
        print(f"engine fused={fused} bf16: {n_clips} clips in {wall:.3f} s "
              f"= {n_clips / wall:.1f} clips/s (host front-end and oracle "
              f"included); predict {st.predict_seconds:.3f} s, "
              f"{st.n_batches} batches, {st.n_pad} pad rows; launches "
              f"flash={counts[0]} weighted={counts[1]}")
        require(counts[0] > 0, f"bf16 fused={fused} run launched no flash "
                "kernel")
        if fused:
            require(counts == launches[True], f"fused bf16 launches {counts}"
                    f" != fused fp32 launches {launches[True]}")
        for a, b in zip(runs[fused], bf16):
            rel = abs(b.predicted_cycles - a.predicted_cycles) \
                / abs(a.predicted_cycles)
            print(f"bf16 vs fp32 fused={fused} {a.name}: rel {rel:.3e}")
            require(a.oracle_cycles == b.oracle_cycles,
                    "oracle cycles differ")
            require(rel <= 1e-2, f"bf16 vs fp32 fused={fused} {a.name} "
                    f"rel {rel}")

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


# --------------------------------------------------------------------- #
# multicore engine and the persistent RT store
# --------------------------------------------------------------------- #

def run_multicore(torch, params, cfg, vocab, mbenches, config,
                  device="cuda"):
    from repro_torch.core.engine import SimulationEngine
    engine = SimulationEngine.from_config(params, cfg, vocab, config,
                                          device=device)
    t0 = time.perf_counter()
    results = engine.run_multicore(mbenches)
    if device == "cuda":
        torch.cuda.synchronize()
    return results, time.perf_counter() - t0, engine


def print_multicore(what, results, wall, engine, counts) -> None:
    st, rt = engine.last_stats, engine.last_rt_stats
    n_clips = sum(r.n_clips for r in results)
    print(f"multicore {what}: {n_clips} clips in {wall:.3f} s = "
          f"{n_clips / wall:.1f} clips/s (host front-end and oracle "
          f"included); predict {st.predict_seconds:.3f} s, {st.n_batches} "
          f"batches, {st.n_pad} pad rows; rt {rt.n_rows_encoded} rows "
          f"encoded, {rt.n_rows_loaded} loaded; launches flash={counts[0]} "
          f"weighted={counts[1]}")
    for r in results:
        for c in r.cores:
            print(f"  {c.name:16s} clips={c.n_clips} predicted="
                  f"{c.predicted_cycles!r} oracle={c.oracle_cycles!r}")
    require(sum(c.n_clips for r in results for c in r.cores)
            == st.n_predicted == st.n_clips,
            f"multicore {what}: clips not conserved")
    require(all(math.isfinite(c.predicted_cycles) and c.n_clips > 0
                for r in results for c in r.cores),
            f"multicore {what}: a core has no clips or a non-finite "
            "prediction")


def per_core_rel(a_results, b_results, what: str, tol: float) -> float:
    """max over cores of |b - a| / |a|; checks that the cores, their
    clips and their oracle cycles line up."""
    worst = 0.0
    for a, b in zip(a_results, b_results, strict=True):
        for ca, cb in zip(a.cores, b.cores, strict=True):
            require((ca.name, ca.n_clips) == (cb.name, cb.n_clips),
                    f"{what}: cores differ")
            require(ca.oracle_cycles == cb.oracle_cycles,
                    f"{what}: oracle cycles differ at {ca.name}")
            worst = max(worst, abs(cb.predicted_cycles - ca.predicted_cycles)
                        / abs(ca.predicted_cycles))
    print(f"{what}: max per-core rel {worst:.3e} (limit {tol:g})")
    require(worst <= tol, f"{what}: per-core rel {worst} > {tol}")
    return worst


def check_multicore(torch, fa_ops, wa_ops):
    """The multicore suite (mt.stream, mt.chase, mt.counter, mt.mix, each
    on MULTICORE_CORES cores) through ``run_multicore`` at the paper
    model's full width.  Returns (launches, the weighted kernel's (U,
    rows) seen in the fused runs)."""
    from repro_torch.configs.capsim import config
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.isa import multicore

    cfg = config()
    vocab = std_mod.build_vocab()
    params = predictor.init_params(cfg, seed=0, device="cuda")
    mbenches = multicore.all_multicore_benchmarks(MULTICORE_CORES)
    base = EngineConfig(precision="fp32", interval_size=MULTICORE_INTERVAL,
                        max_checkpoints=1, batch_size=256, with_oracle=True)
    print(f"multicore config: E={cfg.d_model} heads={cfg.num_heads} "
          f"head_dim={cfg.head_dim} M=369 L_clip={base.l_clip} batch="
          f"{base.batch_size} interval={base.interval_size} checkpoints="
          f"{base.max_checkpoints} benchmarks={[m.name for m in mbenches]} "
          f"x{MULTICORE_CORES} cores")
    # the fused step's U per batch, read off the host-side dedup
    seen_u = {}
    dedupe = std_mod.dedupe_context_tokens

    def recording(ctx, *a, **kw):
        uniq, counts = dedupe(ctx, *a, **kw)
        require(ctx.shape[1] == 369, f"a fused batch has M={ctx.shape[1]}")
        seen_u[uniq.shape[1]] = seen_u.get(uniq.shape[1], 0) + 1
        return uniq, counts

    runs, launches = {}, [0, 0]
    for precision in ("fp32", "bf16"):
        for fused in (False, True):
            fa_ops.flash_attention.launches = 0
            wa_ops.weighted_attention.launches = 0
            std_mod.dedupe_context_tokens = recording
            try:
                res, wall, eng = run_multicore(
                    torch, params, cfg, vocab, mbenches,
                    base.replace(precision=precision, fused_serving=fused))
            finally:
                std_mod.dedupe_context_tokens = dedupe
            counts = (fa_ops.flash_attention.launches,
                      wa_ops.weighted_attention.launches)
            if precision == "fp32":
                launches = [launches[0] + counts[0], launches[1] + counts[1]]
            runs[precision, fused] = res
            print_multicore(f"{precision} fused={fused}", res, wall, eng,
                            counts)
            require(counts[0] > 0, f"multicore {precision} fused={fused}: "
                    "no flash launch")
            require((counts[1] > 0) == fused, f"multicore {precision} "
                    f"fused={fused}: weighted launches {counts[1]}")
    print(f"multicore fused batches by U: {dict(sorted(seen_u.items()))}")
    per_core_rel(runs["fp32", False], runs["fp32", True],
                 "multicore fused vs unfused fp32", 1e-3)
    for fused in (False, True):
        per_core_rel(runs["fp32", fused], runs["bf16", fused],
                     f"multicore bf16 vs fp32 fused={fused}", 1e-2)
    # the card's fp32 run against the port's CPU path, one benchmark
    cpu, cpu_wall, _ = run_multicore(torch, params, cfg, vocab,
                                     mbenches[:1], base, device="cpu")
    print(f"multicore CPU plain path: {mbenches[0].name} in {cpu_wall:.1f} s")
    per_core_rel(runs["fp32", False][:1], cpu,
                 f"multicore card vs CPU {mbenches[0].name}", 1e-4)
    return {"flash_attention": launches[0],
            "weighted_attention": launches[1]}, seen_u


def fused_weighted_shapes(torch, wa_ops, seen_u, m_ctx=369, prefix="mc",
                          seed=4):
    """The weighted kernel at each U a fused step reached (batch 256, H4
    D32): self U->U weighted by multiplicities summing to the context
    width ``m_ctx``, cross U->128 weighted by clip_mask; kernel vs plain
    in both dtypes, and the timing rows."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(seed)
    rows, errs = [], {}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        for U in sorted(seen_u):
            for label, Skv in ((f"{prefix}_fused_self_u{U}", U),
                               (f"{prefix}_fused_cross_u{U}", 128)):
                B, H, D = 256, 4, 32
                q, k, v = make_qkv(torch, gen, B, U, Skv, H, D, tdt)
                if Skv == U:      # multiplicities of U slots summing to M
                    n = torch.randint(max(1, U // 2), U + 1, (B,),
                                      generator=gen)
                    w = torch.zeros(B, U)
                    for b in range(B):
                        w[b, :n[b]] = torch.bincount(
                            torch.randint(0, int(n[b]),
                                          (m_ctx - int(n[b]),),
                                          generator=gen),
                            minlength=int(n[b])).float() + 1.0
                    w = w.cuda()
                else:
                    w = make_aux(torch, gen, "clip", B, Skv)
                out = wa_ops.weighted_attention(q, k, v, w)
                ref = wa_ops.weighted_attention_plain(q, k, v, w)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                print(f"kernel weighted_attention {label:16s} {dtype:8s} "
                      f"B={B} Sq={U} Skv={Skv} H={H} D={D} "
                      f"max_abs_err={err:.3e}")
                require(err <= tol, f"weighted_attention {label} {dtype} "
                        f"err {err}")
                errs[dtype] = max(errs.get(dtype, 0.0), err)
                qt, kt, vt = (x.transpose(1, 2).contiguous()
                              for x in (q, k, v))
                log_w = torch.log(w)[:, None, None, :].to(tdt)
                row = {"shape": label, "dtype": dtype,
                       "ms": cuda_ms(torch, lambda: wa_ops.weighted_attention(
                           q, k, v, w)),
                       "device_ms": device_ms(torch, lambda:
                                              wa_ops.weighted_attention(
                                                  q, k, v, w)),
                       "plain_ms": cuda_ms(torch, lambda:
                                           wa_ops.weighted_attention_plain(
                                               q, k, v, w)),
                       "library_ms": cuda_ms(torch, lambda:
                                             F.scaled_dot_product_attention(
                                                 qt, kt, vt, attn_mask=log_w))}
                row["bound_ms"], row["bound_by"] = bound(B, U, Skv, H, D,
                                                         dtype, True)
                rows.append(row)
                print(f"time weighted_attention {label:16s} {dtype:8s} "
                      f"kernel_ms={row['ms']:.4f} "
                      f"device_ms={row['device_ms']:.4f} "
                      f"plain_ms={row['plain_ms']:.4f} "
                      f"library_ms={row['library_ms']:.4f} "
                      f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                      f"bound_share={row['bound_ms'] / row['ms']:.3f}")
    return rows, errs


def check_rt_store(torch):
    """The persistent RT store on the card, through ``rt_store_dir``:
    a run persists, a restart adopts the table (rows loaded, none
    encoded) and reproduces the run bitwise, in fp32 and in bf16 (whose
    table round-trips bit for bit), and a store the CPU path wrote in the
    same directory is not adopted by the card."""
    import shutil
    import tempfile

    from repro_torch.configs.capsim import config
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.core.rt_cache import RTCache
    from repro_torch.isa import multicore

    cfg = config()
    vocab = std_mod.build_vocab()
    params = predictor.init_params(cfg, seed=0, device="cuda")
    mbenches = multicore.all_multicore_benchmarks(MULTICORE_CORES)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    store = Path(tempfile.mkdtemp(prefix="rt_store_", dir=build_dir))
    try:
        for precision in ("fp32", "bf16"):
            ec = EngineConfig(precision=precision,
                              interval_size=MULTICORE_INTERVAL,
                              max_checkpoints=1, batch_size=256,
                              with_oracle=False, rt_store_dir=str(store))
            runs = []
            for attempt in ("cold", "restart"):
                res, wall, eng = run_multicore(torch, params, cfg, vocab,
                                               mbenches, ec)
                rt = eng.last_rt_stats
                table = eng._rt_cache.table[:eng._rt_cache.n_rows]
                runs.append(([c.predicted_cycles for r in res
                              for c in r.cores], rt, table))
                print(f"rt-store {precision} {attempt}: {wall:.3f} s, "
                      f"{rt.n_rows_encoded} rows encoded in "
                      f"{rt.build_seconds:.4f} s, {rt.n_rows_loaded} loaded "
                      f"in {rt.store_load_seconds:.4f} s, table "
                      f"{table.dtype}")
            (p1, rt1, t1), (p2, rt2, t2) = runs
            require(rt1.n_rows_loaded == 0 and rt1.n_rows_encoded > 0,
                    f"rt-store {precision}: the cold run loaded rows")
            require(rt2.n_rows_loaded == rt1.n_rows_encoded > 0
                    and rt2.n_rows_encoded == 0,
                    f"rt-store {precision}: restart loaded "
                    f"{rt2.n_rows_loaded}, encoded {rt2.n_rows_encoded}")
            bits = torch.int16 if t1.dtype == torch.bfloat16 else torch.int32
            require(torch.equal(t1.view(bits), t2.view(bits)),
                    f"rt-store {precision}: the adopted table is not "
                    "bit-exact")
            require(p1 == p2, f"rt-store {precision}: restart predictions "
                    "are not bitwise the cold run's")
            print(f"rt-store {precision}: table {tuple(t1.shape)} "
                  f"{t1.dtype} bit-exact, {len(p1)} per-core predictions "
                  "bitwise equal")
        # a store the port's CPU path writes into the same directory, with
        # the same parameters, config (the bf16 runs' inference config is
        # ``cfg`` itself), l_token and vocab, is not the card's (C1/C2):
        # the card adopts its own bf16 table, the CPU its own rows
        p_cpu = _to(params, "cpu")
        cpu_cache = RTCache(p_cpu, cfg, 16, device="cpu",
                            store_dir=str(store),
                            store_extra=vocab.signature())
        require(cpu_cache.stats.n_rows_loaded == 0,
                "the CPU path adopted a table the card encoded")
        cpu_cache.ensure_rows(mbenches[0].compiled()[0].token_table(vocab,
                                                                    16))
        cpu_cache.persist()
        card = RTCache(params, cfg, 16, device="cuda", store_dir=str(store),
                       store_extra=vocab.signature())
        again = RTCache(p_cpu, cfg, 16, device="cpu", store_dir=str(store),
                        store_extra=vocab.signature())
        print(f"rt-store CPU-written store in the same directory: the card "
              f"loaded {card.stats.n_rows_loaded} rows (its own bf16 "
              f"table: {t1.shape[0]}), the CPU {again.stats.n_rows_loaded} "
              f"(its own: {cpu_cache.n_rows})")
        require(card.stats.n_rows_loaded == t1.shape[0] and torch.equal(
            card.table[:card.n_rows].view(torch.int16), t1.view(torch.int16)),
                "the card did not adopt exactly its own bf16 table")
        require(again.stats.n_rows_loaded == cpu_cache.n_rows,
                "the CPU path did not adopt its own store")
    finally:
        shutil.rmtree(store, ignore_errors=True)


# --------------------------------------------------------------------- #
# sampled simulation (the analytical-ML fusion path)
# --------------------------------------------------------------------- #

def counted(fa_ops, wa_ops, fn):
    """``fn()`` with both attention launch counters set to 0 just before
    and read just after: (its result, (flash, weighted) launches)."""
    fa_ops.flash_attention.launches = 0
    wa_ops.weighted_attention.launches = 0
    out = fn()
    return out, (fa_ops.flash_attention.launches,
                 wa_ops.weighted_attention.launches)


def sampling_config(fraction: float):
    from repro_torch.core.engine_config import SamplingConfig
    return SamplingConfig(**dict(SAMPLING, fraction=fraction))


def check_sampling(torch, fa_ops, wa_ops):
    """``EngineConfig.sampling`` at the paper model's full width, fp32,
    batch 256.  Single-core, the first 3 Table II benchmarks at up to
    SAMPLING_CHECKPOINTS checkpoints (502.gcc has 1): fraction=1.0
    bitwise the unsampled run, unfused and fused; fraction=0.08 reported
    per benchmark (clips predicted / extrapolated, CI, error against the
    unsampled total, clips/s), and on the CPU for one benchmark (the same
    sample, <= 1e-4).  Multicore, the 4 mt benchmarks x 4 cores, one
    checkpoint: fraction=1.0 bitwise per core, fraction=0.08 reported.
    Returns the (flash, weighted) launches of the card runs."""
    from repro_torch.configs.capsim import config
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.isa import multicore, progen

    cfg = config()
    vocab = std_mod.build_vocab()
    names = list(progen.TABLE_II)[:BENCHMARKS]
    params = predictor.init_params(cfg, seed=0, device="cuda")
    base = EngineConfig(precision="fp32", interval_size=20_000,
                        max_checkpoints=SAMPLING_CHECKPOINTS, batch_size=256,
                        with_oracle=False)
    launches = [0, 0]

    def run(what, config, device="cuda", multi=None):
        def go():
            if multi is not None:
                return run_multicore(torch, params, cfg, vocab, multi,
                                     config, device)
            return run_engine(torch, params, cfg, vocab,
                              names if device == "cuda" else names[:1],
                              config, device)
        (res, wall, eng), counts = counted(fa_ops, wa_ops, go)
        st, fe = eng.last_stats, eng.frontend_stats
        n_clips = sum(r.n_clips for r in res)
        n_pred = sum(r.clips_predicted for r in res)
        print(f"sampling {what} on {device}: {n_clips} clips, {n_pred} "
              f"predicted and {n_clips - n_pred} extrapolated, in "
              f"{wall:.3f} s = {n_clips / wall:.1f} clips/s; front-end "
              f"{fe.frontend_seconds:.3f} s (interpret "
              f"{fe.interpret_seconds:.3f}, tokenize "
              f"{fe.tokenize_seconds:.3f}, context "
              f"{fe.context_seconds:.3f}, analytical features "
              f"{fe.analytical_seconds:.3f}); predict "
              f"{st.predict_seconds:.3f} s, {st.n_batches} batches; "
              f"launches flash={counts[0]} weighted={counts[1]}")
        if device == "cuda":
            fused = config.fused_serving
            require(counts[0] > 0 and (counts[1] > 0) == fused,
                    f"sampling {what}: launches {counts}")
            launches[0] += counts[0]
            launches[1] += counts[1]
        require(all(math.isfinite(r.predicted_cycles) for r in res),
                f"sampling {what}: non-finite prediction")
        return res, wall

    print(f"sampling config: E={cfg.d_model} fp32 batch 256, benchmarks "
          f"{names} at up to {SAMPLING_CHECKPOINTS} checkpoints of 20,000 "
          f"instructions; {SAMPLING}")
    full = {}
    for fused in (False, True):
        ec = base.replace(fused_serving=fused)
        full[fused], full_wall = run(f"unsampled fused={fused}", ec)
        one, _ = run(f"fraction=1.0 fused={fused}",
                     ec.replace(sampling=sampling_config(1.0)))
        for a, b in zip(full[fused], one, strict=True):
            require(b.predicted_cycles == a.predicted_cycles
                    and b.clips_extrapolated == 0,
                    f"sampling fraction=1.0 fused={fused} {a.name}: "
                    f"{b.predicted_cycles!r} != {a.predicted_cycles!r}")
        print(f"sampling fraction=1.0 fused={fused}: predicted cycles "
              f"bitwise the unsampled run's for {len(one)} benchmarks")
        if not fused:
            unsampled_wall = full_wall
    sampled, wall = run("fraction=0.08", base.replace(
        sampling=sampling_config(SAMPLING["fraction"])))
    for a, r in zip(full[False], sampled, strict=True):
        lo, hi = r.cycles_ci
        err = (r.predicted_cycles - a.predicted_cycles) / a.predicted_cycles
        print(f"  {r.name:16s} clips={r.n_clips} predicted="
              f"{r.clips_predicted} extrapolated={r.clips_extrapolated} "
              f"estimate={r.predicted_cycles!r} CI=[{lo!r}, {hi!r}] "
              f"(width {(hi - lo) / r.predicted_cycles:.3e}) unsampled="
              f"{a.predicted_cycles!r} error {err:+.3e} unsampled in CI "
              f"{lo <= a.predicted_cycles <= hi}")
        require(0 < r.clips_predicted < r.n_clips and lo <= r.predicted_cycles
                <= hi, f"sampling {r.name}: report {r.cycles_ci}")
    n_clips = sum(r.n_clips for r in sampled)
    print(f"sampling fraction=0.08: {n_clips / wall:.1f} clips/s against "
          f"the unsampled run's {n_clips / unsampled_wall:.1f}")
    cpu, _ = run("fraction=0.08", base.replace(
        sampling=sampling_config(SAMPLING["fraction"])), device="cpu")
    a, b = sampled[0], cpu[0]
    require(bool((a.clip_provenance == b.clip_provenance).all()),
            f"sampling card vs CPU {a.name}: different samples")
    rel = max(abs(y - x) / abs(x) for x, y in
              zip((a.predicted_cycles, *a.cycles_ci),
                  (b.predicted_cycles, *b.cycles_ci)))
    print(f"sampling card vs CPU {a.name}: the same {a.clips_predicted} "
          f"clips sampled; estimate and CI rel {rel:.3e} (limit 1e-4)")
    require(rel <= 1e-4, f"sampling card vs CPU rel {rel}")

    mbenches = multicore.all_multicore_benchmarks(MULTICORE_CORES)
    mbase = base.replace(interval_size=MULTICORE_INTERVAL, max_checkpoints=1)
    mfull, mwall = run("multicore unsampled", mbase, multi=mbenches)
    mone, _ = run("multicore fraction=1.0",
                  mbase.replace(sampling=sampling_config(1.0)),
                  multi=mbenches)
    for a, b in zip(mfull, mone, strict=True):
        for ca, cb in zip(a.cores, b.cores, strict=True):
            require(cb.predicted_cycles == ca.predicted_cycles,
                    f"sampling multicore fraction=1.0 {ca.name}: "
                    f"{cb.predicted_cycles!r} != {ca.predicted_cycles!r}")
    print(f"sampling multicore fraction=1.0: every one of "
          f"{sum(len(r.cores) for r in mone)} cores bitwise the unsampled "
          "run's (one checkpoint: each core's clips are one segment)")
    msampled, wall = run("multicore fraction=0.08", mbase.replace(
        sampling=sampling_config(SAMPLING["fraction"])), multi=mbenches)
    for a, r in zip(mfull, msampled, strict=True):
        lo, hi = r.cycles_ci
        err = (r.predicted_cycles - a.predicted_cycles) / a.predicted_cycles
        print(f"  {r.name:16s} x{r.n_cores} clips={r.n_clips} predicted="
              f"{r.clips_predicted} extrapolated={r.clips_extrapolated} "
              f"estimate={r.predicted_cycles!r} CI=[{lo!r}, {hi!r}] "
              f"unsampled={a.predicted_cycles!r} error {err:+.3e} "
              f"unsampled in CI {lo <= a.predicted_cycles <= hi}")
    n_clips = sum(r.n_clips for r in msampled)
    print(f"sampling multicore fraction=0.08: {n_clips / wall:.1f} clips/s "
          f"against the unsampled run's {n_clips / mwall:.1f}")
    return {"flash_attention": launches[0],
            "weighted_attention": launches[1]}


# --------------------------------------------------------------------- #
# the fault-tolerant SimulationService
# --------------------------------------------------------------------- #

def service_requests(ds, n: int):
    """The dataset's clips split into ``n`` equal requests."""
    from repro_torch.serving import Request
    per = max(1, len(ds) // n)
    return [Request(i, ds.clip_tokens[i * per:(i + 1) * per],
                    ds.context_tokens[i * per:(i + 1) * per],
                    ds.clip_mask[i * per:(i + 1) * per]) for i in range(n)]


def check_service(torch, fa_ops, wa_ops):
    """``SimulationService`` at the paper model's full width (fp32
    reference, batch 256) over requests built with ``build_dataset`` from
    the first 3 Table II benchmarks.  Healthy: every ticket ok at
    fused_int8, clips/s and p50/p99 latency, each rung's spot check
    against the monolithic fp32 reference within its gate (rt: C2; the
    int8 rung also against the port's CPU int8 path).
    Chaos: nan_output/device_error/slow_flush, every ticket typed, a
    demotion, a re-promotion and an abandoned flush seen, every served
    total within its rung's gate against a monolithic fp32 replay.
    Store: a corrupt read cold-encodes to the same totals, and the
    previous generation survives a crashed persist.  Returns the
    (flash, weighted) launches of the healthy and chaos runs and the U of
    the healthy run's fused batches."""
    import dataclasses
    import shutil
    import tempfile
    import warnings

    import numpy as np

    from repro_torch.configs.capsim import config
    from repro_torch.core import predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.data.dataset import BuildConfig, build_dataset
    from repro_torch.isa import progen
    from repro_torch.serving import (PredictorEngine, ServiceSLA,
                                     SimulationService)
    from repro_torch.serving.service import STATUSES, _QueuedRequest

    cfg = config().replace(dtype="float32")   # the ladder's fp32 rungs
    vocab = std_mod.build_vocab()
    params = predictor.init_params(cfg, seed=0, device="cuda")
    names = list(progen.TABLE_II)[:BENCHMARKS]
    base = EngineConfig(batch_size=256)
    t0 = time.perf_counter()
    bcfg = BuildConfig(interval_size=20_000, warmup=0,
                       max_checkpoints=SERVICE_CHECKPOINTS, sample=False)
    ds = build_dataset(names, bcfg, vocab)
    reqs = service_requests(ds, SERVICE_REQUESTS)
    print(f"service config: E={cfg.d_model} fp32 reference, batch 256; "
          f"{len(ds)} clips of {names} (build_dataset, up to "
          f"{SERVICE_CHECKPOINTS} checkpoints, every sliced clip kept, "
          f"{time.perf_counter() - t0:.1f} s) in {SERVICE_REQUESTS} "
          f"requests of {reqs[0].clip_mask.shape[0]} clips")
    launches = [0, 0]
    seen_u = {}
    dedupe = std_mod.dedupe_context_tokens

    def recording(ctx, *a, **kw):
        uniq, counts = dedupe(ctx, *a, **kw)
        seen_u[uniq.shape[1]] = seen_u.get(uniq.shape[1], 0) + 1
        return uniq, counts

    # healthy: one burst of every request
    sla = ServiceSLA(default_deadline_s=120.0, watchdog_s=10.0,
                     check_clips=64)
    svc = SimulationService(params, cfg, base, sla=sla, device="cuda")
    svc.prewarm(reqs[0])

    def burst():
        with svc:
            t = time.perf_counter()
            tickets = [svc.submit(r) for r in reqs]
            out = [tk.result(timeout=300) for tk in tickets]
            return out, time.perf_counter() - t
    std_mod.dedupe_context_tokens = recording
    try:
        (results, wall), counts = counted(fa_ops, wa_ops, burst)
    finally:
        std_mod.dedupe_context_tokens = dedupe
    launches = [launches[0] + counts[0], launches[1] + counts[1]]
    require(all(r.status == "ok" and r.tier == "fused_int8" for r in results),
            "service healthy: " + str({r.status for r in results}))
    lat = [r.latency_seconds for r in results]
    clips = sum(r.n_clips for r in results)
    print(f"service healthy: {len(results)} requests, {clips} clips in "
          f"{wall:.3f} s = {clips / wall:.1f} clips/s; latency p50 "
          f"{1e3 * np.percentile(lat, 50):.1f} ms, p99 "
          f"{1e3 * np.percentile(lat, 99):.1f} ms; "
          f"{svc.stats()['n_flushes']} flushes; fused U "
          f"{dict(sorted(seen_u.items()))}; launches flash={counts[0]} "
          f"weighted={counts[1]}")
    require(counts[0] > 0 and counts[1] > 0,
            f"service healthy: launches {counts}")
    qr = _QueuedRequest(req=reqs[1], ticket=None, arrival=0.0, deadline=0.0)
    k = sla.check_clips
    check = dataclasses.replace(reqs[1], clip_tokens=reqs[1].clip_tokens[:k],
                                context_tokens=reqs[1].context_tokens[:k],
                                clip_mask=reqs[1].clip_mask[:k])

    def tier_times(tier):
        with torch.inference_mode():
            b = tier.backend()
            b.reset_context_width()
            b.add(check.clip_tokens, check.context_tokens, check.clip_mask)
            return b.drain()
    want = float(tier_times(svc._reference).sum())
    for tier in svc._tiers[:-1]:
        err = svc._spot_check(tier, [qr])
        times = tier_times(tier)
        total = abs(float(times.sum()) - want) / abs(want)
        gate = SERVICE_GATES[tier.name]
        print(f"service spot check {tier.name} vs monolithic fp32 ({k} "
              f"clips): max rel per clip {err!r} (gate {gate:g}), rel of "
              f"the total {total!r}")
        require(err is not None and err <= gate,
                f"service spot check {tier.name}: {err} > {gate}")
        if tier.name == "fused_int8":
            # the quantized model's own error depends on the parameters;
            # what the port must hold is its CPU int8 path
            cpu = PredictorEngine(params, cfg, tier.config, device="cpu")
            cpu.submit(check)
            cpu_total = cpu.flush()[0].total_cycles
            rel = abs(float(times.sum()) - cpu_total) / abs(cpu_total)
            print(f"service fused_int8 card vs the port's CPU int8 path "
                  f"({k} clips): total rel {rel!r} (limit 1e-4)")
            require(rel <= 1e-4, f"service fused_int8 card vs CPU {rel}")
    print(f"c2 held: the rt rung against the monolithic one on the card "
          f"{svc._spot_check(svc._tiers[2], [qr])!r}")

    # chaos: one request at a time, so every flush draws its faults
    creqs = service_requests(ds, 2 * SERVICE_REQUESTS)
    csla = ServiceSLA(default_deadline_s=120.0, watchdog_s=1.0,
                      check_every=4, check_clips=64, promote_after=1,
                      backoff_max=4)
    svc = SimulationService(params, cfg, base.replace(
        faults=CHAOS_FAULTS, fault_seed=CHAOS_SEED), sla=csla, device="cuda")
    svc.prewarm(creqs[0])

    def closed_loop():
        with svc:
            t = time.perf_counter()
            out = [svc.submit(r).result(timeout=120) for r in creqs]
            return out, time.perf_counter() - t
    (results, wall), counts = counted(fa_ops, wa_ops, closed_loop)
    launches = [launches[0] + counts[0], launches[1] + counts[1]]
    st = svc.stats()
    alive = svc.join_abandoned(timeout=60)
    tiers = st["tiers"]
    demotions = sum(t["demotions"] for t in tiers.values())
    promotions = sum(t["promotions"] for t in tiers.values())
    print(f"service chaos {CHAOS_FAULTS} seed {CHAOS_SEED}, watchdog "
          f"{csla.watchdog_s} s: {len(results)} requests in {wall:.3f} s; "
          f"{st['statuses']}; faults fired {st['faults_fired']}; demotions "
          f"{demotions}, promotions {promotions}, flush threads abandoned "
          f"{st['abandoned_flush_threads_total']} ({alive} alive after the "
          f"join); launches flash={counts[0]} weighted={counts[1]}")
    for name, t in tiers.items():
        print(f"  tier {name}: " + ", ".join(
            f"{k} {v}" for k, v in t.items() if k != "name" and v))
    require(all(r.status in STATUSES for r in results),
            "service chaos: an untyped result")
    require(demotions >= 1 and promotions >= 1,
            f"service chaos: demotions {demotions} promotions {promotions}")
    require(st["abandoned_flush_threads_total"] >= 1 and alive == 0,
            "service chaos: no flush thread abandoned, or one still alive")
    ref = PredictorEngine(params, cfg, base.replace(rt_cache=False),
                          device="cuda")
    worst = {}
    for r, q in zip(results, creqs, strict=True):
        if not r.ok:
            continue
        ref.submit(q)
        want = ref.flush()[0].total_cycles
        rel = abs(r.total_cycles - want) / abs(want)
        worst[r.tier] = max(worst.get(r.tier, 0.0), rel)
        require(rel <= SERVICE_GATES[r.tier], f"service chaos request "
                f"{r.request_id} at {r.tier}: rel {rel} against the "
                "monolithic replay")
    print("service chaos: served totals against a monolithic fp32 replay, "
          "max rel per rung " + ", ".join(
              f"{k} {v!r} (gate {SERVICE_GATES[k]:g})"
              for k, v in worst.items()))

    # the RT store under corrupt reads and crashed persists
    store = Path(tempfile.mkdtemp(prefix="svc_store_", dir=ROOT / "build"))
    try:
        def serve(faults, requests):
            svc = SimulationService(
                params, cfg, base.replace(rt_store_dir=str(store),
                                          faults=faults),
                sla=ServiceSLA(check_every=0), device="cuda")
            loaded = svc._tiers[0].cache.stats.n_rows_loaded
            with svc:
                out = [svc.submit(r).result(timeout=120) for r in requests]
            require(all(r.status == "ok" for r in out),
                    f"service store {faults}: {[r.status for r in out]}")
            return svc, loaded, [r.total_cycles for r in out]
        clean, loaded, want = serve({}, reqs[:4])
        table = clean._tiers[0].cache.table[:clean._tiers[0].cache.n_rows]
        require(loaded == 0, "service store: the first run loaded rows")
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            bad, loaded, got = serve({"corrupt_rt_read": 1.0}, reqs[:4])
        fired = bad.injector.stats().get("corrupt_rt_read", 0)
        print(f"service store corrupt_rt_read: fired {fired}, rows loaded "
              f"{loaded}, {len(warned)} warnings, totals bitwise the clean "
              f"run's {got == want}")
        require(fired >= 1 and loaded == 0 and warned and got == want,
                "service store: a corrupt read did not cold-encode to the "
                "same totals")
        extra = build_dataset(
            list(progen.TABLE_II)[BENCHMARKS:BENCHMARKS + 1],
            dataclasses.replace(bcfg, max_checkpoints=1), vocab)
        crash, loaded, _ = serve({"crash_persist": 1.0},
                                 service_requests(extra, 2))
        failures = crash.stats()["tiers"]["fused_int8"]["persist_failures"]
        after = SimulationService(params, cfg, base.replace(
            rt_store_dir=str(store)), device="cuda")._tiers[0].cache
        kept = after.table[:after.n_rows]
        print(f"service store crash_persist: {loaded} rows loaded, "
              f"{crash._tiers[0].cache.n_rows} after growing, persist "
              f"failures {failures}; a restart loads {after.n_rows} rows, "
              f"bit-exact the previous generation "
              f"{torch.equal(kept, table)}")
        require(loaded == table.shape[0] and failures >= 1
                and crash._tiers[0].cache.n_rows > loaded
                and torch.equal(kept, table),
                "service store: a crashed persist lost the previous "
                "generation")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return {"flash_attention": launches[0],
            "weighted_attention": launches[1]}, seen_u


# --------------------------------------------------------------------- #
# Mamba2 LM
# --------------------------------------------------------------------- #

def cast_params(params, specs, dtype):
    """Cast every parameter whose spec has no dtype of its own (the
    reference's fp32 norms, A_log, dt_bias and D stay float32)."""
    if not isinstance(specs, dict):
        return params if specs.dtype else params.to(dtype)
    return {k: cast_params(params[k], specs[k], dtype) for k in params}


def live_rel(a, b, vocab: int) -> float:
    """max |a - b| / max |b| over the real vocab columns."""
    return rel_err(a[..., :vocab], b[..., :vocab])


def check_mamba2(torch, fa_ops, wa_ops, ssd_ops):
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import transformer as tfm

    cfg = get_config("mamba2-780m")
    f32 = cfg.replace(dtype="float32", param_dtype="float32")
    V = cfg.vocab_size
    t0 = time.perf_counter()
    params = tfm.init_params(f32, seed=0, device="cuda")
    params16 = cast_params(params, tfm.model_specs(cfg), torch.bfloat16)
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    print(f"mamba2 config: layers={cfg.num_layers} d_model={cfg.d_model} "
          f"ssd_heads={cfg.d_model * cfg.ssm_expand // cfg.ssm_head_dim} "
          f"head_dim={cfg.ssm_head_dim} d_state={cfg.ssm_state} chunk="
          f"{cfg.ssm_chunk} vocab={V} padded={tfm.padded_vocab(cfg)} "
          f"params={n_params} (init {time.perf_counter() - t0:.1f} s); "
          f"batch {MAMBA2_BATCH} x {MAMBA2_PROMPT} tokens + "
          f"{MAMBA2_DECODE} decode steps")
    shape = ShapeConfig("prefill_4k", MAMBA2_PROMPT, MAMBA2_BATCH,
                        "prefill")
    batch = random_batch(cfg, shape, "prefill", seed=0, device="cuda")
    # warm-up (cuBLAS handles, lazy modules), not counted
    generate(params, f32, {"tokens": batch["tokens"][:1, :256]}, 1)

    fa_ops.flash_attention.launches = 0
    wa_ops.weighted_attention.launches = 0
    ssd_ops.ssd_scan.launches = 0
    runs, peaks = {}, {}
    for dtype, p, c in (("float32", params, f32),
                        ("bfloat16", params16, cfg)):
        torch.cuda.reset_peak_memory_stats()
        runs[dtype] = generate(p, c, batch, MAMBA2_DECODE)
        peaks[dtype] = torch.cuda.max_memory_allocated() / 2**30
    launches = ssd_ops.ssd_scan.launches
    print(f"mamba2 launches: ssd={launches} flash="
          f"{fa_ops.flash_attention.launches} weighted="
          f"{wa_ops.weighted_attention.launches}")
    require(launches == 2 * cfg.num_layers,
            f"mamba2: {launches} SSD launches, expected {cfg.num_layers} "
            "per prefill")
    for dtype, g in runs.items():
        n_tok = MAMBA2_BATCH * MAMBA2_PROMPT
        print(f"mamba2 {dtype}: prefill {g.prefill_seconds:.4f} s = "
              f"{n_tok / g.prefill_seconds:.1f} tokens/s; decode "
              f"{1e3 * g.decode_seconds / MAMBA2_DECODE:.3f} ms/step "
              f"(batch {MAMBA2_BATCH}); peak memory {peaks[dtype]:.2f} GiB "
              f"(f32 and bf16 parameters included); first tokens "
              f"{g.tokens[0, :6].tolist()}")
        require(bool(torch.isfinite(g.logits.float()).all()),
                f"mamba2 {dtype}: non-finite logits")
        require(int(g.tokens.max()) < V,
                f"mamba2 {dtype}: decoded a padded vocab column")
    gap = float((runs["bfloat16"].logits[:, 0, :V].float()
                 - runs["float32"].logits[:, 0, :V]).norm()
                / runs["float32"].logits[:, 0, :V].norm())
    agree = float((runs["bfloat16"].tokens == runs["float32"].tokens)
                  .float().mean())
    print(f"mamba2 bf16 vs f32: prefill last-row logits relative norm "
          f"{gap:.3e} (reported, not gated); greedy tokens agree "
          f"{agree:.3f}")

    # where the device time goes: one prefill and one decode step per
    # dtype under the profiler (after the counted runs)
    for dtype, p, c in (("float32", params, f32),
                        ("bfloat16", params16, cfg)):
        (_, cache), *prof = device_profile(
            torch, lambda: tfm.prefill_step(p, batch, c))
        print_profile(f"mamba2 {dtype} prefill", *prof)
        _, *prof = device_profile(torch, lambda: tfm.decode_step(
            p, {"tokens": runs[dtype].tokens[:, :1]}, c, cache,
            MAMBA2_PROMPT))
        print_profile(f"mamba2 {dtype} decode step", *prof)
        del cache

    # card vs the port's CPU plain path, and prefill vs decode, on a
    # 2-layer model at full width in f32
    two = f32.replace(num_layers=2)
    p_cpu = tfm.init_params(two, seed=1, device="cpu")
    p_card = _to(p_cpu, "cuda")
    tok = torch.randint(0, V, (1, 512),
                        generator=torch.Generator().manual_seed(1))
    card = generate(p_card, two, {"tokens": tok[:, :511]}, 2, device="cuda")
    cpu = generate(p_cpu, two, {"tokens": tok[:, :511]}, 2, device="cpu")
    rel = live_rel(card.logits.cpu(), cpu.logits, V)
    full_card, _ = tfm.prefill_step(p_card, {"tokens": tok[:, :511].cuda()},
                                    two)
    full_cpu, _ = tfm.prefill_step(p_cpu, {"tokens": tok[:, :511]}, two)
    rel_full = live_rel(full_card.cpu(), full_cpu, V)
    print(f"mamba2 card vs CPU (2 layers, prompt 511 + 2 decode steps): "
          f"step logits rel {rel:.3e}, prefill logits rel {rel_full:.3e}, "
          f"tokens equal {torch.equal(card.tokens.cpu(), cpu.tokens)}")
    require(rel <= 1e-4 and rel_full <= 1e-4,
            f"mamba2 card vs CPU rel {rel} / {rel_full}")
    long, _ = tfm.prefill_step(p_card, {"tokens": tok.cuda()}, two)
    _, cache = tfm.prefill_step(p_card, {"tokens": tok[:, :511].cuda()}, two)
    step, _ = tfm.decode_step(p_card, {"tokens": tok[:, 511:].cuda()}, two,
                              cache, 511)
    rel_pd = live_rel(step[:, 0], long[:, -1], V)
    print(f"mamba2 prefill(511) + decode vs prefill(512) last row: rel "
          f"{rel_pd:.3e}")
    require(rel_pd <= 1e-4, f"mamba2 prefill vs decode rel {rel_pd}")
    return launches


def rel_norm(a, b) -> float:
    """|a - b| / |b| (Frobenius), in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def check_mamba2_bf16(torch):
    """bf16 Mamba2 on the card held to the port's CPU bf16 path: the same
    seeded bf16 parameters, cut to MAMBA2_GATE_LAYERS layers at full
    width, one prefill of MAMBA2_GATE_PROMPT tokens (a ragged second SSD
    chunk).  Gated as the CPU test gates the port against JAX: the last
    row's logits on the card lie within half of the port's own bf16-vs-
    f32 gap (on the CPU) of the CPU's, and each layer fed the CPU's input
    stays within 1e-3 (relative norm) of the CPU's output."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    cfg = get_config("mamba2-780m").replace(num_layers=MAMBA2_GATE_LAYERS)
    f32 = cfg.replace(dtype="float32", param_dtype="float32")
    V = cfg.vocab_size
    p32 = tfm.init_params(f32, seed=2, device="cpu")
    p16 = cast_params(p32, tfm.model_specs(cfg), torch.bfloat16)
    p16_card, p32_card = _to(p16, "cuda"), _to(p32, "cuda")
    tok = torch.randint(0, V, (MAMBA2_GATE_BATCH, MAMBA2_GATE_PROMPT),
                        generator=torch.Generator().manual_seed(2))
    t0 = time.perf_counter()

    def last(p, c, device):
        logits, _ = tfm.prefill_step(p, {"tokens": tok.to(device)}, c)
        return logits[:, -1, :V].float().cpu()
    card16, card32 = last(p16_card, cfg, "cuda"), last(p32_card, f32, "cuda")
    cpu16, cpu32 = last(p16, cfg, "cpu"), last(p32, f32, "cpu")
    gap_cpu, gap_card = rel_norm(cpu16, cpu32), rel_norm(card16, card32)
    d = rel_norm(card16, cpu16)
    # each layer fed the CPU's input
    x = tfm._embed_tokens(p16, tok, cfg)
    per_layer = []
    for r in range(cfg.num_layers):
        y_cpu, _ = tfm._block_forward(tfm._index(p16["blocks"], r)["i0"], x,
                                      cfg, "prefill", None)
        y_card, _ = tfm._block_forward(
            tfm._index(p16_card["blocks"], r)["i0"], x.cuda(), cfg,
            "prefill", None)
        per_layer.append(rel_norm(y_card.cpu(), y_cpu))
        x = y_cpu
    print(f"mamba2 bf16 gate ({cfg.num_layers} layers at full width, "
          f"B={MAMBA2_GATE_BATCH} x {MAMBA2_GATE_PROMPT} tokens, "
          f"{time.perf_counter() - t0:.1f} s): last-row logits card vs CPU "
          f"{d:.3e}; the port's bf16 vs f32 gap on the CPU {gap_cpu:.3e} "
          f"(on the card {gap_card:.3e}); per layer fed the CPU's input "
          f"max {max(per_layer):.3e} (" + ", ".join(
              f"{v:.2e}" for v in per_layer) + ")")
    require(d < 0.5 * gap_cpu, f"mamba2 bf16 card vs CPU {d} >= half of "
            f"the bf16 vs f32 gap {gap_cpu}")
    require(max(per_layer) <= 1e-3, f"mamba2 bf16 per layer "
            f"{max(per_layer)} > 1e-3")


def device_profile(torch, fn, top: int = 5):
    """Run ``fn`` once under ``torch.profiler``.  Returns (its result, wall
    s, device busy s = the sum of the kernels' device times, the port's
    own kernels' device s, the ``top`` kernels by device time as (name,
    ms, calls))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    ours = sum(e.self_device_time_total for e in kernels
               if "capsim" in e.key) / 1e6
    require(busy > 0, "the profiler saw no device time")
    return out, wall, busy, ours, [(e.key, e.self_device_time_total / 1e3,
                                    e.count) for e in kernels[:top]]


def print_profile(what: str, wall: float, busy: float, ours: float,
                  top) -> None:
    print(f"{what} profiled: wall {1e3 * wall:.2f} ms, device busy "
          f"{1e3 * busy:.2f} ms (idle share {1 - busy / wall:.3f}); the "
          f"port's kernels {1e3 * ours:.2f} ms ({ours / busy:.3f} of busy); "
          "top kernels " + "; ".join(f"{name[:60]} {ms:.2f} ms x{n}"
                                     for name, ms, n in top))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


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
    from repro_torch.kernels.ssd import ops as ssd_ops

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
    for name, (log, seconds) in logs.items():
        regs = [int(line.split("Used ")[1].split()[0])
                for line in log.splitlines() if "Used " in line]
        spills = [line.strip() for line in log.splitlines()
                  if "spill stores" in line and " 0 bytes spill" not in line]
        print(f"build {name}: {len(regs)} instantiations, registers "
              f"{min(regs)}-{max(regs)}, {len(spills)} with spills, nvcc "
              f"{seconds:.1f} s")
    sass_pipes(torch, build, fa_ops, ssd_ops)

    errs = check_kernels(torch, fa_ops, wa_ops)
    errs["ssd"] = check_ssd(torch, ssd_ops)
    rows = time_kernels(torch, fa_ops, wa_ops)
    rows["ssd"] = time_ssd(torch, ssd_ops)
    check_gates(rows)
    launches = check_engine(torch, fa_ops, wa_ops)
    mc_launches, seen_u = check_multicore(torch, fa_ops, wa_ops)
    for name, n in mc_launches.items():
        launches[name] += n
    mc_rows, mc_errs = fused_weighted_shapes(torch, wa_ops, seen_u)
    rows["weighted_attention"] += mc_rows
    for dtype, err in mc_errs.items():
        errs["weighted_attention"][dtype] = max(
            errs["weighted_attention"][dtype], err)
    check_rt_store(torch)
    t0 = time.perf_counter()
    for name, n in check_sampling(torch, fa_ops, wa_ops).items():
        launches[name] += n
    t1 = time.perf_counter()
    svc_launches, svc_u = check_service(torch, fa_ops, wa_ops)
    for name, n in svc_launches.items():
        launches[name] += n
    print(f"phases: sampling {t1 - t0:.1f} s, service "
          f"{time.perf_counter() - t1:.1f} s")
    svc_rows, svc_errs = fused_weighted_shapes(torch, wa_ops, svc_u, 360,
                                               "svc", seed=5)
    rows["weighted_attention"] += svc_rows
    for dtype, err in svc_errs.items():
        errs["weighted_attention"][dtype] = max(
            errs["weighted_attention"][dtype], err)
    launches["ssd"] = check_mamba2(torch, fa_ops, wa_ops, ssd_ops)
    check_mamba2_bf16(torch)

    sources = {"flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:33", "block_self",
        "float32"),
        "weighted_attention": (
        "src/repro_torch/csrc/weighted_attention.cu",
        "src/repro/kernels/fused_serving/kernel.py:33", "fused_self_u128",
        "float32"),
        "ssd": (
        "src/repro_torch/csrc/ssd.cu",
        "src/repro/kernels/ssd/kernel.py:30", SSD_PATH[0], "bfloat16")}
    kernels = []
    for name, (source, replaces, main_shape, dtype) in sources.items():
        row = next(r for r in rows[name]
                   if r["shape"] == main_shape and r["dtype"] == dtype)
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name]["float32"],
            "max_abs_err_bf16": errs[name]["bfloat16"],
            "shape": f"{main_shape} {dtype}",
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}
        if "device_ms" in row:
            entry["device_ms"] = row["device_ms"]
        if name != "ssd":                 # the paper model's own dtype
            row = next(r for r in rows[name]
                       if r["shape"] == main_shape
                       and r["dtype"] == "bfloat16")
            entry.update({f"{key}_bf16": row[key] for key in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
        kernels.append(entry)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
