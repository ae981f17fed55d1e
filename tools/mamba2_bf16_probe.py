#!/usr/bin/env python3
"""Where bf16 Mamba2 on the card parts from the port's CPU bf16 path.

    python3 tools/mamba2_bf16_probe.py [--layers 12] [--batch 2] [--prompt 300]

The model of ``chip_smoke.py``'s bf16 gate: ``mamba2-780m`` cut to
``--layers`` layers at full width, seeded float32 parameters cast to
bfloat16 as the chip smoke test casts them (norms, A_log, dt_bias and D
stay float32), one prefill of ``--batch`` x ``--prompt`` seeded tokens.
Prints, for each layer fed the CPU's input, the relative norm of the
card's output against the CPU's: with the SSD kernel, and with the SSD
scan's plain version run on the card in its place; the SSD kernel's y
and final state against the plain version on that layer's own inputs
(relative norm and max |diff| / max |plain|); the card with the kernel
and cuBLAS held to full-precision bf16 reductions
(``allow_bf16_reduced_precision_reduction = False``); then the last
row's logits the same three ways, beside the port's bf16-vs-f32 gap on
the CPU.  If the plain-SSD column sits far below the kernel column, the
SSD kernel is what parts the card from the CPU.  Needs the card and the CUDA
toolkit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402


def rel_norm(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm())


def rel_max(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def cast_params(params, specs, dtype):
    """As chip_smoke.py: every parameter whose spec has no dtype of its
    own goes to ``dtype``."""
    if not isinstance(specs, dict):
        return params if specs.dtype else params.to(dtype)
    return {k: cast_params(params[k], specs[k], dtype) for k in params}


def to(tree, device):
    return {k: to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class PlainSSD:
    """Within the block, ``ssd_ops.ssd_scan`` as its plain version."""

    def __enter__(self):
        self.kernel = ssd_ops.ssd_scan
        ssd_ops.ssd_scan = ssd_ops.ssd_scan_plain

    def __exit__(self, *exc):
        ssd_ops.ssd_scan = self.kernel


class FullReduction:
    """Within the block, cuBLAS may not reduce bf16 products in reduced
    precision (PyTorch allows it by default)."""

    def __enter__(self):
        m = torch.backends.cuda.matmul
        self.was = m.allow_bf16_reduced_precision_reduction
        m.allow_bf16_reduced_precision_reduction = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = self.was


class RecordSSD:
    """Within the block, each ``ssd_scan`` call also runs the plain
    version on the same inputs and records (y rel norm, y rel max, state
    rel norm, state rel max) of the kernel against it."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        self.kernel = ssd_ops.ssd_scan

        def both(*args, **kw):
            y, st = self.kernel(*args, **kw)
            yp, sp = ssd_ops.ssd_scan_plain(*args, **kw)
            self.rows.append((rel_norm(y, yp), rel_max(y, yp),
                              rel_norm(st, sp), rel_max(st, sp)))
            return y, st
        # the kernel's wrapper counts its launches on the module's name
        both.launches = self.kernel.launches
        ssd_ops.ssd_scan = both
        return self

    def __exit__(self, *exc):
        ssd_ops.ssd_scan = self.kernel


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mamba2_bf16_probe: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}")

    cfg = get_config("mamba2-780m").replace(num_layers=args.layers,
                                            dtype="bfloat16",
                                            param_dtype="bfloat16")
    f32 = cfg.replace(dtype="float32", param_dtype="float32")
    V = cfg.vocab_size
    p32 = tfm.init_params(f32, seed=2, device="cpu")
    p16 = cast_params(p32, tfm.model_specs(cfg), torch.bfloat16)
    card = to(p16, "cuda")
    tok = torch.randint(0, V, (args.batch, args.prompt),
                        generator=torch.Generator().manual_seed(2))

    x = tfm._embed_tokens(p16, tok, cfg)
    print("layer  card/kernel vs CPU  card/plain-SSD vs CPU  "
          "card/kernel, full reduction  "
          "SSD y rel_norm / rel_max  SSD state rel_norm / rel_max")
    for r in range(cfg.num_layers):
        bp_cpu = tfm._index(p16["blocks"], r)["i0"]
        bp_card = tfm._index(card["blocks"], r)["i0"]
        y_cpu, _ = tfm._block_forward(bp_cpu, x, cfg, "prefill", None)
        with RecordSSD() as rec:
            y_k, _ = tfm._block_forward(bp_card, x.cuda(), cfg, "prefill",
                                        None)
        with PlainSSD():
            y_p, _ = tfm._block_forward(bp_card, x.cuda(), cfg, "prefill",
                                        None)
        with FullReduction():
            y_f, _ = tfm._block_forward(bp_card, x.cuda(), cfg, "prefill",
                                        None)
        yn, ym, sn, sm = rec.rows[0]
        print(f"{r:5d}  {rel_norm(y_k, y_cpu):18.3e}  "
              f"{rel_norm(y_p, y_cpu):21.3e}  {rel_norm(y_f, y_cpu):28.3e}  "
              f"{yn:11.3e} / {ym:9.3e}  {sn:13.3e} / {sm:9.3e}")
        x = y_cpu

    def last(p, c, device):
        logits, _ = tfm.prefill_step(p, {"tokens": tok.to(device)}, c)
        return logits[:, -1, :V].float().cpu()
    cpu16 = last(p16, cfg, "cpu")
    cpu32 = last(p32, f32, "cpu")
    card_k = last(card, cfg, "cuda")
    with PlainSSD():
        card_p = last(card, cfg, "cuda")
    with FullReduction():
        card_f = last(card, cfg, "cuda")
    print(f"last-row logits: card/kernel vs CPU {rel_norm(card_k, cpu16):.3e}, "
          f"card/plain-SSD vs CPU {rel_norm(card_p, cpu16):.3e}, "
          f"card/kernel with full reductions vs CPU "
          f"{rel_norm(card_f, cpu16):.3e}, the port's bf16 vs f32 gap on "
          f"the CPU {rel_norm(cpu16, cpu32):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
