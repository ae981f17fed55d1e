#!/usr/bin/env python3
"""Where the bf16 dense decoder parts between the card and the CPU.

    python3 tools/dense_bf16_probe.py      # from the root of a checkout, one GPU

qwen3-4b at full width cut to 2 layers, the seeded parameters of
``chip_smoke.py``'s dense bf16 gate (seed 1, cast to bf16 but the f32
norm scales), a prompt of 2 x 300 tokens.  Layer 0 runs op by op on the
CPU; the card computes each op from the CPU's input of that op, so each
line is one op's own card-vs-CPU difference (relative norm).  Each
matrix product is also held against the same product accumulated in f32
on the CPU and rounded once to bf16 (``exact``), on both devices, and
the card's products are run with and without
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
(cuBLAS may then reduce split-K partial sums in bf16).  Then the last
row's logits card vs CPU and the CPU's bf16-vs-f32 gap, as the gate
computes them, under each setting; the same card run with the
attention's plain version on the card (what the flash kernel adds); and
each layer fed the CPU's input, card vs CPU.

Needs the card and the CUDA toolkit (the kernels build at first use).
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dense_bf16_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention as am
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import (activation, apply_rope, norm,
                                           rms_norm)

    cfg = get_config("qwen3-4b").replace(num_layers=2)
    f32 = cfg.replace(dtype="float32", param_dtype="float32")
    V = cfg.vocab_size
    p32 = tfm.init_params(f32, seed=1, device="cpu")

    def cast(params, specs):
        if not isinstance(specs, dict):
            return params if specs.dtype else params.to(torch.bfloat16)
        return {k: cast(params[k], specs[k]) for k in params}
    p16 = cast(p32, tfm.model_specs(cfg))

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}
    p16c = to(p16, "cuda")
    tok = torch.randint(0, V, (2, 301),
                        generator=torch.Generator().manual_seed(3))[:, :300]
    print(f"dense bf16 probe: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}; qwen3-4b 2 layers at full width, B=2 x "
          f"300; cpu threads {torch.get_num_threads()}")

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return float((a - b).norm() / b.norm())

    def exact(x, w):
        return (x.float() @ w.float()).to(torch.bfloat16)

    def op(name, fn, *cpu_in, gemm=False):
        """fn on the CPU inputs and on their card copies; prints the
        card-vs-CPU rel norm (and each vs the f32-accumulated product
        for a matrix product).  Returns the CPU output."""
        out_cpu = fn(*cpu_in)
        out_card = fn(*[x.cuda() if isinstance(x, torch.Tensor) else x
                        for x in cpu_in])
        line = f"  {name:12s} card vs cpu {rel(out_card, out_cpu):.3e}"
        if gemm:
            ex = exact(*cpu_in)
            line += (f"; cpu vs exact {rel(out_cpu, ex):.3e}, card vs "
                     f"exact {rel(out_card, ex):.3e}")
        print(line)
        return out_cpu

    for reduced in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = reduced
        print(f"allow_bf16_reduced_precision_reduction = {reduced}")
        lp = tfm._index(p16["blocks"], 0)["i0"]
        mix, ffn = lp["mixer"], lp["ffn"]
        B, S = tok.shape
        H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        pos = torch.arange(S).expand(B, S)
        x = tfm._embed_tokens(p16, tok, cfg)
        h = op("norm1", lambda a, s: norm(a, {"scale": s}, cfg), x,
               lp["norm1"]["scale"])
        q = op("wq", lambda a, w: a @ w, h, mix["wq"], gemm=True)
        k = op("wk", lambda a, w: a @ w, h, mix["wk"], gemm=True)
        v = op("wv", lambda a, w: a @ w, h, mix["wv"], gemm=True)
        q, k, v = (t.reshape(B, S, -1, Dh) for t in (q, k, v))
        q = op("q_norm", rms_norm, q, mix["q_norm"])
        k = op("k_norm", rms_norm, k, mix["k_norm"])
        q = op("rope q", lambda a, p: apply_rope(a, p, cfg.rope_theta), q,
               pos)
        k = op("rope k", lambda a, p: apply_rope(a, p, cfg.rope_theta), k,
               pos)
        o = op("attention", am.causal_attention, q, k, v)
        a = op("wo", lambda t, w: t @ w, o.reshape(B, S, H * Dh),
               mix["wo"], gemm=True)
        x = op("residual1", torch.add, x, a)
        h = op("norm2", lambda t, s: norm(t, {"scale": s}, cfg), x,
               lp["norm2"]["scale"])
        g = op("w_gate", lambda t, w: t @ w, h, ffn["w_gate"], gemm=True)
        u = op("w_up", lambda t, w: t @ w, h, ffn["w_up"], gemm=True)
        sg = op("silu", lambda t: activation(t, "silu"), g)
        act = op("silu*up", torch.mul, sg, u)
        y = op("w_down", lambda t, w: t @ w, act, ffn["w_down"], gemm=True)
        x = op("residual2", torch.add, x, y)
        xf = op("final_norm", lambda t, s: norm(t, {"scale": s}, cfg), x,
                p16["final_norm"]["scale"])
        op("logits", lambda t, w: t @ w, xf[:, -1:], p16["unembed"],
           gemm=True)

        def last(p, c, device):
            logits, _ = tfm.prefill_step(p, {"tokens": tok.to(device)}, c)
            return logits[:, -1, :V].float().cpu()
        card16 = last(p16c, cfg, "cuda")
        cpu16, cpu32 = last(p16, cfg, "cpu"), last(p32, f32, "cpu")
        print(f"  whole model: last-row logits card vs cpu "
              f"{rel(card16, cpu16):.3e}; cpu bf16 vs f32 gap "
              f"{rel(cpu16, cpu32):.3e}; card bf16 vs cpu f32 "
              f"{rel(card16, cpu32):.3e}")
        # the same card run with the attention's plain version on the
        # card: what the flash kernel adds to the card's difference
        kernel = fa_ops.flash_attention
        fa_ops.flash_attention = fa_ops.flash_attention_plain
        try:
            card16_plain = last(p16c, cfg, "cuda")
        finally:
            fa_ops.flash_attention = kernel
        print(f"  whole model, attention's plain version on the card: "
              f"card vs cpu {rel(card16_plain, cpu16):.3e}; card kernel "
              f"vs card plain {rel(card16, card16_plain):.3e}")
        # each layer fed the CPU's input (the C4 gate's second measure)
        x = tfm._embed_tokens(p16, tok, cfg)
        per_layer = []
        for r in range(cfg.num_layers):
            lp_r = tfm._index(p16["blocks"], r)["i0"]
            lp_c = tfm._index(p16c["blocks"], r)["i0"]
            y_cpu, *_ = tfm._block_forward(lp_r, x, cfg, "prefill", None,
                                          pos)
            y_card, *_ = tfm._block_forward(lp_c, x.cuda(), cfg, "prefill",
                                           None, pos.cuda())
            per_layer.append(rel(y_card, y_cpu))
            x = y_cpu
        print("  per layer fed the cpu's input: " + ", ".join(
            f"{v:.3e}" for v in per_layer))
    return 0


if __name__ == "__main__":
    sys.exit(main())
