#!/usr/bin/env python3
"""Where the RT path and the monolithic path part on the card (C2).

    python3 tools/c2_probe.py          # from the root of a checkout, one GPU

The paper model at full width (``configs/capsim.py`` with float32 compute,
TF32 off), seeded random parameters, one batch of 256 clips of each of the
first 3 Table II benchmarks (20,000-instruction checkpoint).  For each
batch it prints:

  * the per-clip relative error of ``forward_cached`` over an ``RTCache``
    table against the monolithic ``forward`` (max over the batch of
    |rt - mono| / max(|mono|, 1), the service's spot-check measure);
  * the instruction encoder run op by op over the cache's encode pass
    (the batch's unique token rows padded to ``encode_bucket``) and over
    every clip row (256 x 128 instructions), each op's max abs difference
    on the same instruction: the first op that differs is where the two
    paths part;
  * the RT vectors of the unique rows encoded in passes padded to other
    row counts against the monolithic rows (which counts agree bitwise);
  * the clip rows encoded in chunks of a fixed number of rows against
    the unique rows encoded in one pass of that many rows (whether one
    chunking for both passes makes them agree bitwise).

Needs the card and the CUDA toolkit (the kernels build at first use).
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("c2_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.capsim import config
    from repro_torch.core import context as ctx_mod
    from repro_torch.core import predictor as pm
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.rt_cache import RTCache, encode_bucket
    from repro_torch.isa import funcsim, progen
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.layers import rms_norm

    cfg = config().replace(dtype="float32")
    vocab = std_mod.build_vocab()
    params = pm.init_params(cfg, seed=0, device="cuda")
    print(f"c2 probe: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, E={cfg.d_model} H={cfg.num_heads} "
          f"D={cfg.head_dim} d_ff={cfg.d_ff} fp32, TF32 off")

    def clips(name):
        bench = progen.build_benchmark(name)
        cprog = bench.compiled()
        table = cprog.token_table(vocab, 16)
        st = progen.fresh_compiled_state(bench)
        _, st = funcsim.run_compiled(cprog, 2_000, st)
        trace, _ = funcsim.run_compiled(cprog, 40_000, st,
                                        snapshot_every=100)
        tok, mask = std_mod.encode_fixed_clips(table, trace.pc, 100, 128)
        ctx_all = ctx_mod.context_tokens_from_matrix(trace.snapshots, vocab)
        ctx = ctx_all[np.minimum(np.arange(tok.shape[0]),
                                 len(ctx_all) - 1)]
        return tok[:256], ctx[:256], mask[:256]

    def trace_encoder(rows):
        """(N, 16) rows -> {op: (N, 16, ...) activation after each op of
        each layer, and "rt": the final (N, E) RT vectors}."""
        mask = (rows != 0).float()
        x = params["embed"][rows]
        out = {"embed": x}
        inst = params["inst"]
        for i in range(inst["wq"].shape[0]):
            p = pm._layer(inst, i)
            h = rms_norm(x, p["norm1"])
            q = pm._heads(h @ p["wq"], cfg)
            k = pm._heads(h @ p["wk"], cfg)
            v = pm._heads(h @ p["wv"], cfg)
            o = flash_attention(q, k, v, kv_mask=mask).flatten(-2)
            a = o @ p["wo"]
            x = x + a
            h2 = rms_norm(x, p["norm2"])
            f1 = h2 @ p["w1"]
            g = F.gelu(f1, approximate="tanh")
            f2 = g @ p["w2"]
            x = x + f2
            for name, t in (("norm1", h), ("q", q), ("k", k), ("v", v),
                            ("attn", o), ("wo", a), ("norm2", h2),
                            ("w1", f1), ("gelu", g), ("w2", f2),
                            ("out", x)):
                out[f"L{i}.{name}"] = t
        out["rt"] = x[:, 0, :]
        return out

    for name in list(progen.TABLE_II)[:3]:
        tok, ctx, mask = clips(name)
        dev = {"context_tokens": torch.as_tensor(ctx, device="cuda"),
               "clip_mask": torch.as_tensor(mask, device="cuda")}
        t0 = time.perf_counter()
        mono = pm.forward(params, {**dev, "clip_tokens":
                                   torch.as_tensor(tok, device="cuda")}, cfg)
        torch.cuda.synchronize()
        mono_s = time.perf_counter() - t0
        cache = RTCache(params, cfg, 16, device="cuda")
        idx = cache.index_clips(tok)
        rt = pm.forward_cached(params, cache.table,
                               {**dev, "rt_idx": torch.as_tensor(
                                   idx, device="cuda")}, cfg)
        err = float(((rt - mono).abs() / mono.abs().clamp(min=1.0)).max())
        bitwise = bool(torch.equal(rt, mono))
        print(f"{name}: {tok.shape[0]} clips, monolithic {mono_s:.3f} s; "
              f"rt vs monolithic max rel {err:.3e} bitwise {bitwise}; "
              f"{cache.n_rows} RT rows (encode pass of "
              f"{encode_bucket(cache.n_rows)})")

        # the same instruction through both encoder passes, op by op
        flat = tok.reshape(-1, 16)
        uniq, inv = std_mod.dedupe_token_rows(flat)
        n_u = uniq.shape[0]
        padded = np.zeros((encode_bucket(n_u), 16), np.int32)
        padded[:n_u] = uniq
        a = trace_encoder(torch.as_tensor(padded, device="cuda"))
        b = trace_encoder(torch.as_tensor(flat, device="cuda"))
        inv_t = torch.as_tensor(inv, device="cuda", dtype=torch.long)
        first = None
        parts = []
        for op in a:
            d = float((a[op][:n_u][inv_t] - b[op]).abs().max())
            parts.append(f"{op} {d:.2e}")
            if d > 0 and first is None:
                first = op
        print(f"  op by op (unique rows padded to {padded.shape[0]} vs "
              f"{flat.shape[0]} clip rows), first op that differs: "
              f"{first}; " + ", ".join(parts))
        # which encode-pass row counts give the monolithic rows bit for bit
        same = []
        for n in (encode_bucket(n_u), 4096, 32768, flat.shape[0]):
            rows = np.zeros((max(n, n_u), 16), np.int32)
            rows[:n_u] = uniq
            r = pm.encode_instructions(params, torch.as_tensor(
                rows, device="cuda"), cfg)[:n_u]
            d = float((r[inv_t] - b["rt"]).abs().max())
            same.append(f"{rows.shape[0]} rows: {d:.2e}")
        print("  RT vectors of passes of n rows vs the monolithic pass: "
              + ", ".join(same))
        # one chunking for both passes
        same = []
        for n in (encode_bucket(n_u), 4096):
            rows = np.zeros((n, 16), np.int32)
            rows[:n_u] = uniq
            r = pm.encode_instructions(params, torch.as_tensor(
                rows, device="cuda"), cfg)[:n_u]
            k = -(-flat.shape[0] // n) * n
            rows = np.zeros((k, 16), np.int32)
            rows[:flat.shape[0]] = flat
            rows_t = torch.as_tensor(rows, device="cuda")
            m = torch.cat([pm.encode_instructions(params, rows_t[i:i + n],
                                                  cfg)
                           for i in range(0, k, n)])[:flat.shape[0]]
            d = float((r[inv_t] - m).abs().max())
            same.append(f"chunks of {n} rows: {d:.2e}")
        print("  both passes in chunks of n rows: " + ", ".join(same))
    return 0


if __name__ == "__main__":
    sys.exit(main())
