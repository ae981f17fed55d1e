#!/usr/bin/env python3
"""Why a one-kernel SSD scan runs slower in bfloat16 than in float32.

    git show a3f4ba3:src/repro_torch/csrc/ssd.cu > build/probe/ssd_parent.cu
    cp src/repro_torch/csrc/dtype.cuh build/probe/
    python3 tools/ssd_dtype_probe.py build/probe/ssd_parent.cu

Builds the given ``ssd.cu`` (its C entry point ``capsim_ssd_scan`` with
the signature it had before the workspace argument) as it is and in
three variants that each remove one kind of global memory access, and
times every build in float32 and bfloat16 on the same data at the
Mamba2-780m prefill shape (Bt 4, S 4096, H 48, P 64, N 128, chunk 256),
CUDA events over 10 calls after 2 warm-up calls:

  base         the source as it is
  no_y_store   y is not written (the store is kept behind a test that
               never holds, so the arithmetic stays)
  no_x_load    x reads as 1 (dt and the decays still scale it)
  no_bc_load   B and C read as 0.5

The variant whose bfloat16 / float32 ratio falls to ~1 names the access
that costs bfloat16 its time.  Needs the card and the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

VARIANTS = {
    "base": [],
    "no_y_store": [("yg[(t0 + row) * a.y_ss + pc + cc * CG] = ",
                    "if (acc[k][cc] == 1234.5f) "
                    "yg[(t0 + row) * a.y_ss + pc + cc * CG] = ")],
    "no_x_load": [("to_f32<T>(xg[(t0 + j) * a.x_ss + e % PT])", "1.0f")],
    "no_bc_load": [("to_f32<T>(src[(row0 + r) * row_stride + c])",
                    "0.5f")],
}


def main() -> int:
    src = Path(sys.argv[1])
    text = src.read_text()
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        body = text
        for old, new in subs:
            if old not in body:
                raise SystemExit(f"{name}: pattern not found: {old}")
            body = body.replace(old, new)
        cu = out / f"ssd_{name}.cu"
        cu.write_text(body)
        lib = out / f"libssd_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-I{src.parent}", "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            print(log)
            return 1
    Bt, S, H, P, N, q = 4, 4096, 48, 64, 128, 256
    g = torch.Generator().manual_seed(3)
    x = torch.randn(Bt, S, H, P, generator=g) * 0.5
    dt = (torch.randn(Bt, S, H, generator=g).abs() * 0.4 + 0.01).cuda()
    Bm = torch.randn(Bt, S, N, generator=g) * 0.3
    Cm = torch.randn(Bt, S, N, generator=g) * 0.3
    A = (-torch.randn(H, generator=g).abs() - 0.1).cuda()
    print(torch.cuda.get_device_name(0))
    for name, (lib_path, _) in procs.items():
        fn = ctypes.CDLL(str(lib_path)).capsim_ssd_scan
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 10
                       + [ctypes.c_void_p])
        times = {}
        for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
            xs, bs, cs = (t.to("cuda", dtype) for t in (x, Bm, Cm))
            y = torch.empty_like(xs)
            st = torch.empty(Bt, H, P, N, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                rc = fn(code, xs.data_ptr(), dt.data_ptr(), bs.data_ptr(),
                        cs.data_ptr(), A.data_ptr(), y.data_ptr(),
                        st.data_ptr(), Bt, S, H, P, N, q, xs.stride(0),
                        xs.stride(1), dt.stride(0), dt.stride(1),
                        bs.stride(0), bs.stride(1), cs.stride(0),
                        cs.stride(1), y.stride(0), y.stride(1), stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(10):
                call()
            t1.record()
            torch.cuda.synchronize()
            times[dtype] = t0.elapsed_time(t1) / 10
        f32, bf16 = times[torch.float32], times[torch.bfloat16]
        print(f"{name:11s} float32 {f32:.4f} ms  bfloat16 {bf16:.4f} ms  "
              f"ratio {bf16 / f32:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
