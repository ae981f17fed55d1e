"""Roofline terms of a dry-run cell on an NVIDIA H100, and the model-FLOPs
yardstick (port of ``repro/launch/roofline.py``).

Terms, per device (H100 SXM, NVIDIA's data sheet, dense rates at the
700 W limit):
    compute term    = FLOPs / peak FLOP/s      (989 TFLOP/s bf16, 67 f32)
    memory term     = HBM bytes / HBM rate     (3.35 TB/s)
    collective term = wire bytes / link rate   (NVLink 4: 900 GB/s a GPU
                                                both ways, 450 GB/s each)

The reference parses its collectives out of compiled HLO text
(``parse_collectives``, kept verbatim so its HLO gives the same
numbers); the port issues its own and records them
(``distributed.collectives.record_collectives``,
``collectives_from_records``).  Both go through one ring model of wire
bytes per op from the group size g (``wire_bytes``):
    all-reduce          2 * bytes * (g-1)/g
    all-gather          out_bytes * (g-1)/g
    reduce-scatter      out_bytes * (g-1)          (out = in/g)
    all-to-all          bytes * (g-1)/g
    collective-permute  bytes                      (single hop)
"""
from __future__ import annotations

import math
import re
from typing import Dict, Tuple

# NVIDIA H100 SXM, per card (data sheet; dense, no sparsity)
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9           # NVLink 4, one direction (900 GB/s both ways)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")

# e.g. "bf16[256,4096,128]{2,1,0}" -> (dtype, numel)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
# replica_groups={{0,1},{2,3}} or replica_groups=[32,16]<=[512]
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")


def wire_bytes(op: str, nbytes: float, g: int) -> float:
    """Bytes one device sends for collective ``op`` whose result is
    ``nbytes``, over a ring of ``g`` devices (the module docstring)."""
    if op == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if op in ("all-gather", "all-to-all"):
        return nbytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(nbytes) * (g - 1)
    if op == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {op!r}")


def _result_bytes(result_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(result_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))       # [num_groups, group_size]<=[total]
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len([x for x in m.group(1).split(",") if x.strip()])
    return 2                          # unknown: conservative


def _add(out: dict, op: str, nbytes: float, g: int) -> None:
    d = out.setdefault(op, {"count": 0, "bytes": 0.0, "wire_bytes": 0.0})
    d["count"] += 1
    d["bytes"] += nbytes
    d["wire_bytes"] += wire_bytes(op, nbytes, g)


def parse_collectives(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """Returns {op_type: {count, bytes, wire_bytes}} per-device totals of
    compiled HLO text (the reference's, verbatim)."""
    out: Dict[str, Dict[str, float]] = {}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if not stripped or "=" not in stripped:
            continue
        # match ' = <result-type> <opname>(' ; skip -done ops (size counted
        # at -start) but count plain and -start forms.
        m = re.search(r"=\s+(\(?[\w\[\],{}\s]*?\)?)\s+([\w-]+)\(", stripped)
        if not m:
            continue
        result_str, opname = m.group(1), m.group(2)
        base = None
        for op in _COLL_OPS:
            if opname == op or opname == op + "-start":
                base = op
                break
        if base is None:
            continue
        _add(out, base, _result_bytes(result_str), _group_size(stripped))
    return out


def collectives_from_records(records) -> Dict[str, Dict[str, float]]:
    """{op: {count, bytes, wire_bytes}} of the port's recorded collectives
    (``collectives.Collective``: op, nbytes, group), summed as
    ``parse_collectives`` sums HLO's."""
    out: Dict[str, Dict[str, float]] = {}
    for r in records:
        _add(out, r.op, r.nbytes, r.group)
    return out


def scale_collectives(colls: dict, scale_inner: float,
                      hlo_text: str = "") -> dict:
    """Every collective's bytes scaled by ``scale_inner`` (a layer trip
    count), counts kept: the reference's first-order model for a scanned
    loop body listed once."""
    out = {}
    for k, v in colls.items():
        out[k] = {kk: vv * (scale_inner if kk != "count" else 1)
                  for kk, vv in v.items()}
    return out


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float,
                   dtype: str = "bfloat16") -> dict:
    """Compute, memory and collective seconds of one device; the compute
    term at the f32 peak for a float32 cell, else the bf16 peak."""
    peak = PEAK_FLOPS_F32 if dtype == "float32" else PEAK_FLOPS_BF16
    t_compute = flops_per_dev / peak
    t_memory = bytes_per_dev / HBM_BW
    t_coll = wire_bytes_per_dev / NVLINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    terms["dominant"] = dom
    terms["roofline_fraction"] = bound / total if total > 0 else 0.0
    return terms


# --------------------------------------------------------------------------- #
# Model FLOPs (the "useful work" yardstick)
# --------------------------------------------------------------------------- #

def is_predictor(cfg) -> bool:
    """The CAPSim predictor's config (the port's has no ``family``)."""
    from repro_torch.configs import capsim
    return isinstance(cfg, capsim.ArchConfig)


def _specs_with_paths(tree, path=()):
    """(path of keys, ParamSpec) of every leaf of a spec tree."""
    from repro_torch.models.layers import ParamSpec
    if isinstance(tree, ParamSpec):
        yield path, tree
        return
    for k in sorted(tree):
        yield from _specs_with_paths(tree[k], path + (k,))


def _count(tree) -> int:
    return sum(math.prod(s.shape) for _, s in _specs_with_paths(tree))


def _model_specs(cfg) -> dict:
    if is_predictor(cfg):
        from repro_torch.core.predictor import model_specs
    else:
        from repro_torch.models.transformer import model_specs
    return model_specs(cfg)


def param_counts(cfg) -> Tuple[int, int]:
    """(total_params, active_params) from the ParamSpec tree."""
    num_experts = getattr(cfg, "num_experts", 0)
    k_over_e = (cfg.experts_per_token / num_experts if num_experts else 1.0)
    total = 0
    active = 0.0
    for keys, spec in _specs_with_paths(_model_specs(cfg)):
        n = math.prod(spec.shape)
        total += n
        is_expert = (num_experts and "ffn" in keys
                     and len(spec.shape) >= 3
                     and num_experts in spec.shape)
        active += n * (k_over_e if is_expert else 1.0)
    return total, int(active)


def model_flops(cfg, shape, kind: str) -> float:
    """6*N_active*D for training, 2*N_active*D for inference forward.

    For the CAPSim predictor, D is the number of tokens flowing through
    the two encoders: per clip, L_clip instructions x L_token tokens in
    the instruction encoder plus M context rows in the block encoder.
    The embedding table is excluded from N (lookup, not matmul)."""
    _, active = param_counts(cfg)
    if is_predictor(cfg):
        specs = _model_specs(cfg)
        n_inst = _count(specs["inst"])
        n_block = _count(specs["block"]) + _count(specs["head"])
        B, L_clip = shape.global_batch, shape.seq_len
        tok_inst = B * L_clip * cfg.clip_tokens
        tok_block = B * cfg.context_tokens
        mult = 6.0 if kind == "train" else 2.0
        return mult * (n_inst * tok_inst + n_block * tok_block)
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    tokens = shape.global_batch  # one decoded token per sequence
    return 2.0 * active * tokens
