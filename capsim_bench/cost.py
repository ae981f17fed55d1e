"""The yardstick's arithmetic: peaks, the work of one attention launch,
and the model's FLOPs per clip.  Frozen here so that a change to the
program cannot change what its numbers are measured against.

``attention_cost`` is a copy of the formula the port's bounds use
(``kernels/flash_attention/ops.py::attention_cost``): q, k and v read
once, o written once, the per-key mask read once as f32; QK^T and PV at 2
FLOPs a multiply-add over every (query, key) pair.
"""
from __future__ import annotations

import math
import re

# NVIDIA H100 SXM, the data sheet's dense rates at the full 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def attention_cost(B: int, Sq: int, Skv: int, H: int, D: int,
                   elem_bytes: int, masked: bool):
    """(FLOPs, HBM bytes) of one attention launch."""
    nbytes = (2 * B * Sq * H * D + 2 * B * Skv * H * D) * elem_bytes \
        + (4 * B * Skv if masked else 0)
    return 4.0 * B * H * Sq * Skv * D, float(nbytes)


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the FLOPs at the
    dtype's peak and the bytes at the memory's."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def _layer_flops(c: dict, rows: int, keys: int, kv_rows: float) -> float:
    """One pre-norm layer over ``rows`` query rows attending to ``keys``
    keys: the q/k/v and output projections (k/v over ``kv_rows`` rows),
    the attention's two products and the FFN."""
    E, HD, F = c["d_model"], c["num_heads"] * c["head_dim"], c["d_ff"]
    proj = 2.0 * rows * E * HD * 2 + 2.0 * kv_rows * E * HD * 2
    attn = 4.0 * rows * keys * HD
    return proj + attn + 4.0 * rows * E * F


def forward_flops_per_clip(c: dict, instruction_encoder: bool = True
                           ) -> float:
    """FLOPs of one clip's forward at the config's sizes: the instruction
    encoder over every one of the clip's ``clip_len`` rows of
    ``clip_tokens`` tokens (left out where an RT table serves them), the
    block encoder (context self-attention, cross-attention into the
    clip's rows) and the head over the ``context_tokens`` rows."""
    E, HD, F = c["d_model"], c["num_heads"] * c["head_dim"], c["d_ff"]
    L, T, M = c["clip_len"], c["clip_tokens"], c["context_tokens"]
    inst = L * c["n_inst_layers"] * _layer_flops(c, T, T, T) \
        if instruction_encoder else 0.0
    per_block = (_layer_flops(c, M, M, M)           # self-attention + FFN
                 + 2.0 * M * E * HD * 2              # cross q and o
                 + 4.0 * M * L * HD                  # cross attention
                 + 2.0 * L * E * HD * 2)             # cross k and v
    head = M * (2.0 * E * E + 2.0 * E)
    return inst + c["n_block_layers"] * per_block + head


def mfu_percent(clips_per_s: float, flops_per_clip: float,
                dtype: str) -> float:
    return 100.0 * clips_per_s * flops_per_clip / PEAK_FLOPS[dtype]


def encode_passes(clips: int, clip_len: int, rows_per_pass: int) -> int:
    return math.ceil(clips * clip_len / rows_per_pass)


# The port's flash-attention kernels, not its weighted-attention ones
# (``fa_fwd_<dtype><head_dim, weighted>`` instantiations).
FLASH_KERNEL = re.compile(r"fa_fwd_(bf16|f32)<\d+, ?(false|\(bool\)0)>")

# The port runs the instruction encoder's rows in launches of this many
# instructions, the last one padded (``predictor.ENCODE_CHUNK``); a reader
# scales the least time to the launches the trace holds where they differ.
ENCODE_ROWS = 4096


def flash_launches(c: dict, clips: int, dtype: str):
    """(FLOPs, bytes) of each flash launch of one forward over ``clips``
    clips: the instruction encoder's passes (masked self-attention over
    each instruction's tokens), then each block layer's context
    self-attention and its masked cross-attention into the clip's rows."""
    H, D, eb = c["num_heads"], c["head_dim"], ELEM_BYTES[dtype]
    L, T, M = c["clip_len"], c["clip_tokens"], c["context_tokens"]
    inst = attention_cost(ENCODE_ROWS, T, T, H, D, eb, True)
    self_ = attention_cost(clips, M, M, H, D, eb, False)
    cross = attention_cost(clips, M, L, H, D, eb, True)
    passes = encode_passes(clips, L, ENCODE_ROWS)
    return ([inst] * (passes * c["n_inst_layers"])
            + [self_, cross] * c["n_block_layers"])


# A flash kernel's name tag by the dtype it computes in.
KERNEL_DTYPE = {"bfloat16": "bf16", "float32": "f32"}


def flash_ops(ops, dtype: str):
    """The flash kernels in ``dtype`` among a trace's device operations."""
    found = (FLASH_KERNEL.search(o[0]) for o in ops)
    return [o for o, m in zip(ops, found)
            if m and m.group(1) == KERNEL_DTYPE[dtype]]
