"""The yardstick's arithmetic for the LM cells: the work of one grouped
SSD scan call.  Frozen here so that a change to the program cannot change
what its numbers are measured against.

``ssd_cost`` is a copy of the formula the port's bounds use
(``kernels/ssd/ops.py::ssd_cost``): per chunk of L real steps, batch row
and group of B/C, C·Bᵀ over the causal half once (L(L+1)/2 pairs of N
multiply-adds); per head the decayed causal product with x·dt (L(L+1)/2
pairs of P) and L·N·P each for the carried state's output and the state
update, at 2 FLOPs a multiply-add; bytes: x read and y written, B/C of
every group, dt and A read, the float32 state written once.
"""
from __future__ import annotations

import re

# the scan's four kernels (csrc/ssd.cu), and the one launched once a call
SSD_KERNEL = re.compile(r"capsim_ssd::ssd_(cb|chunk_state|state_pass|"
                        r"chunk_out)\b")
SSD_LAST = "chunk_out"


def ssd_cost(Bt: int, S: int, H: int, P: int, N: int, q: int,
             elem_bytes: int, G: int = 1):
    """(FLOPs, HBM bytes) of one call."""
    lens = [min(q, S - t) for t in range(0, S, q)]
    flops = float(Bt * G) * sum(L * (L + 1) * N for L in lens) \
        + float(Bt * H) * sum(L * (L + 1) * P + 4 * L * N * P for L in lens)
    nbytes = (2 * Bt * S * H * P + 2 * Bt * S * G * N) * elem_bytes \
        + 4 * (Bt * S * H + H + Bt * H * P * N)
    return flops, float(nbytes)


def cell_ssd_cost(c: dict, t: dict, elem_bytes: int):
    """One call's work at an LM train cell's shapes: the configuration's
    Mamba2 sizes over the traffic's batch and sequence."""
    return ssd_cost(t["batch"], t["seq_len"], c["mamba_num_heads"],
                    c["mamba_head_dim"], c["ssm_state_size"],
                    c["chunk_size"], elem_bytes, c["n_groups"])
