"""The grouped SSD scan kernel's share of its roofline in training, in
percent: the least time of the calls the trace holds (each at the
cell's one shape, ``lm_cost.cell_ssd_cost`` in the training dtype; a
call's four kernels end with one ``ssd_chunk_out``), over the device
time of the four kernels."""
from capsim_bench import cost, lm_cost


def read(rec, cell):
    tr = rec.get("trace")
    if tr is None:
        return None
    c = cell.config
    got = [(o, m.group(1)) for o in tr.ops
           for m in [lm_cost.SSD_KERNEL.search(o[0])] if m]
    calls = sum(1 for _, k in got if k == lm_cost.SSD_LAST)
    if not calls:
        return None
    flops, nbytes = lm_cost.cell_ssd_cost(c, cell.traffic,
                                          cost.ELEM_BYTES[c["dtype"]])
    least = calls * cost.least_seconds(flops, nbytes, c["dtype"])
    busy = sum(e - s for (_, s, e, _), _ in got) * 1e-9
    return 100.0 * least / busy
