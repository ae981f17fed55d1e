"""The flash kernel's share of its roofline in training, in percent: the
least time of a step's launches (the forward and, under remat, its
recompute, at the step's fixed shapes) times the steps the trace holds,
over the device time of the flash kernels in it."""
from capsim_bench import cost


def read(rec, cell):
    tr = rec.get("trace")
    if tr is None:
        return None
    c = cell.config
    step = cost.flash_launches(c, rec["batch"], c["train_dtype"])
    step = step * (2 if c["remat"] else 1)
    got = cost.flash_ops(tr.ops, c["train_dtype"])
    if not got:
        return None
    least = sum(cost.least_seconds(f, b, c["train_dtype"]) for f, b in step)
    busy = sum(e - s for _, s, e, _ in got) * 1e-9
    return 100.0 * least * (len(got) / len(step)) / busy
