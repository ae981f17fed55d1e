"""The flash kernel's share of its roofline in the service, in percent:
the least time of the window's launches (from the batch shapes the
serving rung's predictor dispatched) over the device time of the flash
kernels in the serving dtype in the trace.  The service's float32
auditor, which re-runs a few clips of every eighth flush, is left out on
both sides: its counters by the driver, its kernels by their dtype.
Where the trace holds another number of launches than the shapes give,
the least time is scaled to the launches traced."""
from capsim_bench import cost


def read(rec, cell):
    tr = rec.get("trace")
    rows = rec.get("counters", {}).get("capsim_predictor_batches_total")
    if tr is None or not rows:
        return None
    c = cell.config
    want_n, want_s = 0, 0.0
    for labels, n in rows:
        for flops, nbytes in cost.flash_launches(c, int(labels["shape"]),
                                                 c["serve_dtype"]):
            want_n += n
            want_s += n * cost.least_seconds(flops, nbytes, c["serve_dtype"])
    got = cost.flash_ops(tr.ops, c["serve_dtype"])
    if not got or not want_n:
        return None
    busy = sum(e - s for _, s, e, _ in got) * 1e-9
    return 100.0 * want_s * (len(got) / want_n) / busy
