"""The flash kernel's share of its roofline in the service, in percent,
from the work the program counted at each launch: the least time of the
window's ``flash_attention`` launches in the serving dtype, their FLOPs
on the compute side of the ridge at the dtype's peak plus their bytes on
the memory side at the memory's rate (``capsim_kernel_flops_total`` and
``capsim_kernel_bytes_total`` by ``bound``, deltas over the window, at
``cost``'s peaks), over the device time of the flash kernels in that
dtype in the trace.  The service's float32 auditor is left out on both
sides by its dtype."""
from capsim_bench import cost


def _sum(rows, dtype, side):
    return sum(d for labels, d in rows
               if labels.get("kernel") == "flash_attention"
               and labels.get("dtype") == dtype
               and labels.get("bound") == side)


def read(rec, cell):
    tr = rec.get("trace")
    counters = rec.get("counters", {})
    if tr is None:
        return None
    dtype = cell.config["serve_dtype"]
    flops = _sum(counters.get("capsim_kernel_flops_total", []), dtype, "ops")
    nbytes = _sum(counters.get("capsim_kernel_bytes_total", []), dtype,
                  "bytes")
    least = flops / cost.PEAK_FLOPS[dtype] + nbytes / cost.PEAK_BYTES_PER_S
    got = cost.flash_ops(tr.ops, dtype)
    if least <= 0 or not got:
        return None
    busy = sum(e - s for _, s, e, _ in got) * 1e-9
    return 100.0 * least / busy
