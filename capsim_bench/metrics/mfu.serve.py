"""The service's model FLOPs a second over the card's peak in the
serving dtype, in percent: the clips completed in the traced window at
the FLOPs a clip takes in this deployment (the instruction encoder over
every row without an RT table, the block encoder and head), over the
traced window."""
from capsim_bench import cost


def read(rec, cell):
    tr = rec.get("trace")
    if tr is None or not rec.get("clips_traced"):
        return None
    c = cell.config
    rt = cell.workload["deployment"]["engine"].get("rt_cache", True)
    flops = cost.forward_flops_per_clip(c, instruction_encoder=not rt)
    return cost.mfu_percent(rec["clips_traced"] / tr.window_s, flops,
                            c["serve_dtype"])
