"""The trainer's model FLOPs a second (three times the forward's a clip;
remat's recompute not counted) over the card's peak in the training
dtype, in percent."""
from capsim_bench import cost


def read(rec, cell):
    if rec.get("trace") is None or not rec.get("steps"):
        return None
    c = cell.config
    rate = rec["steps"] * rec["batch"] / rec["window_s"]
    return cost.mfu_percent(rate, 3.0 * cost.forward_flops_per_clip(c),
                            c["train_dtype"])
