"""Device milliseconds a step of the kernels launched inside the MoE
layers' span ``lm/moe``: the forward and remat's recompute in the
backward (the layers' own backward kernels are launched outside it),
over the steps the trace holds (its ``train/forward`` ranges)."""


def read(rec, cell):
    tr = rec.get("trace")
    if tr is None or not tr.ranges.get("lm/moe") \
            or not tr.ranges.get("train/forward"):
        return None
    ops = tr.kernels_in_range("lm/moe")
    return sum(e - s for _, s, e, _ in ops) * 1e-6 / len(
        tr.ranges["train/forward"])
