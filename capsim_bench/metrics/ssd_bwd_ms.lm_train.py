"""Device milliseconds a step of the kernels launched inside the SSD
scan's backward, the span ``ssd/backward`` (the autograd engine's thread
opens it around the plain version's recompute and its gradient), over
the steps the trace holds (its ``train/forward`` ranges)."""


def read(rec, cell):
    tr = rec.get("trace")
    if tr is None or not tr.ranges.get("ssd/backward") \
            or not tr.ranges.get("train/forward"):
        return None
    ops = tr.kernels_in_range("ssd/backward")
    return sum(e - s for _, s, e, _ in ops) * 1e-6 / len(
        tr.ranges["train/forward"])
