"""Device milliseconds a step of the kernels the host launched inside
the train step's ``train/forward`` range."""


def read(rec, cell):
    tr = rec.get("trace")
    if tr is None or not tr.ranges.get("train/forward"):
        return None
    ops = tr.kernels_in_range("train/forward")
    return sum(e - s for _, s, e, _ in ops) * 1e-6 / len(
        tr.ranges["train/forward"])
