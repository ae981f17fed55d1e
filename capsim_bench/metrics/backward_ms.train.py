"""Device milliseconds a step of the kernels launched inside the train
step's ``train/backward`` range (the autograd engine's thread launches
them while the range is open), remat's recompute included."""


def read(rec, cell):
    tr = rec.get("trace")
    if tr is None or not tr.ranges.get("train/backward"):
        return None
    ops = tr.kernels_in_range("train/backward")
    return sum(e - s for _, s, e, _ in ops) * 1e-6 / len(
        tr.ranges["train/backward"])
