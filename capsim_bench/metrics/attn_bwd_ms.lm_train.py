"""Device milliseconds a step of the kernels launched inside flash
attention's backward, the span ``flash_attention_backward`` (the
autograd engine's thread opens it around the backward kernels, or, in a
program that recomputes, around the plain version's recompute and its
gradient), over the steps the trace holds (its ``train/forward``
ranges)."""


def read(rec, cell):
    tr = rec.get("trace")
    if tr is None or not tr.ranges.get("flash_attention_backward") \
            or not tr.ranges.get("train/forward"):
        return None
    ops = tr.kernels_in_range("flash_attention_backward")
    return sum(e - s for _, s, e, _ in ops) * 1e-6 / len(
        tr.ranges["train/forward"])
