"""Clips of every training step in the window (steps x batch), over the
window's seconds, which end in a synchronize."""


def read(rec, cell):
    if "steps" not in rec:
        return None
    return rec["steps"] * rec["batch"] / rec["window_s"]
