"""Clips of every request completed in the window, over its seconds."""


def read(rec, cell):
    if "clips_in_window" not in rec:
        return None
    return rec["clips_in_window"] / rec["window_s"]
