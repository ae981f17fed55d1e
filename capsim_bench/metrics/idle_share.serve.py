"""Share of the traced window in which no operation ran on the device,
in percent."""


def read(rec, cell):
    tr = rec.get("trace")
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
