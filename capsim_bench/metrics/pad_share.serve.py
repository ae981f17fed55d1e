"""Share of the dispatched rows that were bucket padding, in percent."""


def read(rec, cell):
    rows = rec.get("counters", {})
    pad = sum(d for _, d in rows.get("capsim_predictor_pad_rows_total", []))
    real = sum(d for _, d in rows.get("capsim_predictor_clips_total", []))
    if pad + real <= 0:
        return None
    return 100.0 * pad / (pad + real)
