"""Mean host milliseconds of a dispatch's copies of its batch to the
device: the serving rung's ``predict.h2d`` span, the program's
``capsim_span_seconds`` histogram, sum over count, as deltas over the
window.  The serving rung is each predictor instance that counted clips
in ``capsim_predictor_clips_total``, from which the driver leaves out
the f32 auditor's rows."""

SPAN = "predict.h2d"


def read(rec, cell):
    counters = rec.get("counters", {})
    serving = {labels.get("instance") for labels, d in
               counters.get("capsim_predictor_clips_total", []) if d}
    rows = [d for labels, d in counters.get("capsim_span_seconds", [])
            if labels.get("span") == SPAN
            and labels.get("instance") in serving]
    count = sum(d[1] for d in rows)
    if not count:
        return None
    return 1e3 * sum(d[0] for d in rows) / count
