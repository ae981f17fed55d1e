"""Real clips per watchdogged flush of the service: the predictor's clip
counter over the flush histogram's count, both as deltas over the
window."""


def _sum(rec, name, count=False):
    rows = rec.get("counters", {}).get(name, [])
    return sum((d[1] if count else d[0]) if isinstance(d, tuple) else d
               for _, d in rows)


def read(rec, cell):
    flushes = _sum(rec, "capsim_service_flush_seconds", count=True)
    if not flushes:
        return None
    return _sum(rec, "capsim_predictor_clips_total") / flushes
