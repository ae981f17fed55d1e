"""Share of the traced window in which the service worker was not busy,
in percent.  The worker's spans, from ``capsim_span_seconds_total`` as
deltas over the driver's counter window: ``service.wait`` (an empty
queue) and the busy three, ``service.collect``, ``service.flush`` and
``service.resolve``.  The value is the wait over the wait and the busy
spans, with the wait clipped to the traced window's time outside the
busy spans.  The counter window also holds the profiler's start and its
teardown after the last request, during which the worker waits on an
empty queue, so in the driver's traced runs the clip always binds: the
value there is the traced window less the busy spans, over the traced
window, and the ``service.wait`` span only bounds it.  The busy spans
fall inside the traced window, since the loop waits for its last
request before the trace ends."""

WAIT = "service.wait"
BUSY = ("service.collect", "service.flush", "service.resolve")


def read(rec, cell):
    tr = rec.get("trace")
    rows = rec.get("counters", {}).get("capsim_span_seconds_total", [])
    wait = sum(d for labels, d in rows if labels.get("span") == WAIT)
    busy = sum(d for labels, d in rows if labels.get("span") in BUSY)
    if tr is None or busy <= 0:
        return None
    wait = min(wait, max(tr.window_s - busy, 0.0))
    return 100.0 * wait / (wait + busy)
