"""Mean milliseconds a served request waited in the service's queue,
from admission to the start of the flush window that served it: the
program's ``capsim_service_queue_wait_seconds`` histogram, sum over
count, as deltas over the window."""


def read(rec, cell):
    rows = rec.get("counters", {}).get("capsim_service_queue_wait_seconds")
    if not rows:
        return None
    total = sum(d[0] for _, d in rows)
    count = sum(d[1] for _, d in rows)
    if not count:
        return None
    return 1e3 * total / count
