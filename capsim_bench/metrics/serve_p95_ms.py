"""95th percentile of submit-to-result over every request submitted in
the window; a request that failed counts as later than any limit."""
import math

from capsim_bench.harness import percentile

FAILED_MS = 1e9


def read(rec, cell):
    if not rec.get("latencies_s"):
        return None
    p = percentile(rec["latencies_s"], 95)
    return FAILED_MS if math.isinf(p) else p * 1e3
