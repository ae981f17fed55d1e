"""Closed-loop clients of the simulation service.

``clients`` clients each submit one request through
``SimulationService.submit``, wait on ``ServiceTicket.result()``, and
submit the next, until the window closes; requests still in flight then
run to their end.  Requests are the mix's intervals (``inputs.
request_pool``), taken in passes over the whole pool, each pass in an
order drawn from the seed: every seed serves the same set of requests.

End to end: every clip of every request completed in the window over the
window's seconds, and the 95th percentile of submit-to-result over every
request submitted in it (one that failed counts as infinitely late).
The output check then compares a sample of the completed requests, drawn
from the seed with the largest among them, with the reference at the
configuration's serving precision (bf16 products over float32 weights).
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from capsim_bench import compare, harness, inputs
from capsim_bench.reference import capsim as ref
from capsim_bench.trace import Profile


def _requests(pool):
    """The pool's requests as the program takes them: int32 tokens, a
    float32 mask."""
    off = pool["offsets"]
    out = []
    for i in range(len(off) - 1):
        s = slice(off[i], off[i + 1])
        out.append((pool["clip_tokens"][s].astype(np.int32),
                    pool["context_tokens"][s].astype(np.int32),
                    pool["clip_mask"][s].astype(np.float32)))
    return out


def arch_config(c: dict, dtype: str):
    from repro_torch.configs.capsim import ArchConfig
    return ArchConfig(name=c["name"], d_model=c["d_model"],
                      num_heads=c["num_heads"], head_dim=c["head_dim"],
                      d_ff=c["d_ff"], vocab_size=c["vocab_size"],
                      clip_tokens=c["clip_tokens"],
                      context_tokens=c["context_tokens"], dtype=dtype,
                      param_dtype=c["param_dtype"], remat=c["remat"])


class _Order:
    """The next request index: passes over the pool, each in an order
    drawn from the seed."""

    def __init__(self, n: int, seed: int):
        self._rng = np.random.default_rng(seed)
        self._n = n
        self._left: list = []
        self.count = 0

    def next(self):
        """(a request id, the pool index of the request)."""
        if not self._left:
            self._left = list(self._rng.permutation(self._n))[::-1]
        self.count += 1
        return self.count, int(self._left.pop())


def _loop(service, reqs, order, n_clients, seconds, timeout):
    """Keep ``n_clients`` requests in flight for ``seconds``: each client
    submits its next request when its last one has its result.  One
    thread drives every client, so the benchmark adds one thread, not
    ``n_clients``, to the host the service runs on.  The service resolves
    a flush's requests together and its flushes in order, so the thread
    waits on the oldest ticket and then takes every other finished one.
    Returns (records, t0, t_end): one record (submit, done, status, total,
    clips, pool index) a request."""
    from repro_torch.serving.engine import Request
    records, flight = [], []
    t0 = time.perf_counter()
    t_end = t0 + seconds

    def submit():
        rid, idx = order.next()
        tok, ctx, mask = reqs[idx]
        ts = time.perf_counter()
        flight.append((ts, idx, tok.shape[0],
                       service.submit(Request(rid, tok, ctx, mask))))

    for _ in range(n_clients):
        submit()
    while flight:
        try:
            flight[0][3].result(timeout)
        except TimeoutError:
            pass
        td = time.perf_counter()
        waiting = []
        for f in flight:
            ts, idx, n, ticket = f
            if ticket.done():
                res = ticket.result(0)
                records.append((ts, td, res.status, res.total_cycles, n, idx))
            elif td - ts >= timeout:
                records.append((ts, td, "timeout", None, n, idx))
            else:
                waiting.append(f)
        finished = len(flight) - len(waiting)
        flight = waiting
        if td < t_end:
            for _ in range(finished):
                submit()
    return records, t0, t_end


def _counters():
    from repro_torch.obs import REGISTRY
    return REGISTRY.snapshot()


def counter_deltas(before: dict, after: dict) -> dict:
    """{family: [(labels, delta)]}: counters' value deltas, histograms'
    (sum, count) deltas, over every cell of the registry."""
    out = {}
    for name, fam in after.items():
        old = {tuple(sorted(v["labels"].items())): v
               for v in before.get(name, {}).get("values", [])}
        rows = []
        for v in fam["values"]:
            o = old.get(tuple(sorted(v["labels"].items())))
            if "count" in v:
                d = (v["sum"] - (o["sum"] if o else 0.0),
                     v["count"] - (o["count"] if o else 0))
            elif fam["kind"] == "counter":
                d = v["value"] - (o["value"] if o else 0.0)
            else:
                continue
            rows.append((v["labels"], d))
        out[name] = rows
    return out


def _auditor_instance(service):
    """The instance label of the predictor behind the service's float32
    auditor, which spot-checks a few clips of every ``check_every``-th
    flush; None before its first check."""
    backend = getattr(service._reference, "_backend", None)
    return backend.instance if backend is not None else None


def serving_rows(deltas: dict, auditor) -> dict:
    """``deltas`` without the auditor predictor's rows: the predictor's
    counters then read the serving rung's work alone."""
    return {name: [r for r in rows
                   if not (name.startswith("capsim_predictor_")
                           and r[0].get("instance") == auditor)]
            for name, rows in deltas.items()}


def run(ctx) -> dict:
    c, t, w = ctx.cell.config, ctx.cell.traffic, ctx.cell.workload
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.serving import service as svc_mod

    dev = ctx.device
    reqs = _requests(inputs.request_pool(t, c, ctx.cache))
    params = ref.make_params(c, ctx.seed, dev)
    dep = w["deployment"]
    service = svc_mod.SimulationService(
        params, arch_config(c, c["serve_dtype"]),
        EngineConfig(**dep["engine"]), sla=svc_mod.ServiceSLA(**dep["sla"]),
        start_tier=dep.get("start_tier", 0), device=dev)
    service.start()

    # warm-up: a request of each remainder bucket, then full flushes, so
    # that every batch shape the window dispatches has run once
    from repro_torch.serving.engine import Request
    allc = [np.concatenate([r[i] for r in reqs[:16]]) for i in range(3)]
    b = service.config.batch_size
    sizes = [service.sla.max_flush_clips]
    while b >= 8:
        sizes.append(b)
        b //= 2
    for k, n in enumerate(sizes):
        res = service.submit(Request(-1 - k, *(a[:n] for a in allc))).result(
            t["timeout_s"])
        if not res.ok:
            raise RuntimeError(f"warm-up request failed: {res.error}")
    order = _Order(len(reqs), ctx.seed)
    _loop(service, reqs, _Order(len(reqs), ctx.seed + 1), t["clients"],
          t["warmup_s"], t["timeout_s"])
    ctx.sync()

    before = _counters()
    setup_s = time.perf_counter() - ctx.t_start
    with Profile(ctx.trace, host_ranges=False) as prof:
        records, t0, t_end = _loop(service, reqs, order, t["clients"],
                                   ctx.seconds, t["timeout_s"])
    deltas = serving_rows(counter_deltas(before, _counters()),
                          _auditor_instance(service))
    peak = ctx.device_info()
    service.stop()
    service.join_abandoned(60)
    del service
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ok = [r for r in records if r[2] in ("ok", "degraded")]
    lat = [(r[1] - r[0]) if r[2] in ("ok", "degraded") else math.inf
           for r in records]
    rec = {"setup_s": setup_s, "window_s": ctx.seconds,
           "attempted": len(records), "failed": len(records) - len(ok),
           "latencies_s": lat,
           "clips_in_window": sum(r[4] for r in ok if r[1] <= t_end),
           "clips_traced": sum(r[4] for r in ok),
           "counters": deltas, "trace": prof.trace, "device": peak}

    # the output check, after the window and with the program's state freed
    rng = np.random.default_rng([ctx.seed, 1])
    pick = sorted(set(rng.choice(len(ok), min(t["check_requests"], len(ok)),
                                 replace=False).tolist())) if ok else []
    if ok:
        pick.append(max(range(len(ok)), key=lambda i: ok[i][4]))
    picked = [ok[i] for i in sorted(set(pick))]
    dt = c["serve_dtype"]
    want = _reference_totals(params, reqs, picked, c, dev, None, dt)
    got = [r[3] for r in picked]
    # no answer at all reads as a gap of the whole total
    gap = compare.widest_gap(got, want) if picked else 1.0
    lim = w["limits"]["request_total_gap"]
    rec["checks"] = [{"name": "request_total_gap", "value": gap,
                      "limit": lim}]
    rec["correct"] = bool(ok) and len(ok) == len(records) and gap <= lim
    if ctx.control:
        fp8 = _reference_totals(params, reqs, picked, c, dev, "fp8", dt)
        f32 = _reference_totals(params, reqs, picked, c, dev, None,
                                "float32")
        rec["control"] = {"request_total_gap": {
            "program": gap, "reference_fp8": compare.widest_gap(fp8, want),
            "program_vs_float32": compare.widest_gap(got, f32)},
            "requests_compared": len(picked)}
    return rec


def _reference_totals(params, reqs, picked, c, dev, quant, dtype):
    """Each picked request's total cycles by the reference in ``dtype``
    with TF32 off (with ``quant``, the control's precision)."""
    with harness.tf32(False):
        out = []
        for r in picked:
            tok, ctx_, mask = reqs[r[5]]
            clips = {"clip_tokens": torch.from_numpy(tok).to(dev),
                     "context_tokens": torch.from_numpy(ctx_).to(dev),
                     "clip_mask": torch.from_numpy(mask).to(dev)}
            out.append(float(ref.predict(params, clips, c, quant, dtype)
                             .double().sum()))
    return out
