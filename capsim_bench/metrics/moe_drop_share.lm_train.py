"""Share of the (token, slot) pairs routed to the experts held here that
their capacity dropped, in percent: the program's
``capsim_moe_slots_total{outcome}`` counter, deltas over the window."""

FAMILY = "capsim_moe_slots_total"


def read(rec, cell):
    rows = rec.get("counters", {}).get(FAMILY, [])
    n = {o: sum(d for labels, d in rows if labels.get("outcome") == o)
         for o in ("kept", "dropped")}
    if n["kept"] + n["dropped"] <= 0:
        return None
    return 100.0 * n["dropped"] / (n["kept"] + n["dropped"])
