"""The output check's control comes out not correct: the reference put
in the program's place one precision below the configuration's.  The
serving control (fp8 products) runs here on a few requests; the training
control (TF32) changes nothing on a CPU and runs on the card."""
import time

import pytest


def test_serve_control_fails_its_limit(small_run):
    """At the configuration's widths: the errors of a precision depend on
    them, and the limit was set at them."""
    _, rec = small_run("paper.serve-mono-c3", control=True,
                       full_width=True, check_requests=8)
    got = rec["control"]["request_total_gap"]
    lim = rec["checks"][0]["limit"]
    assert got["program"] <= lim < got["reference_fp8"], got


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["paper.train-b256", "mc4.train-peer-b32"])
def test_train_control_fails_a_limit_on_the_card(input_cache, cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    from capsim_bench import harness
    c = harness.load_cell(cell)
    c.traffic.update(batch=32, warm_steps=1)
    ctx = harness.RunContext(cell=c, seed=2**31 + 3, seconds=1.0,
                             trace=False, device=torch.device("cuda", 0),
                             cache=input_cache,
                             t_start=time.perf_counter(), control=True)
    rec = harness.driver(c.kind).run(ctx)
    lims = c.workload["limits"]
    assert rec["correct"], rec["checks"]
    tf = rec["control"]["reference_tf32"]
    assert any(tf[k] > lims[k] for k in lims), (tf, lims)
