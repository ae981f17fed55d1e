"""A run driven with the timed path broken underneath comes out not
correct, once for each fault the cell can have; unbroken, it comes out
correct.  The cells run cut to a small width on the CPU: everything but
the look for a card is the run's own code."""
import pytest
import torch


@pytest.mark.parametrize("cell", ["paper.serve-mono-c3", "paper.train-b256",
                                  "mc4.train-peer-b32"])
def test_sound_run_is_correct(small_run, cell):
    out, rec = small_run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) >= {"setup_s"}


def test_serve_answer_altered_where_it_is_produced(small_run, monkeypatch):
    """One clip in eight comes back from the predictor doubled, so every
    request holds altered answers whatever flush it lands in."""
    from repro_torch.core import predictor
    orig = predictor.forward

    def altered(*a, **kw):
        out = orig(*a, **kw).clone()
        out[::8] = out[::8] * 2
        return out
    monkeypatch.setattr(predictor, "forward", altered)
    out, _ = small_run("paper.serve-mono-c3")
    assert not out["correct"], out["checks"]


def test_serve_half_of_the_batch_left_out(small_run, monkeypatch):
    """Every other clip of a batch is left out of the prediction and reads
    0, so every request of two clips or more loses some."""
    from repro_torch.core import predictor
    orig = predictor.forward

    def half(params, batch, cfg, *a, **kw):
        out = orig(params, {key: v[::2] for key, v in batch.items()}, cfg,
                   *a, **kw)
        full = out.new_zeros(batch["clip_mask"].shape[0])
        full[::2] = out
        return full
    monkeypatch.setattr(predictor, "forward", half)
    out, _ = small_run("paper.serve-mono-c3")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["paper.train-b256", "mc4.train-peer-b32"])
def test_train_step_returns_its_state_unchanged(small_run, monkeypatch, cell):
    from repro_torch.training import train_loop
    orig = train_loop.make_train_step

    def make(*a, **kw):
        step = orig(*a, **kw)

        def unchanged(state, batch):
            _, metrics = step(state, batch)
            return state, metrics
        return unchanged
    monkeypatch.setattr(train_loop, "make_train_step", make)
    out, _ = small_run(cell)
    assert not out["correct"], out["checks"]
    assert {c["name"]: c["value"] for c in out["checks"]}["change_gap"] > 0.5


@pytest.mark.parametrize("cell", ["paper.train-b256", "mc4.train-peer-b32"])
def test_train_step_leaves_one_leaf_unmoved(small_run, monkeypatch, cell):
    """The update skips the head's last weight: the loss of the warm-up's
    first steps, the momentum and the median leaf's change stay right."""
    from repro_torch.training import train_loop
    orig = train_loop.make_train_step

    def make(*a, **kw):
        step = orig(*a, **kw)

        def frozen(state, batch):
            new, metrics = step(state, batch)
            head = dict(new["params"]["head"],
                        w2=state["params"]["head"]["w2"])
            new = dict(new, params=dict(new["params"], head=head))
            return new, metrics
        return frozen
    monkeypatch.setattr(train_loop, "make_train_step", make)
    out, _ = small_run(cell)
    assert not out["correct"], out["checks"]
    got = {c["name"]: c["value"] for c in out["checks"]}
    assert got["change_worst_gap"] > 0.5 and got["change_gap"] < 0.5, got


@pytest.mark.parametrize("cell", ["paper.train-b256", "mc4.train-peer-b32"])
def test_train_half_of_the_batch_left_out(small_run, monkeypatch, cell):
    """The loss is the mean over the first half of the batch alone."""
    from repro_torch.core import predictor
    orig = predictor.mape_loss

    def half(params, batch, cfg, *a, **kw):
        k = batch["time"].shape[0] // 2
        return orig(params, {key: v[:k] for key, v in batch.items()}, cfg,
                    *a, **kw)
    monkeypatch.setattr(predictor, "mape_loss", half)
    out, _ = small_run(cell)
    assert not out["correct"], out["checks"]


def test_a_split_smaller_than_a_batch_is_refused(small_run):
    with pytest.raises(ValueError, match="fewer than a batch"):
        small_run("paper.train-b256", batch=4096)
