"""The port's examples (``examples/*_torch.py``) run on the CPU at a small
size when asked for it (``--device cpu``): each completes and returns
what it printed, finite and of the expected size."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart():
    out = _example("quickstart_torch").main(["--device", "cpu"])
    assert out["predicted"].shape == out["oracle"].shape == (16,)
    assert np.isfinite(out["predicted"]).all()
    assert (out["predicted"] > 0).all()


def test_simulate_benchmark():
    results = _example("simulate_benchmark_torch").main(
        ["--device", "cpu", "--benchmarks", "503.bwaves",
         "--interval-size", "3000", "--max-checkpoints", "1"])
    assert [r.name for r in results] == ["503.bwaves"]
    assert results[0].n_clips > 0
    assert np.isfinite(results[0].predicted_cycles)


def test_train_capsim(tmp_path):
    out = _example("train_capsim_torch").main(
        ["--device", "cpu", "--fast", "--steps", "3", "--batch-size", "4",
         "--ckpt-dir", str(tmp_path / "ckpt")])
    assert out["steps"] == 3
    assert np.isfinite(out["val"]) and np.isfinite(out["test"])


def test_train_lm(tmp_path):
    out = _example("train_lm_torch").main(
        ["--device", "cpu", "--arch", "qwen3-4b", "--steps", "5",
         "--seq-len", "16", "--batch-size", "2", "--ckpt-dir",
         str(tmp_path / "ckpt")])
    assert out["steps"] == 5
    assert out["losses"] and np.isfinite(out["losses"]).all()
