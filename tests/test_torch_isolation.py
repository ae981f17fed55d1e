"""The port stands alone: importing every ``repro_torch`` module, and
``chip_smoke.py``, loads neither JAX nor anything of the ``repro``
package, and the entry points (the training launcher and the data mesh
among them) refuse to fall back to the CPU."""
import argparse
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, importlib.util, pkgutil, sys
sys.path.insert(0, {src!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_repro():
    code = _PROBE.format(src=str(ROOT / "src"),
                         smoke=str(ROOT / "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 20, out.stdout          # every module was imported
    assert bad.strip() == "[]", bad


EXAMPLES = ("quickstart_torch", "simulate_benchmark_torch",
            "train_capsim_torch", "train_lm_torch")


def _example(name: str):
    """An example script of ``examples/`` as a module (not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_sources_name_no_reference_import():
    for path in list((ROOT / "src" / "repro_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"] + [ROOT / "examples" / f"{n}.py"
                                       for n in EXAMPLES]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "repro"), (path, line)


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.configs.capsim import smoke_config
    from repro_torch.core import lstm_baseline, predictor
    from repro_torch.core import standardize as std_mod
    from repro_torch.core.engine import SimulationEngine
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.core.rt_cache import RTCache
    from repro_torch.core.simulate import capsim_simulate_multicore
    from repro_torch.isa import multicore
    from repro_torch.launch import serve
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.specs import random_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import PredictorEngine, SimulationService
    cfg = smoke_config()
    params = predictor.init_params(cfg, device="cpu")
    vocab = std_mod.build_vocab()
    mb = multicore.build_multicore_benchmark("mt.mix", 2)
    for build in (lambda: predictor.init_params(cfg),
                  lambda: RTCache(params, cfg),
                  lambda: SimulationEngine(params, cfg, vocab),
                  lambda: SimulationEngine(params, cfg,
                                           vocab).run_multicore([mb]),
                  lambda: capsim_simulate_multicore(mb, params, cfg,
                                                    vocab),
                  lambda: PredictorEngine(params, cfg),
                  lambda: SimulationService(params, cfg),
                  lambda: make_data_mesh(2),
                  lambda: make_data_mesh(2, "cuda:0", on_one_device=True),
                  lambda: SimulationEngine(params, cfg, vocab,
                                           EngineConfig(mesh_shape=(2,))),
                  lambda: serve.main(["--mesh", "2", "--n-benchmarks",
                                      "1"]),
                  lambda: serve.main(["--engine-config",
                                      '{"mesh_shape": [1]}',
                                      "--n-benchmarks", "1"]),
                  lambda: train.main(["--smoke", "--steps", "1",
                                      "--ckpt-dir", str(tmp_path / "c")]),
                  lambda: train.main(["--smoke", "--steps", "1",
                                      "--multicore", "2",
                                      "--ckpt-dir", str(tmp_path / "m")]),
                  lambda: lstm_baseline.init_params(cfg),
                  *(lambda m=_example(name): m.main([])
                    for name in EXAMPLES)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # the LM zoo's dense decoders, its MoE and hybrid models and its
    # frontend and codebook models
    for arch in ("olmo-1b", "qwen3-4b", "internlm2-20b", "nemotron-4-15b",
                 "kimi-k2-1t-a32b", "llama4-maverick-400b-a17b",
                 "jamba-1.5-large-398b", "qwen2-vl-2b", "musicgen-large"):
        lm = get_smoke_config(arch)
        lm_params = tfm.init_params(lm, device="cpu")
        batch = random_batch(lm, ShapeConfig("p", 12, 1, "prefill"),
                             "prefill", device="cpu")
        for call in (lambda: tfm.init_params(lm),
                     lambda: tfm.init_cache(lm, 1, 8),
                     lambda: serve.generate(lm_params, lm, batch, 1),
                     lambda: random_batch(lm, ShapeConfig("p", 4, 1,
                                                          "prefill"),
                                          "prefill"),
                     lambda: random_batch(lm, ShapeConfig("t", 12, 1,
                                                          "train"),
                                          "train"),
                     lambda: train.main(["--arch", arch, "--smoke",
                                         "--steps", "1", "--ckpt-dir",
                                         str(tmp_path / arch)]),
                     lambda: serve.serve_lm(argparse.Namespace(
                         arch=arch, device="cuda", decode_steps=1))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
