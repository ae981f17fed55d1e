"""What the benchmark may import: never JAX or the JAX package, and in
the reference and the frozen front-end nothing of the program."""
import ast

import pytest

from capsim_bench import harness

SOURCES = sorted(p for p in harness.BENCH_DIR.rglob("*.py")
                 if "tests" not in p.parts)


def _top_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_and_no_jax_package(path):
    assert not _top_imports(path) & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name in (
    "reference", "frontend") or p.name in ("cost.py", "compare.py",
                                          "inputs.py", "trace.py")],
    ids=lambda p: p.name)
def test_yardstick_free_of_the_program(path):
    assert "repro_torch" not in _top_imports(path)


def test_names_compared_whole():
    assert harness.forbidden_loaded({"repro_torch": 1,
                                     "repro_torch.core": 1}) == []
    assert harness.forbidden_loaded({"repro.core.engine": 1}) == ["repro"]
    assert harness.forbidden_loaded({"jax.numpy": 1, "jaxlib": 1}) == [
        "jax", "jaxlib"]
    assert harness.forbidden_loaded({"jaxtyping": 1}) == []
