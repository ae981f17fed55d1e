"""The manifest and the files it names, found by name alone."""
import json
import re

import pytest

from capsim_bench import harness

BENCH = json.loads((harness.REPO_ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert (harness.BENCH_DIR / "drivers" / f"{c.kind}.py").exists()
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
    assert set(c.workload["limits"]) and "deployment" in c.workload


def test_every_metric_has_a_reader_and_a_valid_name():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert callable(harness.reader(m["name"]))
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])


def test_configs_are_under_paths_and_listed_once():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        data = json.loads((harness.REPO_ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_a_metric_without_workloads_follows_what_it_moves():
    m = {"name": "x", "moves": "train_clips_per_s"}
    assert harness._reports(m, "any", ["train_clips_per_s"])
    assert not harness._reports(m, "any", ["serve_clips_per_s"])
    assert harness._reports({"name": "x", "workloads": ["a"]}, "a", [])


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no.such-cell")
