"""The benchmark's files: every cell names a configuration, an entry and
a builder that exist, every metric of ``BENCHMARK.json`` has a reader
and every reader a metric, and ``BENCHMARK.json`` says what the files
say."""

import json
import pathlib
import re

import pytest

from benchmark import harness

HERE = pathlib.Path(harness.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = sorted(p.name[:-5] for p in (HERE / "workloads").glob("*.json"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    workload, config = harness.load_cell(cell)
    assert NAME.match(cell) and NAME.match(workload["config"])
    assert config["name"] == workload["config"]
    assert (HERE / "entries" / f"{workload['entry']}.py").is_file()
    assert (HERE / "builders" / f"{config['builder']}.py").is_file()
    assert workload["chips"] in (1, 4)
    assert 0 < len(workload["why"]) <= 200 and "\n" not in workload["why"]
    assert workload["limits"] and all(
        v > 0 for v in workload["limits"].values())
    assert all(NAME.match(k) for k in config["reduced"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_in_benchmark_json(cell):
    spec = harness.load_spec()
    workload, _ = harness.load_cell(cell)
    row = next(w for w in spec["workloads"] if w["name"] == cell)
    assert row["config"] == workload["config"]
    assert row["chips"] == workload["chips"]
    assert row["why"] == workload["why"]
    # setup_s, one more end-to-end metric and one per-layer metric at
    # least; each per-layer metric moves one the cell reports.
    e2e = {m["name"] for m in harness.cell_metrics(spec, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.cell_metrics(spec, cell, "per_layer")
    assert per_layer
    assert all(m["moves"] in e2e for m in per_layer)


def test_every_metric_has_a_reader():
    spec = harness.load_spec()
    metrics = spec["end_to_end"] + spec["per_layer"]
    readers = {p.stem: harness.load_module(p)
               for p in (HERE / "metrics").glob("*.py")}
    assert set(readers) == {m["name"] for m in metrics}
    assert all(callable(r.read) for r in readers.values())
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert set(m.get("workloads", [])) <= set(CELLS)
    for m in spec["per_layer"]:
        assert m["moves"] in e2e


def test_benchmark_json_configs():
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert {c["name"] for c in spec["configs"]} == {
        harness.load_cell(cell)[0]["config"] for cell in CELLS}
    assert {w["name"] for w in spec["workloads"]} == set(CELLS)
    for c in spec["configs"]:
        with open(HERE.parent / c["file"]) as f:
            config = json.load(f)
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        assert config["source"] == c["source"]
        assert 0 < len(c["source"]) <= 200
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
