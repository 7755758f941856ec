"""BENCHMARK.json and the files the harness finds by its names."""

import json
import re

import pytest

from benchmark import cells, statements

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[key]}) == len(BENCH[key])
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(workload):
    c = cells.cell(workload)
    assert c.config["name"] == c.workload["config"]
    assert statements.module(c.config["statements"]).trace_steps(c.config, c.traffic) >= 1
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.metric_reader(m["name"]))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "proofs_per_s"}
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_moves_an_end_to_end_metric(metric):
    m = [e for e in BENCH["per_layer"] if e["name"] == metric][0]
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert set(m.get("workloads", [])) <= {w["name"] for w in BENCH["workloads"]}


def test_unknown_workload():
    with pytest.raises(KeyError):
        cells.cell("no-such-cell")
