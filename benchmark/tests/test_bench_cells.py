"""Every cell's mode end to end at a tiny size on the CPU, on the kernels'
plain versions: the result line has the contract's shape and is correct."""

import json

import pytest
from bench_tiny import CELLS, root_for, run_tiny

from benchmark import harness


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_prints_the_contracts_line(cell):
    result, lines = run_tiny(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    spec = harness.benchmark_spec(root_for(cell))
    want = {m["name"] for m in harness.cell_metrics(cell, spec, "end_to_end")}
    assert set(result["metrics"]) == want and "setup_s" in want
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    dev = result["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1 and "memory_peak_bytes" in dev
    assert set(result["checks"]) == set(harness.load_limits(cell))
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(result)
    assert all(json.loads(line) for line in lines)


@pytest.mark.parametrize("cell", ["res8-offline-long", "res8-live-65k"])
def test_traced_run_profiles_a_slice_of_the_window(cell):
    """The slice is traced once the window has closed. On the CPU it has no
    device events: no per-layer metric is read (a reader that finds nothing
    returns nothing), busy_s is 0."""
    result, _ = run_tiny(cell, seconds=0.6, trace=True)
    assert result["correct"] is True
    assert result["metrics"] == {}
    assert result["device"]["window_s"] > 0 and result["device"]["busy_s"] == 0.0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"


def test_every_cell_has_its_files():
    spec = harness.benchmark_spec()
    for cell in spec["workloads"]:
        cfg = harness.load_config(cell["config"])
        assert cfg.data["name"] == cell["config"]
        traffic = harness.load_traffic(cell["traffic"])
        harness.load_mode(traffic["mode"])
        assert harness.load_limits(cell["name"])["decision_mismatches"] == 0
    for m in spec["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)


def test_benchmark_json_keeps_to_the_contracts_shape():
    spec = harness.benchmark_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    budget = 2 + 14 * 24
    assert budget * (spec["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
