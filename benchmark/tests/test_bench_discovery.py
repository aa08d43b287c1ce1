"""A cell, a configuration, a traffic mix and a per-layer metric added as new
files (and a new entry in BENCHMARK.json) are found and run without an edit
to any file the benchmark has."""

import json
import shutil
from pathlib import Path

from bench_tiny import TINY, run_tiny

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_picked_up(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    before = {p.relative_to(b): p.read_bytes() for p in b.rglob("*") if p.is_file()}
    # a configuration whose module builds its model with an argument the shared code never sees
    cfg = json.loads((b / "configs" / "mobilenet-hey-ff.json").read_text())
    cfg.update(name="mobilenet-nodrop", dropout=0.0)
    (b / "configs" / "mobilenet-nodrop.json").write_text(json.dumps(cfg))
    module = (b / "configs" / "mobilenet-hey-ff.py").read_text()
    built = 'create_model(cfg["model"], num_labels=cfg["num_labels"], width_mult=cfg["width_mult"])'
    assert built in module
    module = module.replace(built, built[:-1] + ', dropout=cfg["dropout"])')
    (b / "configs" / "mobilenet-nodrop.py").write_text(module)
    # a traffic mix, a cell's limits, a per-layer metric
    traffic = json.loads((b / "traffic" / "eval_clips.json").read_text())
    traffic.update(TINY["mobilenet-offline-clips"], clip_seconds=1.0)
    (b / "traffic" / "short_clips.json").write_text(json.dumps(traffic))
    limits = {"probs_gap": 1.0, "decision_mismatches": 0}
    (b / "limits" / "mobilenet-nodrop-short.json").write_text(json.dumps(limits))
    (b / "metrics" / "calls.offline.py").write_text("def read(sl):\n    return float(sl.calls)\n")
    spec["configs"].append({"name": "mobilenet-nodrop", "source": "https://example.org/mobilenet-nodrop",
                            "file": "benchmark/configs/mobilenet-nodrop.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "mobilenet-nodrop-short", "config": "mobilenet-nodrop",
                              "traffic": "short_clips", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "offline_rtf":
            m["workloads"].append("mobilenet-nodrop-short")
    spec["per_layer"].append({"name": "calls.offline", "unit": "batches", "better": "higher",
                              "source": "program_counter", "layer": "engine", "moves": "offline_rtf",
                              "workloads": ["mobilenet-nodrop-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    result, _ = run_tiny("mobilenet-nodrop-short", root=tmp_path)
    assert result["correct"] and set(result["metrics"]) == {"offline_rtf", "setup_s"}
    traced, _ = run_tiny("mobilenet-nodrop-short", seconds=0.6, trace=True, root=tmp_path)
    assert traced["metrics"]["calls.offline"]["value"] >= 2
    after = {p.relative_to(b): p.read_bytes() for p in b.rglob("*") if p.is_file() and "__pycache__" not in str(p)}
    assert all(after[k] == v for k, v in before.items())
