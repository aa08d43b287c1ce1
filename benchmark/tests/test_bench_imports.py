"""Nothing that the benchmark runs loads JAX, flax or the JAX package; the
check compares whole top-level names, since the port's name begins with the
JAX package's."""

import os
import subprocess
import sys
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = """
import sys, time, torch
sys.path.insert(0, "benchmark/tests")
from bench_tiny import CELLS, run_tiny
from benchmark import harness, readings, run
for cell in CELLS:
    result, _ = run_tiny(cell, trace=True)
spec = harness.benchmark_spec()
for m in spec["per_layer"]:
    harness.load_metric(m["name"])
print("LOADED", ",".join(harness.forbidden_modules()))
print("PORT", "howl_tpu_torch" in sys.modules)
"""


def test_a_run_of_every_cell_loads_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines() if line.startswith(("LOADED", "PORT")))
    assert lines["LOADED"].strip() == ""
    assert lines["PORT"].strip() == "True"


def test_the_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(["howl_tpu_torch", "howl_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["howl_tpu.ops.frontend", "jax._src", "jaxlib", "flax.linen"]) == [
        "flax", "howl_tpu", "jax", "jaxlib"]


def test_no_source_of_the_benchmark_imports_them():
    for path in (ROOT / "benchmark").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in harness.FORBIDDEN, (path, line)
