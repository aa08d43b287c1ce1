"""Tiny sizes of each cell's traffic, for the CPU tests: the same modes and
engines on the kernels' plain versions."""

import atexit
import json
import shutil
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
TINY = {
    "res8-offline-long": {"batch": 4, "clip_seconds": 3.0, "pool_batches": 2, "check_recordings": 4},
    "res8-live-65k": {"streams": 6, "ring_hops": 3, "check_streams": 6, "warmup_hops": 12},
    "mobilenet-offline-clips": {"batch": 4, "clip_seconds": 1.5, "pool_batches": 2, "check_recordings": 4},
    "mobilenet-live-4k": {"streams": 6, "ring_hops": 3, "check_streams": 6, "warmup_hops": 4},
}
CELLS = tuple(TINY)
# the warm-up's hops are checked too, so a slow machine's short window still checks a dozen hops
SEED = 2**31 + 12_345  # past 32 signed bits, as the driver's seeds are
# cells whose files the benchmark keeps without an entry in BENCHMARK.json (PERF.md, Open questions): run from a
# root whose BENCHMARK.json adds the entry, and their end-to-end metrics
LATER = {"mobilenet-live-4k": ({"config": "mobilenet-hey-ff", "traffic": "live_4k"}, ("live_streams", "hop_ms_p95"))}
_roots = {}


def root_for(cell: str) -> Path:
    """The repository's root, or for a cell kept for later a temporary root
    beside it: the benchmark's folder linked, BENCHMARK.json with the cell."""
    if cell not in LATER:
        return ROOT
    if cell not in _roots:
        entry, e2e = LATER[cell]
        tmp = Path(tempfile.mkdtemp(prefix="bench-later-"))
        atexit.register(shutil.rmtree, tmp, True)
        (tmp / "benchmark").symlink_to(ROOT / "benchmark", target_is_directory=True)
        spec = json.loads((ROOT / "BENCHMARK.json").read_text())
        spec["workloads"].append({"name": cell, **entry, "chips": 1, "why": "kept for later"})
        for m in spec["end_to_end"]:
            if m["name"] in e2e:
                m["workloads"].append(cell)
        (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
        _roots[cell] = tmp
    return _roots[cell]


def run_tiny(cell: str, seconds: float = 0.3, trace: bool = False, control: bool = False, root=None, **override):
    from benchmark import run

    return run.run_cell(cell, SEED, seconds, trace, torch.device("cpu"), root=root or root_for(cell),
                        t0=time.perf_counter(), traffic_override={**TINY.get(cell, {}), **override},
                        control=control)
