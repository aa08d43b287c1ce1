"""Profiling hooks (counterpart of ``howl_tpu/utils/profiling.py``; the
reference has none).

``trace(log_dir)`` wraps a block in a ``torch.profiler`` trace that
TensorBoard or Perfetto opens: a Chrome trace JSON written under
``log_dir``. The CUDA activity joins the CPU one when the work is on the
card (``device``, default: whenever CUDA is available); the context yields
the profiler, whose ``key_averages()`` name the kernels it saw. ``StepTimer``
records per-step wall times and reports percentiles.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import List

import torch


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the block; on exit the trace is written to
    ``log_dir/trace_<pid>_<ns>.json``, whose path the profiler's
    ``trace_path`` attribute then holds."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize()
    prof.trace_path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(prof.trace_path))


class StepTimer:
    def __init__(self):
        self.times: List[float] = []
        self._start = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._start)

    def summary(self) -> dict:
        import numpy as np

        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
        }
