"""Profiling hooks (counterpart of ``howl_tpu/utils/profiling.py``; the
reference has none).

``trace(log_dir)`` wraps a block in a ``torch.profiler`` trace that
TensorBoard or Perfetto opens: a Chrome trace JSON written under
``log_dir``. The CUDA activity joins the CPU one when the work is on the
card (``device``, default: whenever CUDA is available); the context yields
the profiler, whose ``key_averages()`` name the kernels it saw. ``StepTimer``
records per-step wall times and reports percentiles.

F18, a fault of PyTorch's profiler that the port works around: once a
process has profiled many launches, every later session loses device
records near its start, more of them the more the process profiled before,
whatever the time between the sessions (``chip_smoke.py`` phase 17g
measures it on the card). So a session on the card opens with
``PRIMER_LAUNCHES`` one-element fills inside a ``trace_primer`` range,
waited for, which take that loss in the block's place; ``lost_at_start`` on
the profiler counts the primer's launches the session lost. Where it lost
them all, the block's first kernels may be missing too, and ``trace``
warns.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from pathlib import Path
from typing import List

import torch

PRIMER_LAUNCHES = 256  # one-element fills, a few microseconds each


def _primer_kernels(prof) -> int:
    """The device kernels the session recorded before its ``trace_primer``
    range ended (the primer's: the block starts after it)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    ends = [e.time_range.end for e in events if e.name == "trace_primer" and e.device_type != cuda]
    if not ends:
        return 0
    return sum(1 for e in events if e.device_type == cuda and e.name != "trace_primer"
               and not getattr(e, "is_user_annotation", False) and e.time_range.start < ends[0])


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the block; on exit the trace is written to
    ``log_dir/trace_<pid>_<ns>.json``, whose path the profiler's
    ``trace_path`` attribute then holds. On the card the session opens
    with the primer (F18, above)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    mark = torch.empty(1, dtype=torch.int16, device=device if device is not None else "cuda") if on_card else None
    with profile(activities=activities) as prof:
        if on_card:
            with record_function("trace_primer"):
                for _ in range(PRIMER_LAUNCHES):
                    mark.fill_(1)
                torch.cuda.synchronize()
        yield prof
        if on_card:
            torch.cuda.synchronize()
    prof.trace_path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(prof.trace_path))
    if on_card:
        prof.lost_at_start = PRIMER_LAUNCHES - _primer_kernels(prof)
        if prof.lost_at_start == PRIMER_LAUNCHES:
            warnings.warn(f"utils.profiling.trace: this session lost every one of its {PRIMER_LAUNCHES} primer "
                          "launches, so the block's first kernels may be missing from the trace: PyTorch's "
                          "profiler drops the first device records of a session once the process has profiled "
                          "many launches (F18); profile in a process of its own", RuntimeWarning, stacklevel=3)


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
