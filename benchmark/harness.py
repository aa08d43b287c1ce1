"""What every cell shares: finding its files by name, the weights and the
inputs made from the seed, the traced slice, the result line.

A cell is an entry of the root ``BENCHMARK.json``. Its files are found by
name, so a later cell, configuration, traffic mix or metric is added as new
files and a new entry, never as an edit:

* ``configs/<config>.json``: the configuration as it is run (model, widths,
  audio, engine settings, precision, source, assumed, reduced), and
  ``configs/<config>.py`` beside it: its port engine, its plain reference
  (from ``reference/``) and its FLOP count;
* ``traffic/<traffic>.json``: a traffic mix, the mode that drives it and its
  parameters;
* ``modes/<mode>.py``: one driver for each kind of traffic;
* ``limits/<cell>.json``: the limit of each number that decides ``correct``;
* ``metrics/<metric>.py``: one reader for each per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "howl_tpu")
# NVIDIA's data sheet, H100 SXM, dense rates, at the full 700 W
PEAKS = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark found by its file name (names hold '-' and '.')."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(name: str, root: Path = ROOT) -> dict:
    for cell in benchmark_spec(root)["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def geometry(cfg: dict) -> dict:
    """The window and stride in mel frames, as the engine quantises them:
    the window's frames, the stride rounded to whole hops."""
    a, e = cfg["audio"], cfg["engine"]
    window_samples = int(e["max_window_size_ms"] / 1000 * a["sample_rate"])
    stride_frames = max(1, round(e["eval_stride_size_ms"] / 1000 * a["sample_rate"] / a["hop_length"]))
    return {"window_samples": window_samples, "window_frames": window_samples // a["hop_length"] + 1,
            "stride_frames": stride_frames, "hop_samples": stride_frames * a["hop_length"],
            "stride_ms": stride_frames * a["hop_length"] / a["sample_rate"] * 1000.0}


@dataclass
class Config:
    name: str
    data: dict  # the JSON, with "geometry" added
    module: object  # configs/<name>.py


def load_config(name: str, root: Path = ROOT) -> Config:
    data = load_json(root / "benchmark" / "configs" / f"{name}.json")
    data["geometry"] = geometry(data)
    return Config(name, data, load_module(root / "benchmark" / "configs" / f"{name}.py", f"bench_config_{name}"))


def load_traffic(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "benchmark" / "traffic" / f"{name}.json")


def load_limits(cell: str, root: Path = ROOT) -> dict:
    return load_json(root / "benchmark" / "limits" / f"{cell}.json")


def load_mode(name: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "modes" / f"{name}.py", f"bench_mode_{name}")


def load_metric(name: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "metrics" / f"{name}.py", f"bench_metric_{name.replace('.', '_')}")


def cell_metrics(cell: str, spec: dict, kind: str, e2e: Optional[set] = None) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports: those that list it, or, without a list, every end-to-end one
    and every per-layer one whose end-to-end metric the cell reports."""
    out = []
    for m in spec[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in (e2e or ()):
            out.append(m)
    return out


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The q-th percentile with linear interpolation between order statistics."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


# ---- what the seed makes ----


def make_weights(shapes: dict, seed: int, device):
    """A float32 state dict of ``shapes`` ({name: (shape, dtype)}) from the
    seed, made on the device in three calls: conv and dense weights normal
    with variance 1 / fan-in (lecun-normal), biases and BatchNorm means
    normal(0, 0.1), BatchNorm scales 1 + normal(0, 0.1), BatchNorm variances
    uniform in [0.5, 1.5]; integer buffers zero."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    kinds = {}
    for key, (shape, dtype) in shapes.items():
        if not dtype.is_floating_point:
            kinds[key] = "zero"
        elif key.endswith("running_var"):
            kinds[key] = "var"
        elif len(shape) >= 2:
            kinds[key] = "weight"
        elif key.endswith("weight"):
            kinds[key] = "scale"
        else:
            kinds[key] = "shift"
    numel = {k: math.prod(s) for k, (s, _) in shapes.items()}
    normal = torch.randn(sum(numel[k] for k, v in kinds.items() if v != "zero" and v != "var"),
                         generator=gen, device=device)
    uniform = torch.rand(sum(numel[k] for k, v in kinds.items() if v == "var") or 1, generator=gen, device=device)
    out, i, j = {}, 0, 0
    for key, (shape, dtype) in shapes.items():
        kind, n = kinds[key], numel[key]
        if kind == "zero":
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        if kind == "var":
            out[key] = (0.5 + uniform[j : j + n]).reshape(shape)
            j += n
            continue
        x = normal[i : i + n].reshape(shape)
        i += n
        if kind == "weight":
            out[key] = x / math.sqrt(n // shape[0])
        elif kind == "scale":
            out[key] = 1.0 + 0.1 * x
        else:
            out[key] = 0.1 * x
    return out


def make_audio(shape, seed: int, spec: dict, sample_rate: int, device):
    """Seeded audio of ``shape`` (recordings, samples), float32, on the device:
    segments of ``segment_ms``, each white noise at a level drawn from
    [``min_db``, 0] dB plus a tone of a frequency drawn log-uniformly from
    ``tone_hz`` and an amplitude up to ``tone_share``, all times ``std``. The
    segments give the posteriors something to follow; steady noise leaves a
    detector's labels constant. Made in blocks of recordings, so that the
    temporaries stay a block's size."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    b, s = shape
    seg = max(int(spec["segment_ms"] * sample_rate / 1000), 1)
    draws = torch.rand((3, b, -(-s // seg)), generator=gen, device=device)
    gain = 10.0 ** (draws[0] * spec["min_db"] / 20.0)
    lo, hi = spec["tone_hz"]
    freq = lo * (hi / lo) ** draws[1] * (2 * math.pi / sample_rate)
    amp = spec["tone_share"] * draws[2]
    out = torch.randn((b, s), generator=gen, device=device)
    t = torch.arange(s, device=device)
    idx = t // seg
    step = max(1, (1 << 27) // s)
    for r in range(0, b, step):
        rows = slice(r, r + step)
        out[rows].mul_(gain[rows][:, idx]).add_(amp[rows][:, idx] * torch.sin(freq[rows][:, idx] * t))
    return out.mul_(spec["std"])


def sub_seed(seed: int, k: int) -> int:
    """The k-th stream of draws of a run's seed, within a generator's 64 bits."""
    return (seed * 1_000_003 + k * 7_919) % (2**63)


# ---- the traced slice ----


@dataclass
class Slice:
    """A traced slice of calls made once the window has closed, with what the
    window itself did beside it. ``device`` comes from a session that traces
    the card alone, so that the profiler adds little host time to the
    slice; ``host`` from a second session that traces the host's ops too,
    for what only they attribute (the device time each op launched)."""

    window_s: float  # the device-only session's slice on the host's clock
    calls: int  # batches or hops in each session's slice
    device: list  # (name, start_us, end_us) of every device kernel, copy and fill of the device-only slice
    host: list  # (name, start_us, end_us, device_us) of every host op of the second session's slice
    runtime: list  # (name, start_us, end_us) of the CUDA runtime calls of the device-only slice
    run_calls: int = 0  # batches or hops completed in the untraced window
    run_window_s: float = 0.0  # the untraced window's seconds
    config: Optional[Config] = None
    traffic: dict = field(default_factory=dict)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of their intervals)."""
        spans = sorted((s, e) for _, s, e in self.device)
        busy, end = 0.0, -math.inf
        for s, e in spans:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy / 1e6

    def device_us(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for name, s, e in self.device if match(name))

    def host_device_us(self, name: str) -> float:
        """The device time of the kernels launched under every host op ``name``."""
        return sum(d for n, _, _, d in self.host if n == name)


def idle_untraced(sl: Slice) -> Optional[float]:
    """The untraced window's idle share as the trace estimates it, in %: one
    less the device's busy time a call in the slice over the window's host
    time a call. None where the slice has no device events."""
    if not sl.device:
        return None
    return 100.0 * (1.0 - (sl.busy_s() / sl.calls) / (sl.run_window_s / sl.run_calls))


PRIMER_LAUNCHES = 256
PRIMER_KERNEL = "FillFunctor<short>"  # the primer's one-element int16 fills, which nothing else launches


def _session(run_slice: Callable[[], int], device, host_ops: bool) -> tuple:
    """One profiler session: a primer of one-element fills, waited for, then
    ``run_slice`` (which returns the calls it made), waited for. PyTorch's
    profiler can drop a session's first device records; the primer takes
    that loss in the slice's place. ``host_ops`` traces the host's ops too.
    Returns (the slice's seconds on the host's clock, calls, the session's
    events, primer launches lost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    mark = torch.empty(1, dtype=torch.int16, device=device)
    activities = [ProfilerActivity.CUDA] if on_card else []
    if host_ops or not on_card:
        activities.append(ProfilerActivity.CPU)
    sync()
    with profile(activities=activities) as prof:
        for _ in range(PRIMER_LAUNCHES if on_card else 0):
            mark.fill_(1)
        sync()
        t0 = time.perf_counter()
        calls = run_slice()
        sync()
        window_s = time.perf_counter() - t0
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    primer = sum(1 for e in events if e.device_type == cuda and PRIMER_KERNEL in e.name)
    return window_s, calls, events, (PRIMER_LAUNCHES - primer) if on_card else 0


def trace_slice(run_slice: Callable[[], int], device) -> tuple:
    """Two sessions of ``run_slice``: the device alone (its kernels, copies
    and fills, and the CUDA runtime calls), then the host's ops with the
    device time each launched. Returns (window_s, calls, device events,
    host events, runtime calls, primer launches lost in each session)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window_s, calls, events, lost_dev = _session(run_slice, device, host_ops=False)
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == cuda and PRIMER_KERNEL not in e.name]
    start = min((s for _, s, _ in dev), default=math.inf)
    runtime = [(e.name, e.time_range.start, e.time_range.end) for e in events
               if e.device_type != cuda and e.time_range.end >= start]
    del events
    _, _, events, lost_host = _session(run_slice, device, host_ops=True)
    host = [(e.name, e.time_range.start, e.time_range.end, float(getattr(e, "device_time_total", 0.0)))
            for e in events if e.device_type != cuda and not getattr(e, "is_user_annotation", False)]
    return window_s, calls, dev, host, runtime, [lost_dev, lost_host]


def breakdown(sl: Slice) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps of the device-only slice, each named by the innermost CUDA
    runtime call in flight at its middle ("host" where none was: the host
    ran Python or an op between calls), in seconds."""
    by_name = {}
    for name, s, e in sl.device:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spans = sorted((s, e) for _, s, e in sl.device)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    out = []
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        covering = [(t - s, n) for n, s, t in sl.runtime if s <= mid <= t]
        out.append([min(covering)[1] if covering else "host", (g1 - g0) / 1e6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": out}


# ---- the run's outcome ----


@dataclass
class Outcome:
    """What a mode hands back: the end-to-end values, the request counts,
    the numbers compared with their limits, and the traced slice."""

    metrics: dict  # end-to-end name -> value
    attempted: int
    failed: int
    checks: dict  # name -> (reading, limit), the numbers that decide ``correct``
    memory_peak_bytes: int
    slice: Optional[Slice] = None


def checks(readings: dict, limits: dict) -> dict:
    """{name: (reading, limit)} for each number the cell's limits file names."""
    return {name: (readings[name], limit) for name, limit in limits.items()}


def within(checks_: dict) -> bool:
    """Every number within its limit (a number that is not one, NaN, is not)."""
    return all(v is not None and v <= lim for v, lim in checks_.values())


def correct(outcome: Outcome) -> bool:
    return outcome.failed == 0 and within(outcome.checks)


def control_verdict(readings: dict, limits: dict) -> dict:
    """The control judged as a run of the program is: its numbers beside the
    cell's limits and whether they make it correct. The control has no
    decisions of its own: its labels and flags are the reference's rule on
    its posteriors, so its ``decision_mismatches`` is 0."""
    ch = checks({**readings, "decision_mismatches": 0}, limits)
    return {"correct": within(ch), "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in ch.items()}}


@dataclass
class Context:
    """One run of one cell, as a mode sees it."""

    cell: str
    config: Config
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    clock: "Clock"
    control: bool = False  # also read the control (``readings.py``)
    notes: dict = field(default_factory=dict)

    def note(self, key: str, value) -> None:
        self.notes[key] = value


class Clock:
    """The run's set-up parts, each on the host's clock from the process start."""

    def __init__(self, t0: float):
        self.t0, self.last, self.parts = t0, t0, {}

    def mark(self, part: str) -> float:
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self.last
        self.last = now
        return now
