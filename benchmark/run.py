"""Run one cell of the benchmark once.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It makes the weights and the audio from the
seed on the card, builds the cell's engine, warms up every shape the cell's
traffic uses, measures for ``--seconds`` seconds, checks what the window
produced against the plain reference, and prints as its last line one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``; with ``--trace 1`` its per-layer
metrics, read from the untraced window and from a slice of further calls
traced once the window has closed), ``device`` and, traced, ``breakdown``;
last in it, ``checks``: each number compared with its limit. The lines
before it say what ran: the set-up's parts, each kernel's launches a call,
the card's power limit, the profiler primers' lost launches.

It exits non-zero without a result where there is no CUDA card or fewer
than the cell asks for, and where JAX, flax or the JAX package is loaded
once the window has closed. Caches that the program builds stay in the
checkout: its kernel library in ``howl_tpu_torch/_build/``, any other in
``.bench_cache/``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment(root: Path) -> None:
    """One thread for the host's numeric libraries, so that their pools do
    not contend with the thread that drives the card, and every cache in
    the checkout."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, root: Path = ROOT, t0: float = T0,
             traffic_override: dict = None, control: bool = False) -> tuple:
    """(result, lines): the result line's object and the lines printed before it."""
    import torch

    from benchmark import harness, port

    spec = harness.benchmark_spec(root)
    cell = harness.find_cell(name, root)
    clock = harness.Clock(t0)
    build_s = port.build_library(device)
    clock.mark("imports_and_build")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    traffic = {**harness.load_traffic(cell["traffic"], root), **(traffic_override or {})}
    ctx = harness.Context(name, harness.load_config(cell["config"], root), traffic, harness.load_limits(name, root),
                          seed, seconds, trace, device, clock, control)
    outcome = harness.load_mode(traffic["mode"], root).run(ctx)
    setup_s = sum(clock.parts.values()) - build_s  # from the process's start to the window's, the build apart
    e2e = {**outcome.metrics, "setup_s": setup_s}
    e2e_specs = harness.cell_metrics(name, spec, "end_to_end")
    metrics, breakdown = {}, None
    if trace:
        sl = outcome.slice
        for m in harness.cell_metrics(name, spec, "per_layer", {m["name"] for m in e2e_specs}):
            value = harness.load_metric(m["name"], root).read(sl) if sl is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = harness.breakdown(sl) if sl is not None else None
    else:
        for m in e2e_specs:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": outcome.memory_peak_bytes,
           "card": harness.card_line() if on_card else "none"}
    if trace and outcome.slice is not None:
        dev["busy_s"], dev["window_s"] = outcome.slice.busy_s(), outcome.slice.window_s
    result = {"correct": harness.correct(outcome), "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    lines = [json.dumps({"setup_parts_s": {**clock.parts, "build": build_s}}),
             json.dumps({**ctx.notes, "end_to_end": e2e}, default=str)]
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment(ROOT)
    import torch

    torch.set_num_threads(1)

    from benchmark import harness

    chips = harness.find_cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s), found {have}", file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)} (JAX, flax or the JAX package)", file=sys.stderr)
        return 3
    for line in lines:
        print(line)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
