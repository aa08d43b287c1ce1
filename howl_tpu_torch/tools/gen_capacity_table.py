"""The capacity table from the step-time model the hub's checks use
(``howl_tpu_torch/inference/capacity.py``; counterpart of
``tools/gen_capacity_table.py``), and the calibration that measures it.

    python -m howl_tpu_torch.tools.gen_capacity_table
        print the table (no device needed)
    python -m howl_tpu_torch.tools.gen_capacity_table --calibrate 1024,16384,65536 [--device cuda|cpu]
        measure each profiled engine's step at those stream counts [--steps 52]

A calibration step of a push engine (incremental, trunk, blocked) is what
``MultiStreamServer`` pays a tick: ``MultiStreamServer.tick`` on the native
mux, gathering (N, hop_block x hop) float32 audio on
``capacity.GATHER_THREADS`` host threads, then the engine's step with its
fire flags fetched (so the host clock around it waits for the card). The
producers' pushes come between ticks and are not timed (each holds
``REFILL`` ticks of a stream's audio), and every timed tick gathers audio,
never an underrun's silence. The ``OnlineEngine``, which no server drives
(``MultiStreamServer`` refuses it), times its ``ingest`` of (N, window)
host windows alone. A point is the median of ``--steps`` (default 52)
timed steps after a warm-up step. Each engine is built as
``hub.load_workspace_engine`` builds it by default: float32, the frontend
grade "auto" picks ("f32"), on ``_trunk_setup``'s res8 with the bench's
seeded weights (500 ms windows every 62.5 ms, 40 mels). The points, each
engine's ceiling (the most streams a card holds at the cadence at any
measured count: N x hop_block x 62.5 / step ms) and its decision lag are
printed as a ``PROFILES`` entry and as one JSON line. ``--device cuda``
(the default) raises without a card; ``--device cpu`` measures the plain
versions, which says nothing of the card.
"""

from __future__ import annotations

import json
import time

import numpy as np

from howl_tpu_torch.tools._study import device_parser

STEPS = 52  # timed steps a point; the point is their median
REFILL = 4  # ticks of audio a producer push holds
# (kind, hop_block) -> the setup's engine kind and the label of its profile
ENGINES = {
    ("online", 1): ("online", "OnlineEngine (full-window re-score)"),
    ("incremental", 1): ("incremental", "IncrementalOnlineEngine"),
    ("streaming_trunk", 1): ("trunk", "FusedStreamingOnlineEngine"),
    ("streaming_trunk", 3): ("trunk", "FusedStreamingOnlineEngine hop_block=3"),
}

def markdown_table() -> str:
    from howl_tpu_torch.inference.capacity import HOP_MS, capacity_table

    lines = [
        "| Engine | Sustainable streams/card | Measured ceiling | Step @16k streams | Decision lag (hops) |",
        "|---|---|---|---|---|",
    ]
    for row in capacity_table(HOP_MS):
        lines.append(f"| `{row['engine']}` | ~{row['sustainable_streams']:,} | {row['ceiling']:,} "
                     f"| {row['step_ms_at_16k']} ms | {row['decision_latency_hops']} |")
    return "\n".join(lines)


def _step_times(eng, n: int, steps: int, rng: np.random.Generator) -> list:
    """The ms of each of ``steps`` timed steps of ``eng`` at ``n`` streams,
    after a warm-up step: server ticks for a push engine, ``ingest`` of
    host windows for the ``OnlineEngine``. Noise at 0.1 for the first 1,024
    streams, repeated (drawing 65,536 streams' audio takes longer than the
    steps)."""
    from howl_tpu_torch.client.stream_server import MultiStreamServer
    from howl_tpu_torch.inference.capacity import GATHER_THREADS

    times = []
    if not hasattr(eng, "push"):
        batch = np.resize((rng.standard_normal((min(n, 1024), eng.window_samples)) * 0.1).astype(np.float32),
                          (n, eng.window_samples))
        for _ in range(steps + 1):
            start = time.perf_counter()
            eng.ingest(batch)  # fetches its fire flags: the clock waits for the card
            times.append((time.perf_counter() - start) * 1e3)
        return times[1:]
    server = MultiStreamServer(eng, capacity_ticks=REFILL + 1, gather_threads=GATHER_THREADS)
    audio = (rng.standard_normal((min(n, 1024), REFILL * server.samples_per_tick)) * 0.1).astype(np.float32)
    for t in range(steps + 1):
        if t % REFILL == 0:  # the producers' pushes, between ticks
            for stream in range(n):
                server.push(stream, audio[stream % len(audio)])
        start = time.perf_counter()
        result = server.tick()
        times.append((time.perf_counter() - start) * 1e3)
        if (result.status != 1).any():
            raise AssertionError(f"tick {t} gathered silence for {int((result.status != 1).sum())} streams")
    return times[1:]


def calibrate(stream_counts, device: str = "cuda", steps: int = STEPS) -> dict:
    """{"kind hop_block": {"label", "points": [[n, ms a step], ...], "ceiling",
    "hops_per_step", "extra_latency_hops"}} measured on ``device``."""
    import torch

    from howl_tpu_torch.inference.capacity import HOP_MS, PROFILES
    from howl_tpu_torch.tools._trunk_setup import engine, trunk_bench_setup

    # the stream counts and steps are this tool's own; the hub's default engines are float32, so the setup's bf16
    # on the card is overridden
    s = trunk_bench_setup(device, None, None, 1, 1)._replace(compute_dtype=None)
    out = {}
    for (kind, hop_block), (setup_kind, label) in ENGINES.items():
        extra = {"hop_block": hop_block} if setup_kind == "trunk" else {}
        points, lag = [], 0
        for n in stream_counts:
            eng = engine(s, setup_kind, num_streams=n, **extra)
            if setup_kind == "trunk":
                lag = eng.schedule.lag + hop_block - 1
            ms = float(np.median(_step_times(eng, n, steps, s.rng)))
            points.append([n, ms])
            prof = PROFILES.get((kind, hop_block))
            model_ms = f"{prof.predict_step_ms(n):7.2f}" if prof else "   none"
            print(f"{label:46s} n={n:>7,}: measured {ms:7.2f} ms/step (median of {steps}), model {model_ms} ms",
                  flush=True)
            del eng
            if s.on_card:
                torch.cuda.empty_cache()
        ceiling = max(int(n * hop_block * HOP_MS / ms) for n, ms in points)
        out[f"{kind} {hop_block}"] = {"label": label, "points": points, "ceiling": ceiling, "hops_per_step": hop_block,
                                      "extra_latency_hops": lag}
        print(f"    ({kind!r}, {hop_block}): EngineProfile(kind={kind!r}, label={label!r}, "
              f"points={tuple((n, round(ms, 3)) for n, ms in points)}, ceiling={ceiling}, hops_per_step={hop_block}, "
              f"extra_latency_hops={lag}),", flush=True)
    print(json.dumps({"calibration": out}))
    return out


def main(argv=None):
    p = device_parser(__doc__)
    p.add_argument("--calibrate", type=str, default=None, help="comma-separated stream counts to measure")
    p.add_argument("--steps", type=int, default=STEPS, help="timed steps a point (the point is their median)")
    args = p.parse_args(argv)
    print(markdown_table())
    if args.calibrate:
        return calibrate([int(x) for x in args.calibrate.split(",")], args.device, args.steps)
    return None


if __name__ == "__main__":
    main()
