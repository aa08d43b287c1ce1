"""Live demo: workspace model + microphone (or WAV replay) client
(counterpart of ``howl_tpu/training/run/demo.py``; ref:
training/run/demo.py:16-58). ``--streams N`` instead serves N concurrent
WAV replays through ONE batched engine via MultiStreamServer: the
bulk-serving path demonstrated end to end from the CLI.

    python -m howl_tpu_torch.training.run.demo --workspace WS --wav a.wav b.wav [--streams 4 --incremental]

The engines run on the card (``--device``, default
``SETTINGS.training.device``) unless given ``--device cpu``: the frontend
kernel (K1) and, for res8, the stem kernel (K2) serve their hops there.
``--incremental`` and ``--streaming-trunk`` are refused together before any
file is read."""

from __future__ import annotations

import sys
from pathlib import Path

from howl_tpu_torch.client.howl_client import FileAudioSource, HowlClient
from howl_tpu_torch.models import MODEL_REGISTRY
from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt


def _run_multistream(args):
    """Replay each --wav on its own stream of one batched engine."""
    import numpy as np

    from howl_tpu_torch import hub
    from howl_tpu_torch.client.stream_server import MultiStreamServer
    from howl_tpu_torch.utils.audio_utils import silent_load

    if not args.wav:
        raise SystemExit("--streams requires --wav (one clip per stream; cycled if fewer)")
    n = args.streams
    engine, ctx = hub.load_workspace_engine(
        args.workspace, args.model, num_streams=n,
        incremental=args.incremental and not args.streaming_trunk,
        streaming_trunk=args.streaming_trunk, device=args.device,
    )
    if not hasattr(engine, "push"):
        raise SystemExit("--streams needs a push-based engine: add --incremental or --streaming-trunk")
    server = MultiStreamServer(engine)
    server.add_listener(lambda idx, tick: print(f"wakeword detected on streams {idx.tolist()} (tick {tick})"))
    del ctx
    clips = [silent_load(str(Path(p))) for p in args.wav]
    hop = server.samples_per_tick
    lag = getattr(getattr(engine, "schedule", None), "lag", 0)
    n_ticks = max((len(c) + hop - 1) // hop for c in clips) + lag + 4
    for t in range(n_ticks):
        for s in range(n):
            clip = clips[s % len(clips)]
            chunk = clip[t * hop : (t + 1) * hop]
            if len(chunk):
                server.push(s, np.pad(chunk, (0, hop - len(chunk))))
        server.tick()
    print(f"served {n} streams x {server.ticks} ticks; per-stream detections: "
          f"{server.detections.tolist()}")
    return server


def run(args=None):
    from howl_tpu_torch.settings import SETTINGS
    from howl_tpu_torch.utils.platform import resolve_device

    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--model", type=str, choices=sorted(MODEL_REGISTRY), default=None),
        opt("--workspace", type=str, default=str(Path("workspaces") / "default")),
        opt("--wav", type=str, nargs="+", default=None, help="replay WAV files instead of the microphone"),
        opt("--incremental", action="store_true",
            help="serve with the incremental engine (featurize only each hop's new audio)"),
        opt("--streaming-trunk", action="store_true",
            help="serve with the streaming-trunk engine (res8: per-layer conv caches, "
                 "cheapest per-step path, +250 ms decision lag)"),
        opt("--streams", type=int, default=0,
            help="serve N concurrent streams through one batched engine "
                 "(MultiStreamServer; each --wav replays on its own stream, cycled)"),
        opt("--device", type=str, default=SETTINGS.training.device,
            help="'cuda' (default: SETTINGS.training.device) or 'cpu'; without a card only 'cpu' runs"),
    )
    args = apb.parser.parse_args(args)
    if args.incremental and args.streaming_trunk:
        apb.parser.error("--incremental and --streaming-trunk are mutually exclusive")
    args.device = resolve_device(args.device)
    if args.streams:
        if not (args.incremental or args.streaming_trunk):
            args.incremental = True  # bulk serving needs a push-based engine
        return _run_multistream(args)

    source = FileAudioSource(args.wav) if args.wav else None
    client = HowlClient.from_workspace(
        args.workspace, args.model, source=source,
        incremental=args.incremental, streaming_trunk=args.streaming_trunk, device=args.device,
    )
    client.add_listener(lambda words: print(f"wakeword detected: {words}"))
    client.start().join()
    return client


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
