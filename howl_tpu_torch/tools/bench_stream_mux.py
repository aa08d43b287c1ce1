"""Host throughput of the multi-stream ingest mux (counterpart of
``tools/bench_stream_mux.py``).

    python -m howl_tpu_torch.tools.bench_stream_mux [n_streams] [hop_samples] [--device cuda|cpu]

Every tick of the 62.5 ms cadence the server gathers (N, hop) from N rings
while producers push. This times one push a stream (each stream's call, as
producers would make it) and one gather of every stream, the best of 3, on
the host that serves the card: ``--device cuda`` (the default) raises
without a CUDA device and without the native library (the fallback is not
what a card's server runs); ``--device cpu`` takes 64 streams and allows the
numpy fallback. Defaults on the card: 16,384 streams, hops of 1,000.
"""

from __future__ import annotations

import time

import numpy as np

from howl_tpu_torch.native import NativeStreamMux, available
from howl_tpu_torch.tools._study import device_parser, pick_device

REPS = 3


def run(n_streams: int, hop: int) -> dict:
    """{"native", "push_ms", "gather_ms" (a tick, the best of 3), "headroom"}."""
    print(f"native={available()} streams={n_streams} hop={hop}")
    mux = NativeStreamMux(n_streams, capacity=8 * hop)
    chunk = (np.random.default_rng(0).standard_normal(hop) * 0.1).astype(np.float32)
    push_best = gather_best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        for s in range(n_streams):
            mux.push(s, chunk)
        push_best = min(push_best, time.perf_counter() - t0)
        t0 = time.perf_counter()
        _, status = mux.gather(hop)
        gather_best = min(gather_best, time.perf_counter() - t0)
        if int((status == 1).sum()) != n_streams:
            raise AssertionError(f"a tick of pushed audio gathered {int((status == 1).sum())} of {n_streams} streams")
    mb = n_streams * hop * 4 / 1e6
    out = {"native": available(), "streams": n_streams, "hop": hop, "push_ms": push_best * 1e3,
           "gather_ms": gather_best * 1e3, "headroom": 62.5 / (gather_best * 1e3)}
    print(f"push  : {out['push_ms']:8.2f} ms/tick ({mb / push_best / 1e3:.2f} GB/s, {n_streams / push_best:,.0f} streams/s)")
    print(f"gather: {out['gather_ms']:8.2f} ms/tick ({mb / gather_best / 1e3:.2f} GB/s)")
    print(f"tick budget: 62.5 ms -> gather headroom {out['headroom']:.1f}x", flush=True)
    return out


def main(argv=None) -> dict:
    p = device_parser(__doc__)
    p.add_argument("n_streams", type=int, nargs="?", default=None)
    p.add_argument("hop_samples", type=int, nargs="?", default=1000)
    args = p.parse_args(argv)
    on_card = pick_device(args.device).type == "cuda"
    if on_card and not available():
        raise RuntimeError("the native mux did not build (no C++ compiler or no native/howl_native.cpp)")
    return run(args.n_streams or (16384 if on_card else 64), args.hop_samples)


if __name__ == "__main__":
    main()
