"""The streaming-trunk engine against the incremental engine at one stream
count (counterpart of ``tools/bench_streaming_trunk.py``).

    python -m howl_tpu_torch.tools.bench_streaming_trunk [num_streams] [steps] [--device cuda|cpu]

Both engines replay the same (num_streams, (period + 1) x hop) noise buffer
hop by hop, each hop taking the last one's state, through the bench's
chains: the trunk engine through ``make_chained_runner`` (``steps`` rounded
down to whole schedule periods), the incremental engine through its
``_step``. A chain is timed whole after
a warm-up chain; a card holds n x steps / time / 16 streams at the 62.5 ms
hop. Defaults: 512 streams and 258 hops on the card (bf16), 8 and 6 on the
CPU (float32).
"""

from __future__ import annotations

from howl_tpu_torch.bench import hop_chain, trunk_chain
from howl_tpu_torch.tools._study import chain_ms
from howl_tpu_torch.tools._trunk_setup import engine, noise, trunk_bench_setup, trunk_parser

HOPS_PER_S = 1000.0 / 62.5


def run(s) -> dict:
    """{"steps", "trunk_ms", "incremental_ms" (a whole chain), the streams
    each holds, "speedup"}."""
    trunk = engine(s, "trunk")
    period = trunk.schedule.period
    super_steps = max(s.steps_arg // period, 1)
    n_steps = super_steps * period
    # period + 1 hops of audio: the runner refuses a multiple of the period
    ring_hops = period + 1
    buf = noise(s, ring_hops * trunk.hop_samples)
    chains = {"trunk": trunk_chain(trunk, buf, ring_hops, super_steps)}
    chains["incremental"] = hop_chain(engine(s, "incremental"), buf, n_steps, ring_hops)
    ms = {}
    for name, chain in chains.items():
        chain()  # the warm-up
        ms[name] = chain_ms(chain, s.device)
    out = {"steps": n_steps, "trunk_ms": ms["trunk"], "incremental_ms": ms["incremental"],
           "trunk_streams": s.n_streams * n_steps / (ms["trunk"] / 1e3) / HOPS_PER_S,
           "incremental_streams": s.n_streams * n_steps / (ms["incremental"] / 1e3) / HOPS_PER_S,
           "speedup": ms["incremental"] / ms["trunk"]}
    print(f"streaming-trunk: {n_steps} steps x {s.n_streams} streams in {ms['trunk'] / 1e3:.3f}s "
          f"-> {out['trunk_streams']:,.0f} streams/card @62.5ms")
    print(f"incremental:     {n_steps} steps x {s.n_streams} streams in {ms['incremental'] / 1e3:.3f}s "
          f"-> {out['incremental_streams']:,.0f} streams/card @62.5ms")
    print(f"speedup: {out['speedup']:.2f}x", flush=True)
    return out


def main(argv=None) -> dict:
    args = trunk_parser(__doc__).parse_args(argv)
    return run(trunk_bench_setup(args.device, args.num_streams, args.steps, default_streams_card=512,
                                 default_steps_card=258, default_steps_cpu=6))


if __name__ == "__main__":
    main()
