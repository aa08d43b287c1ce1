"""Hop-blocked streaming-trunk serving against per-hop serving at one
stream count (counterpart of ``tools/bench_trunk_blocked.py``).

    python -m howl_tpu_torch.tools.bench_trunk_blocked [num_streams] [super_steps] [--device cuda|cpu]

The per-hop engine replays ``super_steps`` schedule periods of hops through
``make_chained_runner`` from a (period + 1)-hop noise buffer; the blocked
engines, ``hop_block`` = period and 2 x period, replay at least as many hops
as blocks (two blocks of audio in the buffer). Each chain is timed whole,
the best of 5 after a warm-up, and reported in ms a hop. Defaults: 16,384
streams and 11 super-steps on the card (bf16), 8 and 2 on the CPU (float32).
"""

from __future__ import annotations

from howl_tpu_torch.bench import trunk_chain
from howl_tpu_torch.tools._study import chain_ms
from howl_tpu_torch.tools._trunk_setup import engine, noise, trunk_bench_setup, trunk_parser

REPS = 5


def _time_runner(eng, ring_hops: int, blocks: int, buf, n_hops: int) -> float:
    """The best ms a hop of ``REPS`` chains of the engine's runner."""
    chain = trunk_chain(eng, buf, ring_hops, blocks)
    chain()  # the warm-up
    return min(chain_ms(chain, eng.device) for _ in range(REPS)) / n_hops


def run(s) -> dict:
    """{"period", "per_hop": ms a hop, "blocked": {hop_block: ms a hop}}."""
    k = s.steps_arg
    per = engine(s, "trunk")
    period = per.schedule.period
    print(f"streams={s.n_streams} period={period} super_steps={k}")
    out = {"period": period, "blocked": {}}
    out["per_hop"] = _time_runner(per, period + 1, k, noise(s, (period + 1) * per.hop_samples), k * period)
    print(f"per-hop         : {out['per_hop']:7.3f} ms/hop", flush=True)
    del per
    for mult in (1, 2):
        h = mult * period
        eng = engine(s, "trunk", hop_block=h)
        blocks = max(k * period // h, 2)
        ms = out["blocked"][h] = _time_runner(eng, 2, blocks, noise(s, 2 * h * eng.hop_samples), blocks * h)
        print(f"hop_block={h:2d}    : {ms:7.3f} ms/hop  (block step {ms * h:7.3f} ms, "
              f"+{(h - 1) * 62.5:.0f} ms max observe lag)", flush=True)
        del eng
    return out


def main(argv=None) -> dict:
    args = trunk_parser(__doc__).parse_args(argv)
    return run(trunk_bench_setup(args.device, args.num_streams, args.steps, default_streams_card=16384,
                                 default_steps_card=11))


if __name__ == "__main__":
    main()
