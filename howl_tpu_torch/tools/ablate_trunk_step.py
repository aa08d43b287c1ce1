"""Where the streaming-trunk step's time goes at serving concurrency
(counterpart of ``tools/ablate_trunk_step.py``).

    python -m howl_tpu_torch.tools.ablate_trunk_step [num_streams] [super_steps] [--device cuda|cpu]

Four chains of hops, each hop taking the last one's state, against the same
engine (``FusedStreamingOnlineEngine``) at one schedule phase repeated, as
the JAX tool runs them:

  1. the full step (``_hop_step``: frontend, mel cache, trunk, head, FSM);
  2. the frontend alone: the plain log-mel chain on tail + hop, the mel cache;
  3. the trunk alone: the slab read from a fixed cache (made to depend on
     the last step through the s6 ring, x 1e-30), ``trunk_stream_step``
     over the rings, the s6 ring, the span mean, the head;
  4. the smoothing and FSM alone: ``detect_step`` on fixed posteriors (made
     to depend on the last step through its fire flags, x 1e-30).

Each chain of super_steps x period hops is timed whole, the best of 5 after
a warm-up, in ms a hop. Defaults: 16,384 streams and 11 super-steps on the
card (bf16), 8 and 2 on the CPU (float32).
"""

from __future__ import annotations

import torch

from howl_tpu_torch.tools._study import chain_ms
from howl_tpu_torch.tools._trunk_setup import engine, noise, trunk_bench_setup, trunk_parser

REPS = 5
LEGS = ("full step", "frontend+melring", "trunk+rings+head", "smoothing+FSM")


def _best_ms(chain, dev, n_steps: int) -> float:
    chain()  # the warm-up
    return min(chain_ms(chain, dev) for _ in range(REPS)) / n_steps


def run(s) -> dict:
    """{leg: ms a hop, "sum of parts", "streams", "steps"}."""
    from howl_tpu_torch.inference.detect import detect_step

    eng = engine(s, "trunk")
    sched, period = eng.schedule, eng.schedule.period
    n_steps, ring_hops, hop = s.steps_arg * period, period + 1, eng.hop_samples
    buf = noise(s, ring_hops * hop)
    phase = 1 % period
    e = sched.by_phase[phase]
    delta, slab_start, gap = e["delta"], e["slab_start"], e["gap"]
    dt = s.compute_dtype or torch.float32
    hi = eng._s6_ring_len - gap
    valid = torch.ones(s.n_streams, dtype=torch.bool, device=s.device)
    init = (eng.tail, eng.mel_cache, eng.rings, eng.s6_ring, eng.state)

    def chunk(m):
        return buf[:, (m % ring_hops) * hop : (m % ring_hops + 1) * hop]

    @torch.no_grad()
    def full():
        tail, mel_cache, rings, s6_ring, state = init
        for m in range(n_steps):
            tail, mel_cache, rings, s6_ring, state, *_ = eng._hop_step(
                phase, chunk(m), tail, mel_cache, rings, s6_ring, state, m * 62.5, valid)

    @torch.no_grad()
    def fe_only():
        tail, mel_cache = init[:2]
        for m in range(n_steps):
            buf2 = torch.cat([tail, chunk(m)], dim=-1)
            mels = eng._mels(buf2, eng._frontend_nc).transpose(1, 2)
            mel_cache = torch.cat([mel_cache, mels], dim=1)[:, -eng._mel_cache_len :]
            tail = buf2[:, -eng.tail_samples :]

    @torch.no_grad()
    def trunk_only():
        rings, s6_ring = init[2:4]
        for _ in range(n_steps):
            slab = eng.mel_cache[:, slab_start : slab_start + sched.slab_frames][..., None]
            slab = (slab + s6_ring[:, :1, :1, None] * 1e-30).to(dt)
            rings, s6_new = eng.model.trunk_stream_step(slab, rings, delta)
            s6_ring = torch.cat([s6_ring[:, delta:], s6_new[:, s6_new.shape[1] - delta :]], dim=1)
            eng.model.head(s6_ring[:, hi - eng.span : hi].mean(dim=1))

    @torch.no_grad()
    def fsm_only():
        state = init[4]
        probs = torch.full((s.n_streams, s.cfg.num_labels), 1.0 / s.cfg.num_labels, device=s.device)
        for m in range(n_steps):
            state, _, fired = detect_step(state, probs, m * 62.5, valid, s.cfg, 62.5)
            probs = probs + fired[:, None] * 1e-30

    out = {name: _best_ms(fn, s.device, n_steps) for name, fn in zip(LEGS, (full, fe_only, trunk_only, fsm_only))}
    out["sum of parts"] = sum(out[name] for name in LEGS[1:])
    print(f"streams={s.n_streams} steps={n_steps}")
    for name, ms in out.items():
        print(f"{name:16s}: {ms:7.3f} ms", flush=True)
    return {**out, "streams": s.n_streams, "steps": n_steps}


def main(argv=None) -> dict:
    args = trunk_parser(__doc__).parse_args(argv)
    return run(trunk_bench_setup(args.device, args.num_streams, args.steps, default_streams_card=16384,
                                 default_steps_card=11))


if __name__ == "__main__":
    main()
