"""Frame-tile sweep of the fused log-mel frontend kernel on the card
(counterpart of ``tools/sweep_frontend_blocks.py``).

The JAX kernel's grid cell covers (``row_block`` clips) x (``fb_block``
frames), and its per-shift product flattens them into one M. A block of the
port's kernels owns one clip and a tile of frames, so the tile is the
counterpart of ``fb_block``, and ``row_block`` has none. This sweeps every
tile the kernels are compiled for, at the JAX tool's default grade
"bf16x2": the tensor-core kernel (``csrc/frontend_tc.cu``, route "tc") at
64, 128 and 256 frames and the FMA kernel (``csrc/frontend.cu``, route
"fma") at 16, 32 and 64. Each leg is slope-timed as the JAX tool times it:
chains of N and 4N launches, each bumped by the last output, and (t_4N -
t_N) / 3N, which cancels what a chain costs once; the median of three. It
prints ms per iteration and the realtime factor of each leg, then the best.

A tile whose block does not fit a block's shared memory is reported from
the reckoning before any launch ("does not fit (N bytes of shared
memory)"); a launch that fails ends the tool with its error.

    python -m howl_tpu_torch.tools.sweep_frontend_blocks [--device cuda|cpu]
        [--batch 512] [--clip-seconds 8] [--iters 16] [--precision bf16x2]

``--precision`` takes a grade of ``frontend_cuda.frontend_grade`` ("none"
is the kernel's default, "bf16x3", as in the JAX tool).

It runs on the card: with ``--device cuda`` (the default) and no CUDA device
it raises. With ``--device cpu`` it runs the plain version at the JAX
tool's CPU size, 4 clips of 2 s and chains of 2 and 8.
"""

from __future__ import annotations

import torch

from howl_tpu_torch.ops.frontend import FrontendConfig
from howl_tpu_torch.ops.frontend_cuda import FMA_TILES, TC_TILES, frontend_grade
from howl_tpu_torch.tools._study import (
    CPU_SIZE, REPEATS, bumped_chain, k1_leg, k1_refusal, pick_device, slope_ms, study_audio, study_parser,
)

N_MELS = 40
ROUTE_TILES = (("tc", TC_TILES[N_MELS]), ("fma", FMA_TILES))


def sweep(audio: torch.Tensor, cfg: FrontendConfig, grade: str, iters: int, dev: torch.device) -> dict:
    """{(route, tile): ms per iteration} of every tile that fits, each
    printed as it is timed, then the best."""
    audio_s = audio.shape[0] * audio.shape[1] / cfg.sample_rate
    results = {}
    with torch.no_grad():
        for route, tiles in ROUTE_TILES:
            for tile in tiles:
                refusal = k1_refusal(cfg, grade, route, tile)
                if refusal:
                    print(f"route={route:3s} tile={tile:3d}: {refusal}", flush=True)
                    continue
                ms, _ = slope_ms(bumped_chain(k1_leg(cfg, grade, route, tile, dev), audio), iters, 4 * iters,
                                 REPEATS, dev)
                print(f"route={route:3s} tile={tile:3d}: {ms:7.3f} ms/iter  ({audio_s / ms * 1e3:,.0f}x realtime)",
                      flush=True)
                results[route, tile] = ms
    best = min(results, key=results.get)
    print(f"\nbest: route={best[0]} tile={best[1]} ({results[best]:.3f} ms/iter, "
          f"{audio_s / results[best] * 1e3:,.0f}x realtime)")
    return results


def main(argv=None) -> dict:
    p = study_parser(__doc__)
    p.add_argument("--precision", default="bf16x2")
    args = p.parse_args(argv)
    dev = pick_device(args.device)
    if dev.type == "cpu":
        args.batch, args.clip_seconds, args.iters = CPU_SIZE
    torch.backends.cuda.matmul.allow_tf32 = False
    grade = frontend_grade(None if args.precision == "none" else args.precision)  # "none": the kernel's default
    audio = study_audio(args.batch, args.clip_seconds, args.seed, dev)
    return sweep(audio, FrontendConfig(n_mels=N_MELS), grade, args.iters, dev)


if __name__ == "__main__":
    main()
