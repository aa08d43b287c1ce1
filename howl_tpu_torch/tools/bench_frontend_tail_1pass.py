"""The frontend kernel's two cheapest grades on the card: their error
against the float32 chain, then their speed at two frame tiles
(counterpart of ``tools/bench_frontend_tail_1pass.py``).

The JAX tool measured two changes to its kernel: a narrow lookahead block
for the tail of each cell's frames, and the one-pass grade "bf16", which
drops the ``x @ W_lo`` correction product of "bf16x2" and halves the DFT's
passes. The port's kernels read a tile's whole audio span once, so the
first change has no counterpart; the second is a grade of both kernels.
This tool prints:

  * the largest error of "bf16x2" and "bf16" against the float32 chain
    (``ops.frontend.log_mel_spectrogram``) on 8 clips, in log-mel units:
    on the card through the kernel at its default route and tile, on the
    CPU through the plain version;
  * both grades slope-timed on the tensor-core kernel (route "tc") at the
    tiles that stand for the JAX tool's cell geometries, 128 and 256
    frames (its ``fb_block``), bf16 output: chains of N and 4N launches,
    each bumped by the last output, (t_4N - t_N) / 3N, the median of
    three; ms per iteration and the realtime factor.

    python -m howl_tpu_torch.tools.bench_frontend_tail_1pass [--device cuda|cpu]

It runs on the card at 512 clips of 8 s and chains of 16 and 64: with
``--device cuda`` (the default) and no CUDA device it raises. With
``--device cpu`` it runs the plain version at the JAX tool's CPU size, 4
clips of 2 s and chains of 2 and 8.
"""

from __future__ import annotations

import torch

from howl_tpu_torch.ops.frontend import FrontendConfig, log_mel_spectrogram
from howl_tpu_torch.ops.frontend_cuda import log_mel_spectrogram_cuda
from howl_tpu_torch.tools._study import (
    CPU_SIZE, REPEATS, bumped_chain, device_parser, k1_leg, k1_refusal, pick_device, slope_ms, study_audio,
)

N_MELS = 40
CARD_SIZE = (512, 8.0, 16)  # batch, clip seconds, iterations: the JAX tool's TPU size
GRADES = ("bf16x2", "bf16")
TILES = (128, 256)  # the JAX tool's fb_block of its cell geometries
ACCURACY_CLIPS = 8


def run(audio: torch.Tensor, cfg: FrontendConfig, iters: int, dev: torch.device) -> dict:
    """{"max_abs_err": {grade: err}, (grade, tile): ms per iteration},
    each printed as it is measured."""
    audio_s = audio.shape[0] * audio.shape[1] / cfg.sample_rate
    results = {"max_abs_err": {}}
    with torch.no_grad():
        small = audio[:ACCURACY_CLIPS]
        ref = log_mel_spectrogram(small, cfg)
        for grade in GRADES:
            err = float((log_mel_spectrogram_cuda(small, cfg, precision=grade) - ref).abs().max())
            print(f"precision={grade:7s} max|err| vs f32 oracle: {err:.4f} (log-mel units)", flush=True)
            results["max_abs_err"][grade] = err
        for grade in GRADES:
            for tile in TILES:
                refusal = k1_refusal(cfg, grade, "tc", tile)
                if refusal:
                    print(f"{grade:7s} route=tc tile={tile:3d}: {refusal}", flush=True)
                    results[grade, tile] = refusal
                    continue
                ms, _ = slope_ms(bumped_chain(k1_leg(cfg, grade, "tc", tile, dev), audio), iters, 4 * iters,
                                 REPEATS, dev)
                print(f"{grade:7s} route=tc tile={tile:3d}: {ms:7.3f} ms/iter  ({audio_s / ms * 1e3:,.0f}x realtime)",
                      flush=True)
                results[grade, tile] = ms
    return results


def main(argv=None) -> dict:
    p = device_parser(__doc__)
    args = p.parse_args(argv)
    dev = pick_device(args.device)
    batch, clip_s, iters = CARD_SIZE if dev.type == "cuda" else CPU_SIZE
    torch.backends.cuda.matmul.allow_tf32 = False
    audio = study_audio(batch, clip_s, 0, dev)  # the JAX tool's seed
    return run(audio, FrontendConfig(n_mels=N_MELS), iters, dev)


if __name__ == "__main__":
    main()
