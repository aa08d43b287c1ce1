"""The whole offline step's share of the card's dense bf16 peak, in %: the
FLOPs that the configuration's model needs for the batches completed in the
untraced window (its ``flops_per_recording``, counted from shapes) over the
window's seconds. Read only where the run drove a card."""

from benchmark.harness import PEAKS


def read(sl):
    if not sl.device:
        return None
    c, tr = sl.config.data, sl.traffic
    samples = int(round(tr["clip_seconds"] * c["audio"]["sample_rate"]))
    g = c["geometry"]
    frames = samples // c["audio"]["hop_length"] + 1
    n_windows = max((frames - g["window_frames"]) // g["stride_frames"] + 1, 1)
    flops = sl.run_calls * tr["batch"] * sl.config.module.flops_per_recording(c, samples, n_windows)
    return 100.0 * flops / sl.run_window_s / PEAKS["bf16"]
