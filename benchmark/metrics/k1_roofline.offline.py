"""K1, the frontend kernel (``ops/frontend_cuda.py``), against its roofline,
in %: the least time of a batch's log-mels, the larger of its operations
over the bf16 peak and its bytes over the HBM bandwidth, over K1's device
time a batch in the slice. Operations: every frame's windowed real DFT
(n_fft x (n_fft / 2 + 1) multiply-adds for each of the real and imaginary
parts) and mel product, 2 FLOPs a multiply-add. Bytes: the float32 audio
read once, the bf16 log-mels written once."""

from benchmark.harness import HBM_BYTES_PER_S, PEAKS

KERNELS = ("logmel_tc_kernel", "logmel_kernel")


def bound_s(cfg: dict, batch: int, samples: int) -> float:
    a = cfg["audio"]
    frames = samples // a["hop_length"] + 1
    n_freqs = a["n_fft"] // 2 + 1
    ops = 2.0 * batch * frames * (2 * a["n_fft"] * n_freqs + n_freqs * a["n_mels"])
    nbytes = batch * samples * 4 + batch * frames * a["n_mels"] * 2
    return max(ops / PEAKS["bf16"], nbytes / HBM_BYTES_PER_S)


def read(sl):
    us = sl.device_us(lambda name: any(k in name for k in KERNELS))
    if not us:
        return None
    c, tr = sl.config.data, sl.traffic
    samples = int(round(tr["clip_seconds"] * c["audio"]["sample_rate"]))
    return 100.0 * bound_s(c, tr["batch"], samples) / (us / 1e6 / sl.calls)
