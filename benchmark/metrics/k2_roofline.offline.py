"""K2, res8's stem kernel (``ops/stem_cuda.py``: conv0, ReLU, AvgPool), against
its roofline, in %: the larger of its operations over the bf16 peak (conv0's
3x3 taps on every mel of every frame into every map, 2 FLOPs a multiply-add)
and its bytes over the HBM bandwidth (the bf16 log-mels read once, the bf16
pooled maps written once), over K2's device time a batch in the slice."""

from benchmark.harness import HBM_BYTES_PER_S, PEAKS

KERNELS = ("stem_tc_kernel", "stem_kernel")


def bound_s(cfg: dict, batch: int, samples: int) -> float:
    a, maps, (pt, pf) = cfg["audio"], cfg["num_maps"], cfg["pooling"]
    frames = samples // a["hop_length"] + 1
    ops = 2.0 * batch * frames * a["n_mels"] * maps * 9
    nbytes = batch * frames * a["n_mels"] * 2 + batch * (frames // pt) * (a["n_mels"] // pf) * maps * 2
    return max(ops / PEAKS["bf16"], nbytes / HBM_BYTES_PER_S)


def read(sl):
    us = sl.device_us(lambda name: any(k in name for k in KERNELS))
    if not us:
        return None
    c, tr = sl.config.data, sl.traffic
    samples = int(round(tr["clip_seconds"] * c["audio"]["sample_rate"]))
    return 100.0 * bound_s(c, tr["batch"], samples) / (us / 1e6 / sl.calls)
