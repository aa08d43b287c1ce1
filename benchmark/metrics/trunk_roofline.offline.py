"""The fused int8 residual trunk (``ops/int8_trunk.py``: six 3x3 convs with
residual adds and BatchNorm) against its roofline, in %: the larger of its
operations over the int8 peak (each layer's 3x3 taps over every pooled
position, maps x maps, 2 operations a multiply-add) and its bytes over the
HBM bandwidth (the bf16 pooled stem read once, the bf16 trunk output written
once), over the trunk kernels' device time a batch in the slice."""

from benchmark.harness import HBM_BYTES_PER_S, PEAKS

KERNELS = ("int8_trunk_fused_kernel", "int8_conv_kernel")


def bound_s(cfg: dict, batch: int, samples: int) -> float:
    a, maps, (pt, pf) = cfg["audio"], cfg["num_maps"], cfg["pooling"]
    positions = batch * ((samples // a["hop_length"] + 1) // pt) * (a["n_mels"] // pf)
    ops = 2.0 * cfg["residual_layers"] * positions * maps * maps * 9
    nbytes = 2 * positions * maps * 2
    return max(ops / PEAKS["int8"], nbytes / HBM_BYTES_PER_S)


def read(sl):
    us = sl.device_us(lambda name: any(k in name for k in KERNELS))
    if not us:
        return None
    c, tr = sl.config.data, sl.traffic
    samples = int(round(tr["clip_seconds"] * c["audio"]["sample_rate"]))
    return 100.0 * bound_s(c, tr["batch"], samples) / (us / 1e6 / sl.calls)
