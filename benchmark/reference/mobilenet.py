"""howl's MobileNetV2 classifier (``howl/model/mobilenet.py``; Sandler et al.
2018, arXiv:1801.04381, table 2 at width 1.0): a 3x3 conv from the log-mel
channel to 3 with bias, padded (3, 1) over (time, mel), BatchNorm, ReLU, a
(2, 1) max pool over time; the 3x3 stride-2 stem to 32 channels with
BatchNorm and ReLU6; the seventeen inverted residual blocks of table 2 (a 1x1
expansion by t except in the first, a 3x3 depthwise conv of stride s, a 1x1
projection, BatchNorm after each, ReLU6 after the first two, the residual
where the stride is 1 and the widths match); a 1x1 conv to 1280 with
BatchNorm and ReLU6; the mean over time and frequency; the linear
classifier. Time is H, mel frequency W. BatchNorm is affine with eps 1e-5 on
the running statistics.

Departure, the configuration's: a stride-2 3x3 conv pads as XLA's ``SAME``
does (total = max((ceil(n / 2) - 1) * 2 + 3 - n, 0), split total // 2
before, the rest after: (0, 1) on an even axis, (1, 1) on an odd one), as
the JAX model that the served package ports pads it; howl's torch model
pads (1, 1) on every axis.
"""

import math

import torch
import torch.nn.functional as F

from benchmark.reference import exact_float32
from benchmark.reference.lower import identity

# (expansion t, channels c, repeats n, stride s): table 2
TABLE2 = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
BN_EPS = 1e-5
STEM, LAST = 32, 1280


def same_pads(n: int, k: int, s: int):
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def blocks():
    """(in, out, stride, expansion) of each inverted residual block."""
    out, ch = [], STEM
    for t, c, n, s in TABLE2:
        for i in range(n):
            out.append((ch, c, s if i == 0 else 1, t))
            ch = c
    return out


def _bn(x: torch.Tensor, w: dict, name: str, fit: bool = False, rnd=identity) -> torch.Tensor:
    if fit:  # the running statistics of this input: see ``fit_weights``
        w[f"{name}.running_mean"].copy_(x.mean(dim=(0, 2, 3)))
        w[f"{name}.running_var"].copy_(x.var(dim=(0, 2, 3), unbiased=False))
    mean, var = rnd(w[f"{name}.running_mean"]), rnd(w[f"{name}.running_var"])
    scale = rnd(w[f"{name}.weight"]) * torch.rsqrt(var + BN_EPS)
    return rnd(x * scale[:, None, None] + (rnd(w[f"{name}.bias"]) - mean * scale)[:, None, None])


def _conv(x, w: dict, name: str, rnd, stride=1, groups=1, padding=0, bias=False):
    b = w[f"{name}.bias"].float() if bias else None
    return rnd(F.conv2d(rnd(x), rnd(w[f"{name}.weight"]), b, stride, padding, 1, groups))


def _same(x, w: dict, name: str, rnd, stride: int, groups: int = 1):
    k = w[f"{name}.weight"].shape[-1]
    top, bottom = same_pads(x.shape[-2], k, stride)
    left, right = same_pads(x.shape[-1], k, stride)
    return _conv(F.pad(x, (left, right, top, bottom)), w, name, rnd, stride, groups)


@torch.no_grad()
def fit_weights(mels: torch.Tensor, w: dict, spread: float) -> None:
    """Data-dependent statistics for random weights, in place: each
    BatchNorm's running mean and variance set to those of its input over the
    windows ``mels`` (B, n_mels, T) of the cell's own kind of audio, layer
    after layer, then the classifier scaled and shifted so that each label's
    logit has mean 0 and standard deviation ``spread`` over them. Random
    statistics leave a random MobileNetV2 deaf to its input."""
    from benchmark.reference.res8 import fit_head

    feats = features(mels, w, fit=True)
    with exact_float32():
        fit_head(feats, w, "classifier.weight", "classifier.bias", spread)


@torch.no_grad()
def features(mels: torch.Tensor, w: dict, rnd=identity, fit: bool = False) -> torch.Tensor:
    """(B, n_mels, T) windows -> (B, 1280) pooled features before the
    classifier; with ``fit``, each BatchNorm's statistics set from its input."""
    with exact_float32():
        x = mels.float().transpose(1, 2)[:, None]  # (B, 1, T, F)
        h = F.relu(_bn(_conv(x, w, "downsample", rnd, padding=(3, 1), bias=True), w, "downsample_bn", fit, rnd))
        h = F.max_pool2d(h, (2, 1))
        h = F.relu6(_bn(_same(h, w, "stem", rnd, 2), w, "stem_bn", fit, rnd))
        for b, (cin, cout, s, t) in enumerate(blocks()):
            conv, bn = f"blocks.{b}.convs.", f"blocks.{b}.bns."
            j = 1 if t != 1 else 0  # the depthwise conv's index: after the expansion, where there is one
            y = F.relu6(_bn(_conv(h, w, conv + "0", rnd), w, bn + "0", fit, rnd)) if t != 1 else h
            y = F.relu6(_bn(_same(y, w, f"{conv}{j}", rnd, s, groups=cin * t), w, f"{bn}{j}", fit, rnd))
            y = _bn(_conv(y, w, f"{conv}{j + 1}", rnd), w, f"{bn}{j + 1}", fit, rnd)
            h = rnd(h + y) if (s == 1 and cin == cout) else y
        h = F.relu6(_bn(_conv(h, w, "head_conv", rnd), w, "head_bn", fit, rnd))
        return h.mean(dim=(2, 3))


@torch.no_grad()
def logits(mels: torch.Tensor, w: dict, rnd=identity) -> torch.Tensor:
    """(B, n_mels, T) windows of log-mels -> (B, L) logits, float32, TF32 off."""
    with exact_float32():
        return F.linear(rnd(features(mels, w, rnd)), rnd(w["classifier.weight"]), w["classifier.bias"].float())


def flops_per_window(n_mels: int, frames: int, num_labels: int) -> int:
    """FLOPs (2 x multiply-adds) of one window's forward pass, counted from
    the shapes of the layers above: every conv and the classifier."""
    total = 0

    def conv(h, w, cin, cout, k, s, groups, pad_h, pad_w):
        nonlocal total
        ho = (h + pad_h - k) // s + 1
        wo = (w + pad_w - k) // s + 1
        total += 2 * ho * wo * cout * (cin // groups) * k * k
        return ho, wo

    h, w = conv(frames, n_mels, 1, 3, 3, 1, 1, 6, 2)
    h = h // 2
    h, w = conv(h, w, 3, STEM, 3, 2, 1, sum(same_pads(h, 3, 2)), sum(same_pads(w, 3, 2)))
    for cin, cout, s, t in blocks():
        hidden = cin * t
        if t != 1:
            conv(h, w, cin, hidden, 1, 1, 1, 0, 0)
        h, w = conv(h, w, hidden, hidden, 3, s, hidden, sum(same_pads(h, 3, s)), sum(same_pads(w, 3, s)))
        conv(h, w, hidden, cout, 1, 1, 1, 0, 0)
    conv(h, w, blocks()[-1][1], LAST, 1, 1, 1, 0, 0)
    return total + 2 * LAST * num_labels
