"""res8 as howl defines it (``howl/model/cnn.py`` Res8, after Tang & Lin
2018): conv0 + ReLU + AvgPool(3, 4) over (time, mel), six 3x3 convs with
ReLU, a residual add on every second one before its affine-less BatchNorm,
the mean over time and frequency, a linear head.

Departures, each the configuration's own:

* windows: howl scores every 500 ms window on its own. The configuration's
  scorer (``scorer: fused_trunk``) runs the trunk once over the whole
  recording and takes window k's features as the mean of the pooled trunk
  frames [round(k * S / P), + span), S the stride in mel frames, P the time
  pool and span = window frames // P (rounding half to even; starts clipped
  to the recording). The live trunk engine scores the same windows.
* the int8 trunk (``precision.offline_trunk: int8``): post-training static
  quantisation of the six residual convs. Weights per output channel
  (max |w| / 127 over the fan-in), activations per layer with scales
  calibrated from representative audio (max |layer input| x 1.1 / 127 over
  the calibration recordings, the float trunk's inputs), round half to even,
  clipped at +-127, exact integer sums, ReLU, then the dequantisation by
  w_scale * s_a. The reference does it in float32 from the float32 weights.
"""

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import exact_float32
from benchmark.reference.lower import identity

LAYERS = 6
BN_EPS = 1e-5


def stem(mels: torch.Tensor, w: dict, pooling, rnd=identity) -> torch.Tensor:
    """(B, n_mels, T) -> (B, maps, T // P_t, n_mels // P_f): time as H."""
    x = mels.float().transpose(1, 2)[:, None]
    y = F.relu(rnd(F.conv2d(rnd(x), rnd(w["conv0.weight"]), padding=1)))
    return rnd(F.avg_pool2d(y, tuple(pooling)))


def _bn(i: int, x: torch.Tensor, w: dict, fit: bool = False, rnd=identity) -> torch.Tensor:
    if fit:  # the running statistics of this input: see ``fit_weights``
        w[f"bn{i}.running_mean"].copy_(x.mean(dim=(0, 2, 3)))
        w[f"bn{i}.running_var"].copy_(x.var(dim=(0, 2, 3), unbiased=False))
    mean, var = rnd(w[f"bn{i}.running_mean"]), rnd(w[f"bn{i}.running_var"])
    return rnd((x - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + BN_EPS))


def quantise_weights(k: torch.Tensor, levels: int):
    """(O, I, 3, 3) -> (integer-valued float32 weights, per-channel scale)."""
    s = (k.float().abs().amax(dim=(1, 2, 3)) / levels).clamp(min=1e-12)
    return torch.clamp(torch.round(k.float() / s[:, None, None, None]), -levels, levels), s


def _int_conv(x: torch.Tensor, k: torch.Tensor, s_a: float, levels: int) -> torch.Tensor:
    """relu(conv) in the integer grid, dequantised: exact integer sums in
    float32 (cuDNN off, since a transform algorithm would round them)."""
    wq, ws = quantise_weights(k, levels)
    xq = torch.clamp(torch.round(x * np.float32(1.0 / s_a)), -levels, levels)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq, wq, padding=1)
    return F.relu(acc) * (ws * np.float32(s_a))[:, None, None]


def trunk(y: torch.Tensor, w: dict, act_scales: Optional[Sequence[float]] = None, levels: int = 127,
          rnd=identity, capture: Optional[list] = None, fit: bool = False) -> torch.Tensor:
    """The six residual layers on (B, maps, T', F') pooled stem activations.
    With ``act_scales`` every conv runs in the integer grid of ``levels``;
    ``capture`` collects each conv's input."""
    x = old = y.float()
    for i in range(1, LAYERS + 1):
        if capture is not None:
            capture.append(x)
        k = w[f"conv{i}.weight"]
        if act_scales is None:
            out = F.relu(rnd(F.conv2d(rnd(x), rnd(k), padding=1)))
        else:
            out = rnd(_int_conv(x, k, act_scales[i - 1], levels))
        if i % 2 == 0:
            x = rnd(out + old)
            old = x
        else:
            x = out
        x = _bn(i, x, w, fit, rnd)
    return x


def calibrate(stems: Sequence[torch.Tensor], w: dict, levels: int, margin: float) -> list:
    """Per-layer activation scales from the float trunk's conv inputs over
    the calibration recordings' pooled stems (a list of blocks)."""
    peak = [0.0] * LAYERS
    for s in stems:
        seen = []
        trunk(s, w, capture=seen)
        peak = [max(p, float(x.abs().max())) for p, x in zip(peak, seen)]
    return [max(p, 1e-6) * margin / levels for p in peak]


def window_starts(n_windows: int, stride_frames: int, pool_t: int, pooled: int, span: int) -> np.ndarray:
    eff = min(span, pooled)
    return np.clip(np.round(np.arange(n_windows) * stride_frames / pool_t).astype(np.int64), 0, pooled - eff)


def posteriors(t: torch.Tensor, w: dict, n_windows: int, window_frames: int, stride_frames: int, pooling,
               rnd=identity) -> torch.Tensor:
    """(B, maps, T', F') trunk output -> (B, n_windows, L) softmax posteriors."""
    tf = t.mean(dim=3).transpose(1, 2)  # (B, T', maps)
    span = max(window_frames // pooling[0], 1)
    eff = min(span, tf.shape[1])
    starts = torch.from_numpy(window_starts(n_windows, stride_frames, pooling[0], tf.shape[1], span)).to(t.device)
    idx = starts[:, None] + torch.arange(eff, device=t.device)[None, :]
    wmean = tf[:, idx].mean(dim=2)  # (B, n_windows, maps)
    logits = F.linear(rnd(wmean), rnd(w["output.weight"]), w["output.bias"].float())
    return torch.softmax(logits, dim=-1)


def fit_head(feats: torch.Tensor, w: dict, weight: str, bias: str, spread: float) -> None:
    """Set a linear head from its input ``feats`` (N, in): each label's row
    one of the leading principal directions of the features' variation over
    the N windows, scaled and shifted so that the label's logit has mean 0
    and standard deviation ``spread`` over them. A random head reads mostly
    what every window shares and follows the windows' differences weakly."""
    mu = feats.mean(dim=0)
    _, _, vh = torch.linalg.svd(feats - mu, full_matrices=False)
    rows = vh[: w[weight].shape[0]]
    sd = ((feats - mu) @ rows.T).std(dim=0).clamp(min=1e-12)
    w[weight].copy_(rows * (spread / sd)[:, None])
    w[bias].copy_(-(mu @ rows.T) * spread / sd)


@torch.no_grad()
def fit_weights(mels: torch.Tensor, w: dict, cfg: dict, spread: float) -> None:
    """Data-dependent statistics for random weights, in place: each
    BatchNorm's running mean and variance set to those of its input over the
    log-mels ``mels`` (B, n_mels, T) of the cell's own kind of audio, layer
    after layer, then the head fitted over the windows' features
    (``fit_head``). Random statistics leave a random res8 deaf to its input."""
    g = cfg["geometry"]
    with exact_float32():
        t = trunk(stem(mels, w, cfg["pooling"]), w, fit=True)
        tf = t.mean(dim=3).transpose(1, 2)
        span = max(g["window_frames"] // cfg["pooling"][0], 1)
        n = (tf.shape[1] - span) * cfg["pooling"][0] // g["stride_frames"]
        starts = window_starts(n, g["stride_frames"], cfg["pooling"][0], tf.shape[1], span)
        idx = torch.from_numpy(starts).to(t.device)[:, None] + torch.arange(span, device=t.device)[None, :]
        fit_head(tf[:, idx].mean(dim=2).flatten(0, 1), w, "output.weight", "output.bias", spread)


@torch.no_grad()
def score(mels: torch.Tensor, w: dict, cfg: dict, n_windows: int, act_scales=None, levels: int = 127,
          rnd=identity) -> torch.Tensor:
    """(B, n_mels, T) log-mels -> (B, n_windows, L) posteriors of the
    configuration's scorer, float32 with TF32 off."""
    g = cfg["geometry"]
    with exact_float32():
        t = trunk(stem(mels, w, cfg["pooling"], rnd), w, act_scales, levels, rnd)
        return posteriors(t, w, n_windows, g["window_frames"], g["stride_frames"], cfg["pooling"], rnd)
