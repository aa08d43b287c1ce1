"""MobileNetV2-style classifier (counterpart of ``howl_tpu/models/mobilenet.py``).

NCHW with time as H, as the other CNNs of the port. The JAX module's stride-2
convs use ``padding="SAME"``, which pads (total // 2, total - total // 2)
with total = max((ceil(n / s) - 1) * s + k - n, 0): (0, 1) on an even axis
and (1, 1) on an odd one at k 3, s 2, where ``nn.Conv2d(padding=1)`` would
pad (1, 1) and shift every later layer. ``_same_conv`` pads as XLA does with
``F.pad`` and convolves unpadded. BatchNorms are affine, with flax's
semantics (``models.base.AffineBatchNorm``), dropout comes before the
classifier in training, the classifier computes in float32, and ``dtype``
is flax's mixed precision (``models.base.HowlModel``).

Parameter names follow the JAX tree: downsample, downsample_bn, stem,
stem_bn, ``blocks.k`` for ``InvertedResidual_k`` (its ``convs.j`` and
``bns.j`` for ``Conv_j`` and ``BatchNorm_j``), head_conv, head_bn,
classifier.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from howl_tpu_torch.models.base import HowlModel, register_model
from howl_tpu_torch.models.cnn import _affine_bn

# (expansion t, output channels c, repeats n, stride s): MobileNetV2 paper table 2
_V2_CONFIG: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"`` on an axis of n: (low, high)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _same_conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` (built unpadded) over x in ``dtype`` with XLA's SAME padding
    on both axes."""
    (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
    top, bottom = same_pads(x.shape[-2], kh, sh)
    left, right = same_pads(x.shape[-1], kw, sw)
    return HowlModel._conv(conv, F.pad(x.to(dtype), (left, right, top, bottom)), dtype)


class InvertedResidual(nn.Module):
    """Expand 1x1 (when t > 1) -> depthwise 3x3 (SAME, stride s) -> project
    1x1, each conv bias-free with a BatchNorm, ReLU6 after the first two;
    a residual when the stride is 1 and the widths match."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = in_channels * expand_ratio
        self.use_residual = stride == 1 and in_channels == out_channels
        convs = [nn.Conv2d(in_channels, hidden, 1, bias=False)] if expand_ratio != 1 else []
        convs += [nn.Conv2d(hidden, hidden, 3, stride=stride, groups=hidden, bias=False),
                  nn.Conv2d(hidden, out_channels, 1, bias=False)]
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(_affine_bn(c.out_channels) for c in convs)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = x
        for j, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            h = bn(_same_conv(conv, h, dtype))
            if j < len(self.convs) - 1:
                h = F.relu6(h)
        return x + h if self.use_residual else h


@register_model("mobilenet")
class MobileNetClassifier(HowlModel):
    """Downsample stem + MobileNetV2 trunk + classifier head (dropout is the
    identity at inference)."""

    def __init__(self, num_labels: int, width_mult: float = 1.0, dropout: float = 0.2, dtype=None):
        super().__init__(dtype)
        self.dropout = dropout
        # the JAX module pads the downsample conv ((3, 3), (1, 1)) on (time, frequency)
        self.downsample = nn.Conv2d(1, 3, 3, padding=(3, 1))
        self.downsample_bn = _affine_bn(3)
        ch = max(8, int(32 * width_mult))
        self.stem = nn.Conv2d(3, ch, 3, stride=2, bias=False)
        self.stem_bn = _affine_bn(ch)
        blocks = []
        for t, c, n, s in _V2_CONFIG:
            out_c = max(8, int(c * width_mult))
            for i in range(n):
                blocks.append(InvertedResidual(ch, out_c, s if i == 0 else 1, t))
                ch = out_c
        self.blocks = nn.ModuleList(blocks)
        last = max(8, int(1280 * width_mult))
        self.head_conv = nn.Conv2d(ch, last, 1, bias=False)
        self.head_bn = _affine_bn(last)
        self.classifier = nn.Linear(last, num_labels)

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        dt = self.compute_dtype()
        h = F.relu(self.downsample_bn(self._conv(self.downsample, self._mels_only(x), dt)))  # time as H
        h = F.max_pool2d(h, (2, 1))
        h = F.relu6(self.stem_bn(_same_conv(self.stem, h, dt)))
        for block in self.blocks:
            h = block(h, dt)
        h = F.relu6(self.head_bn(self._conv(self.head_conv, h, dt)))
        return self._head(self.classifier, self._dropout(h.mean(dim=(2, 3)), self.dropout))
