"""res8 (counterpart of ``howl_tpu/models/cnn.py``'s ``Res8``).

Inside the module the layout is NCHW with time as H and mel frequency as W,
as in the reference torch res8, so AvgPool(3, 4) pools (time=3, freq=4). The
public trunk functions keep the JAX package's layout: ``stem_features``
returns, and ``residual_features`` takes and returns, (B, T', F', maps).

The stem (conv0 + ReLU + AvgPool) runs through ``ops/stem_cuda.py``: the
hand-written kernel on a CUDA device, its plain version on the CPU. The
residual convs and the head are ``F.conv2d`` and ``F.linear``, as XLA
lowers them in the JAX package. BatchNorm is affine-less, running stats
only, eps 1e-5.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from howl_tpu_torch.models.base import register_model
from howl_tpu_torch.ops.stem_cuda import fold_stem_weights, res8_stem_cuda


@register_model("res8", supports_trunk=True)
class Res8(nn.Module):
    """res8: 1 stem conv + AvgPool + 6 residual 3x3 convs with affine-less
    BatchNorm + mean + linear head. Parameter names are the reference's:
    conv0..conv6, bn1..bn6, output."""

    def __init__(self, num_labels: int, num_maps: int = 45, pooling: Tuple[int, int] = (3, 4)):
        super().__init__()
        self.num_labels = num_labels
        self.num_maps = num_maps
        self.pooling = tuple(pooling)
        self.conv0 = nn.Conv2d(1, num_maps, 3, padding=1, bias=False)
        for i in range(1, 7):
            setattr(self, f"conv{i}", nn.Conv2d(num_maps, num_maps, 3, padding=1, bias=False))
            setattr(self, f"bn{i}", nn.BatchNorm2d(num_maps, eps=1e-5, momentum=0.1, affine=False))
        self.output = nn.Linear(num_maps, num_labels)

    def stem_taps(self, n_mels: int) -> torch.Tensor:
        """conv0's (3, 3, maps) float32 tap table for the stem kernel."""
        return fold_stem_weights(self.conv0.weight.detach().permute(2, 3, 1, 0), n_mels, self.pooling[1])

    def stem_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, F, T) features -> (B, T', F', maps) pooled stem activations."""
        mel_tm = x[:, 0].transpose(-1, -2).to(self.conv0.weight.dtype).contiguous()  # (B, T, F)
        return res8_stem_cuda(mel_tm, self.stem_taps(mel_tm.shape[-1]), self.pooling)

    def residual_features(self, y: torch.Tensor) -> torch.Tensor:
        """Pooled stem activations (B, T', F', maps) -> trunk output, same layout."""
        x = old_x = y.to(self.conv0.weight.dtype).permute(0, 3, 1, 2)  # NCHW, time = H
        for i in range(1, 7):
            y = F.relu(getattr(self, f"conv{i}")(x))
            if i % 2 == 0:
                x = y + old_x
                old_x = x
            else:
                x = y
            x = getattr(self, f"bn{i}")(x)
        return x.permute(0, 2, 3, 1)

    def trunk_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, F, T) features -> (B, T', F', maps) pre-mean trunk output."""
        return self.residual_features(self.stem_features(x))

    def head(self, pooled: torch.Tensor) -> torch.Tensor:
        """Mean trunk features (..., maps) -> logits, in float32."""
        return F.linear(pooled.float(), self.output.weight.float(), self.output.bias.float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk_features(x).mean(dim=(1, 2)))
