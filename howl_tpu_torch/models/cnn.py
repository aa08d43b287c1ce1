"""res8 (counterpart of ``howl_tpu/models/cnn.py``'s ``Res8``).

Inside the module the layout is NCHW with time as H and mel frequency as W,
as in the reference torch res8, so AvgPool(3, 4) pools (time=3, freq=4). The
public trunk functions keep the JAX package's layout: ``stem_features``
returns, and ``residual_features`` takes and returns, (B, T', F', maps).

The stem (conv0 + ReLU + AvgPool) has two routes. In training, and whenever
grad mode is on and conv0 requires grad, it is the differentiable
``F.conv2d`` + ReLU + ``F.avg_pool2d`` chain, as the JAX train step runs it
through XLA. Otherwise it runs through ``ops/stem_cuda.py``: the
hand-written kernel on a CUDA device, its plain version on the CPU; that
kernel has no backward and refuses inputs that require grad. The residual
convs and the head are ``F.conv2d`` and ``F.linear``, as XLA lowers them in
the JAX package.

BatchNorm is affine-less, eps 1e-5. In eval mode it normalizes with the
running stats. In training it normalizes with the batch's float32 mean and
biased variance (E[x^2] - E[x]^2, clipped at 0) and moves the running stats
as flax's ``BatchNorm(momentum=0.9)`` does, with the biased variance;
``torch.nn.BatchNorm2d`` would move them with the unbiased one.

``dtype`` is flax's mixed precision: with ``torch.bfloat16`` the convs run
in bf16 on bf16 casts of the parameters, BatchNorm statistics, the head and
the loss stay float32, and the parameters keep their own dtype (float32
master weights in training). ``None`` computes in the parameters' dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from howl_tpu_torch.models.base import register_model
from howl_tpu_torch.ops.frontend import round_bf16
from howl_tpu_torch.ops.stem_cuda import fold_stem_weights, res8_stem_cuda

BN_MOMENTUM = 0.9  # flax's convention: running = momentum * running + (1 - momentum) * batch
BN_EPS = 1e-5


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init: variance scaling 1/fan_in, truncated
    normal at two standard deviations."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # std of N(0, 1) truncated to [-2, 2]
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@register_model("res8", supports_trunk=True)
class Res8(nn.Module):
    """res8: 1 stem conv + AvgPool + 6 residual 3x3 convs with affine-less
    BatchNorm + mean + linear head. Parameter names are the reference's:
    conv0..conv6, bn1..bn6, output."""

    def __init__(
        self,
        num_labels: int,
        num_maps: int = 45,
        pooling: Tuple[int, int] = (3, 4),
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.num_labels = num_labels
        self.num_maps = num_maps
        self.pooling = tuple(pooling)
        self.dtype = dtype
        self.conv0 = nn.Conv2d(1, num_maps, 3, padding=1, bias=False)
        for i in range(1, 7):
            setattr(self, f"conv{i}", nn.Conv2d(num_maps, num_maps, 3, padding=1, bias=False))
            setattr(self, f"bn{i}", nn.BatchNorm2d(num_maps, eps=BN_EPS, momentum=0.1, affine=False))
        self.output = nn.Linear(num_maps, num_labels)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Res8":
        """flax's initializers, drawn from ``generator``: lecun-normal conv and
        dense kernels, zero bias, BatchNorm running stats 0 and 1."""
        for i in range(7):
            conv = getattr(self, f"conv{i}")
            _lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
        _lecun_normal_(self.output.weight, self.num_maps, generator)
        self.output.bias.zero_()
        for i in range(1, 7):
            getattr(self, f"bn{i}").reset_running_stats()
        return self

    def compute_dtype(self) -> torch.dtype:
        return self.dtype or self.conv0.weight.dtype

    # ---- stem ----

    def stem_taps(self, n_mels: int) -> torch.Tensor:
        """conv0's (3, 3, maps) float32 tap table for the stem kernel, rounded
        to bf16 values when the stem computes in bf16."""
        taps = fold_stem_weights(self.conv0.weight.detach().permute(2, 3, 1, 0), n_mels, self.pooling[1])
        return round_bf16(taps) if self.compute_dtype() == torch.bfloat16 else taps

    def stem_trains(self) -> bool:
        """True when the stem must be differentiable: in training, or with
        grad mode on and conv0 requiring grad."""
        return self.training or (torch.is_grad_enabled() and self.conv0.weight.requires_grad)

    def stem_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, F, T) features -> (B, T', F', maps) pooled stem activations."""
        dt = self.compute_dtype()
        if self.stem_trains():
            mel = x[:, :1].transpose(-1, -2).to(dt)  # (B, 1, T, F): time is H
            y = F.relu(F.conv2d(mel, self.conv0.weight.to(dt), padding=1))
            return F.avg_pool2d(y, self.pooling, stride=self.pooling).permute(0, 2, 3, 1)
        mel_tm = x[:, 0].transpose(-1, -2).to(dt).contiguous()  # (B, T, F)
        return res8_stem_cuda(mel_tm, self.stem_taps(mel_tm.shape[-1]), self.pooling)

    # ---- residual trunk ----

    def _batch_norm(self, i: int, x: torch.Tensor) -> torch.Tensor:
        bn = getattr(self, f"bn{i}")
        if not self.training:
            return bn(x)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)
            bn.num_batches_tracked += 1
        y = (xf - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
        return y.to(x.dtype)

    def residual_features(self, y: torch.Tensor) -> torch.Tensor:
        """Pooled stem activations (B, T', F', maps) -> trunk output, same layout."""
        dt = self.compute_dtype()
        x = old_x = y.to(dt).permute(0, 3, 1, 2)  # NCHW, time = H
        for i in range(1, 7):
            y = F.relu(F.conv2d(x, getattr(self, f"conv{i}").weight.to(dt), padding=1))
            if i % 2 == 0:
                x = y + old_x
                old_x = x
            else:
                x = y
            x = self._batch_norm(i, x)
        return x.permute(0, 2, 3, 1)

    def trunk_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, F, T) features -> (B, T', F', maps) pre-mean trunk output."""
        return self.residual_features(self.stem_features(x))

    def head(self, pooled: torch.Tensor) -> torch.Tensor:
        """Mean trunk features (..., maps) -> logits, in float32."""
        return F.linear(pooled.float(), self.output.weight.float(), self.output.bias.float())

    def windowed_logits(self, x: torch.Tensor, span_lo: int, span_hi: int) -> torch.Tensor:
        """Logits of the window over trunk frames [span_lo, span_hi) of a
        context segment: the trunk-mode training forward, which matches the
        fused clip-level scoring of the serving engine."""
        return self.head(self.trunk_features(x)[:, span_lo:span_hi].mean(dim=(1, 2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk_features(x).mean(dim=(1, 2)))
