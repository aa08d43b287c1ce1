"""The convolutional classifiers (counterpart of ``howl_tpu/models/cnn.py``):
res8, small-cnn and seq-cnn.

small-cnn and seq-cnn run in NCHW with time as H, as res8 does, their convs
padded as the JAX modules pad theirs, max pools before an affine BatchNorm
(eps 1e-5, running stats in eval mode), dense layers on features flattened
in the JAX package's (time, frequency, channel) order, and logits in
float32. Their parameter names are the JAX modules': conv0, bn1, conv1,
bn2, fc1, fc2.

The rest of this docstring is res8's, the counterpart of the JAX ``Res8``.

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

from howl_tpu_torch.models.base import HowlModel, register_model
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

    def stem_features(self, x: torch.Tensor, taps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, C, F, T) features -> (B, T', F', maps) pooled stem activations.
        ``taps``: the stem kernel's tap table when the caller keeps one
        (``stem_taps``), so that it is packed once for many calls."""
        dt = self.compute_dtype()
        if self.stem_trains():
            mel = x[:, :1].transpose(-1, -2).to(dt)  # (B, 1, T, F): time is H
            y = F.relu(F.conv2d(mel, self.conv0.weight.to(dt), padding=1))
            return F.avg_pool2d(y, self.pooling, stride=self.pooling).permute(0, 2, 3, 1)
        mel_tm = x[:, 0].transpose(-1, -2).to(dt).contiguous()  # (B, T, F)
        return res8_stem_cuda(mel_tm, self.stem_taps(mel_tm.shape[-1]) if taps is None else taps, self.pooling)

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

    def trunk_features(self, x: torch.Tensor, taps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, C, F, T) features -> (B, T', F', maps) pre-mean trunk output."""
        return self.residual_features(self.stem_features(x, taps))

    def head(self, pooled: torch.Tensor) -> torch.Tensor:
        """Mean trunk features (..., maps) -> logits, in float32."""
        return F.linear(pooled.float(), self.output.weight.float(), self.output.bias.float())

    # ---- streaming-trunk support (FusedStreamingOnlineEngine) ----
    #
    # The trunk is a stack of 3x3 SAME convs that look one frame ahead, so a
    # live stream can compute only the newly final frames of every layer each
    # hop from a short ring per stage. Residuals add the pre-BatchNorm sums
    # (old_x in residual_features), so those sums (r2, r4) are kept beside the
    # post-BN stage outputs (s0..s5). Rings and stage outputs are (B, T', F',
    # maps), time on axis 1, as in the JAX package.

    def _conv_relu(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """relu(conv_i(x)) on (B, T, F, maps) stage frames, same layout out."""
        w = getattr(self, f"conv{i}").weight.to(self.compute_dtype())
        return F.relu(F.conv2d(x.permute(0, 3, 1, 2), w, padding=1)).permute(0, 2, 3, 1)

    def _stage_norm(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """bn_i over (B, T, F, maps) stage frames, same layout out."""
        return self._batch_norm(i, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def trunk_intermediates(self, x: torch.Tensor, taps: Optional[torch.Tensor] = None) -> dict:
        """Whole-clip trunk forward returning every kept stage: s0 (the pooled
        stem, ``stem_features``: the stem kernel on a card), s1..s6 (post-BN
        outputs), r2 and r4 (pre-BN residual sums), each (B, T', F', maps).
        It prefills the streaming-trunk rings, so a stream starts from the
        offline clip's left-edge SAME padding."""
        y = self.stem_features(x, taps).to(self.compute_dtype())
        outs = {"s0": y}
        x = old_x = y
        for i in range(1, 7):
            y = self._conv_relu(i, x)
            if i % 2 == 0:
                x = y + old_x
                old_x = x
                if i < 6:
                    outs[f"r{i}"] = x
            else:
                x = y
            x = self._stage_norm(i, x)
            outs[f"s{i}"] = x
        return outs

    @staticmethod
    def _ingest(ring: torch.Tensor, new: torch.Tensor, delta: int) -> torch.Tensor:
        """Shift the ``delta`` newest of ``new``'s frames into a newest-last
        time ring (axis 1); when delta is below the new frame count, the
        leading new frames recompute frames already in the ring and are
        dropped."""
        n_new = new.shape[1]
        return torch.cat([ring[:, delta:], new[:, n_new - delta :]], dim=1)

    def trunk_stream_step(self, mel_slab: torch.Tensor, rings: dict, delta: int):
        """One streaming-trunk step: the n_new newest pooled-trunk frames from
        per-stage rings.

        mel_slab: (B, n_new * pool_t + 2, F, 1) ZMUV'd mel frames covering
        conv0's support of the new pooled frames. rings: (B, n_new + 2, F',
        maps) newest-last stage rings s0..s5, r2, r4. delta: how many of the
        computed frames are new this step.

        conv0 runs over the slab with ``F.conv2d`` (where the JAX package runs
        an XLA conv), then rows [1, 1 + n_new * pool_t) are kept and pooled;
        every layer after it runs its SAME conv over its input ring's n_new +
        2 newest frames and keeps the interior. Returns (updated rings, the
        s6 frequency mean (B, n_new, maps) in float32).
        """
        dt = self.compute_dtype()
        pool_t = self.pooling[0]
        n_new = (mel_slab.shape[1] - 2) // pool_t
        mel = mel_slab[..., 0][:, None].to(dt)  # (B, 1, T, F): time is H
        y = F.relu(F.conv2d(mel, self.conv0.weight.to(dt), padding=1))[:, :, 1 : 1 + n_new * pool_t]
        y = F.avg_pool2d(y, self.pooling, stride=self.pooling).permute(0, 2, 3, 1)  # (B, n_new, F', maps)
        rings = dict(rings)
        rings["s0"] = self._ingest(rings["s0"], y, delta)
        s6_mean = None
        for i in range(1, 7):
            y = self._conv_relu(i, rings[f"s{i - 1}"][:, -(n_new + 2) :])[:, 1 : 1 + n_new]
            if i % 2 == 0:
                res_src = "s0" if i == 2 else f"r{i - 2}"
                x = y + rings[res_src][:, -(n_new + 2) : -2]
                if i < 6:
                    rings[f"r{i}"] = self._ingest(rings[f"r{i}"], x, delta)
            else:
                x = y
            s = self._stage_norm(i, x)
            if i < 6:
                rings[f"s{i}"] = self._ingest(rings[f"s{i}"], s, delta)
            else:
                s6_mean = s.float().mean(dim=2)
        return rings, s6_mean

    def windowed_logits(self, x: torch.Tensor, span_lo: int, span_hi: int) -> torch.Tensor:
        """Logits of the window over trunk frames [span_lo, span_hi) of a
        context segment: the trunk-mode training forward, which matches the
        fused clip-level scoring of the serving engine."""
        return self.head(self.trunk_features(x)[:, span_lo:span_hi].mean(dim=(1, 2)))

    def forward(self, x: torch.Tensor, taps: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.head(self.trunk_features(x, taps).mean(dim=(1, 2)))


def _affine_bn(channels: int) -> nn.BatchNorm2d:
    """flax's ``BatchNorm()`` defaults as a torch layer: scale and bias, eps
    1e-5; in eval mode it normalizes with the running stats."""
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=0.01)


@register_model("small-cnn")
class SmallCnn(HowlModel):
    """Two conv encoders + MLP head. ``num_hidden_input`` is fc1's input
    width, 384 for a 41-frame window of 40 mels (flax infers it)."""

    def __init__(self, num_labels: int, num_maps1: int = 48, num_maps2: int = 64, num_hidden_input: int = 384,
                 hidden_size: int = 128, dtype=None):
        super().__init__(dtype)
        self.conv0 = nn.Conv2d(1, num_maps1, (8, 16), stride=(2, 2), padding=(4, 0))
        self.bn1 = _affine_bn(num_maps1)
        self.conv1 = nn.Conv2d(num_maps1, num_maps2, (5, 5), stride=(2, 1), padding=(2, 2))
        self.bn2 = _affine_bn(num_maps2)
        self.fc1 = nn.Linear(num_hidden_input, hidden_size)
        self.fc2 = nn.Linear(hidden_size, num_labels)

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        self._check_dtype()
        x = self._mels_only(x).to(self.conv0.weight.dtype)  # (B, 1, T, F)
        x = self.bn1(F.max_pool2d(F.relu(self.conv0(x)), 2))
        x = self.bn2(F.max_pool2d(F.relu(self.conv1(x)), 2))
        x = F.relu(self.fc1(x.permute(0, 2, 3, 1).flatten(1)))  # flattened as (T', F', C)
        return self._head(self.fc2, x)


@register_model("seq-cnn", is_sequential=True)
class SequentialCnn(HowlModel):
    """Per-frame conv encoder for the CTC objective: (T', B, L) logits.
    ``n_mels`` sets fc1's input width (flax infers it)."""

    def __init__(self, num_labels: int, num_maps1: int = 48, num_maps2: int = 64, hidden_size: int = 128,
                 n_mels: int = 40, dtype=None):
        super().__init__(dtype)
        self.conv0 = nn.Conv2d(1, num_maps1, (20, 16), stride=(1, 2), padding=(10, 0))
        self.bn1 = _affine_bn(num_maps1)
        self.conv1 = nn.Conv2d(num_maps1, num_maps2, (5, 5), stride=(2, 1), padding=(2, 2))
        self.bn2 = _affine_bn(num_maps2)
        self.fc1 = nn.Linear(((n_mels - 16) // 2 + 1) // 2 // 2 * num_maps2, hidden_size)
        self.fc2 = nn.Linear(hidden_size, num_labels)

    def compute_length(self, length):
        length = (length + 2 * 10 - 20) // 1 + 1
        length = length // 2
        length = (length + 2 * 2 - 4 - 1) // 2 + 1
        return length // 2

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        self._check_dtype()
        x = self._mels_only(x).to(self.conv0.weight.dtype)  # (B, 1, T, F)
        x = self.bn1(F.max_pool2d(F.relu(self.conv0(x)), 2))
        x = self.bn2(F.max_pool2d(F.relu(self.conv1(x)), 2))
        x = x.permute(2, 0, 3, 1).flatten(2)  # (T', B, F' * C), flattened as (F', C)
        return self._head(self.fc2, F.relu(self.fc1(x)))  # (T', B, L)
