"""Model registry (counterpart of ``howl_tpu/models/base.py``).

Models are ``torch.nn.Module``s holding their own parameters and buffers.
Canonical model input is the frontend's feature layout (B, C, F, T); a model
slices the channels it uses. Every name of the JAX package's zoo is
registered: res8 and small-cnn (``cnn.py``, with seq-cnn), mobilenet
(``mobilenet.py``), lstm, seq-lstm, gru and las (``rnn.py``).
``ConvertedStaticModel`` turns a window classifier into a per-frame model.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass
class ModelSpec:
    """Registry entry: constructor + behavioral flags."""

    name: str
    factory: Callable[..., nn.Module]
    is_sequential: bool = False  # emits (T, B, L) per-frame logits
    is_recurrent: bool = False  # carries streaming state
    uses_deltas: bool = False  # consumes delta/accel channels (only LAS does)
    supports_trunk: bool = False  # fully-convolutional trunk + mean head (fused clip scoring)
    defaults: Dict[str, Any] = field(default_factory=dict)

    @property
    def uses_trunk(self) -> bool:
        """Whether the engines score through res8's stem kernel and trunk: a
        trunk-capable model that emits one output per window and carries no
        state (the JAX engine's default for ``fused_trunk``). ``convert_static``
        makes res8's spec sequential, and its windows then go through the
        wrapped classifier as a whole."""
        return self.supports_trunk and not self.is_sequential and not self.is_recurrent


MODEL_REGISTRY: Dict[str, ModelSpec] = {}


def register_model(
    name: str,
    is_sequential: bool = False,
    is_recurrent: bool = False,
    uses_deltas: bool = False,
    supports_trunk: bool = False,
    **defaults,
):
    def wrap(cls):
        MODEL_REGISTRY[name] = ModelSpec(
            name, cls, is_sequential, is_recurrent, uses_deltas, supports_trunk, defaults
        )
        cls.registered_name = name
        return cls

    return wrap


def model_spec(name: str) -> ModelSpec:
    try:
        return MODEL_REGISTRY[name]
    except KeyError as e:
        raise ValueError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}") from e


def create_model(name: str, num_labels: int, **kwargs) -> nn.Module:
    spec = model_spec(name)
    return spec.factory(num_labels=num_labels, **{**spec.defaults, **kwargs})


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init: variance scaling 1/fan_in, truncated
    normal at two standard deviations."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # std of N(0, 1) truncated to [-2, 2]
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class DropoutDraws:
    """Where a model's dropout masks come from in training: drawn from
    ``generator`` (keep where a uniform draw is at or above the rate), or,
    with ``masks``, taken from that list in the order the forward asks for
    them (the tests replay the JAX step's masks this way). With ``rows``
    (lo, hi, total), one rank of a data-parallel step, each mask is the
    global batch's, drawn (or given) for ``total`` rows on the batch axis,
    of which the rank keeps rows [lo, hi)."""

    def __init__(self, generator: Optional[torch.Generator] = None, masks=None, rows=None):
        self.generator = generator
        self.masks = None if masks is None else list(masks)
        self.rows = rows

    def keep(self, shape, rate: float, device, batch_axis: int = 0) -> torch.Tensor:
        if self.rows is not None:
            lo, hi, total = self.rows
            shape = tuple(shape[:batch_axis]) + (total,) + tuple(shape[batch_axis + 1 :])
        if self.masks is not None:
            keep = torch.as_tensor(np.array(self.masks.pop(0)), dtype=torch.bool, device=device)
        else:
            keep = torch.rand(shape, generator=self.generator, device=device) >= rate
        return keep if self.rows is None else keep.narrow(batch_axis, lo, hi - lo)


def use_dropout_draws(model: nn.Module, draws: Optional[DropoutDraws]) -> None:
    """Give every ``HowlModel`` inside ``model`` its dropout source (None:
    PyTorch's global generator)."""
    for m in model.modules():
        if isinstance(m, HowlModel):
            m.dropout_draws = draws


def use_data_group(model: nn.Module, group) -> None:
    """Give every BatchNorm of ``model`` (res8's and ``AffineBatchNorm``)
    the data group whose global batch its training statistics span (None:
    this process's batch alone)."""
    for m in model.modules():
        if hasattr(m, "data_group"):
            m.data_group = group


def batch_moments(xf: torch.Tensor, group=None):
    """Per-channel mean and biased variance (E[x^2] - E[x]^2, clipped at 0)
    of float32 (B, C, H, W) ``xf``. With a data group (a
    ``parallel.mesh.DataGroup`` of more than one rank; a seed's group of a
    (seed, data) grid) over the global batch: each rank's sums of x and x^2
    and its element count are all-reduced in float32 over the group by the
    differentiable all-reduce, so the gradient through the statistics
    reaches every rank's rows."""
    if group is None or group.size == 1:
        mean = xf.mean(dim=(0, 2, 3))
        return mean, torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    import warnings

    from torch.distributed.nn.functional import all_reduce

    c = xf.shape[1]
    count = xf.new_full((1,), float(xf.numel() // c))
    with warnings.catch_warnings():  # newer PyTorch marks it deprecated; its replacement has no backward
        warnings.simplefilter("ignore", FutureWarning)
        sums = all_reduce(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), count]),
                          group=group.pg if group.pg is not None else torch.distributed.group.WORLD)
    mean, sq = sums[:c] / sums[-1], sums[c : 2 * c] / sums[-1]
    return mean, torch.clamp(sq - mean * mean, min=0.0)


def serve_in_weight_dtype(model: nn.Module) -> nn.Module:
    """Clear the mixed-precision ``dtype`` of ``model`` and every module in
    it, so that it computes in its weights' dtype: the engines cast the
    weights to their compute dtype, as the JAX engines cast their
    variables."""
    for m in model.modules():
        if "dtype" in vars(m):
            m.dtype = None
    return model


class AffineBatchNorm(nn.BatchNorm2d):
    """flax's ``BatchNorm()`` as a torch layer over NCHW: scale and bias, eps
    1e-5. In eval mode it is ``nn.BatchNorm2d``'s own forward on the running
    stats, which computes in float32 for a bf16 input and returns the
    input's dtype, as flax does. In training it
    normalizes with the batch's float32 mean and biased variance (E[x^2] -
    E[x]^2, clipped at 0) and moves the running stats as flax's momentum
    0.99 does, with that biased variance; ``torch.nn.BatchNorm2d`` would move
    them with the unbiased one. The statistics and the normalization run in
    float32 whatever the input's dtype, and the output takes the input's
    dtype, as flax's ``BatchNorm(dtype=...)`` returns it."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__(channels, eps=eps, momentum=1.0 - momentum)
        self.data_group = None  # training statistics over a data group's global batch (``use_data_group``)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)  # the running stats: one batch_norm call, float32 arithmetic for bf16 x
        xf = x.float()
        mean, var = batch_moments(xf, self.data_group)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)


class HowlModel(nn.Module):
    """Shared helpers of the zoo's models other than res8.

    ``dtype`` is flax's mixed precision, as ``Res8`` has it: with
    ``torch.bfloat16`` the convs, recurrences and hidden dense layers compute
    in bf16 on bf16 casts of the parameters, while BatchNorm statistics and
    the dense heads (``_head``) stay float32 and the parameters keep their
    own dtype (float32 master weights in training). ``None`` computes in the
    parameters' dtype, which is how the engines serve (they cast the
    weights). Dropout is applied in training only, from ``dropout_draws``
    (a ``DropoutDraws``; None takes PyTorch's global generator), with the
    JAX modules' rates.
    """

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.dropout_draws: Optional[DropoutDraws] = None

    def compute_dtype(self) -> torch.dtype:
        return self.dtype or next(self.parameters()).dtype

    def compute_length(self, length):
        """Frames of model output per frames of feature input (identity unless
        the model downsamples time)."""
        return length

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "HowlModel":
        """flax's initializers, drawn from ``generator``: lecun-normal conv,
        dense and recurrent input kernels, orthogonal recurrent kernels (each
        gate's), zero biases, BatchNorm scale 1, bias 0 and running stats 0
        and 1, las's context vector uniform in +-0.25."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _lecun_normal_(m.weight, m.weight[0].numel(), generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.RNNBase):
                for name, p in m.named_parameters():
                    if name.startswith("weight_ih"):
                        _lecun_normal_(p, p.shape[1], generator)
                    elif name.startswith("weight_hh"):
                        for gate in p.split(m.hidden_size):
                            nn.init.orthogonal_(gate, generator=generator)
                    else:
                        p.zero_()
            vec = getattr(m, "context_vec", None)
            if isinstance(vec, nn.Parameter):
                vec.uniform_(-0.25, 0.25, generator=generator)
        return self

    @staticmethod
    def _mels_only(x: torch.Tensor) -> torch.Tensor:
        """(B, C, F, T) -> (B, 1, T, F): the log-mel channel, time as H."""
        return x[:, :1].transpose(-1, -2)

    @staticmethod
    def _conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``layer`` over x in ``dtype``, on casts of its parameters."""
        bias = None if layer.bias is None else layer.bias.to(dtype)
        return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride, layer.padding, layer.dilation,
                        layer.groups)

    @staticmethod
    def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """A dense layer in ``dtype``, on casts of its parameters."""
        return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))

    @staticmethod
    def _head(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """A dense layer in float32, as the JAX modules compute their logits."""
        return F.linear(x.float(), layer.weight.float(), layer.bias.float())

    def _dropout(self, x: torch.Tensor, rate: float, batch_axis: int = 0) -> torch.Tensor:
        """flax's ``Dropout(rate)``: in training, each value kept with
        probability 1 - rate and scaled by 1 / (1 - rate), else zero.
        ``batch_axis`` is the axis of ``x`` that holds the batch's rows."""
        if not self.training or rate == 0.0:
            return x
        draws = self.dropout_draws or DropoutDraws()
        keep = draws.keep(x.shape, rate, x.device, batch_axis)
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class ConvertedStaticModel(nn.Module):
    """A static window classifier turned into a per-frame sequential model by
    a sliding window over the time axis (counterpart of the JAX package's
    ``ConvertedStaticModel``). Windows are the full-coverage ones, (T - W) //
    S + 1 of them; all of them fold into the batch axis and the inner
    classifier runs once. A clip shorter than one window raises."""

    def __init__(self, inner: nn.Module, frame_window_size: int = 40, frame_stride_size: int = 10):
        super().__init__()
        self.inner = inner
        self.frame_window_size = frame_window_size
        self.frame_stride_size = frame_stride_size

    def init_weights(self, generator: torch.Generator) -> "ConvertedStaticModel":
        self.inner.init_weights(generator)
        return self

    def compute_length(self, length):
        if length is None:
            return None
        return torch.clamp(torch.as_tensor(length - self.frame_window_size) // self.frame_stride_size + 1, min=1)

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        total = x.shape[-1]
        if total < self.frame_window_size:
            raise ValueError(
                f"input has {total} frames but the converted model's window is "
                f"{self.frame_window_size}; pad clips to at least one window"
            )
        windows = x.unfold(-1, self.frame_window_size, self.frame_stride_size)  # (B, C, F, nw, W)
        b, num_windows = x.shape[0], windows.shape[3]
        flat = windows.movedim(3, 1).reshape(b * num_windows, *x.shape[1:-1], self.frame_window_size)
        logits = self.inner(flat)  # (B * nw, L)
        return logits.reshape(b, num_windows, -1).transpose(0, 1)  # (nw, B, L)
