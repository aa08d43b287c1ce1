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
from typing import Any, Callable, Dict

import torch
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


class HowlModel(nn.Module):
    """Shared helpers of the zoo's models other than res8.

    ``dtype`` is the JAX modules' mixed-precision field. These models serve
    in their parameters' dtype (the engines cast the weights, as the JAX
    engines do, ``inference/config.cast_compute_dtype``); a compute dtype
    other than the parameters' comes with these families' training (ROADMAP
    Queue 1, item 8) and raises until then.
    """

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype

    def _check_dtype(self) -> None:
        if self.dtype is not None and self.dtype != next(self.parameters()).dtype:
            raise NotImplementedError(
                f"{type(self).__name__} computes in its parameters' dtype: mixed precision (dtype={self.dtype}) "
                "is not ported to PyTorch yet (ROADMAP Queue 1, item 8: the families' training)"
            )

    def compute_length(self, length):
        """Frames of model output per frames of feature input (identity unless
        the model downsamples time)."""
        return length

    @staticmethod
    def _mels_only(x: torch.Tensor) -> torch.Tensor:
        """(B, C, F, T) -> (B, 1, T, F): the log-mel channel, time as H."""
        return x[:, :1].transpose(-1, -2)

    @staticmethod
    def _head(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """A dense layer in float32, as the JAX modules compute their logits."""
        return nn.functional.linear(x.float(), layer.weight.float(), layer.bias.float())


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
