"""Model registry (counterpart of ``howl_tpu/models/base.py``).

Models are ``torch.nn.Module``s holding their own parameters and buffers.
Canonical model input is the frontend's feature layout (B, C, F, T); a model
slices the channels it uses. Only res8 is ported; every other name of the
JAX package's zoo raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict

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

# the JAX package's other models, ported with the rest of the zoo
NOT_PORTED = ("small-cnn", "seq-cnn", "mobilenet", "lstm", "seq-lstm", "gru", "las")


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
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet (ROADMAP Queue 1, item 8: remaining model zoo)"
        )
    try:
        return MODEL_REGISTRY[name]
    except KeyError as e:
        raise ValueError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}") from e


def create_model(name: str, num_labels: int, **kwargs) -> nn.Module:
    spec = model_spec(name)
    return spec.factory(num_labels=num_labels, **{**spec.defaults, **kwargs})
