"""Wake-word classifier models (torch.nn), the whole zoo of the JAX package,
and the detection metrics."""

from howl_tpu_torch.models import cnn, mobilenet, rnn  # noqa: F401 — populate the registry
from howl_tpu_torch.models.base import (
    MODEL_REGISTRY,
    ConvertedStaticModel,
    ModelSpec,
    create_model,
    model_spec,
    register_model,
)
from howl_tpu_torch.models.metric import ConfusionMatrix

__all__ = [
    "MODEL_REGISTRY",
    "ConfusionMatrix",
    "ConvertedStaticModel",
    "ModelSpec",
    "create_model",
    "model_spec",
    "register_model",
]
