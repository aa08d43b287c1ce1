"""Wake-word classifier models (torch.nn) and the detection metrics. Only
res8 is ported so far."""

from howl_tpu_torch.models import cnn  # noqa: F401 — populate the registry
from howl_tpu_torch.models.base import MODEL_REGISTRY, ModelSpec, create_model, model_spec, register_model
from howl_tpu_torch.models.metric import ConfusionMatrix

__all__ = ["MODEL_REGISTRY", "ConfusionMatrix", "ModelSpec", "create_model", "model_spec", "register_model"]
