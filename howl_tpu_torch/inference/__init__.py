"""Batched offline inference: fused-trunk scoring, smoothing and the FSM."""

from howl_tpu_torch.inference.config import EngineConfig
from howl_tpu_torch.inference.engine import StreamingEngine, WholeClipEngine

__all__ = ["EngineConfig", "StreamingEngine", "WholeClipEngine"]
