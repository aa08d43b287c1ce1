"""Inference: batched offline scoring, live serving, smoothing and the FSM."""

from howl_tpu_torch.inference.config import EngineConfig
from howl_tpu_torch.inference.engine import StreamingEngine, WholeClipEngine
from howl_tpu_torch.inference.online import IncrementalOnlineEngine, OnlineEngine
from howl_tpu_torch.inference.streaming_trunk import FusedStreamingOnlineEngine

__all__ = [
    "EngineConfig",
    "FusedStreamingOnlineEngine",
    "IncrementalOnlineEngine",
    "OnlineEngine",
    "StreamingEngine",
    "WholeClipEngine",
]
