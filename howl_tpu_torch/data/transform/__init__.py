"""Host-side batch samplers producing fixed-shape arrays for device programs."""

from howl_tpu_torch.data.transform.batchifier import (
    AudioSequenceBatchifier,
    ClassificationBatchSampler,
    WakeWordFrameBatchifier,
)

__all__ = ["AudioSequenceBatchifier", "ClassificationBatchSampler", "WakeWordFrameBatchifier"]
