"""Datasets: metadata containers and the howl-format and noise-corpus loaders
(counterpart of ``howl_tpu/data/dataset``). The GSC, Common Voice and Hey
Snips loaders and the dataset writer are not ported yet (ROADMAP Queue 1,
item 12)."""

from howl_tpu_torch.data.dataset.dataset import (
    AudioClassificationDataset,
    AudioClipDataset,
    AudioDataset,
    DatasetSplit,
    DatasetType,
    WakeWordDataset,
)
from howl_tpu_torch.data.dataset.dataset_loader import (
    AudioClipDatasetLoader,
    RecursiveNoiseDatasetLoader,
    RegisteredPathDatasetLoader,
    WakeWordDatasetLoader,
)

__all__ = [
    "AudioClassificationDataset",
    "AudioClipDataset",
    "AudioClipDatasetLoader",
    "AudioDataset",
    "DatasetSplit",
    "DatasetType",
    "RecursiveNoiseDatasetLoader",
    "RegisteredPathDatasetLoader",
    "WakeWordDataset",
    "WakeWordDatasetLoader",
]
