"""Datasets: metadata containers, the corpus loaders (howl format, noise,
Google Speech Commands, Common Voice, Hey Snips), the loader factory and the
dataset writers (counterpart of ``howl_tpu/data/dataset``)."""

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
from howl_tpu_torch.data.dataset.gsc_loader import GoogleSpeechCommandsDatasetLoader

__all__ = [
    "AudioClassificationDataset",
    "AudioClipDataset",
    "AudioClipDatasetLoader",
    "AudioDataset",
    "DatasetSplit",
    "DatasetType",
    "GoogleSpeechCommandsDatasetLoader",
    "RecursiveNoiseDatasetLoader",
    "RegisteredPathDatasetLoader",
    "WakeWordDataset",
    "WakeWordDatasetLoader",
]
