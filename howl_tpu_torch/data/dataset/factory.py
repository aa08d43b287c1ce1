"""Dataset-loader factory keyed by AudioDatasetType
(ref: howl/dataset_loader/dataset_loader_factory.py:9 + howl_audio_dataset_loader.py:13)."""

from __future__ import annotations

from pathlib import Path

from howl_tpu_torch.data.dataset.common_voice_loader import MozillaCommonVoiceLoader
from howl_tpu_torch.data.dataset.constants import METADATA_FILE_PREFIX, AudioDatasetType
from howl_tpu_torch.data.dataset.dataset import DatasetSplit, DatasetType, WakeWordDataset
from howl_tpu_torch.data.dataset.dataset_loader import MetadataLoaderMixin


class HowlAudioDatasetLoader(MetadataLoaderMixin):
    """Loads howl-format datasets (raw / aligned / stitched) by metadata prefix."""

    dataset_class = WakeWordDataset

    def __init__(self, dataset_type: AudioDatasetType, dataset_path: Path):
        self.name = dataset_type.value
        self.dataset_type = dataset_type
        self.dataset_path = Path(dataset_path)
        if not self.dataset_path.exists():
            raise FileNotFoundError(f"dataset path is invalid: {self.dataset_path}")
        self.default_prefix = METADATA_FILE_PREFIX[dataset_type]

    def load_splits(self, path: Path = None, **dataset_kwargs):
        return super().load_splits(path or self.dataset_path, **dataset_kwargs)

    def load_split(self, dataset_split: DatasetSplit, **dataset_kwargs):
        set_types = {
            DatasetSplit.TRAINING: DatasetType.TRAINING,
            DatasetSplit.DEV: DatasetType.DEV,
            DatasetSplit.TEST: DatasetType.TEST,
        }
        ds_kwargs = dict(dataset_kwargs)
        ds_kwargs.pop("dataset_split", None)
        # parse only the requested split's jsonl (the reference loader reads
        # one file per call too, ref howl_audio_dataset_loader.py:_load_dataset)
        return self.load_single(self.dataset_path, dataset_split, set_types[dataset_split], **ds_kwargs)


class _CommonVoiceAdapter:
    """Adapts MozillaCommonVoiceLoader to the factory interface."""

    name = AudioDatasetType.COMMON_VOICE.value

    def __init__(self, dataset_path: Path):
        self.dataset_path = Path(dataset_path)
        if not self.dataset_path.exists():
            raise FileNotFoundError(f"dataset path is invalid: {self.dataset_path}")
        self._loader = MozillaCommonVoiceLoader()

    def load_splits(self, **dataset_kwargs):
        return self._loader.load_splits(self.dataset_path, **dataset_kwargs)


def get_dataset_loader(dataset_type: AudioDatasetType, dataset_path: Path):
    if dataset_type == AudioDatasetType.COMMON_VOICE:
        return _CommonVoiceAdapter(dataset_path)
    return HowlAudioDatasetLoader(dataset_type, dataset_path)
