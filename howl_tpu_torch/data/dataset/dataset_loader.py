"""Dataset loaders: howl-format jsonl metadata + recursive noise globs.

(ref: howl/data/dataset/dataset_loader.py:30-77)
"""

from __future__ import annotations

from pathlib import Path

from howl_tpu_torch.data.common.metadata import AudioClipMetadata
from howl_tpu_torch.data.dataset.dataset import (
    AudioClipDataset,
    AudioDataset,
    DatasetSplit,
    DatasetType,
    WakeWordDataset,
)
from howl_tpu_torch.utils.class_registry import ClassRegistry
from howl_tpu_torch.utils.logger import Logger


class RegisteredPathDatasetLoader(ClassRegistry):
    """Registry of loaders keyed by string (gsc / mozilla-cv / hey-snips / ...)."""

    registered_map = {}

    def load_splits(self, path: Path, **dataset_kwargs):
        raise NotImplementedError


def load_metadata_jsonl(path: Path):
    metadata_list = []
    with Path(path).open(encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                metadata_list.append(AudioClipMetadata.from_json(line))
    return metadata_list


class MetadataLoaderMixin:
    """Reads ``{prefix}metadata-{split}.jsonl`` triples (ref dataset_loader.py:39)."""

    dataset_class = AudioDataset
    metadata_class = AudioClipMetadata
    default_prefix = ""

    def load_single(self, path: Path, split: DatasetSplit, set_type: DatasetType, prefix: str = None, **dataset_kwargs):
        """Load ONE split's jsonl (callers iterating splits avoid parsing the
        other two files each time)."""
        path = Path(path)
        if prefix is None:
            prefix = self.default_prefix
        filename = path / f"{prefix}metadata-{split.value}.jsonl"
        if not filename.exists():
            # reference parity (ref dataset_loader.py:41 opens directly):
            # a typo'd path/prefix must fail loudly, not train on 0 clips
            raise FileNotFoundError(f"missing metadata file {filename}")
        metadata_list = load_metadata_jsonl(filename)
        # resolve clip paths relative to the dataset's audio dir
        for metadata in metadata_list:
            if not metadata.path.is_absolute():
                metadata.path = path / "audio" / metadata.path
        return self.dataset_class(
            metadata_list=metadata_list, set_type=set_type, dataset_split=split, **dataset_kwargs
        )

    def load_splits(self, path: Path, prefix: str = None, **dataset_kwargs):
        Logger.info(f"loading dataset from {path} (prefix={prefix!r})")
        return (
            self.load_single(path, DatasetSplit.TRAINING, DatasetType.TRAINING, prefix, **dataset_kwargs),
            self.load_single(path, DatasetSplit.DEV, DatasetType.DEV, prefix, **dataset_kwargs),
            self.load_single(path, DatasetSplit.TEST, DatasetType.TEST, prefix, **dataset_kwargs),
        )


class AudioClipDatasetLoader(MetadataLoaderMixin, RegisteredPathDatasetLoader, name="clip"):
    dataset_class = AudioClipDataset


class WakeWordDatasetLoader(MetadataLoaderMixin, RegisteredPathDatasetLoader, name="wake-word"):
    """Aligned wakeword datasets: ``aligned-metadata-{split}.jsonl``."""

    dataset_class = WakeWordDataset
    default_prefix = "aligned-"


class RecursiveNoiseDatasetLoader:
    """Globs ``**/*.wav`` under a noise corpus root (SNSD/MUSAN;
    ref dataset_loader.py:73-77)."""

    def load(self, path: Path, **dataset_kwargs) -> AudioClipDataset:
        wav_names = sorted(Path(path).glob("**/*.wav"))
        metadata_list = [AudioClipMetadata(path=p.absolute()) for p in wav_names]
        return AudioClipDataset(
            metadata_list=metadata_list, set_type=DatasetType.TRAINING, **dataset_kwargs
        )
