"""Google Speech Commands corpus loader (ref: howl/data/dataset/gsc_dataset_loader.py:14)."""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import List, Tuple

from howl_tpu_torch.data.common.metadata import AudioClipMetadata
from howl_tpu_torch.data.dataset.dataset import AudioClassificationDataset, DatasetType
from howl_tpu_torch.data.dataset.dataset_loader import RegisteredPathDatasetLoader


class GoogleSpeechCommandsDatasetLoader(RegisteredPathDatasetLoader, name="gsc"):
    """Splits by testing_list.txt / validation_list.txt; labels from folders."""

    def __init__(self, vocab: List[str] = None, use_bg_noise: bool = False):
        self.vocab = vocab
        self.use_bg_noise = use_bg_noise

    def load_splits(
        self, path: Path, **dataset_kwargs
    ) -> Tuple[AudioClassificationDataset, AudioClassificationDataset, AudioClassificationDataset]:
        path = Path(path)
        file_map = defaultdict(lambda: DatasetType.TRAINING)
        with (path / "testing_list.txt").open() as f:
            file_map.update({k: DatasetType.TEST for k in f.read().split("\n") if k})
        with (path / "validation_list.txt").open() as f:
            file_map.update({k: DatasetType.DEV for k in f.read().split("\n") if k})
        all_list = sorted(path.glob("*/*.wav"))
        if not self.use_bg_noise:
            all_list = [x for x in all_list if "noise" not in str(x)]
        folders = sorted(x for x in path.glob("*/") if x.is_dir())
        vocab = [x.name for x in folders] if self.vocab is None else self.vocab
        label_map = {k: idx for idx, k in enumerate(vocab)}
        label_map["__default__"] = len(vocab)

        def load(set_type: DatasetType) -> AudioClassificationDataset:
            metadata_list = [
                AudioClipMetadata(path=p.absolute(), transcription=p.parent.name)
                for p in all_list
                if file_map[str(Path(p.parent.name) / p.name)] == set_type
            ]
            return AudioClassificationDataset(
                metadata_list=metadata_list, label_map=label_map, set_type=set_type, **dataset_kwargs
            )

        return load(DatasetType.TRAINING), load(DatasetType.DEV), load(DatasetType.TEST)
