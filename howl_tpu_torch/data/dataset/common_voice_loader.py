"""Mozilla Common Voice family loaders (ref: howl/data/dataset/common_voice_dataset_loader.py:22-123)."""

from __future__ import annotations

import csv
from functools import partial
from pathlib import Path
from typing import Tuple

from howl_tpu_torch.data.common.metadata import UNKNOWN_TRANSCRIPTION, AudioClipMetadata
from howl_tpu_torch.data.dataset.dataset import AudioClipDataset, DatasetType
from howl_tpu_torch.data.dataset.dataset_loader import RegisteredPathDatasetLoader
from howl_tpu_torch.utils.hash_utils import sha256_int
from howl_tpu_torch.utils.logger import Logger


def _read_tsv(path: Path):
    with Path(path).open(encoding="utf-8", newline="") as f:
        yield from csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE)


class MozillaCommonVoiceLoader(RegisteredPathDatasetLoader, name="mozilla-cv"):
    """train/dev/test.tsv -> clip datasets."""

    def load_splits(self, path: Path, **dataset_kwargs) -> Tuple[AudioClipDataset, ...]:
        path = Path(path)
        if not path.exists():
            raise FileNotFoundError(f"dataset path doesn't exist: {path}")
        filenames = ("train.tsv", "dev.tsv", "test.tsv")
        if not all((path / x).exists() for x in filenames):
            raise FileNotFoundError(f"dataset missing metadata tsv under {path}")

        def load(filename, set_type):
            Logger.info(f"loading split {filename}")
            metadata_list = [
                AudioClipMetadata(
                    path=(path / "clips" / row["path"]).absolute(), transcription=row["sentence"]
                )
                for row in _read_tsv(path / filename)
            ]
            return AudioClipDataset(metadata_list=metadata_list, set_type=set_type, **dataset_kwargs)

        return (
            load("train.tsv", DatasetType.TRAINING),
            load("dev.tsv", DatasetType.DEV),
            load("test.tsv", DatasetType.TEST),
        )


class MozillaKeywordLoader(RegisteredPathDatasetLoader, name="mozilla-kw"):
    """validated.tsv split 80/10/10 by sha256(client_id)."""

    def load_splits(self, path: Path, **dataset_kwargs) -> Tuple[AudioClipDataset, ...]:
        path = Path(path)
        Logger.info("loading Mozilla keyword dataset")
        md_splits = ([], [], [])
        for row in _read_tsv(path / "validated.tsv"):
            metadata = AudioClipMetadata(
                path=(path / "clips" / row["path"]).absolute(), transcription=row["sentence"]
            )
            bucket = sha256_int(row["client_id"]) % 100
            md_splits[0 if bucket < 80 else (1 if bucket < 90 else 2)].append(metadata)
        return (
            AudioClipDataset(metadata_list=md_splits[0], set_type=DatasetType.TRAINING, **dataset_kwargs),
            AudioClipDataset(metadata_list=md_splits[1], set_type=DatasetType.DEV, **dataset_kwargs),
            AudioClipDataset(metadata_list=md_splits[2], set_type=DatasetType.TEST, **dataset_kwargs),
        )


class MozillaWakeWordLoader(RegisteredPathDatasetLoader, name="mozilla-ww"):
    """verified/rejected recordings split by speaker or sound id."""

    def __init__(self, training_pct=80, dev_pct=10, test_pct=10, split_by_speaker=True, split="verified"):
        self.split_by_speaker = split_by_speaker
        total = training_pct + dev_pct + test_pct
        training_pct = 100 * training_pct / total
        dev_pct = 100 * dev_pct / total
        test_pct = 100 * test_pct / total
        self.cutoffs = (training_pct, training_pct + dev_pct, training_pct + dev_pct + test_pct)
        self.split = split

    def load_splits(self, path: Path, **dataset_kwargs) -> Tuple[AudioClipDataset, ...]:
        path = Path(path)
        if self.split not in ("verified", "rejected"):
            raise ValueError("split must be 'verified' or 'rejected'")
        audio_path = path / self.split
        if not audio_path.exists():
            raise FileNotFoundError(f"dataset malformed: missing {audio_path}")
        metadatas = ([], [], [])
        Logger.info("loading wake word dataset")
        using_verified = self.split == "verified"
        for sound_fp in sorted(audio_path.glob("*/*.ogg")) + sorted(audio_path.glob("*/*.wav")):
            sound_id = sound_fp.stem
            speaker_id = sound_fp.parent.name
            if using_verified:
                transcription = (sound_fp.parent / sound_id).with_suffix(".txt").read_text()
            else:
                transcription = UNKNOWN_TRANSCRIPTION
            metadata = AudioClipMetadata(path=sound_fp.absolute(), transcription=transcription)
            bucket = sha256_int(speaker_id if self.split_by_speaker else sound_id) % 100
            idx = next(i for i, cutoff in enumerate(self.cutoffs) if bucket < cutoff)
            metadatas[idx].append(metadata)
        return (
            AudioClipDataset(metadata_list=metadatas[0], set_type=DatasetType.TRAINING, **dataset_kwargs),
            AudioClipDataset(metadata_list=metadatas[1], set_type=DatasetType.DEV, **dataset_kwargs),
            AudioClipDataset(metadata_list=metadatas[2], set_type=DatasetType.TEST, **dataset_kwargs),
        )


SoundIdSplitMozillaWakeWordLoader = partial(MozillaWakeWordLoader, split_by_speaker=False)
SpeakerSplitMozillaWakeWordLoader = partial(MozillaWakeWordLoader, split_by_speaker=True)
