"""Orchestrates stitching per split -> stitched-metadata-{split}.jsonl
(ref: howl/dataset/stitched_audio_dataset_generator.py:16-90)."""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

from howl_tpu_torch.data.common.vocab import Vocab
from howl_tpu_torch.data.dataset.constants import DIR_AUDIO, AudioDatasetType
from howl_tpu_torch.data.dataset.dataset import DatasetSplit
from howl_tpu_torch.data.dataset.dataset_writer import AudioDatasetMetadataWriter
from howl_tpu_torch.data.dataset.factory import HowlAudioDatasetLoader
from howl_tpu_torch.etl.stitcher import WordStitcher
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.utils.logger import Logger


class StitchedAudioDatasetGenerator:
    def __init__(
        self,
        aligned_audio_dataset_path: Path,
        vocab: Vocab,
        max_num_training_samples: int,
        max_num_dev_samples: int,
        max_num_test_samples: int,
        validate_fn: Optional[Callable] = None,
        sample_rate: int = None,
        mono: bool = None,
        labeler=None,
    ):
        self.vocab = vocab
        self.aligned_audio_dataset_path = Path(aligned_audio_dataset_path)
        self.dataset_loader = HowlAudioDatasetLoader(
            AudioDatasetType.ALIGNED, self.aligned_audio_dataset_path
        )
        self.validate_fn = validate_fn
        self.base_ds_kwargs = dict(
            sample_rate=sample_rate or SETTINGS.audio.sample_rate,
            mono=SETTINGS.audio.use_mono if mono is None else mono,
            frame_labeler=labeler,
        )
        self.max_num_samples = {
            DatasetSplit.TRAINING: max_num_training_samples,
            DatasetSplit.DEV: max_num_dev_samples,
            DatasetSplit.TEST: max_num_test_samples,
        }

    def generate_datasets(self):
        for split in (DatasetSplit.TRAINING, DatasetSplit.DEV, DatasetSplit.TEST):
            self._generate_dataset(split)

    def _generate_dataset(self, dataset_split: DatasetSplit):
        if len(self.vocab) <= 1:
            Logger.warning(f"word stitching requires at least two words: {self.vocab}")
            return
        aligned_dataset = self.dataset_loader.load_split(dataset_split, **self.base_ds_kwargs)
        stitcher = WordStitcher(vocab=self.vocab, validate_fn=self.validate_fn)
        audio_dir = self.aligned_audio_dataset_path / DIR_AUDIO
        audio_dir.mkdir(exist_ok=True)
        stitcher.generate_stitched_audio_samples(
            self.max_num_samples[dataset_split],
            audio_dir,
            aligned_dataset,
            audio_sample_filename_template=dataset_split.value + "_{sample_idx}",
        )
        with AudioDatasetMetadataWriter(
            self.aligned_audio_dataset_path, AudioDatasetType.STITCHED, dataset_split
        ) as writer:
            for sample in stitcher.stitched_samples:
                writer.write(sample.metadata)
