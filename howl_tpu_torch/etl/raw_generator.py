"""Raw dataset mining: positives/negatives from a source corpus
(ref: howl/dataset/raw_audio_dataset_generator.py:14-94)."""

from __future__ import annotations

from pathlib import Path

from howl_tpu_torch.context import InferenceContext
from howl_tpu_torch.data.common.metadata import AudioClipMetadata
from howl_tpu_torch.data.common.tokenizer import TokenType
from howl_tpu_torch.data.dataset.constants import AudioDatasetType, SampleType
from howl_tpu_torch.data.dataset.dataset_writer import AudioDatasetWriter
from howl_tpu_torch.data.dataset.factory import get_dataset_loader
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.utils import hash_utils
from howl_tpu_torch.utils.logger import Logger


class RawAudioDatasetGenerator:
    """Mines a corpus: positives (transcript contains any vocab word) and
    negatives (transcript does NOT contain the wakeword), bucketed by
    sha256(clip stem) % 100 < percentage."""

    def __init__(self, input_dataset_path: Path, dataset_type: AudioDatasetType):
        self.input_dataset_path = Path(input_dataset_path)
        if not self.input_dataset_path.exists():
            raise FileNotFoundError(f"dataset path is invalid: {self.input_dataset_path}")
        self.dataset_type = dataset_type
        self.dataset_loader = get_dataset_loader(dataset_type, self.input_dataset_path)
        self.inference_ctx = InferenceContext(
            vocab=SETTINGS.training.vocab, token_type=SETTINGS.training.token_type
        )
        ds_kwargs = dict(sample_rate=SETTINGS.audio.sample_rate, mono=SETTINGS.audio.use_mono)
        self.train_ds, self.dev_ds, self.test_ds = self.dataset_loader.load_splits(**ds_kwargs)

    def filter_fn(self, metadata: AudioClipMetadata, sample_type: SampleType, percentage: int = 100) -> bool:
        bucket = hash_utils.sha256_int(metadata.path.stem) % 100
        if bucket >= percentage:
            return False
        if sample_type == SampleType.POSITIVE:
            return self.inference_ctx.searcher.contains_any(metadata.transcription.lower())
        if sample_type == SampleType.NEGATIVE:
            return not self.inference_ctx.searcher.search(metadata.transcription.lower())
        raise RuntimeError(f"invalid sample type: {sample_type}")

    def generate_datasets(
        self,
        dataset_path: Path,
        sample_type: SampleType,
        percentage: int = 100,
        print_statistics: bool = True,
        num_workers: int = None,
    ):
        Logger.info(f"generating {sample_type.value} dataset using {percentage}% of the data")

        def keep(metadata):
            return self.filter_fn(metadata, sample_type, percentage)

        word_searcher = (
            self.inference_ctx.searcher if self.inference_ctx.token_type == TokenType.WORD else None
        )
        for source in (self.train_ds, self.dev_ds, self.test_ds):
            dataset = source.filter(keep, clone=True)
            if print_statistics:
                dataset.print_stats(
                    header=dataset.dataset_split.value,
                    word_searcher=word_searcher,
                    compute_length=True,
                    num_workers=num_workers,
                )
            Logger.info(f"generating {dataset.dataset_split.value} split")
            AudioDatasetWriter(dataset, AudioDatasetType.RAW).write(Path(dataset_path), num_workers=num_workers)
