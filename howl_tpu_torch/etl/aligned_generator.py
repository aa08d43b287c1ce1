"""Attach alignments to a raw dataset -> aligned-metadata-{split}.jsonl
(ref: howl/dataset/aligned_audio_dataset_generator.py:22-215)."""

from __future__ import annotations

from enum import Enum, unique
from pathlib import Path
from typing import Dict, Optional

from howl_tpu_torch.align.base import AlignedTranscription
from howl_tpu_torch.align.mfa import MfaTextGridConverter
from howl_tpu_torch.align.stub import StubAligner
from howl_tpu_torch.align.textgrid import TextGrid
from howl_tpu_torch.data.common.metadata import AudioClipMetadata
from howl_tpu_torch.data.common.tokenizer import TokenType
from howl_tpu_torch.data.dataset.constants import AudioDatasetType
from howl_tpu_torch.data.dataset.dataset_writer import AudioDatasetMetadataWriter
from howl_tpu_torch.data.dataset.factory import HowlAudioDatasetLoader
from howl_tpu_torch.settings import SETTINGS
from howl_tpu_torch.utils.logger import Logger


@unique
class AlignmentType(str, Enum):
    MFA = "mfa"
    STUB = "stub"


def _convert_textgrid(path_str: str, use_phones: bool):
    """Parse + convert one TextGrid (module-level so a spawn-context process
    pool can pickle it). Returns (stem, AlignedTranscription | None)."""
    path = Path(path_str)
    try:
        converter = MfaTextGridConverter(use_phones=use_phones)
        return path.stem, converter.convert(TextGrid.from_file(path))
    except Exception as e:  # noqa: BLE001 — skip malformed grids, keep going
        Logger.warning(f"failed to parse {path}: {e}")
        return path.stem, None


class AlignedAudioDatasetGenerator:
    def __init__(
        self,
        raw_audio_dataset_path: Path,
        alignment_type: AlignmentType,
        alignments_path: Optional[Path] = None,
        sample_rate: int = None,
        mono: bool = None,
        token_type: TokenType = None,
        num_workers: Optional[int] = None,
    ):
        self.raw_audio_dataset_path = Path(raw_audio_dataset_path)
        if not self.raw_audio_dataset_path.exists():
            raise FileNotFoundError(f"dataset path is invalid: {self.raw_audio_dataset_path}")
        sample_rate = sample_rate or SETTINGS.audio.sample_rate
        mono = SETTINGS.audio.use_mono if mono is None else mono
        token_type = token_type or TokenType(SETTINGS.training.token_type)

        loader = HowlAudioDatasetLoader(AudioDatasetType.RAW, self.raw_audio_dataset_path)
        ds_kwargs = dict(sample_rate=sample_rate, mono=mono)
        self.train_ds, self.dev_ds, self.test_ds = loader.load_splits(**ds_kwargs)

        if alignment_type == AlignmentType.MFA:
            if alignments_path is None:
                raise ValueError("MFA alignment requires --alignments-path")
            self.alignments = self._load_mfa_alignments(Path(alignments_path), token_type, num_workers)
        elif alignment_type == AlignmentType.STUB:
            # the stub aligner needs only transcription + duration: read the
            # WAV header for the sample count instead of decoding every clip
            from howl_tpu_torch.utils.audio_utils import wav_num_samples

            self.alignments: Dict[str, AlignedTranscription] = {}
            for ds in (self.train_ds, self.dev_ds, self.test_ds):
                for metadata in ds.metadata_list:
                    duration_ms = wav_num_samples(metadata.path, sample_rate) / sample_rate * 1000
                    self.alignments[metadata.audio_id] = StubAligner.from_duration(
                        metadata.transcription, duration_ms
                    )
        else:
            raise ValueError(f"alignment type is invalid: {alignment_type}")

    @staticmethod
    def _load_mfa_alignments(
        alignments_path: Path, token_type: TokenType, num_workers: Optional[int] = None
    ) -> Dict[str, AlignedTranscription]:
        """TextGrid ingestion on a worker pool (ref pools this too,
        aligned_audio_dataset_generator.py:98-116). Parsing is pure Python, so
        the pool is spawn-context PROCESSES (utils/parallel.py on why spawn);
        ordered results keep the alignment map identical to a sequential run."""
        from functools import partial

        from howl_tpu_torch.utils.parallel import parallel_map

        paths = [str(p) for p in sorted(alignments_path.glob("**/*.TextGrid"))]
        use_phones = token_type == TokenType.PHONE
        results = parallel_map(
            partial(_convert_textgrid, use_phones=use_phones), paths, num_workers=num_workers, mode="process"
        )
        alignments = {stem: aligned for stem, aligned in results if aligned is not None}
        Logger.info(f"loaded {len(alignments)} alignments from {alignments_path}")
        return alignments

    def _generate_dataset(self, dataset):
        metadata_list = []
        for metadata in dataset.metadata_list:
            aligned = self.alignments.get(metadata.audio_id)
            if aligned is None:
                Logger.warning(f"alignment for audio file {metadata.audio_id} does not exist")
                continue
            metadata_list.append(
                AudioClipMetadata(
                    path=metadata.path,
                    transcription=aligned.transcription,
                    end_timestamps=aligned.end_timestamps,
                )
            )
        with AudioDatasetMetadataWriter(
            self.raw_audio_dataset_path, AudioDatasetType.ALIGNED, dataset.dataset_split
        ) as writer:
            for metadata in metadata_list:
                writer.write(metadata)

    def generate_datasets(self):
        for ds in (self.train_ds, self.dev_ds, self.test_ds):
            self._generate_dataset(ds)
