"""Synthetic wakeword generation: cut vocab-word spans out of aligned clips and
stitch one random sample per word of the inference sequence
(ref: howl/data/stitcher.py:20-194).

Differences from the reference, on purpose:
  * validation is a pluggable callable (path -> bool keyword_present) instead
    of a hard PocketSphinx dependency; and the keep/skip logic is corrected —
    the reference *skips* samples in which the keywords WERE detected
    (stitcher.py:154-167, noted as inverted in SURVEY.md §2.4); here a
    validated sample is KEPT when all keywords are detected.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from howl_tpu_torch.data.common.metadata import AudioClipMetadata
from howl_tpu_torch.data.common.sample import Sample
from howl_tpu_torch.data.common.vocab import Vocab
from howl_tpu_torch.utils import audio_utils
from howl_tpu_torch.utils.logger import Logger


@dataclass
class FrameLabelledSample:
    audio_data: np.ndarray
    audio_length_ms: float
    end_timestamps: Optional[List[float]]
    label: int


class Stitcher:
    def __init__(
        self,
        vocab: Vocab,
        inference_sequence: List[int] = None,
        validate_fn: Optional[Callable[[Path, str], bool]] = None,
        sample_rate: int = None,
    ):
        from howl_tpu_torch.settings import SETTINGS

        self.inference_sequence = (
            list(inference_sequence)
            if inference_sequence is not None
            else list(SETTINGS.inference_engine.inference_sequence)
        )
        self.sample_rate = sample_rate or SETTINGS.audio.sample_rate
        self.vocab = vocab
        self.wakeword = " ".join(str(self.vocab[x]) for x in self.inference_sequence)
        self.validate_fn = validate_fn


class WordStitcher(Stitcher):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.stitched_samples: List[Sample] = []

    def concatenate_end_timestamps(self, end_timestamps_list: List[List[float]]) -> List[float]:
        """Concatenate per-word timestamps, repeating the last timestamp of each
        word to stand in for the separating space (ref stitcher.py:68-88)."""
        concatenated = []
        last = 0.0
        for end_timestamps in end_timestamps_list:
            for timestamp in end_timestamps:
                concatenated.append(timestamp + last)
            concatenated.append(concatenated[-1])  # the space after this word
            last = concatenated[-1]
        return concatenated[:-1]  # no trailing space

    def generate_stitched_audio_samples(
        self,
        num_stitched_samples: int,
        stitched_audio_dir: Path,
        *datasets,
        audio_sample_filename_template: str = "{sample_idx}",
        max_attempts_factor: int = 5,
    ):
        """Harvest per-word audio spans from aligned samples, then concatenate
        one random span per word of the inference sequence."""
        sample_set: List[List[FrameLabelledSample]] = [[] for _ in range(len(self.vocab))]

        for dataset in datasets:
            for idx in range(len(dataset)):
                sample = dataset[idx]
                if sample.label_data is None:
                    continue
                end_ts = sample.metadata.end_timestamps or []
                for label, char_indices in sample.label_data.char_indices:
                    start_char = char_indices[0] - 1 if char_indices[0] > 0 else 0
                    start_timestamp = end_ts[start_char]
                    end_timestamp = end_ts[char_indices[-1]]
                    a = int(start_timestamp * self.sample_rate / 1000)
                    b = int(end_timestamp * self.sample_rate / 1000)
                    adjusted = [end_ts[ci] - start_timestamp for ci in char_indices]
                    sample_set[label].append(
                        FrameLabelledSample(
                            sample.audio_data[a:b], end_timestamp - start_timestamp, adjusted, label
                        )
                    )

        sample_lists = []
        for element in self.inference_sequence:
            Logger.info(f"samples for vocab {self.vocab[element]!r}: {len(sample_set[element])}")
            if not sample_set[element]:
                raise ValueError(f"no samples harvested for vocab word {self.vocab[element]!r}")
            sample_lists.append(sample_set[element])

        stitched_audio_dir = Path(stitched_audio_dir)
        stitched_audio_dir.mkdir(parents=True, exist_ok=True)
        self.stitched_samples = []
        num_skipped = 0
        attempts = 0
        sample_idx = 0
        while sample_idx < num_stitched_samples:
            attempts += 1
            if attempts > max_attempts_factor * num_stitched_samples:
                Logger.warning(
                    f"giving up after {attempts} attempts; produced {sample_idx} samples "
                    f"({num_skipped} rejected by validation)"
                )
                break
            picked = [random.choice(lst) for lst in sample_lists]
            audio_data = np.concatenate([p.audio_data for p in picked])

            path = (stitched_audio_dir / audio_sample_filename_template.format(sample_idx=sample_idx)).with_suffix(
                ".wav"
            )
            audio_utils.write_wav(path, audio_data, self.sample_rate)

            if self.validate_fn is not None and not self.validate_fn(path, self.wakeword):
                num_skipped += 1
                path.unlink(missing_ok=True)
                continue

            metadata = AudioClipMetadata(
                path=path,
                transcription=self.wakeword,
                end_timestamps=self.concatenate_end_timestamps([p.end_timestamps for p in picked]),
            )
            self.stitched_samples.append(Sample(metadata, audio_data, self.sample_rate))
            sample_idx += 1

        if self.validate_fn is not None:
            Logger.info(
                f"generated {sample_idx} stitched samples; {num_skipped} rejected by keyword validation"
            )
